"""The port's example drivers on the CPU, run as a user runs them.

``examples/active_learning_svm.py`` of the JAX package has its counterpart
in ``repro_torch.examples.active_learning_svm``: the same flags plus
``--device``, one report line per method.  At ``--d 32`` both packages'
``newsgroups_like`` refuse (40 topic words per class drawn without
replacement), so the small run takes ``--d 64``.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

SRC = str(Path(__file__).resolve().parents[1] / "src")
LINE = re.compile(r"^(\w+) +MAP (\d\.\d{3}) -> (\d\.\d{3}) \| margin "
                  r"\d\.\d{5} \(optimal \d\.\d{5}\) \| nonempty lookups "
                  r"(\d+)/(\d+) \| select \d+\.\ds$")


def test_active_learning_example_runs_on_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.active_learning_svm",
         "--iters", "2", "--n", "300", "--d", "64", "--classes", "3",
         "--methods", "random,bh", "--device", "cpu"],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=SRC))
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert lines[0] == ("corpus (300, 65), 2 AL iterations, 3 one-vs-all "
                        "SVMs, device cpu")
    reports = [LINE.match(line) for line in lines[1:] if line]
    assert [m.group(1) for m in reports] == ["random", "bh"]
    for m in reports:
        assert 0.0 <= float(m.group(2)) <= 1.0
        assert 0.0 <= float(m.group(3)) <= 1.0
        assert int(m.group(5)) == 2 * 3 and int(m.group(4)) <= 6
