"""The port's example drivers on the CPU, run as a user runs them.

``examples/active_learning_svm.py`` of the JAX package has its counterpart
in ``repro_torch.examples.active_learning_svm``: the same flags plus
``--device``, one report line per method.  At ``--d 32`` both packages'
``newsgroups_like`` refuse (40 topic words per class drawn without
replacement), so the small run takes ``--d 64``.  ``serve_lm`` and
``al_data_curation`` run at the JAX examples' defaults.
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


def _run_example(name, *args):
    return subprocess.run(
        [sys.executable, "-m", f"repro_torch.examples.{name}", *args,
         "--device", "cpu"], capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=SRC))


def test_serve_lm_example_runs_on_cpu():
    """``examples/serve_lm.py``'s counterpart at its defaults (reduced
    qwen2.5-3b, batch 8, prompt 32, 48 generated tokens)."""
    proc = _run_example("serve_lm")
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert lines[0] == "qwen2.5-3b: batch=8 gen=48"
    assert re.fullmatch(r"first call: \d+\.\d\ds; steady: \d+\.\d\ds = \d+ "
                        r"tok/s on cpu", lines[1]), lines[1]
    sample = re.fullmatch(r"sample: \[(.*)\]", lines[2]).group(1)
    toks = [int(v) for v in sample.split(",")]
    assert len(toks) == 12 and all(0 <= v < 512 for v in toks)


def test_al_data_curation_example_runs_on_cpu():
    """``examples/al_data_curation.py``'s counterpart at its defaults
    (reduced qwen3-1.7b, 512 sequences of 24 tokens, LBH 16 bits): eight
    picks, each a margin no larger than the pool's mean."""
    proc = _run_example("al_data_curation")
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert lines[0].startswith("indexed 512 sequences on cpu; table: {'n': "
                               "512, 'k': 16")
    picks = re.findall(r"\((\d+), (\d+\.\d+)\)", lines[1])
    assert len(picks) == 8 and len({i for i, _ in picks}) == 8
    m = re.fullmatch(r"selected margin mean (\d+\.\d+) vs pool mean "
                     r"(\d+\.\d+) .*", lines[2])
    assert m and float(m.group(1)) < float(m.group(2))
