"""The port's example drivers on the CPU, run as a user runs them.

``examples/active_learning_svm.py`` of the JAX package has its counterpart
in ``repro_torch.examples.active_learning_svm``: the same flags plus
``--device``, one report line per method.  At ``--d 32`` both packages'
``newsgroups_like`` refuse (40 topic words per class drawn without
replacement), so the small run takes ``--d 64``.  ``serve_lm`` and
``al_data_curation`` run at the JAX examples' defaults, as do the four
serving walkthroughs (``quickstart``, ``serve_index``, ``serve_async``,
``refresh_loop``), whose own assertions are the JAX examples'; ``serve_lm``
also runs the MoE arch (reduced deepseek-moe-16b), the MLA archs
(minicpm3-4b, deepseek-v3-671b) and the recurrent ones (recurrentgemma-2b,
mamba2-780m).  ``train_lm`` runs at a few steps (its default is 200) and
with int8 moments; it refuses the stub-front-end archs, as the JAX
example does.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

SRC = str(Path(__file__).resolve().parents[1] / "src")
# each example runs with one intra-op thread: the suite runs beside other
# workers on the same cores, where torch's default thread pool spins on
# every one of the LBH loop's small ops (quickstart took over 250 s with
# five busy processes beside it, 24 s with one thread)
ENV = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
LINE = re.compile(r"^(\w+) +MAP (\d\.\d{3}) -> (\d\.\d{3}) \| margin "
                  r"\d\.\d{5} \(optimal \d\.\d{5}\) \| nonempty lookups "
                  r"(\d+)/(\d+) \| select \d+\.\ds$")


def test_active_learning_example_runs_on_cpu():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.active_learning_svm",
         "--iters", "2", "--n", "300", "--d", "64", "--classes", "3",
         "--methods", "random,bh", "--device", "cpu"],
        capture_output=True, text=True, timeout=300, env=ENV)
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
        env=ENV)


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


# each case: the example's arguments, then one pattern per line of its
# output, in order (re.fullmatch)
SERVING = {
    "quickstart": ((), [
        r"database: \(20000, 129\)",
        r"fit in \d+\.\ds on cpu; table stats: \{'n': 20000, 'k': 20, .*\}",
        r"table lookup: nonempty=True candidates=\d+ margin=\d\.\d{5} "
        r"\(true rank \d+/20000; brute-force min \d\.\d{5}\)",
        r"device scan:  idx=\d+ margin=\d\.\d{5} \(rank \d+\)"]),
    "serve_index": ((), [
        r"index: \{'tables': 4, 'n': 10000, 'rows': 10000, .*'device': "
        r"'cpu', .*\}",
        r"32-query batch: \d+/32 nonempty, mean margin \d\.\d{4}",
        r"service: \{'requests': 74, 'batches': 3, .*\}",
        r"after insert/delete: n=10250, version=3",
        r"post-update answers: \[(\d+, ){7}\d+\]",
        r"after churn: n=4250, rows=4250, compactions=1",
        r"post-compaction answers \(stable ids\): \[.*\]",
        r"scan ids: \[(\d+, ){7}\d+\]",
        r"scan service: \{'requests': 8, 'batches': 1, .*\}"]),
    "serve_async": ((), [
        r"96 requests from 4 threads -> \d+ device flushes \(mean batch "
        r"\d+\.\d\), p95 latency \d+\.\d ms",
        r"batch-size histogram: \{.*\}",
        r"async answers == sync query_batch, all 96",
        r"bounded queue \(max_queue=8\): 4/12 shed explicitly",
        r"closed; queue depth 0"]),
    "refresh_loop": ((), [
        r"recall@20 pre-drift: +random \d\.\d{3} +drift-focused \d\.\d{3} "
        r"+\(generation 0\)",
        r"recall@20 post-drift: +random \d\.\d{3} +drift-focused \d\.\d{3} "
        r"+\(generation 0\)",
        r"recall@20 post-refresh: +random \d\.\d{3} +drift-focused "
        r"\d\.\d{3} +\(generation 1\)",
        r"refresh cost: learn \d+\.\d\ds \+ build \d+\.\d\ds off-lock; swap "
        r"pause \d+\.\d\dms under the lock; \d+ rows caught up "
        r"mid-refresh"]),
    "serve_lm": (("--arch", "deepseek-moe-16b"), [
        r"deepseek-moe-16b: batch=8 gen=48",
        r"first call: \d+\.\d\ds; steady: \d+\.\d\ds = \d+ tok/s on cpu",
        r"sample: \[(\d+, ){11}\d+\]"]),
}


@pytest.mark.parametrize("name", sorted(SERVING))
def test_serving_example_runs_on_cpu(name):
    """The port's counterparts of ``examples/quickstart.py``,
    ``serve_index.py``, ``serve_async.py`` and ``refresh_loop.py`` at the
    JAX examples' sizes (their asserts hold inside the run), and
    ``serve_lm`` on the MoE arch."""
    args, patterns = SERVING[name]
    proc = _run_example(name, *args)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [ln for ln in proc.stdout.strip().splitlines() if ln]
    assert len(lines) == len(patterns), lines
    for line, pat in zip(lines, patterns):
        assert re.fullmatch(pat, line), (pat, line)


@pytest.mark.parametrize("arch", ["minicpm3-4b", "deepseek-v3-671b",
                                  "recurrentgemma-2b", "mamba2-780m"])
def test_serve_lm_runs_each_new_family(arch):
    """``serve_lm --arch`` for MLA and the recurrent blocks, at the JAX
    example's defaults (batch 8, 32-token prompts, 48 generated)."""
    proc = _run_example("serve_lm", "--arch", arch)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [ln for ln in proc.stdout.strip().splitlines() if ln]
    patterns = [rf"{arch}: batch=8 gen=48",
                r"first call: \d+\.\d\ds; steady: \d+\.\d\ds = \d+ tok/s "
                r"on cpu",
                r"sample: \[(\d+, ){11}\d+\]"]
    assert len(lines) == len(patterns), lines
    for line, pat in zip(lines, patterns):
        assert re.fullmatch(pat, line), (pat, line)


@pytest.mark.parametrize("moment_dtype", ["float32", "int8"])
def test_train_lm_example_runs_on_cpu(moment_dtype):
    """``examples/train_lm.py``'s counterpart at 20 steps: the first half,
    a restart from its checkpoint into a model of zeros, the second half,
    and the example's own check that the loss improved."""
    proc = _run_example("train_lm", "--steps", "20", "--moment-dtype",
                        moment_dtype)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = [ln for ln in proc.stdout.strip().splitlines() if ln]
    patterns = [r"\[phase 1\] loss \d+\.\d{3} -> \d+\.\d{3}",
                r"\[restart\] restored at step 10",
                r"\[phase 2\] loss \d+\.\d{3} -> \d+\.\d{3} \(stragglers "
                r"flagged: \d+\)",
                r"OK: loss improved across a checkpoint/restart boundary"]
    assert len(lines) == len(patterns), lines
    for line, pat in zip(lines, patterns):
        assert re.fullmatch(pat, line), (pat, line)
    refused = _run_example("train_lm", "--arch", "musicgen-large")
    assert refused.returncode != 0 and "stub frontend" in refused.stderr
