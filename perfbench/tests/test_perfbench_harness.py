"""The harness: ``BENCHMARK.json`` has the shape its format fixes and agrees
with the files it names; a cell, mix and metric added as files alone are
found; a run loads neither JAX nor the JAX package; the reference loads
nothing of the program; a run without a card or without the program
prints no result; the profiler's empty sessions are retried and then
fail the run."""
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

from perfbench import profiling, spec
from perfbench.tests.sizes import SIZES

ROOT = Path(__file__).resolve().parents[2]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert all(_line(w) for w in BENCH["command"])
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]]
    names += [w["name"] for w in BENCH["workloads"]]
    names += [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    used = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert (ROOT / "perfbench" / "traffic" / f"{w['traffic']}.json"
                ).is_file()
        used.add(w["config"])
    assert used == {c["name"] for c in BENCH["configs"]}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    setup = [m for m in BENCH["end_to_end"] if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_reports_setup_and_its_metrics(cell):
    bench = BENCH
    e2e, per = spec.cell_metrics(bench, cell)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2 and per
    merged = spec.cell(bench, cell)     # its file agrees with the entry
    assert set(merged["limits"]) >= {"margin_err", "cand_mismatch",
                                     "rerank_gap"}
    for m in per:
        assert m["moves"] in names
        assert "workloads" not in m or cell in m["workloads"]


def _per_layer(bench):
    return {m["name"]: m for m in bench["per_layer"]}


@pytest.mark.parametrize("metric", sorted(
    p.stem for p in (ROOT / "perfbench" / "metrics").glob("*.py")))
def test_metric_reader_agrees_with_benchmark_json(metric):
    entry = _per_layer(BENCH)[metric]
    mod = spec.metric_module(metric)
    assert (mod.LAYER, mod.UNIT, mod.MOVES, mod.SOURCE) == (
        entry["layer"], entry["unit"], entry["moves"], entry["source"])


ADDED = """
import json, sys
sys.path.insert(0, sys.argv[1])
from perfbench import spec
from perfbench.harness import run
bench = spec.load_benchmark(sys.argv[1])
e2e, per = spec.cell_metrics(bench, "tiny1m-scan-b5")
ctx = {"phases": {"window": {"batches": 3}}}
out = run(sys.argv[1], "tiny1m-scan-b5", 5, 0.3, False,
          require_cuda=False, device="cpu", size=json.loads(sys.argv[2]))
print(json.dumps({"per": [m["name"] for m in per],
                  "read": spec.metric_module("batches_seen").read(ctx),
                  "correct": out["correct"],
                  "batch": out["attempted"]}))
"""


def test_additions_as_files_are_found(tmp_path):
    copy = tmp_path / "checkout"
    shutil.copytree(ROOT / "perfbench", copy / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (copy / "src").symlink_to(ROOT / "src")
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    mix = json.loads((ROOT / "perfbench/traffic/round10-l6264.json"
                      ).read_text())
    mix["batch"] = 5
    (copy / "perfbench/traffic/round5-l6264.json").write_text(
        json.dumps(mix))
    cell = json.loads((ROOT / "perfbench/workloads/tiny1m-scan-round10.json"
                       ).read_text())
    cell.update(name="tiny1m-scan-b5", traffic="round5-l6264",
                entry="query_batch_copy", why="a cell added as files")
    (copy / "perfbench/workloads/tiny1m-scan-b5.json").write_text(
        json.dumps(cell))
    shutil.copy(ROOT / "perfbench/entries/query_batch.py",
                copy / "perfbench/entries/query_batch_copy.py")
    (copy / "perfbench/metrics/batches_seen.py").write_text(
        'LAYER = "query service"\nUNIT = "batches"\n'
        'MOVES = "qps"\nSOURCE = "program_counter"\n\n\n'
        'def read(ctx):\n    return ctx["phases"]["window"]["batches"]\n')
    bench["workloads"].append({k: cell[k] for k in
                               ("name", "config", "traffic", "chips",
                                "why")})
    bench["per_layer"].append({
        "name": "batches_seen", "unit": "batches", "better": "higher",
        "source": "program_counter", "layer": "query service",
        "moves": "qps", "workloads": ["tiny1m-scan-b5"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(bench))
    size = SIZES["tiny1m-scan-round10"]
    out = subprocess.run([sys.executable, "-c", ADDED, str(copy),
                          json.dumps(size)], cwd=copy, capture_output=True,
                         text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["per"] == ["batches_seen"] and got["read"] == 3
    assert got["correct"] and got["batch"] % 5 == 0


LOADED = """
import json, sys
sys.path.insert(0, sys.argv[1])
from perfbench.harness import FORBIDDEN, run
from perfbench.tests.sizes import SIZES
for cell in SIZES:
    run(sys.argv[2], cell, 3, 0.3, False, require_cuda=False,
        device="cpu", size=SIZES[cell])
top = {m.split(".")[0] for m in list(sys.modules)}
print(json.dumps(sorted(top & set(FORBIDDEN))))
"""


def test_a_run_loads_neither_jax_nor_the_jax_package():
    out = subprocess.run([sys.executable, "-c", LOADED, str(ROOT),
                          str(ROOT)],
                         capture_output=True, text=True, timeout=240,
                         cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


REPORT = """
import json, sys, types
sys.path.insert(0, sys.argv[1])
from perfbench.run import report
out = {"correct": True, "checks": {"unanswered": {"value": 0, "limit": 0}}}
if sys.argv[2]:
    sys.modules[sys.argv[2]] = types.ModuleType(sys.argv[2])
sys.exit(report(out))
"""


@pytest.mark.parametrize("loaded", ("", "jax", "flax", "repro.core"))
def test_a_loaded_jax_module_prints_no_result(loaded):
    out = subprocess.run([sys.executable, "-c", REPORT, str(ROOT), loaded],
                         capture_output=True, text=True, timeout=120)
    if loaded:
        assert out.returncode != 0 and out.stdout.strip() == ""
        assert loaded.split(".")[0] in out.stderr
    else:
        assert out.returncode == 0
        assert json.loads(out.stdout)["correct"]
        assert out.stderr.strip().endswith("(limit 0)")


REFERENCE = """
import json, sys
sys.path.insert(0, sys.argv[1])
import perfbench.reference.hyperplane, perfbench.check, perfbench.costs
import perfbench.data, perfbench.reference.generator
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules}
                        & {"repro_torch", "repro", "jax"})))
"""


def test_the_reference_loads_nothing_of_the_program():
    out = subprocess.run([sys.executable, "-c", REFERENCE, str(ROOT)],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def _run_cli(cwd):
    return subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "tiny1m-scan-round10", "--seed", "2147483659", "--seconds", "1",
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=120, env={"PATH": "/usr/bin:/bin", "HOME": str(cwd)})


def test_no_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the run would measure")
    out = _run_cli(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "no result" in out.stderr


def test_without_the_program_no_result(tmp_path):
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = _run_cli(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


def _event(name, start, end, cuda):
    import torch
    dt = torch.autograd.DeviceType
    return SimpleNamespace(name=name, device_type=dt.CUDA if cuda
                           else dt.CPU,
                           time_range=SimpleNamespace(start=start, end=end))


def test_profile_reduction():
    ev = [_event(profiling.WINDOW_MARK, 0, 100, False),
          _event(profiling.WINDOW_MARK, 0, 100, True),
          _event("topk_hist_kernel<int>", 10, 30, True),
          _event("bh_seeded_product_kernel", 25, 40, True),
          _event("Memcpy HtoD", 60, 70, True),
          _event("aten::to", 40, 60, False),
          _event("aten::sort", 70, 100, False)]
    red = profiling.reduce_events(ev)
    assert red["window_s"] == pytest.approx(100e-6)
    assert red["busy_s"] == pytest.approx(40e-6)       # 10-40, 60-70
    assert red["copies_s"] == pytest.approx(10e-6)
    assert profiling.fragment_seconds(red["kernels"], ("topk_hist",)) == \
        pytest.approx(20e-6)
    assert [g[0] for g in red["idle_gaps"]] == ["aten::sort", "aten::to",
                                                "host: no operation recorded"]
    assert profiling.reduce_events(ev[:1] + ev[5:]) is None


def test_empty_profiles_are_retried_then_fail():
    lines = []
    with pytest.raises(profiling.EmptyProfile):
        profiling.traced(lambda: {}, lines.append)
    assert len(lines) == profiling.PROFILE_TRIES


# kernel names as the profiler reports them on the card (torch 2.x, CUDA)
MERGE_NAMES = [
    "void at_cuda_detail::cub::DeviceSegmentedRadixSortKernel<at_cuda_detail"
    "::cub::DeviceRadixSortPolicy<long, long, int>::Policy900, false, false,"
    " long, long, at::native::detail::OpaqueType<8>, int>",
    "void at::native::radixSortKVInPlace<2, -1, 32, 32, long, long, unsigned"
    " int>(at::cuda::detail::TensorInfo<long, unsigned int>)",
    "void at::native::vectorized_elementwise_kernel<2, at::native::"
    "BinaryFunctor<long, long, long, at::native::BitwiseOrFunctor<long> >, "
    "std::array<char*, 3ul> >(int)",
    "void at::native::vectorized_elementwise_kernel<2, at::native::"
    "BUnaryFunctor<long, long, long, at::native::lshift_kernel_cuda(at::"
    "TensorIteratorBase&)::{lambda(long, long)#1}>, std::array<char*, 2ul> >"]
OTHER_NAMES = [
    "void at::native::radixSortKVInPlace<2, -1, 32, 32, float, long, unsigned"
    " int>(at::cuda::detail::TensorInfo<float, unsigned int>)",
    "void at::native::radixSortKVInPlace<2, -1, 32, 32, int, long, unsigned "
    "int>(at::cuda::detail::TensorInfo<int, unsigned int>)",
    "void at_cuda_detail::cub::DeviceSegmentedRadixSortKernel<at_cuda_detail"
    "::cub::DeviceRadixSortPolicy<int, long, int>::Policy900, false, false, "
    "int, long, at::native::detail::OpaqueType<8>, int>",
    "void at::native::index_elementwise_kernel<128, 4, at::native::"
    "gpu_index_kernel<at::native::index_kernel_impl<at::native::OpaqueType<4>"
    " >(at::TensorIteratorBase&)>",
    "void at::native::vectorized_elementwise_kernel<4, at::native::"
    "BitwiseAndFunctor<int>, std::array<char*, 3ul> >(int)",
    "void (anonymous namespace)::topk_hist_kernel<unsigned int, 8, false, "
    "short, short>(unsigned int const*)",
    "void (anonymous namespace)::bh_seeded_product_kernel<1, 1>(float const*)"]


def test_kernels_are_told_apart_by_name():
    """Each kernel's time goes to one layer's reader: the merge's int64
    sorts and key shifts to ``merge_roofline``, the hash and scan kernels
    to theirs, the rest (union, gather, margins, their sorts) to
    ``rerank_roofline``."""
    from perfbench import costs
    names = MERGE_NAMES + OTHER_NAMES
    kernels = {n: [1e-3 * (i + 1), 1] for i, n in enumerate(names)}
    merge = spec.metric_module("merge_roofline")
    assert [bool(merge.PATTERN.search(n)) for n in names] == [True] * len(
        MERGE_NAMES) + [False] * len(OTHER_NAMES)
    shape = {"n": 18_846, "d": 600, "k": 16, "w": 1, "g": 1, "b": 20,
             "l": 201}
    ph = {"batches": 7, "candidates": 20 * 7 * 201}
    ctx = {"profile": {"kernels": kernels}, "phases": {"traced": ph},
           "shape": shape, "costs": costs}
    t_merge = sum(1e-3 * (i + 1) for i in range(len(MERGE_NAMES)))
    t_rerank = sum(1e-3 * (len(MERGE_NAMES) + i + 1) for i in range(5))
    assert merge.read(ctx) == pytest.approx(100 * 7 * costs.merge_bound(
        18_846, 1, 20, 201).seconds / t_merge)
    assert spec.metric_module("rerank_roofline").read(ctx) == pytest.approx(
        100 * costs.rerank_bound(20 * 7 * 201, 600).seconds / t_rerank)
    none = dict(ctx, profile={"kernels": {n: kernels[n]
                                          for n in OTHER_NAMES}})
    assert merge.read(none) is None
