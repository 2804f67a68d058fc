"""One run of one cell: set-up, the measured window, the traced segment,
the check, and the result line.

``run`` returns the result as a dict; ``perfbench/run.py`` is the command
line.  Set-up is everything from the process's start to the window:
imports, CUDA init, loading (or, in a fresh checkout, building) the
kernel libraries into the program's fixed ``build/kernels``, the data and
traffic made on the device from the seed, the index's fit and the warm-up
of the cell's shapes.  With ``trace`` the window is followed by a traced
segment of the same traffic (``profiling.traced``), which the per-layer
readers read; the check covers every phase.
"""
from __future__ import annotations

import os
import sys
import time
from pathlib import Path

from perfbench import check as chk
from perfbench import costs, profiling, spec

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class RunError(RuntimeError):
    """The run cannot give a result (no card, a failed phase, a module
    that must not load)."""


def process_start_s() -> float:
    """Seconds since this process started, from /proc where it has it."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        with open("/proc/uptime") as f:
            return max(0.0, float(f.read().split()[0]) - start)
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T_IMPORT


_T_IMPORT = time.perf_counter()


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one the run may not load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _log(line: str) -> None:
    print(line, file=sys.stderr, flush=True)


def _device_info(torch, device, chips: int) -> dict:
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": chips,
                "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}
    return {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": 0}


def run(root, cell_name: str, seed: int, seconds: float, trace: bool, *,
        require_cuda: bool = True, device: str = "cuda", size=None,
        log=_log) -> dict:
    """One run of ``cell_name``.  ``require_cuda=False``, ``device="cpu"``
    and ``size`` (tests only) run it on the CPU, with numbers of the
    configuration's data, the mix and the cell's check overridden at a
    size a CPU holds.  Raises RunError where the run may give no result."""
    root = Path(root)
    bench = spec.load_benchmark(root)
    cell = spec.cell(bench, cell_name)
    cfg = spec.config(cell["config"])
    mix = spec.traffic(cell["traffic"])
    if size:
        cfg["data"].update(size.get("data", {}))
        mix.update(size.get("traffic", {}))
        cell["check"].update(size.get("check", {}))
    e2e, per_layer = spec.cell_metrics(bench, cell_name)
    import torch
    if require_cuda:
        if not torch.cuda.is_available():
            raise RunError("torch.cuda.is_available() is False")
        if torch.cuda.device_count() < int(cell["chips"]):
            raise RunError(f"{torch.cuda.device_count()} CUDA devices, the "
                           f"cell asks for {cell['chips']}")
    dev = torch.device(device)
    src = root / "src"
    if not (src / "repro_torch").is_dir():
        raise RunError(f"no program under {src}")
    sys.path.insert(0, str(src))
    t = time.perf_counter()
    if dev.type == "cuda":
        from repro_torch.kernels import ops
        ops.load_libraries()
        torch.cuda.reset_peak_memory_stats()
    build_s = time.perf_counter() - t
    entry = spec.entry(cell["entry"])(cfg, mix, cell, seed, dev)
    setup_s = process_start_s()
    log(f"set-up {setup_s:.3f} s (kernel libraries loaded or built in "
        f"{build_s:.3f} s)")

    entry.phase("window", seconds)
    reduced, tries = None, 0
    if trace:
        def segment():
            return entry.phase("traced", float(cell["trace_seconds"]))
        try:
            _, reduced, tries = profiling.traced(segment, log)
        except profiling.EmptyProfile as e:
            raise RunError(str(e)) from e
        log(f"profiler tries: {tries}")
    device_info = _device_info(torch, dev, int(cell["chips"]))
    ctx = entry.context()
    ctx.update(profile=reduced, costs=costs)
    values = dict(entry.end_to_end(), setup_s=setup_s)
    entry.release()

    t = time.perf_counter()
    numbers = entry.check()
    correct, checks = chk.verdict(numbers, cell["limits"])
    check_s = time.perf_counter() - t
    attempted, failed = entry.counts(numbers)

    metrics = {}
    if not trace:
        for m in e2e:
            if m["name"] not in values:
                raise RunError(f"the entry reports no {m['name']}")
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        for m in per_layer:
            v = spec.metric_module(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device_info.update(busy_s=reduced["busy_s"],
                           window_s=reduced["window_s"])
    out = {"correct": bool(correct), "attempted": attempted,
           "failed": failed, "metrics": metrics, "device": device_info}
    if trace:
        out["breakdown"] = {"device_ops": profiling.top_ops(
            reduced["kernels"]), "idle_gaps": reduced["idle_gaps"]}
        out["profiler_tries"] = tries
    out["checks"] = checks
    log(f"check {check_s:.3f} s")
    return out

