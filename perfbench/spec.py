"""Find a cell's pieces by name: ``BENCHMARK.json`` at the checkout's root,
and under ``perfbench/`` one file for each configuration
(``configs/<name>.json``), traffic mix (``traffic/<name>.json``), cell
(``workloads/<name>.json``), entry that a cell drives (``entries/<name>.py``,
named by the cell's ``"entry"``) and per-layer metric
(``metrics/<name>.py``).

A new cell, mix, configuration, entry or metric is new files and new
entries in ``BENCHMARK.json``: nothing here names one.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load_benchmark(root: Path) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _json(kind: str, name: str) -> dict:
    path = HERE / kind / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} file for {name!r}: {path}")
    return json.loads(path.read_text())


def config(name: str) -> dict:
    return _json("configs", name)


def traffic(name: str) -> dict:
    return _json("traffic", name)


def cell(bench: dict, name: str) -> dict:
    """The cell's ``BENCHMARK.json`` entry merged over its own file."""
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if len(entries) != 1:
        raise KeyError(f"BENCHMARK.json has no workload {name!r}")
    out = _json("workloads", name)
    for key, value in entries[0].items():
        if key in out and out[key] != value:
            raise ValueError(f"workloads/{name}.json gives {key} = "
                             f"{out[key]!r}, BENCHMARK.json {value!r}")
    out.update(entries[0])
    return out


def _module(kind: str, name: str):
    path = HERE / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind} module for {name!r}: {path}")
    spec = importlib.util.spec_from_file_location(
        f"perfbench_{kind}_{name.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_module(name: str):
    """The reader module of per-layer metric ``name``."""
    return _module("metrics", name)


def entry(name: str):
    """The ``Entry`` class of the entry ``name`` a cell drives."""
    return _module("entries", name).Entry


def _applies(metric: dict, cell_name: str, reported: set | None) -> bool:
    if "workloads" in metric:
        return cell_name in metric["workloads"]
    return reported is None or metric["moves"] in reported


def cell_metrics(bench: dict, cell_name: str) -> tuple[list, list]:
    """(end-to-end metrics, per-layer metrics) that ``cell_name`` reports:
    an entry with a ``workloads`` key where it lists the cell, one without
    it everywhere (a per-layer one wherever its ``moves`` is reported)."""
    e2e = [m for m in bench["end_to_end"] if _applies(m, cell_name, None)]
    names = {m["name"] for m in e2e}
    per = [m for m in bench["per_layer"] if _applies(m, cell_name, names)]
    return e2e, per
