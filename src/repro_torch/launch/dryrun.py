"""Dry-run accounting of every (arch x shape) cell on the production
meshes, without a device: the counterpart of the JAX package's
launch/dryrun.py, which lowers and compiles each cell on a 512-device
host mesh.

The port's step for a cell (``train.step.make_train_step`` with remat and
the arch's training overrides, ``serve.engine.make_prefill_step`` or
``make_serve_step``) runs on the meta device under
``launch.op_stats.OpCounter``: FLOPs by dtype, op-boundary bytes,
launches and the transient peak of live bytes, globally.  Parameters,
gradients, optimizer moments, caches and inputs are counted per device
exactly, from the reference's shardings (``sharding.rules``,
``launch.specs``) over the mesh; FLOPs and the transient bytes are the
global count divided by the devices (``"split": "ideal"``).
``launch.analysis`` turns the per-device account into roofline terms at
the NVIDIA H100 80GB HBM3's data-sheet rates.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both    (64 records)

Records go to ``--out-dir`` (default experiments/dryrun_torch), one JSON
per (arch, shape, mesh).  Meta tensors hold no device state, so every
cell runs in this process.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
import traceback

import torch

from repro_torch.configs.base import SHAPES, ArchConfig, ShapeConfig, cells_for
from repro_torch.configs.registry import ARCHS, get_arch
from repro_torch.launch import analysis
from repro_torch.launch import specs as S
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.op_stats import OpCounter
from repro_torch.models.layers import abstract_params, logical_axes, tree_map
from repro_torch.models.transformer import Transformer, model_spec
from repro_torch.optim.adamw import (AdamWConfig, _up_to, init_opt_state,
                                     tree_leaves)
from repro_torch.serve.engine import make_prefill_step, make_serve_step
from repro_torch.sharding.rules import (MeshShape, batch_spec, param_rules,
                                        param_shardings, shard_count)
from repro_torch.train.step import make_train_step
from repro_torch.utils import h100

# per-arch training knobs (activation memory / optimizer-state pressure),
# the reference's
TRAIN_OVERRIDES = {
    "deepseek-v3-671b": dict(num_microbatches=8, moment_dtype="int8",
                             accum_dtype="bfloat16"),
    "deepseek-moe-16b": dict(num_microbatches=2),
    "minitron-8b": dict(num_microbatches=2),
}
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
ONE_DEVICE = MeshShape(("data", "model"), (1, 1))


def count_params(cfg: ArchConfig):
    """(total, active) parameters: an expert leaf counts
    experts_per_token / num_experts of itself as active."""
    leaves = []
    tree_map(leaves.append, model_spec(cfg))
    total = active = 0.0
    for s in leaves:
        n = float(math.prod(s.shape))
        total += n
        if "experts" in s.axes:
            active += n * cfg.experts_per_token / max(cfg.num_experts, 1)
        else:
            active += n
    return total, active


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _leaf_specs(tree, specs) -> list:
    """(leaf, spec) pairs of a tensor tree and its tree of specs."""
    return list(zip(tree_leaves(tree), _up_to(tree, specs), strict=True))


def _per_device(pairs, mesh: MeshShape) -> float:
    return sum(_nbytes(t) / shard_count(s, mesh) for t, s in pairs)


def _moment_pairs(moments, params, p_specs) -> list:
    """(tensor, spec) of the optimizer moments: a float moment takes its
    parameter's spec; int8 codes take it too and the last-dim-blocked
    scales it minus the last dim (the reference's ``_opt_shardings``)."""
    out = []
    for m, spec in zip(_up_to(params, moments), _up_to(params, p_specs),
                       strict=True):
        if isinstance(m, (list, tuple)):      # int8: [codes, scales]
            codes, scales = m
            out.append((codes, spec[:codes.ndim]))
            out.append((scales, spec[:max(codes.ndim - 1, 0)]))
        else:
            out.append((m, spec))
    return out


def count_step(cfg: ArchConfig, shape: ShapeConfig, *, dtype=None,
               opt_cfg: AdamWConfig | None = None, remat: bool = True,
               num_microbatches: int | None = None) -> dict:
    """Build cfg on the meta device and run one step of shape's kind
    under an ``OpCounter``.  Returns the global counts and the tensors the
    per-device account needs (parameters, optimizer state, inputs,
    caches).  A train step takes the arch's ``TRAIN_OVERRIDES`` unless
    opt_cfg / num_microbatches are given; dtype defaults to the config's
    (the reference's dry-run)."""
    dtype = dtype or S.act_dtype(cfg)
    spec = model_spec(cfg)
    t0 = time.perf_counter()
    params = abstract_params(spec, dtype)
    out: dict = {"params": params, "opt_state": None, "caches": None,
                 "microbatches": 1, "remat": False}
    if shape.kind == "train":
        kw = dict(TRAIN_OVERRIDES.get(cfg.name, {}))
        moments = kw.pop("moment_dtype", "float32")
        opt_cfg = opt_cfg or AdamWConfig(moment_dtype=moments)
        accum = _DTYPES[kw.pop("accum_dtype", "float32")]
        nmb = num_microbatches or kw.pop("num_microbatches", 1)
        model = Transformer(cfg, params, trainable=True)
        state = init_opt_state(model.tree(), opt_cfg)
        batch = S.train_inputs(cfg, shape)
        step = make_train_step(cfg, opt_cfg, num_microbatches=nmb,
                               remat=remat, accum_dtype=accum)
        out.update(opt_state=state, inputs=batch, microbatches=nmb,
                   remat=remat, grad_dtype=accum if nmb > 1 else dtype)
        run = lambda: step(model, state, batch)          # noqa: E731
    elif shape.kind == "prefill":
        model = Transformer(cfg, params)
        inputs = S.prefill_inputs(cfg, shape)
        step = make_prefill_step(cfg, cache_len=shape.seq_len)
        out.update(inputs=inputs)
        run = lambda: step(model, inputs)                # noqa: E731
    else:
        model = Transformer(cfg, params)
        caches = S.cache_abstract(cfg, shape.global_batch, shape.seq_len,
                                  dtype)
        inp, _ = S.decode_inputs(cfg, shape, dtype)
        step = make_serve_step(cfg)
        out.update(inputs={"inputs": inp}, caches=caches)
        run = lambda: step(model, caches, inp, shape.seq_len - 1)  # noqa
    out["build_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with OpCounter("meta") as counter:
        result = run()
    out["count_s"] = time.perf_counter() - t0
    if shape.kind == "prefill":
        out["outputs"], out["caches"] = result
    elif shape.kind == "decode":
        out["outputs"] = result[0]           # the next tokens
    del result
    out.update(flops_by_dtype=dict(counter.flops_by_dtype),
               eager_bytes=counter.eager_bytes, launches=counter.launches,
               ops=counter.ops, transient_peak=counter.peak_bytes,
               top_buffers=counter.top_buffers())
    return out


def build_cell(arch: str, shape_name: str, multi_pod: bool,
               counts: dict | None = None) -> dict:
    """The account of one cell on one production mesh (the counterpart
    of the reference's ``build_lowered``): ``account`` of the step's
    global counts (``count_step``, unless given)."""
    cfg = get_arch(arch)
    shape = SHAPES[shape_name]
    return account(cfg, shape, make_production_mesh(multi_pod=multi_pod),
                   counts if counts is not None else count_step(cfg, shape))


def account(cfg: ArchConfig, shape: ShapeConfig, mesh: MeshShape,
            c: dict) -> dict:
    """The per-device account of a step's counts c (``count_step``) over
    mesh: every parameter, gradient, moment, cache and input from its
    sharding, the step's transient split ideally, the parameter
    collectives and the roofline terms."""
    spec = model_spec(cfg)
    rules = param_rules(cfg)
    p_specs = param_shardings(logical_axes(spec), rules, mesh, c["params"])
    p_pairs = _leaf_specs(c["params"], p_specs)
    params_b = _per_device(p_pairs, mesh)
    train = shape.kind == "train"
    if train:
        g_item = torch.empty((), dtype=c["grad_dtype"]).element_size()
        grads_b = sum(t.numel() * g_item / shard_count(s, mesh)
                      for t, s in p_pairs)
        opt_b = _per_device(
            _moment_pairs(c["opt_state"]["m"], c["params"], p_specs)
            + _moment_pairs(c["opt_state"]["v"], c["params"], p_specs),
            mesh)
        in_specs = S.train_input_shardings(mesh, cfg, shape)
    else:
        grads_b = opt_b = 0.0
        in_specs = {k: v for k, v in S.train_input_shardings(
            mesh, cfg, shape).items() if k in c["inputs"]}
        if shape.kind == "decode":
            inp = c["inputs"]["inputs"]
            in_specs = {"inputs": batch_spec(mesh, shape.global_batch,
                                             inp.ndim)}
    inputs_b = _per_device([(c["inputs"][k], in_specs[k])
                            for k in c["inputs"]], mesh)
    caches_b = 0.0
    if c["caches"] is not None:
        c_specs = S.cache_shardings(mesh, c["caches"], shape.global_batch)
        caches_b = _per_device(_leaf_specs(c["caches"], c_specs), mesh)
    outputs_b = 0.0
    if shape.kind == "prefill":
        outputs_b = _per_device([(c["outputs"], S.logits_sharding(
            mesh, cfg, shape.global_batch))], mesh)
    elif shape.kind == "decode":
        outputs_b = _per_device([(c["outputs"], batch_spec(
            mesh, shape.global_batch, 1))], mesh)

    n_dev = mesh.size
    # the step's own allocations that are counted exactly (gradients, a
    # prefill's caches, the logits), assumed live at the transient peak;
    # the rest of the transient splits ideally
    created_global = 0.0
    created_b = grads_b
    if train:
        created_global = sum(t.numel() * g_item for t, _ in p_pairs)
    elif shape.kind == "prefill":
        created_global = sum(map(_nbytes, tree_leaves(c["caches"])))
        created_global += _nbytes(c["outputs"])
        created_b = caches_b + outputs_b
    else:
        created_global = _nbytes(c["outputs"])
        created_b = outputs_b
    rest = max(c["transient_peak"] - created_global, 0) / n_dev
    resident = params_b + opt_b + inputs_b + (
        caches_b if shape.kind == "decode" else 0.0)
    memory = {"params_bytes": params_b, "grads_bytes": grads_b,
              "opt_state_bytes": opt_b, "inputs_bytes": inputs_b,
              "caches_bytes": caches_b, "outputs_bytes": outputs_b,
              "transient_bytes": rest,
              "peak_bytes": resident + created_b + rest}

    # what the step cannot avoid moving, per device
    if train:
        min_bytes = 2 * (params_b + grads_b + opt_b) + inputs_b
    else:
        min_bytes = params_b + inputs_b + caches_b + outputs_b
    axes = _up_to(c["params"], logical_axes(spec))
    coll = analysis.param_collectives(
        mesh, [(_nbytes(t), a, s) for (t, s), a in zip(p_pairs, axes,
                                                       strict=True)],
        train=train, remat=c["remat"], microbatches=c["microbatches"])
    flops_dev = {k: v / n_dev for k, v in c["flops_by_dtype"].items()}
    terms = analysis.roofline(flops_dev, min_bytes, c["eager_bytes"] / n_dev,
                              coll)
    return {"cfg": cfg, "shape": shape, "mesh": mesh, "counts": c,
            "memory": memory, "roofline": terms,
            "collectives": coll.summary, "min_bytes": min_bytes}


def one_device_record(cfg: ArchConfig, shape: ShapeConfig, **kw) -> dict:
    """The record of cfg's step at shape on one card: ``count_step(cfg,
    shape, **kw)`` accounted on a 1 x 1 mesh.  Its roofline's
    ``step_floor_s`` is the step's floor, the one yardstick of a step's
    bound (``chip_smoke.py`` prints it beside each measured step)."""
    return record(account(cfg, shape, ONE_DEVICE,
                          count_step(cfg, shape, **kw)))


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_path: str | None = None, counts: dict | None = None) -> dict:
    """The record of one cell (``record``), printed, and written to
    out_path when given."""
    rec = record(build_cell(arch, shape_name, multi_pod, counts))
    r, mem = rec["roofline"], rec["memory"]
    print(f"[dryrun] {arch} {shape_name} mesh={rec['mesh']} "
          f"count={rec['count_s']:.1f}s "
          f"flops/dev={rec['flops_per_device']:.3e} "
          f"min_bytes/dev={r['min_bytes']:.3e} launches={rec['launches']} "
          f"peak={mem['peak_bytes'] / 2**30:.2f}GiB "
          f"floor={r['step_floor_s']:.4g}s bound={r['bound']} "
          f"fits_80g={rec['fits_80g']}", flush=True)
    if out_path:
        with open(out_path, "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def record(cell: dict) -> dict:
    """A cell's record: the reference's keys (flops_per_device,
    bytes_per_device (here min_bytes), memory.peak_bytes, collectives,
    top_buffers, roofline, params_total / active, tokens_per_step,
    model_flops_*, useful_flops_fraction) plus the port's (launches,
    flops_by_dtype, eager_bytes, the global totals, fits_80g)."""
    cfg, shape, mesh, c = cell["cfg"], cell["shape"], cell["mesh"], \
        cell["counts"]
    n_dev = mesh.size
    total, active = count_params(cfg)
    tokens = (shape.global_batch * shape.seq_len
              if shape.kind != "decode" else shape.global_batch)
    flops_total = sum(c["flops_by_dtype"].values())
    multi = "pod" in mesh.axis_names
    rec = {
        "arch": cfg.name, "shape": shape.name,
        "mesh": "multi" if multi else "single",
        "mesh_shape": dict(zip(mesh.axis_names, mesh.sizes)),
        "devices": n_dev, "kind": shape.kind, "card": h100.CARD,
        "split": "ideal", "collectives_modelled": "params",
        "build_s": c["build_s"], "count_s": c["count_s"],
        "flops_per_device": flops_total / n_dev,
        "flops_by_dtype": {k: v / n_dev
                           for k, v in c["flops_by_dtype"].items()},
        "bytes_per_device": cell["min_bytes"],
        "eager_bytes": c["eager_bytes"] / n_dev,
        "launches": c["launches"],
        "memory": cell["memory"],
        "collectives": cell["collectives"],
        "top_buffers": c["top_buffers"],
        "roofline": cell["roofline"],
        "global": {"flops": flops_total,
                   "flops_by_dtype": c["flops_by_dtype"],
                   "eager_bytes": c["eager_bytes"],
                   "transient_peak_bytes": c["transient_peak"],
                   "ops": c["ops"]},
        "fits_80g": cell["memory"]["peak_bytes"] <= h100.HBM_CAPACITY,
        "params_total": total, "params_active": active,
        "tokens_per_step": tokens,
        "model_flops_total": analysis.model_flops(active, tokens, shape.kind),
    }
    rec["model_flops_per_device"] = rec["model_flops_total"] / n_dev
    if rec["flops_per_device"]:
        rec["useful_flops_fraction"] = (rec["model_flops_per_device"]
                                        / rec["flops_per_device"])
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out-dir", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)

    os.makedirs(args.out_dir, exist_ok=True)
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        cells = [(name, s.name) for name, cfg in ARCHS.items()
                 if args.arch in (None, name) for s in cells_for(cfg)]
    else:
        if not (args.arch and args.shape):
            ap.error("give --arch and --shape, or --all")
        cells = [(args.arch, args.shape)]
    failures = []
    for name, shape_name in cells:
        try:
            counts = count_step(get_arch(name), SHAPES[shape_name])
            for m in meshes:
                out = os.path.join(args.out_dir,
                                   f"{name}_{shape_name}_{m}.json")
                run_cell(name, shape_name, m == "multi", out, counts)
        except Exception as e:     # the other cells still run; exit 1
            failures.append((name, shape_name, f"{type(e).__name__}: {e}"))
            print(f"[FAIL] {name} {shape_name}:", flush=True)
            traceback.print_exc()
    print(f"\n[dryrun] {len(cells) * len(meshes) - len(failures) * len(meshes)}"
          f" records; {len(failures)} failed cells: {failures}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
