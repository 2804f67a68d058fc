"""Roofline terms of a dry-run cell against the NVIDIA H100 80GB HBM3's
data-sheet rates (``utils/h100.py``), and the ring model of the parameter
collectives its shardings imply: the counterpart of the JAX package's launch/analysis.py
(TPU v5e constants) and of hlo_stats.py's collective costing.

The floor is a lower bound: ``compute_s`` from the FLOPs split by dtype
(float32 matmuls at the strict-fp32 rate, bf16 on the tensor cores),
``memory_s`` from ``min_bytes`` (what the step cannot avoid moving: in
a train step every parameter, gradient and optimizer moment read once
and written once, since the update rewrites parameters and moments and
the global-norm clip needs every gradient stored before any update,
and the inputs read; in a serving step every parameter, cache and input
read once and the outputs written once), and ``collective_s`` from the
modelled wire bytes.  The eager op-boundary
bytes are reported beside it (``eager_bytes``, ``eager_memory_s``) and
are no floor: a 50 MB L2 lets small eager ops beat HBM.

Ring model, per device, for a group of g devices (hlo_stats._wire_bytes):
  all-reduce          2 (g-1)/g |buf|
  all-gather          (g-1)/g |result|
  reduce-scatter      (g-1) |result|
  all-to-all          (g-1)/g |buf|
  collective-permute  |buf|
A group whose members span HGX nodes (``launch.mesh.NODE_SIZE`` GPUs,
devices numbered in the mesh's row-major order) is costed on InfiniBand,
one inside a node on NVLink.  Only parameter traffic is modelled
(``param_collectives``): a leaf sharded over data axes (FSDP) is
all-gathered over them once per forward (once more in backward under
remat) and its gradient reduce-scattered over them; the gradient of a
leaf replicated over a data axis is all-reduced over those axes.  A
leaf's model-axis (tensor-parallel) and expert-placing shards stay where
they are: tensor and expert parallelism move activations, and activation
collectives are not modelled.
"""
from __future__ import annotations

import math

import numpy as np

from repro_torch.launch.mesh import NODE_SIZE
from repro_torch.sharding.rules import MeshShape, data_axes
from repro_torch.utils.h100 import (FLOP_RATES, FP32_FLOP_S, HBM_BYTES_S,
                                    IB_BYTES_S, NVLINK_BYTES_S)


def wire_bytes(op: str, size: float, g: int) -> float:
    """Per-device interconnect bytes of one collective over g devices;
    size is the result's bytes (the operand's for an all-reduce)."""
    if g <= 1:
        return 0.0
    if op == "all-reduce":
        return 2 * (g - 1) / g * size
    if op == "all-gather":
        return (g - 1) / g * size
    if op == "reduce-scatter":
        return (g - 1) * size
    if op == "all-to-all":
        return (g - 1) / g * size
    if op == "collective-permute":
        return float(size)
    raise ValueError(f"unknown collective {op!r}")


def group_spans_nodes(mesh: MeshShape, axes: tuple[str, ...]) -> bool:
    """Whether a group varying over ``axes`` (the other coordinates fixed)
    holds devices of more than one node."""
    if not axes:
        return False
    names = list(mesh.axis_names)
    ids = np.arange(mesh.size).reshape(mesh.sizes)
    keep = [names.index(a) for a in names if a not in axes]
    ids = ids.transpose(keep + [names.index(a) for a in axes])
    groups = ids.reshape(-1, math.prod(mesh.shape[a] for a in axes))
    return bool((groups // NODE_SIZE != groups[:, :1] // NODE_SIZE).any())


class Collectives:
    """Accumulates modelled collectives: {op[_xnode]: {"count", "bytes",
    "wire_bytes"}} and the NVLink / InfiniBand wire bytes per device."""

    def __init__(self, mesh: MeshShape):
        self.mesh = mesh
        self.summary: dict[str, dict] = {}
        self.nvlink_bytes = 0.0
        self.ib_bytes = 0.0

    def add(self, op: str, size: float, axes: tuple[str, ...],
            times: int = 1) -> None:
        g = math.prod(self.mesh.shape[a] for a in axes)
        if g <= 1 or times <= 0:
            return
        wire = wire_bytes(op, size, g) * times
        cross = group_spans_nodes(self.mesh, axes)
        key = op + ("_xnode" if cross else "")
        s = self.summary.setdefault(key, {"count": 0, "bytes": 0.0,
                                          "wire_bytes": 0.0})
        s["count"] += times
        s["bytes"] += size * times
        s["wire_bytes"] += wire
        if cross:
            self.ib_bytes += wire
        else:
            self.nvlink_bytes += wire


def param_collectives(mesh: MeshShape, leaves, *, train: bool, remat: bool,
                      microbatches: int = 1) -> Collectives:
    """The parameter traffic of one step.  leaves: (full bytes, logical
    axes, spec) per parameter leaf (the gradient in the parameter's
    dtype).  A leaf's data axes (pod, data) in its spec are FSDP axes,
    except on an `experts` dim, where they place experts (EP).  Each
    forward (one per microbatch) all-gathers a leaf over its FSDP axes, a
    remat backward once more; a train step reduce-scatters its gradient
    over them and all-reduces it over the data axes it is replicated on.
    Tensor- and expert-parallel leaves stay sharded: their traffic is
    activations, not modelled."""
    coll = Collectives(mesh)
    gathers = microbatches * ((2 if remat else 1) if train else 1)
    dp = data_axes(mesh)
    for full, axes, spec in leaves:
        fsdp, placed = [], []
        for ax, part in zip(axes, spec):
            named = [a for a in (part if isinstance(part, tuple)
                                 else (part,)) if a is not None]
            placed += named
            if ax != "experts":
                fsdp += [a for a in named if a in dp]
        fsdp = tuple(fsdp)
        shard = full / math.prod(mesh.shape[a] for a in placed)
        kept = shard * math.prod(mesh.shape[a] for a in fsdp)
        coll.add("all-gather", kept, fsdp, gathers)
        if not train:
            continue
        coll.add("reduce-scatter", shard, fsdp)
        coll.add("all-reduce", shard, tuple(a for a in dp if a not in placed))
    return coll


def roofline(flops_by_dtype: dict, min_bytes: float, eager_bytes: float,
             coll: Collectives) -> dict:
    """Roofline terms of one device's share of a step."""
    t_compute = sum(f / FLOP_RATES.get(dt, FP32_FLOP_S)
                    for dt, f in flops_by_dtype.items())
    t_memory = min_bytes / HBM_BYTES_S
    t_coll = coll.nvlink_bytes / NVLINK_BYTES_S + coll.ib_bytes / IB_BYTES_S
    terms = {"compute_s": t_compute, "memory_s": t_memory,
             "collective_s": t_coll, "min_bytes": min_bytes,
             "nvlink_bytes": coll.nvlink_bytes, "ib_bytes": coll.ib_bytes,
             "eager_bytes": eager_bytes,
             "eager_memory_s": eager_bytes / HBM_BYTES_S}
    terms["bound"] = max(("compute", t_compute), ("memory", t_memory),
                         ("collective", t_coll), key=lambda kv: kv[1])[0]
    # overlapped roofline: the step can't be faster than the max term
    terms["step_floor_s"] = max(t_compute, t_memory, t_coll)
    terms["compute_fraction"] = t_compute / (terms["step_floor_s"] or 1.0)
    return terms


def model_flops(n_active_params: float, tokens: float, kind: str) -> float:
    """6 N D for train, 2 N D for inference (decode D = batch tokens)."""
    return (6.0 if kind == "train" else 2.0) * n_active_params * tokens
