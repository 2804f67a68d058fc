"""Logical-axis -> mesh-axis rules: the JAX package's partitioning of the
model zoo, as tables the dry-run's account reads.

Parallelism map (the reference's, src/repro/sharding/rules.py):
  DP   : batch over ("pod", "data")
  FSDP : the params' `embed`/`expert_embed` logical axes over "data"
  TP   : `ffn` / `heads` / `kv` / `vocab` / `rnn` over "model"
  EP   : `experts` over "model" (deepseek-v3 overrides to ("data", "model"):
         pure EP over the whole mesh)
  SP   : sequence over "data" for small-batch long-context cells

The port runs no GSPMD program over a mesh, so a mesh here is a
``MeshShape`` (axis names and sizes, no devices) and a partition spec is a
tuple with one entry per dimension: a mesh-axis name, a tuple of names, or
None (replicated), trailing Nones trimmed as ``spec_for`` trims them.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.configs.base import ArchConfig
from repro_torch.models.layers import is_spec

DEFAULT_PARAM_RULES: dict[str, tuple[str, ...]] = {
    "embed": ("data",),          # FSDP
    "expert_embed": ("data",),
    "ffn": ("model",),
    "heads": ("model",),
    "kv": ("model",),
    "vocab": ("model",),
    "experts": ("model",),
    "rnn": ("model",),
    "rnn_blocks": ("model",),
    "lora": (),
    "embed2": (),
    "null": (),
    "layers": (),
}

ARCH_RULE_OVERRIDES: dict[str, dict[str, tuple[str, ...]]] = {
    # 256 experts x (3 matmuls x 7168 x 2048) dominate the 671B params:
    # shard experts over the whole mesh, keep their embed dim unsharded
    # (the contraction dim of the expert matmuls)
    "deepseek-v3-671b": {"experts": ("data", "model"), "expert_embed": ()},
    # kv dim (kv_heads * head_dim = 256) is far below the 16-way model
    # axis: the small kv projections stay replicated
    "qwen2.5-3b": {"kv": ()},
    "qwen2-vl-7b": {"kv": ()},
    "recurrentgemma-2b": {"kv": ()},   # kv = 1 head
}


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A device-free mesh: axis names and their sizes.  ``shape`` maps a
    name to its size, as ``jax.sharding.Mesh.shape`` does."""
    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"axes {self.axis_names} and sizes {self.sizes} "
                             f"differ in length")

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        """The number of devices."""
        return math.prod(self.sizes)


def param_rules(cfg: ArchConfig) -> dict[str, tuple[str, ...]]:
    rules = dict(DEFAULT_PARAM_RULES)
    rules.update(ARCH_RULE_OVERRIDES.get(cfg.name, {}))
    return rules


def _filter_axes(axes: tuple[str, ...], mesh: MeshShape) -> tuple[str, ...]:
    return tuple(a for a in axes if a in mesh.axis_names)


def spec_for(axes: tuple[str, ...], rules, mesh: MeshShape, shape) -> tuple:
    """Partition spec of one param: logical axes -> mesh axes, dropping
    assignments that do not divide the dim (replicated instead)."""
    used: set[str] = set()
    out = []
    for dim, ax in zip(shape, axes):
        mesh_axes = _filter_axes(rules.get(ax, ()), mesh)
        mesh_axes = tuple(a for a in mesh_axes if a not in used)
        size = math.prod(mesh.shape[a] for a in mesh_axes)
        if mesh_axes and dim % size == 0:
            out.append(mesh_axes if len(mesh_axes) > 1 else mesh_axes[0])
            used.update(mesh_axes)
        else:
            out.append(None)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _map2(fn, spec_tree, tree):
    if is_spec(spec_tree) or isinstance(spec_tree, tuple):
        return fn(spec_tree, tree)
    if isinstance(spec_tree, dict):
        return {k: _map2(fn, spec_tree[k], tree[k]) for k in sorted(spec_tree)}
    return [_map2(fn, s, t) for s, t in zip(spec_tree, tree, strict=True)]


def param_shardings(logical_tree, rules, mesh: MeshShape, shapes_tree):
    """Tree of partition specs matching the param tree: logical_tree's
    leaves are axis tuples (``models.layers.logical_axes``), shapes_tree's
    anything with a ``.shape``."""
    return _map2(lambda axes, arr: spec_for(axes, rules, mesh, arr.shape),
                 logical_tree, shapes_tree)


def data_axes(mesh: MeshShape) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def batch_spec(mesh: MeshShape, global_batch: int, ndim: int,
               seq_dim: int | None = None, seq_len: int = 0) -> tuple:
    """Spec of a (B, ...) input: batch over (pod, data) when divisible,
    else the sequence over data (SP), else replicated."""
    dp = data_axes(mesh)
    size = math.prod(mesh.shape[a] for a in dp)
    if global_batch % size == 0 and global_batch >= size:
        return tuple([dp if len(dp) > 1 else dp[0]] + [None] * (ndim - 1))
    if seq_dim is not None and "data" in mesh.axis_names \
            and seq_len % mesh.shape["data"] == 0:
        parts: list = [None] * ndim
        parts[seq_dim] = "data"
        return tuple(parts)
    return ()


def shard_count(spec: tuple, mesh: MeshShape) -> int:
    """How many ways a spec splits its tensor: the product of the sizes of
    every mesh axis it names."""
    n = 1
    for part in spec:
        for a in (part if isinstance(part, tuple) else (part,)):
            if a is not None:
                n *= mesh.shape[a]
    return n

