"""Carry the JAX package's index state and model weights across as numpy
arrays.

The port never reads a jax object: callers (the parity tests) take plain
arrays out of a JAX ``MultiTableIndex``, ``HyperplaneIndex`` or parameter
tree and hand them here.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.checkpoint.manager import from_numpy, to_numpy
from repro_torch.core import functions as F
from repro_torch.core.indexer import HyperplaneIndex, IndexConfig
from repro_torch.models.layers import tree_map
from repro_torch.models.transformer import Transformer
from repro_torch.serving.multi_table import MultiTableIndex
from repro_torch.utils.device import resolve_device

_UV_KINDS = {"bh": F.BHHash, "lbh": F.LBHHash, "ah": F.AHHash}


def families_from_numpy(specs, device="cuda") -> list:
    """Port hash families from specs, one dict each:

    - ``{"kind": "seeded_bh", "seed": int, "u": (d, k), "v": (d, k)}``;
    - ``{"kind": "bh" | "lbh" | "ah", "u": (d, k'), "v": (d, k')}``
      (AH: k' = k/2 bit pairs);
    - ``{"kind": "eh", "mats": (k, d', d'), "dims": (d',) or None}``.

    A seeded family is rebuilt from its seed by the port's generator (its
    u/v give the shape; the port's values agree with JAX's within a few
    float32 ulp, and the kernel regenerates them from the seed anyway).
    The other kinds take their arrays as given.
    """
    dev = resolve_device(device)
    out = []
    for spec in specs:
        kind = spec["kind"]
        if kind == "eh":
            mats = np.array(spec["mats"], dtype=np.float32)
            if mats.ndim != 3 or mats.shape[1] != mats.shape[2]:
                raise ValueError(f"mats must be a (k, d, d) array, got "
                                 f"{mats.shape}")
            dims = spec.get("dims")
            out.append(F.EHHash(
                torch.from_numpy(mats).to(dev),
                None if dims is None else torch.from_numpy(
                    np.array(dims, dtype=np.int64)).to(dev)))
            continue
        u = np.array(spec["u"], dtype=np.float32)      # own, writable
        v = np.array(spec["v"], dtype=np.float32)
        if u.ndim != 2 or u.shape != v.shape:
            raise ValueError(f"u and v must be equal (d, k) arrays, got "
                             f"{u.shape} and {v.shape}")
        if kind == "seeded_bh":
            out.append(F.SeededBHHash.create(int(spec["seed"]), u.shape[0],
                                             u.shape[1], dev))
        elif kind in _UV_KINDS:
            out.append(_UV_KINDS[kind](torch.from_numpy(u).to(dev),
                                       torch.from_numpy(v).to(dev)))
        else:
            raise ValueError(f"unknown family kind {kind!r}")
    return out


def index_from_numpy(config: IndexConfig, families, x, codes, active, ids_np,
                     next_id: int, device="cuda",
                     cls=MultiTableIndex) -> MultiTableIndex:
    """A fitted port index holding a JAX index's state.

    families: specs as in ``families_from_numpy``; x: (rows, d) features;
    codes: L per-table (rows, W) uint32 codes; active: (rows,) tombstone
    mask; ids_np: (rows,) row -> stable id; next_id: the id high-water mark.
    cls: the index class to build, ``MultiTableIndex`` or
    ``serving.lsm.LSMMultiTableIndex`` (which takes the rows as its base
    segment).
    """
    index = cls(config, tables=len(codes), device=device)
    return index.restore(families_from_numpy(families, index.device), x,
                         codes, active, ids_np, next_id)


def hyperplane_index_from_numpy(config: IndexConfig, family, x, codes,
                                device="cuda") -> HyperplaneIndex:
    """A fitted port ``HyperplaneIndex`` holding a JAX index's state.

    family: one spec as in ``families_from_numpy``; x: (n, d) features;
    codes: (n, W) uint32 packed codes.
    """
    index = HyperplaneIndex(config, device=device)
    (fam,) = families_from_numpy([family], index.device)
    return index.restore(fam, x, codes)


def params_from_numpy(cfg, tree, *, device="cuda",
                      dtype=torch.float32) -> Transformer:
    """The port's ``Transformer`` holding a JAX parameter tree.

    tree: ``jax.tree.map(np.asarray, init_params(key, model_spec(cfg),
    dtype))``, the body stacked; it is taken apart into one block per
    layer.  Every leaf must have its spec's shape and be used exactly once
    (``transformer.match_tree``).
    """
    dev = resolve_device(device)
    tensors = tree_map(
        lambda a: torch.from_numpy(np.array(a, dtype=np.float32)), tree)
    return Transformer(cfg, tensors, dtype=dtype, device=dev)


def params_to_numpy(cfg, model: Transformer) -> dict:
    """The inverse of ``params_from_numpy``: the model's parameters as a
    JAX-layout tree of float32 numpy arrays (``model_spec``'s structure,
    the body restacked: ``Transformer.tree``)."""
    if cfg != model.cfg:
        raise ValueError(f"config {cfg.name!r} does not match the model's")
    return tree_map(lambda t: t.detach().to("cpu", torch.float32).numpy()
                    .copy(), model.tree())


def opt_state_to_numpy(state) -> dict:
    """An ``optim.adamw`` state as the JAX package's tree of numpy arrays:
    {"step": int32 scalar, "m": tree, "v": tree}; a bfloat16 moment as
    its bytes (a ``V2`` array, the reference's file format; view it as
    ml_dtypes.bfloat16), an int8 moment as a (codes, scales) tuple."""
    def conv(x):
        if isinstance(x, dict):
            return {k: conv(x[k]) for k in sorted(x)}
        if isinstance(x, (list, tuple)):
            return tuple(conv(t) for t in x)
        return to_numpy(x)
    return {"step": to_numpy(state["step"]),
            "m": conv(state["m"]), "v": conv(state["v"])}


def opt_state_from_numpy(tree, device="cuda") -> dict:
    """The inverse: a JAX ``init_opt_state`` / ``apply_updates`` state as
    numpy arrays (``jax.tree.map(np.asarray, state)``; bfloat16 moments
    as ml_dtypes or ``V2`` arrays) -> the port's state on ``device`` (the
    step counter on the host)."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(x[k]) for k in sorted(x)}
        if isinstance(x, (list, tuple)):
            return [conv(t) for t in x]
        return from_numpy(np.array(x)).to(dev)
    return {"step": from_numpy(np.array(tree["step"], np.int32)),
            "m": conv(tree["m"]), "v": conv(tree["v"])}
