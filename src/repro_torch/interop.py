"""Carry the JAX package's index state across as numpy arrays.

The port never reads a jax object: callers (the parity tests) take plain
arrays out of a JAX ``MultiTableIndex`` and hand them here.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.functions import BHHash, LBHHash, SeededBHHash
from repro_torch.core.indexer import IndexConfig
from repro_torch.serving.multi_table import MultiTableIndex
from repro_torch.utils.device import resolve_device


def families_from_numpy(specs, device="cuda") -> list:
    """Port hash families from specs ``{"kind": "seeded_bh" | "bh" | "lbh",
    "seed": int (seeded_bh only), "u": (d, k), "v": (d, k)}``.

    A seeded family is rebuilt from its seed by the port's generator (its
    u/v give the shape; the port's values agree with JAX's within a few
    float32 ulp, and the kernel regenerates them from the seed anyway).
    bh / lbh families take u, v as given.
    """
    dev = resolve_device(device)
    out = []
    for spec in specs:
        kind = spec["kind"]
        u = np.array(spec["u"], dtype=np.float32)      # own, writable
        v = np.array(spec["v"], dtype=np.float32)
        if u.ndim != 2 or u.shape != v.shape:
            raise ValueError(f"u and v must be equal (d, k) arrays, got "
                             f"{u.shape} and {v.shape}")
        if kind == "seeded_bh":
            out.append(SeededBHHash.create(int(spec["seed"]), u.shape[0],
                                           u.shape[1], dev))
        elif kind in ("bh", "lbh"):
            cls = BHHash if kind == "bh" else LBHHash
            out.append(cls(torch.from_numpy(u).to(dev),
                           torch.from_numpy(v).to(dev)))
        else:
            raise ValueError(f"unknown family kind {kind!r}")
    return out


def index_from_numpy(config: IndexConfig, families, x, codes, active, ids_np,
                     next_id: int, device="cuda") -> MultiTableIndex:
    """A fitted port ``MultiTableIndex`` holding a JAX index's state.

    families: specs as in ``families_from_numpy``; x: (rows, d) features;
    codes: L per-table (rows, W) uint32 codes; active: (rows,) tombstone
    mask; ids_np: (rows,) row -> stable id; next_id: the id high-water mark.
    """
    index = MultiTableIndex(config, tables=len(codes), device=device)
    return index.restore(families_from_numpy(families, index.device), x,
                         codes, active, ids_np, next_id)
