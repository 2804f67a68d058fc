"""Compressed cross-replica gradient synchronisation (int8 + error
feedback) over the port's single-controller mesh (``utils.mesh``).

Each replica's gradients plus its residual are quantised to int8 blocks
(``adamw.quantize_blockwise``); the codes and their float32 block scales
(~1.02 bytes an element instead of 4) cross to the merge device, which
dequantises, sums and takes the mean.  The quantisation error stays with
the replica as its next residual (error feedback), so the bias telescopes
instead of accumulating.
"""
from __future__ import annotations

import torch

from repro_torch.optim.adamw import (dequantize_blockwise,
                                     quantize_blockwise, tree_leaves,
                                     tree_unflatten)
from repro_torch.utils.mesh import Mesh


def compressed_psum(grads, residuals, mesh: Mesh):
    """grads, residuals: one tree per shard of the one-axis ``mesh``, each
    on its shard's device.  Returns (the mean of the grads, float32 on the
    first shard's device, where the codes are merged; the new residuals,
    one tree per shard on its device)."""
    devices = mesh.devices
    if len(grads) != len(devices) or len(residuals) != len(devices):
        raise ValueError(f"{len(grads)} gradient and {len(residuals)} "
                         f"residual trees for a mesh of {len(devices)}")
    merge = devices[0]
    n = len(devices)
    flat_g = [tree_leaves(g) for g in grads]
    flat_r = [tree_leaves(r) for r in residuals]
    summed, new_r = [], [[] for _ in devices]
    for j in range(len(flat_g[0])):
        total = None
        for k, dev in enumerate(devices):
            g32 = flat_g[k][j].to(dev, torch.float32) + flat_r[k][j]
            q, s = quantize_blockwise(g32)
            new_r[k].append(g32 - dequantize_blockwise(q, s))
            part = dequantize_blockwise(q.to(merge), s.to(merge))
            total = part if total is None else total + part
        summed.append(total / n)
    return (tree_unflatten(grads[0], summed),
            [tree_unflatten(residuals[k], new_r[k]) for k in range(n)])


def init_residuals(params):
    """Zero float32 residuals in params' structure, on its devices."""
    return tree_unflatten(params, [torch.zeros(p.shape, dtype=torch.float32,
                                               device=p.device)
                                   for p in tree_leaves(params)])
