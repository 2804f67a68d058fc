"""Seed-generated bilinear hash: the CUDA kernel's wrapper, its launch
count and its plain PyTorch version.

codes = pack( sgn((X U_g) .* (X V_g)) ) for G tables, U_g / V_g generated
from the table's 32-bit seed.  The kernel (csrc/bilinear_hash_seeded.cu)
replaces the TPU kernel ``bilinear_hash_seeded_kernel``
(src/repro/kernels/bilinear_hash.py:125): it regenerates the factors on
the card and reads x once for all G tables.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import bilinear_hash_seeded_ref
from repro_torch.utils.bits import n_words

LIBRARY = "bilinear_hash_seeded"
_SIGNATURES = {
    "bh_seeded_rows_per_block": (ctypes.c_int, [ctypes.c_int]),
    "bh_seeded_launch": (ctypes.c_int, [ctypes.c_void_p] * 3
                         + [ctypes.c_int] * 4 + [ctypes.c_void_p]),
}


def seeds_as_int32(seeds) -> list[int]:
    """uint32 seeds -> the int32 values with the same bits."""
    out = []
    for s in seeds:
        s = int(s) & 0xFFFFFFFF
        out.append(s - (1 << 32) if s >= 1 << 31 else s)
    return out


def bilinear_hash_seeded_plain(x: torch.Tensor, seeds, k: int):
    """Plain version: per table, materialise the factors with the torch
    generator, project with strict-fp32 matmuls, sign and pack
    (``ref.bilinear_hash_seeded_ref``).  Returns (G, n, ceil(k/32)) int32
    with pad bits past k set to 0."""
    return torch.stack([bilinear_hash_seeded_ref(x, int(s) & 0xFFFFFFFF, k)
                        for s in seeds])


def bilinear_hash_seeded(x: torch.Tensor, seeds, k: int) -> torch.Tensor:
    """Packed seeded-BH codes for len(seeds) tables: (G, n, ceil(k/32))
    int32, pad bits past k set to 0.

    x: (n, d) float32, contiguous; seeds: uint32 python ints.  A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel (and counts
    the launch in ``bilinear_hash_seeded.launches``) or raises.
    """
    if x.device.type == "cpu":
        return bilinear_hash_seeded_plain(x, seeds, k)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError("x must be a contiguous (n, d) float32 tensor, got "
                         f"{x.dtype} {tuple(x.shape)}")
    n, d = x.shape
    g = len(seeds)
    out = torch.empty((g, n, n_words(k)), dtype=torch.int32, device=x.device)
    if n == 0 or g == 0:
        return out
    lib = _build.load(LIBRARY, _SIGNATURES)
    if lib.bh_seeded_rows_per_block(d) == 0:
        raise ValueError(f"d = {d} is too wide for the hash kernel's "
                         f"shared-memory row tile")
    with torch.cuda.device(x.device):
        seeds_dev = torch.tensor(seeds_as_int32(seeds), dtype=torch.int32,
                                 device=x.device)
        err = lib.bh_seeded_launch(
            x.data_ptr(), seeds_dev.data_ptr(), out.data_ptr(), n, d, k, g,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"bilinear_hash_seeded launch failed: CUDA error "
                           f"{err}")
    bilinear_hash_seeded.launches += 1
    return out


bilinear_hash_seeded.launches = 0
