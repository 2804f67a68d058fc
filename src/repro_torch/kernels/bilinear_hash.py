"""Bilinear hash kernels: each CUDA kernel's wrapper, its launch count and
its plain PyTorch version.

codes = pack( sgn((X U) .* (X V)) ), LSB-first, bits past k set to 0.

- ``bilinear_hash`` (csrc/bilinear_hash.cu) hashes with materialised
  (d, k) factors, the learned LBH and drawn BH families; it replaces the
  TPU kernel ``bilinear_hash_kernel`` (src/repro/kernels/bilinear_hash.py:52).
- ``bilinear_hash_seeded`` (csrc/bilinear_hash_seeded.cu) hashes for G
  tables whose U_g / V_g are generated from each table's 32-bit seed; it
  replaces ``bilinear_hash_seeded_kernel`` (same file, :125): it
  generates the factors on the card once per call and reads x once for
  all G tables.

Both run the d-tiled product of ``csrc/bilinear_product.cuh``, whose
shared memory does not depend on d: any d >= 1 and any k >= 1 launch.  At
few rows (a micro-batch of query normals) it takes the chain plan, a lane
per (row, column) over the card; the seeded wrapper counts each launch
that does in the open span's ``hash_chain_plan``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (bilinear_hash_ref,
                                     bilinear_hash_seeded_ref)
from repro_torch.utils import trace
from repro_torch.utils.bits import n_words

LIBRARY = "bilinear_hash_seeded"
_SIGNATURES = {
    "bh_seeded_launch": (ctypes.c_int, [ctypes.c_void_p] * 3
                         + [ctypes.c_int] * 4 + [ctypes.c_void_p]),
    "bh_seeded_plan": (ctypes.c_int, [ctypes.c_int] * 4 + [ctypes.c_void_p]),
}
FACTORS_LIBRARY = "bilinear_hash"
_FACTORS_SIGNATURES = {
    "bh_launch": (ctypes.c_int, [ctypes.c_void_p] * 4
                  + [ctypes.c_int] * 3 + [ctypes.c_void_p]),
    "bh_plan": (ctypes.c_int, [ctypes.c_int] * 3 + [ctypes.c_void_p]),
}
# threads of a tile plan's block (bprod::kThreads); a chain plan's block
# is the fewest warps that hold a row's columns, at most 128 threads
TILE_THREADS = 256


def bilinear_hash_plain(x: torch.Tensor, u: torch.Tensor, v: torch.Tensor):
    """Plain version: strict-fp32 matmuls, sign, pack
    (``ref.bilinear_hash_ref``).  Returns (n, ceil(k/32)) int32."""
    return bilinear_hash_ref(x, u, v)


def bilinear_hash(x: torch.Tensor, u: torch.Tensor,
                  v: torch.Tensor) -> torch.Tensor:
    """Packed bilinear codes from materialised factors: (n, ceil(k/32))
    int32, pad bits past k set to 0.

    x: (n, d), u, v: (d, k), all contiguous float32 on one device.  A CPU
    tensor takes the plain version; a CUDA tensor launches the kernel (and
    counts the launch in ``bilinear_hash.launches``) or raises.
    """
    if x.device.type == "cpu":
        return bilinear_hash_plain(x, u, v)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    if x.dim() != 2 or u.dim() != 2 or u.shape[0] != x.shape[1]:
        raise ValueError(f"need x (n, d) and u, v (d, k), got "
                         f"{tuple(x.shape)} and {tuple(u.shape)}")
    n, d = x.shape
    k = u.shape[1]
    for name, t, shape in (("x", x, (n, d)), ("u", u, (d, k)),
                           ("v", v, (d, k))):
        if (t.device != x.device or t.dtype != torch.float32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 tensor of "
                             f"shape {shape} on {x.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    out = torch.empty((n, n_words(k)), dtype=torch.int32, device=x.device)
    if n == 0 or k == 0:
        return out
    if d == 0:
        raise ValueError("x has no features (d = 0)")
    lib = _build.load(FACTORS_LIBRARY, _FACTORS_SIGNATURES)
    with torch.cuda.device(x.device):
        err = lib.bh_launch(x.data_ptr(), u.data_ptr(), v.data_ptr(),
                            out.data_ptr(), n, d, k,
                            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"bilinear_hash launch failed: CUDA error {err}")
    _build.count(bilinear_hash)
    return out


bilinear_hash.launches = 0


def seeds_as_int32(seeds) -> list[int]:
    """uint32 seeds -> the int32 values with the same bits."""
    out = []
    for s in seeds:
        s = int(s) & 0xFFFFFFFF
        out.append(s - (1 << 32) if s >= 1 << 31 else s)
    return out


# the seed lists already on a card: (device, seeds as int32) -> tensor
_SEEDS_ON_DEVICE: dict = {}
_SEEDS_KEPT = 64


def seeds_on_device(seeds, device) -> torch.Tensor:
    """The (G,) int32 tensor of ``seeds`` on ``device``, copied there once
    per seed list, so a query batch's hash makes no host-to-device copy."""
    key = (device, tuple(seeds_as_int32(seeds)))
    t = _SEEDS_ON_DEVICE.get(key)
    if t is None:
        if len(_SEEDS_ON_DEVICE) >= _SEEDS_KEPT:
            _SEEDS_ON_DEVICE.clear()
        t = torch.tensor(key[1], dtype=torch.int32, device=device)
        _SEEDS_ON_DEVICE[key] = t
    return t


def bilinear_hash_seeded_plain(x: torch.Tensor, seeds, k: int):
    """Plain version: per table, materialise the factors with the torch
    generator, project with strict-fp32 matmuls, sign and pack
    (``ref.bilinear_hash_seeded_ref``).  Returns (G, n, ceil(k/32)) int32
    with pad bits past k set to 0."""
    return torch.stack([bilinear_hash_seeded_ref(x, int(s) & 0xFFFFFFFF, k)
                        for s in seeds])


@functools.lru_cache(maxsize=256)
def takes_chain_plan(device: int, n: int, d: int, k: int, g: int) -> bool:
    """Whether the seeded hash of (n, d) rows, k bits and g tables on card
    ``device`` takes the chain plan, as the library's ``bh_seeded_plan``
    reports it (once per shape)."""
    lib = _build.load(LIBRARY, _SIGNATURES)
    out = (ctypes.c_int64 * 12)()
    with torch.cuda.device(device):
        err = lib.bh_seeded_plan(n, d, k, g, out)
    if err != 0:
        raise RuntimeError(f"bh_seeded_plan failed: CUDA error {err}")
    return out[6 + 3] != TILE_THREADS


def bilinear_hash_seeded(x: torch.Tensor, seeds, k: int) -> torch.Tensor:
    """Packed seeded-BH codes for len(seeds) tables: (G, n, ceil(k/32))
    int32, pad bits past k set to 0.

    x: (n, d) float32, contiguous; seeds: uint32 python ints.  A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel (and counts
    the launch in ``bilinear_hash_seeded.launches``, and one that takes
    the chain plan in the open span's ``hash_chain_plan``) or raises.
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
    if n == 0 or g == 0 or k == 0:
        return out
    if d == 0:
        raise ValueError("x has no features (d = 0)")
    lib = _build.load(LIBRARY, _SIGNATURES)
    with torch.cuda.device(x.device):
        seeds_dev = seeds_on_device(seeds, x.device)
        err = lib.bh_seeded_launch(
            x.data_ptr(), seeds_dev.data_ptr(), out.data_ptr(), n, d, k, g,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"bilinear_hash_seeded launch failed: CUDA error "
                           f"{err}")
    _build.count(bilinear_hash_seeded)
    if takes_chain_plan(x.device.index, n, d, k, g):
        trace.add("hash_chain_plan", 1)
    return out


bilinear_hash_seeded.launches = 0
