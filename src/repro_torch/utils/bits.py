"""Bit-level helpers shared by the hashing core and the kernels.

Conventions
-----------
- "signs"  : int8 tensors in {-1, +1}, shape (..., k).
- "packed" : int32 tensors carrying uint32 bits, shape (..., W) with
  W = ceil(k / 32); bit j of word w is sign bit (32*w + j) mapped
  +1 -> 1, -1 -> 0.  torch's uint32 lacks ``>>`` and ``+`` on the CPU, so
  the bits travel as int32 and become uint32 only at numpy boundaries,
  through ``.view``.  On int32, ``>>`` is an arithmetic shift: every shift
  below is masked before its bits are used.
"""
from __future__ import annotations

import numpy as np
import torch

WORD = 32


def n_words(k: int) -> int:
    return (k + WORD - 1) // WORD


def _shifts(device) -> torch.Tensor:
    return torch.arange(WORD, dtype=torch.int32, device=device)


def pack_signs(signs: torch.Tensor) -> torch.Tensor:
    """Pack {-1,+1} signs (..., k) into int32 words (..., ceil(k/32)),
    LSB-first, pad bits 0."""
    k = signs.shape[-1]
    w = n_words(k)
    bits = (signs > 0).to(torch.int32)
    pad = w * WORD - k
    if pad:
        bits = torch.nn.functional.pad(bits, (0, pad))
    bits = bits.reshape(bits.shape[:-1] + (w, WORD))
    # distinct powers of two: the int32 sum is the OR, bit 31 included
    # (1 << 31 is INT32_MIN, and no partial sum leaves the int32 range)
    return (bits << _shifts(signs.device)).sum(dim=-1, dtype=torch.int32)


def unpack_signs(packed: torch.Tensor, k: int) -> torch.Tensor:
    """Inverse of pack_signs -> int8 signs (..., k)."""
    w = packed.shape[-1]
    bits = (packed[..., None] >> _shifts(packed.device)) & 1
    bits = bits.reshape(packed.shape[:-1] + (w * WORD,))[..., :k]
    return (bits.to(torch.int8) * 2 - 1)


def popcount_u32(x: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of the uint32 bits held in an int32 tensor.  Each
    arithmetic shift is masked before use; the final byte sum uses shifts
    and adds of non-negative values instead of the wrapping multiply."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F         # four byte counts, each <= 8
    x = x + (x >> 8)
    x = x + (x >> 16)
    return x & 0x3F


def hamming_packed(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamming distance between packed codes; broadcasts leading dims.

    a: (..., W), b: (..., W) -> (...,) int32.
    """
    return popcount_u32(torch.bitwise_xor(a, b)).sum(dim=-1,
                                                     dtype=torch.int32)


def last_word_mask(k: int) -> int:
    """int32 mask of the valid bits in the last packed word (-1 = all)."""
    rem = k - (n_words(k) - 1) * WORD
    return (1 << rem) - 1 if rem < WORD else -1


def flip_packed(packed: torch.Tensor, k: int) -> torch.Tensor:
    """Bitwise NOT restricted to the low k bits (the paper's query-code
    flip); pad bits of the last word stay 0 so distances stay in [0, k]."""
    out = torch.bitwise_not(packed)
    out[..., -1] &= last_word_mask(k)
    return out


def to_numpy_u32(packed: torch.Tensor) -> np.ndarray:
    """int32 bit carrier -> host uint32 array (same bits)."""
    return packed.detach().cpu().contiguous().numpy().view(np.uint32)


def from_numpy_u32(packed: np.ndarray, device="cpu") -> torch.Tensor:
    """Host uint32 (or int32) array -> int32 bit-carrier tensor."""
    arr = np.ascontiguousarray(np.asarray(packed, dtype=np.uint32))
    if not arr.flags.writeable:       # torch tensors may be written to
        arr = arr.copy()
    return torch.from_numpy(arr.view(np.int32)).to(device)


def np_hamming_packed(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """NumPy oracle for tests."""
    x = np.bitwise_xor(a.astype(np.uint32), b.astype(np.uint32))
    return np.unpackbits(x.view(np.uint8), axis=-1).sum(axis=-1).astype(np.int32)
