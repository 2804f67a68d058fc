"""The scan path's per-query candidate lists in stable-id space: the CUDA
kernel's wrapper (csrc/candidate_lists.cu), its launch count and its
plain PyTorch version.

Given each query's union slots sorted ascending (live-row positions, -1
for an empty slot), the slots' ``valid`` flags and the live-row ->
stable-id map, ``candidate_lists`` returns one (B, C + 2) int64 tensor:
row q holds the query's unique live rows as stable ids, left-aligned in
ascending order, -1 after them; column C its count; column C + 1 whether
any of its slots is valid (1 or 0).  ``MultiTableIndex.answer_from_scan``
reads it back with the batch's other answers and takes each list as a
view of it.  It replaces no TPU kernel: the JAX package builds the lists
on the host.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

LIBRARY = "candidate_lists"
_SIGNATURES = {
    "cand_lists_launch": (ctypes.c_int, [ctypes.c_void_p] * 4
                          + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]),
    "cand_lists_plan": (ctypes.c_int, [ctypes.c_int, ctypes.c_int,
                                       ctypes.c_void_p]),
}


def candidate_lists_plain(flat: torch.Tensor, valid: torch.Tensor,
                          id_map: torch.Tensor) -> torch.Tensor:
    """Plain version: the kept slots by a cumulative sum, put in place by
    a scatter."""
    b, c = flat.shape
    keep = flat >= 0
    keep[:, 1:] &= flat[:, 1:] != flat[:, :-1]
    out = torch.full((b, c + 2), -1, dtype=torch.int64, device=flat.device)
    # a dropped slot goes to column c, which the count overwrites
    dest = torch.where(keep, torch.cumsum(keep, dim=1) - 1, c)
    ids = torch.where(keep, id_map[torch.clamp(flat, min=0).long()], -1)
    out.scatter_(1, dest, ids)
    out[:, c] = keep.sum(dim=1)
    out[:, c + 1] = valid.any(dim=1).long()
    return out


def candidate_lists(flat: torch.Tensor, valid: torch.Tensor,
                    id_map: torch.Tensor) -> torch.Tensor:
    """(B, C + 2) int64 lists for sorted int32 slots flat (B, C), bool
    valid (B, C) and the int64 id_map (n_live,), contiguous on one device.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (one launch, counted in ``candidate_lists.launches``) or raises.
    """
    if flat.device.type == "cpu":
        return candidate_lists_plain(flat, valid, id_map)
    if flat.device.type != "cuda":
        raise ValueError(f"unsupported device {flat.device}")
    if flat.dim() != 2:
        raise ValueError(f"flat must be (B, C), got {tuple(flat.shape)}")
    b, c = flat.shape
    for name, t, dtype, shape in (
            ("flat", flat, torch.int32, (b, c)),
            ("valid", valid, torch.bool, (b, c)),
            ("id_map", id_map, torch.int64, tuple(id_map.shape[:1]))):
        if (t.device != flat.device or t.dtype != dtype
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous {dtype} tensor of "
                             f"shape {shape} on {flat.device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if b == 0 or c == 0:        # no slots: empty lists, count 0, flag 0
        out = torch.full((b, c + 2), -1, dtype=torch.int64,
                         device=flat.device)
        out[:, c:] = 0
        return out
    out = torch.empty((b, c + 2), dtype=torch.int64, device=flat.device)
    lib = _build.load(LIBRARY, _SIGNATURES)
    with torch.cuda.device(flat.device):
        err = lib.cand_lists_launch(
            flat.data_ptr(), valid.data_ptr(), id_map.data_ptr(),
            out.data_ptr(), b, c,
            torch.cuda.current_stream(flat.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"candidate_lists launch failed: CUDA error {err}")
    _build.count(candidate_lists)
    return out


candidate_lists.launches = 0
