"""The exact re-rank's margins: the CUDA kernel's wrapper
(csrc/row_margins.cu, kernel 11), its launch count and its plain PyTorch
version.

``row_margins(x, w, rows, valid)`` gives the (B, C) float32 margins
|w_q . x_r| / max(||w_q||, 1e-12) of the candidate rows r = rows[q, c],
+inf where ``valid`` is False.  With ``delta=`` and ``split=`` the row
space is two segments, as the LSM index keeps it: rows < split come from
x, the others from delta at row - split.  Every re-rank of the port
(``core.search.margin_rerank_batch``, ``margin_batch`` and their
segmented forms) takes its margins here, and the sort that follows stays
in ``core.search``.

A margin depends on its row, w and d alone: the kernel sums each row in a
fixed order chosen by d, and the plain version pads the products so that
torch's reduction starts every row aligned (``_row_margins``).  The
kernel replaces no TPU kernel: the JAX package's re-rank is plain jnp
(see the .cu file).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.utils import trace

LIBRARY = "row_margins"
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_SIGNATURES = {
    "row_margins_launch": (_I, [_P, _P, _L, _L, _L, _P, _P, _P, _P,
                                _I, _I, _I, _P]),
    "row_margins_plan": (_I, [_I, _I, _I, _P]),
}

# the products' d axis is zero-padded to a multiple of this many floats
# (32 bytes) before the sum: see _row_margins
_ROW_ALIGN = 8


# -- plain version ------------------------------------------------------------

def _row_margins(cx, w_batch):
    """|w.x| / ||w|| of gathered rows cx (B, C, d) against w_batch (B, d).

    The CUDA sum over a contiguous axis longer than 128 loads it in
    vectors from each row's own alignment, so rows that start at other
    offsets mod 16 bytes (a d * 4-byte row stride that is no multiple of
    16) would sum in other orders: a row's margin would depend on its
    place among the candidates.  Zero-padding d to a multiple of
    ``_ROW_ALIGN`` starts every row aligned; the added terms are +0.0."""
    prod = cx * w_batch[:, None, :]
    pad = -prod.shape[-1] % _ROW_ALIGN
    if pad:
        prod = torch.nn.functional.pad(prod, (0, pad))
    m = torch.abs(torch.sum(prod, dim=-1))
    return m / torch.clamp(torch.linalg.vector_norm(w_batch, dim=1,
                                                    keepdim=True), min=1e-12)


def _segmented_rows(base_x, delta_x, split: int, rows):
    """x[rows] over a row space stored as two segments: rows < split from
    base_x, rows >= split from delta_x at row - split.  Both may carry
    padding rows; out-of-range rows are clamped (their slots are invalid)."""
    cb = base_x[torch.clamp(rows, 0, base_x.shape[0] - 1)]
    cd = delta_x[torch.clamp(rows - split, 0, delta_x.shape[0] - 1)]
    return torch.where((rows < split)[..., None], cb, cd)


def row_margins_plain(x, w, rows, valid, *, delta=None, split=None):
    """Plain version: the rows gathered (an invalid slot's row clamped into
    range), multiplied by w, padded and summed (``_row_margins``), +inf at
    invalid slots."""
    if delta is None:
        cx = x[torch.clamp(rows, 0, x.shape[0] - 1)]
    else:
        cx = _segmented_rows(x, delta, split, rows)
    return torch.where(valid, _row_margins(cx, w), torch.inf)


# -- the kernel ---------------------------------------------------------------

def _check(x, w, rows, valid, delta, split):
    if rows.dim() != 2 or x.dim() != 2:
        raise ValueError(f"rows must be (B, C) and x (n, d), got "
                         f"{tuple(rows.shape)} and {tuple(x.shape)}")
    b, c = rows.shape
    d = x.shape[1]
    want = [("x", x, torch.float32, tuple(x.shape)),
            ("w", w, torch.float32, (b, d)),
            ("rows", rows, torch.int64, (b, c)),
            ("valid", valid, torch.bool, (b, c))]
    if (delta is None) != (split is None):
        raise ValueError("delta and split come together")
    if delta is not None:
        if split < 0:
            raise ValueError(f"split must be >= 0, got {split}")
        want.append(("delta", delta, torch.float32,
                     (delta.shape[0] if delta.dim() == 2 else -1, d)))
    for name, t, dtype, shape in want:
        if (t.device != x.device or t.dtype != dtype or not t.is_contiguous()
                or tuple(t.shape) != shape):
            raise ValueError(f"{name} must be a contiguous {dtype} tensor of "
                             f"shape {shape} on {x.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")


def row_margins(x, w, rows, valid, *, delta=None, split=None):
    """(B, C) float32 margins of the rows rows (B, C) int64 of x (n, d)
    float32 against w (B, d) float32, +inf where valid (B, C) bool is
    False; all contiguous on one device.  delta (m, d) float32 and split:
    rows >= split come from delta at row - split.  An invalid slot's row
    is never read and may be out of range.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel (one launch, counted in ``row_margins.launches`` and in the
    innermost open span's ``row_margins`` count) or raises."""
    _check(x, w, rows, valid, delta, split)
    if x.device.type == "cpu":
        return row_margins_plain(x, w, rows, valid, delta=delta, split=split)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    b, c = rows.shape
    out = torch.empty((b, c), dtype=torch.float32, device=x.device)
    if b == 0 or c == 0:
        return out
    if delta is None:
        delta, split, n_delta = x, x.shape[0], 0
    else:
        n_delta = delta.shape[0]
    lib = _build.load(LIBRARY, _SIGNATURES)
    with torch.cuda.device(x.device):
        err = lib.row_margins_launch(
            x.data_ptr(), delta.data_ptr(), split, x.shape[0], n_delta,
            w.data_ptr(), rows.data_ptr(), valid.data_ptr(), out.data_ptr(),
            b, c, x.shape[1],
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"row_margins launch failed: CUDA error {err}")
    _build.count(row_margins)
    trace.add("row_margins", 1)
    return out


row_margins.launches = 0
