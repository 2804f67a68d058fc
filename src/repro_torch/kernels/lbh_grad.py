"""Fused LBH surrogate-gradient chain (paper eq. 16-18): the CUDA kernel's
wrapper, its launch count and its plain PyTorch version.

Given p = X u, q = X v and the (m, m) residue R, the gradient of
g~(u, v) = -b~^T R b~ (R symmetric) needs

    b = tanh(p*q/2);  s = (R b) * (1 - b^2);  out = (s*q, s*p)

after which grad_u = -X^T (s*q), grad_v = -X^T (s*p).  The kernel
(csrc/lbh_chain.cu) replaces the TPU kernel ``lbh_chain_kernel``
(src/repro/kernels/lbh_grad.py:44): it reads R once and keeps b, R b and s
on chip.

Launch accounting.  ``lbh_chain.launches`` counts the kernel's runs on
the device: one per eager call, and for a CUDA graph, per replay, the
launches captured into it (``core.learning.BitLoop`` adds them).  A call
made while the current stream is capturing records a launch instead of
running one and counts in ``lbh_chain.captured``; a call inside
``warming_up()`` (the eager step that precedes a capture) counts in
``lbh_chain.warmup_launches``.
"""
from __future__ import annotations

import contextlib
import ctypes
import threading

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import lbh_chain_ref

LIBRARY = "lbh_chain"
_SIGNATURES = {
    "lbh_chain_launch": (ctypes.c_int, [ctypes.c_void_p] * 5
                         + [ctypes.c_int, ctypes.c_void_p]),
    "lbh_chain_plan": (ctypes.c_int, [ctypes.c_int, ctypes.c_void_p]),
}


def lbh_chain_plain(p: torch.Tensor, q: torch.Tensor, r: torch.Tensor):
    """Plain version: tanh, a strict-fp32 matvec and the elementwise chain
    (``ref.lbh_chain_ref``).  Returns (s*q, s*p), each (m,) float32."""
    return lbh_chain_ref(p, q, r)


def lbh_chain(p: torch.Tensor, q: torch.Tensor, r: torch.Tensor):
    """(s*q, s*p), each (m,) float32, for p, q (m,) and r (m, m), all
    contiguous float32 on one device.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (and counts the launch: see the module's launch accounting) or raises.
    """
    if p.device.type == "cpu":
        return lbh_chain_plain(p, q, r)
    if p.device.type != "cuda":
        raise ValueError(f"unsupported device {p.device}")
    m = p.shape[0]
    for name, t, shape in (("p", p, (m,)), ("q", q, (m,)), ("r", r, (m, m))):
        if (t.device != p.device or t.dtype != torch.float32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous float32 tensor of "
                             f"shape {shape} on {p.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    sq = torch.empty_like(p)
    sp = torch.empty_like(p)
    if m == 0:
        return sq, sp
    lib = _build.load(LIBRARY, _SIGNATURES)
    with torch.cuda.device(p.device):
        err = lib.lbh_chain_launch(
            p.data_ptr(), q.data_ptr(), r.data_ptr(), sq.data_ptr(),
            sp.data_ptr(), m, torch.cuda.current_stream(p.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"lbh_chain launch failed: CUDA error {err}")
    if torch.cuda.is_current_stream_capturing():
        _build.count(lbh_chain, "captured")
    elif getattr(_warmup, "depth", 0):
        _build.count(lbh_chain, "warmup_launches")
    else:
        _build.count(lbh_chain)
    return sq, sp


lbh_chain.launches = 0          # runs on the device (eager and replayed)
lbh_chain.captured = 0          # launches recorded into CUDA graphs
lbh_chain.warmup_launches = 0   # eager launches that warm up a capture

_warmup = threading.local()


@contextlib.contextmanager
def warming_up():
    """Count this thread's eager chain launches in
    ``lbh_chain.warmup_launches`` instead of ``lbh_chain.launches`` (the
    warm-up before a capture)."""
    _warmup.depth = getattr(_warmup, "depth", 0) + 1
    try:
        yield
    finally:
        _warmup.depth -= 1
