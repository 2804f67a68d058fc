"""Device resolution and input conversion shared by the port's entry
points."""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device="cuda") -> torch.device:
    """The torch.device an entry point runs on.  A CUDA device that this
    process cannot use raises: the port never carries on on the CPU when the
    card was asked for (pass ``device="cpu"`` for the plain versions)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            f"False; pass device='cpu' to run the plain PyTorch versions")
    return dev


def as_float_tensor(a, device) -> torch.Tensor:
    """numpy array or tensor -> contiguous float32 tensor on ``device``."""
    if not torch.is_tensor(a):
        a = torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))
    return a.to(device=device, dtype=torch.float32).contiguous()
