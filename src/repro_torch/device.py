"""Where the port's entry points put their tensors."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU.  Asking for CUDA without a usable card
    raises; the CPU is used only when the caller names it."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain PyTorch versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


__all__ = ["resolve_device"]
