"""Rotary position embedding — the port of ``repro.layers.rope``."""
from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float,
               device=None) -> torch.Tensor:
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=device) / head_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, n_heads, head_dim); positions broadcastable to (..., S).
    Rotates the two halves of head_dim (the reference's layout)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    ang = positions[..., None].to(torch.float32) * freqs     # (..., S, hd/2)
    sin = torch.sin(ang)[..., None, :]
    cos = torch.cos(ang)[..., None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


__all__ = ["rope_freqs", "apply_rope"]
