"""Online K smoothing (paper Sec. III-C) — the port of
``repro.core.smoothing.compute_online_offsets``.

Softmax is shift-invariant when the same offset vector is subtracted from
every key, so per-channel offsets derived from the first ``window`` tokens
(zero except on the top-k outlier channels, where the offset is half the
signed value at maximum magnitude) are subtracted from all keys before they
are quantized into the cache.
"""
from __future__ import annotations

import torch


def compute_online_offsets(k_window: torch.Tensor,
                           top_k: int = 16) -> torch.Tensor:
    """k_window: (B, W, n_kv, hd) (or (W, hd)) -> offsets (B, n_kv, hd).

    The token axis is reduced away; ties in the argmax and in the top-k
    threshold resolve as in the reference (first index, ``>=``)."""
    token_axis = -3 if k_window.ndim >= 3 else -2
    absk = k_window.abs()
    idx = absk.argmax(dim=token_axis, keepdim=True)
    val_at_max = k_window.gather(token_axis, idx).squeeze(token_axis)
    mag = absk.amax(dim=token_axis)
    k = min(top_k, mag.shape[-1])
    thresh = mag.topk(k, dim=-1).values[..., -1:]
    return torch.where(mag >= thresh, 0.5 * val_at_max,
                       torch.zeros((), dtype=mag.dtype, device=mag.device))


__all__ = ["compute_online_offsets"]
