"""Device-dispatching wrappers of the serving path's kernels.

Each wrapper picks its route from where its tensors lie: CUDA tensors go to
the hand-written kernel (it launches or raises), CPU tensors to the plain
PyTorch version.  There is no other switch.  Each wrapper adds one to its
entry of :data:`LAUNCHES` where it launches its kernel, and nowhere else,
so a run can show that it went through the kernels.

  K1 bfp_quantize_kv_pair       <- repro/kernels/bfp_quant.py:252
  K2 convert_prefill_cache      <- repro/kernels/bfp_quant.py:395
  K3 bfp_attention_prefill      <- repro/kernels/bfp_attention.py:321
  K4 bfp_attention_decode_cache <- repro/kernels/bfp_attention.py:828
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core.kvcache import AsymKVCache
from repro_torch.kernels import bfp_attention, bfp_quant

KERNELS = ("bfp_quantize_kv_pair", "convert_prefill_cache",
           "bfp_attention_prefill", "bfp_attention_decode_cache")

# kernel name -> launches since the last reset
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}


def reset_launch_counts() -> None:
    for name in KERNELS:
        LAUNCHES[name] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def _on_card(*tensors: torch.Tensor) -> bool:
    """True for CUDA tensors, False for CPU tensors; anything else, or a
    mix, raises."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cuda"}:
        return True
    if kinds == {"cpu"}:
        return False
    raise ValueError(f"tensors on {sorted(kinds)}: the kernels take CUDA "
                     f"tensors and their plain versions CPU tensors")


def bfp_quantize_kv_pair(k: torch.Tensor, v: torch.Tensor,
                         mantissa_bits: int = 8):
    """K1: (B, S, Hkv, hd) float32 K and V -> (k_mant, k_exp, v_mant,
    v_exp) in the prefill attention kernel's layouts."""
    if _on_card(k, v):
        out = bfp_quant.quantize_kv_pair_cuda(k, v, mantissa_bits)
        LAUNCHES["bfp_quantize_kv_pair"] += 1
        return out
    return bfp_quant.quantize_kv_pair_plain(k, v, mantissa_bits)


def convert_prefill_cache(k: torch.Tensor, v: torch.Tensor,
                          k_offsets: torch.Tensor,
                          s_bulk: int) -> Dict[str, torch.Tensor]:
    """K2: dense prefill K (minus ``k_offsets``) and V -> the 12 packed
    ``AsymKVCache`` regions, keyed by field name."""
    if _on_card(k, v, k_offsets):
        out = bfp_quant.convert_prefill_cache_cuda(k, v, k_offsets, s_bulk)
        LAUNCHES["convert_prefill_cache"] += 1
        return out
    return bfp_quant.convert_prefill_cache_plain(k, v, k_offsets, s_bulk)


def bfp_attention_prefill(q: torch.Tensor, k_mant: torch.Tensor,
                          k_exp: torch.Tensor, v_mant: torch.Tensor,
                          v_exp: torch.Tensor, *, mantissa_bits: int = 8,
                          causal: bool = True, logit_cap: float = 0.0,
                          window: int = 0) -> torch.Tensor:
    """K3: GQA prefill attention on K1's packed K/V -> (B, S, H, hd)."""
    kw = dict(mantissa_bits=mantissa_bits, causal=causal,
              logit_cap=logit_cap, window=window)
    if _on_card(q, k_mant, k_exp, v_mant, v_exp):
        out = bfp_attention.attention_prefill_cuda(q, k_mant, k_exp, v_mant,
                                                   v_exp, **kw)
        LAUNCHES["bfp_attention_prefill"] += 1
        return out
    return bfp_attention.attention_prefill_plain(q, k_mant, k_exp, v_mant,
                                                 v_exp, **kw)


def bfp_attention_decode_cache(q: torch.Tensor, cache: AsymKVCache,
                               start: torch.Tensor | None = None, *,
                               logit_cap: float = 0.0) -> torch.Tensor:
    """K4: one-token GQA decode of q (B, H, hd) over the whole packed
    cache; ``start`` (B,) int32 masks each row's left padding."""
    tensors = [q, *cache.tensors().values()]
    if start is not None:
        tensors.append(start)
    if _on_card(*tensors):
        out = bfp_attention.attention_decode_cache_cuda(
            q, cache, start, logit_cap=logit_cap)
        LAUNCHES["bfp_attention_decode_cache"] += 1
        return out
    return bfp_attention.attention_decode_cache_plain(q, cache, start,
                                                      logit_cap=logit_cap)


__all__ = ["bfp_quantize_kv_pair", "convert_prefill_cache",
           "bfp_attention_prefill", "bfp_attention_decode_cache", "KERNELS",
           "LAUNCHES", "reset_launch_counts", "launch_counts"]
