"""Attention on the serving path — the port of the kernel routes of
``repro.layers.attention``.

Prefill (``attention_prefill``, the counterpart of
``attention_prefill_pallas``): Q fake-quantized to BFP per token, fresh K/V
packed by K1, attention by K3.  Decode (``attention_decode``, the
counterpart of ``_decode_packed_pallas_single``): one call of K4 over the
whole packed cache.  Both keep P in float32 inside the kernels, as the
reference's kernel path does, so P is not BFP-quantized here.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import bfp
from repro_torch.core.kvcache import AsymKVCache
from repro_torch.core.quant_config import QuantConfig
from repro_torch.kernels import ops


def _attention_quant(quant: Optional[QuantConfig]) -> bool:
    return quant is not None and quant.enabled and quant.quant_attention


def quant_qk(x: torch.Tensor,
             quant: Optional[QuantConfig]) -> torch.Tensor:
    """BFP fake quantization of Q or K per token along head_dim."""
    if _attention_quant(quant):
        x = bfp.bfp_fake_quant(x, quant.group_size, quant.act_mantissa_bits,
                               quant.rounding, axis=-1)
    return x


def attention_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int = 0,
                      logit_cap: float = 0.0,
                      quant: Optional[QuantConfig] = None) -> torch.Tensor:
    """q: (B, S, H, hd); k, v: (B, S, Hkv, hd) fresh post-RoPE values, S a
    multiple of 32.  Returns (B, S, H, hd) float32."""
    bits = quant.act_mantissa_bits if _attention_quant(quant) else 8
    q = quant_qk(q, quant)
    km, ke, vm, ve = ops.bfp_quantize_kv_pair(
        k.to(torch.float32).contiguous(), v.to(torch.float32).contiguous(),
        bits)
    return ops.bfp_attention_prefill(
        q.to(torch.float32).contiguous(), km, ke, vm, ve,
        mantissa_bits=bits, causal=causal, logit_cap=logit_cap,
        window=window)


def attention_decode(q: torch.Tensor, cache: AsymKVCache, *,
                     logit_cap: float = 0.0,
                     quant: Optional[QuantConfig] = None,
                     pad_prefix: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """q: (B, 1, H, hd) against the packed cache; ``pad_prefix`` (B,) masks
    each row's left padding.  Returns (B, 1, H, hd) float32."""
    B, _, H, hd = q.shape
    q = quant_qk(q, quant).to(torch.float32)
    start = None
    if pad_prefix is not None:
        start = pad_prefix.to(torch.int32).contiguous()
    out = ops.bfp_attention_decode_cache(q[:, 0].contiguous(), cache, start,
                                         logit_cap=logit_cap)
    return out.reshape(B, 1, H, hd)


__all__ = ["quant_qk", "attention_prefill", "attention_decode"]
