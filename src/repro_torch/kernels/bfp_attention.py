"""BFP attention kernels of the serving path, with their plain versions.

K3 ``attention_prefill`` replaces ``repro.kernels.bfp_attention
.bfp_attention_prefill_batched``: causal GQA attention of fresh queries on
BFP-packed K/V (K1's layouts), dequantized in the tile, with P kept in
float32; optional softcap and sliding window; rows with no valid key give 0.

K4 ``attention_decode_cache`` replaces ``repro.kernels.bfp_attention
.bfp_attention_decode_asym_batched``: one-token GQA decode over the whole
packed ``AsymKVCache`` — the 8-bit init block, the 4-bit bulk, the K ring
(and the <= 32 freshly demoted K tokens below it), the V group ring and the
residual V group re-quantized at its current length — with left-pad
masking per row (``start``) and an optional softcap.

``*_plain`` are the plain PyTorch versions: they dequantize into position
order and take one float32 softmax, so they compute the same function as the
kernels' online softmax, with sums taken in another order.  ``*_cuda``
check their arguments, allocate outputs and scratch, and launch
``csrc/bfp_attention_prefill.cu`` and ``csrc/bfp_attention_decode.cu``.
Callers use the wrappers in ``kernels.ops``.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import bfp
from repro_torch.core.kvcache import (GROUP, INIT_TOKENS, LOCAL_TOKENS,
                                      V_LOCAL_GROUPS, AsymKVCache,
                                      dequantize_k, dequantize_v_groups)
from repro_torch.kernels import _build
from repro_torch.kernels.bfp_quant import _check, region_shapes

NEG_INF = -1e30
# positions of the cache each block of the decode kernel covers (4 warps of
# one 32-token tile each); partial results are merged by a combine pass
DECODE_SPLIT = 128
HEAD_DIMS = (32, 64, 128)
DECODE_REPS = (1, 2, 4, 8)


def _sqrt_hd(hd: int) -> float:
    # the float32 constant the reference divides scores by
    return float(torch.tensor(math.sqrt(hd), dtype=torch.float32))


def _softmax_pv(s, valid, v_spec: str, v, logit_cap: float):
    """Masked float32 softmax of scores ``s`` and its product with ``v``;
    rows with no valid key give 0 (as the kernels' l == 0 rule)."""
    if logit_cap > 0:
        s = logit_cap * torch.tanh(s / logit_cap)
    s = torch.where(valid, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum(v_spec, p, v)
    return o, l


# ---------------------------------------------------------------------------
# K3: prefill attention
# ---------------------------------------------------------------------------

def attention_prefill_plain(q: torch.Tensor, k_mant: torch.Tensor,
                            k_exp: torch.Tensor, v_mant: torch.Tensor,
                            v_exp: torch.Tensor, *, mantissa_bits: int = 8,
                            causal: bool = True, logit_cap: float = 0.0,
                            window: int = 0) -> torch.Tensor:
    """q: (B, S, H, hd) float32; K (B, S, Hkv, hd) + (B, S, Hkv, hd/32);
    V token-grouped (B, S, Hkv, hd) + (B, S/32, Hkv, hd) -> (B, S, H, hd)
    float32."""
    B, S, H, D = q.shape
    Hkv = k_mant.shape[2]
    k = dequantize_k(k_mant, k_exp, mantissa_bits)
    v = dequantize_v_groups(v_mant, v_exp, mantissa_bits)
    qg = q.to(torch.float32).reshape(B, S, Hkv, H // Hkv, D)
    s = torch.einsum("bsgrd,btgd->bgrst", qg, k) / _sqrt_hd(D)
    pos = torch.arange(S, device=q.device)
    d = pos[:, None] - pos[None, :]
    valid = torch.ones_like(d, dtype=torch.bool)
    if causal:
        valid = d >= 0
        if window > 0:
            valid &= d < window
    o, l = _softmax_pv(s, valid, "bgrst,btgd->bgrsd", v, logit_cap)
    o = torch.where(l > 0, o / l.clamp_min(1e-30), 0.0)
    return o.permute(0, 3, 1, 2, 4).reshape(B, S, H, D)


def attention_prefill_cuda(q: torch.Tensor, k_mant: torch.Tensor,
                           k_exp: torch.Tensor, v_mant: torch.Tensor,
                           v_exp: torch.Tensor, *, mantissa_bits: int = 8,
                           causal: bool = True, logit_cap: float = 0.0,
                           window: int = 0) -> torch.Tensor:
    B, S, H, D = q.shape
    Hkv = k_mant.shape[2]
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    if H % Hkv or 32 % (H // Hkv):
        raise ValueError(f"H={H} / Hkv={Hkv} must be a divisor of 32")
    if S % GROUP:
        raise ValueError(f"S={S} must be a multiple of {GROUP}")
    dev = q.device
    _check("q", q, torch.float32, (B, S, H, D), dev)
    _check("k_mant", k_mant, torch.int8, (B, S, Hkv, D), dev)
    _check("k_exp", k_exp, torch.int8, (B, S, Hkv, D // GROUP), dev)
    _check("v_mant", v_mant, torch.int8, (B, S, Hkv, D), dev)
    _check("v_exp", v_exp, torch.int8, (B, S // GROUP, Hkv, D), dev)
    out = torch.empty((B, S, H, D), dtype=torch.float32, device=dev)
    _build.launch("bfp_attention_prefill", "bfp_attention_prefill",
                  "ppppppiiiiiiiiff", q, k_mant, k_exp, v_mant, v_exp, out,
                  B, S, H, Hkv, D, mantissa_bits, int(causal), int(window),
                  float(logit_cap), _sqrt_hd(D))
    return out


# ---------------------------------------------------------------------------
# K4: single-call decode over the whole asymmetric cache
# ---------------------------------------------------------------------------

def cache_kv_in_position_order(cache: AsymKVCache):
    """Dequantize positions [0, length) of the cache in position order:
    init block, 4-bit bulk below the recent window, K ring over the last 64
    positions (the demoted band below them stays 4-bit), V ring groups
    {cg-2, cg-1} (>= 1) and the residual group re-quantized at its current
    length.  Returns (k, v), each (B, length, Hkv, hd) float32."""
    L = cache.length
    cg, r = divmod(L, GROUP)
    k = torch.cat([
        dequantize_k(cache.k_init_mant, cache.k_init_exp, 8),
        dequantize_k(bfp.unpack_int4(cache.k_bulk_mant, axis=-1),
                     cache.k_bulk_exp, 4)], dim=1)[:, :L].clone()
    lo = max(INIT_TOKENS, L - LOCAL_TOKENS)
    if L > lo:
        slots = (torch.arange(lo, L, device=k.device)
                 - INIT_TOKENS) % LOCAL_TOKENS
        k[:, lo:L] = dequantize_k(cache.k_local_mant[:, slots],
                                  cache.k_local_exp[:, slots], 8)
    v = torch.cat([
        dequantize_v_groups(cache.v_init_mant, cache.v_init_exp, 8),
        dequantize_v_groups(bfp.unpack_int4(cache.v_bulk_mant, axis=1),
                            cache.v_bulk_exp, 4)], dim=1)[:, :L].clone()
    for g in range(max(cg - V_LOCAL_GROUPS, 1), cg):
        slot = g % V_LOCAL_GROUPS
        v[:, g * GROUP:(g + 1) * GROUP] = dequantize_v_groups(
            cache.v_local_mant[:, slot * GROUP:(slot + 1) * GROUP],
            cache.v_local_exp[:, slot:slot + 1], 8)
    if r and cg:
        # (below one complete group, positions < 32 read the init group,
        # as in the reference; serving never decodes there)
        v[:, cg * GROUP:L] = bfp.bfp_fake_quant(cache.v_resid[:, :r], GROUP,
                                                8, "trunc", axis=1)
    return k, v


def attention_decode_cache_plain(q: torch.Tensor, cache: AsymKVCache,
                                 start: torch.Tensor | None = None, *,
                                 logit_cap: float = 0.0) -> torch.Tensor:
    """q: (B, H, hd) float32; ``start`` (B,) int: positions below it are
    left padding and masked.  Returns (B, H, hd) float32."""
    B, H, D = q.shape
    Hkv = cache.k_init_mant.shape[2]
    L = cache.length
    k, v = cache_kv_in_position_order(cache)
    s = torch.einsum("bgrd,btgd->bgrt",
                     q.to(torch.float32).reshape(B, Hkv, H // Hkv, D),
                     k) / _sqrt_hd(D)
    pos = torch.arange(L, device=q.device)
    valid = torch.ones((B, L), dtype=torch.bool, device=q.device)
    if start is not None:
        valid = pos[None, :] >= start.to(q.device)[:, None]
    o, l = _softmax_pv(s, valid[:, None, None], "bgrt,btgd->bgrd", v,
                       logit_cap)
    o = torch.where(l > 0, o / l.clamp_min(1e-30), 0.0)
    return o.reshape(B, H, D)


# the regions the decode kernel reads, in its argument order
DECODE_REGIONS = ("k_init_mant", "k_init_exp", "k_local_mant", "k_local_exp",
                  "k_bulk_mant", "k_bulk_exp", "v_resid", "v_init_mant",
                  "v_init_exp", "v_local_mant", "v_local_exp", "v_bulk_mant",
                  "v_bulk_exp")


def attention_decode_cache_cuda(q: torch.Tensor, cache: AsymKVCache,
                                start: torch.Tensor | None = None, *,
                                logit_cap: float = 0.0) -> torch.Tensor:
    B, H, D = q.shape
    Hkv = cache.k_init_mant.shape[2]
    L = cache.length
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    if H % Hkv or H // Hkv not in DECODE_REPS:
        raise ValueError(f"H={H} / Hkv={Hkv} not in {DECODE_REPS}")
    if not 1 <= L <= cache.max_seq:
        raise ValueError(f"cache length {L} outside [1, {cache.max_seq}]")
    dev = q.device
    _check("q", q, torch.float32, (B, H, D), dev)
    regions = cache.tensors()
    shapes = region_shapes(B, Hkv, D, cache.s_bulk)
    shapes["v_resid"] = (B, GROUP, Hkv, D)
    for name in DECODE_REGIONS:
        dtype = torch.float32 if name == "v_resid" else torch.int8
        _check(name, regions[name], dtype, shapes[name], dev)
    if start is None:
        start = torch.zeros((B,), dtype=torch.int32, device=dev)
    _check("start", start, torch.int32, (B,), dev)
    n_splits = -(-L // DECODE_SPLIT)
    part_o = torch.empty((n_splits, B, H, D), dtype=torch.float32,
                         device=dev)
    part_ml = torch.empty((n_splits, B, H, 2), dtype=torch.float32,
                          device=dev)
    out = torch.empty((B, H, D), dtype=torch.float32, device=dev)
    _build.launch("bfp_attention_decode", "bfp_attention_decode_cache",
                  "p" * 18 + "iiiiiii" + "ff",
                  q, *(regions[n] for n in DECODE_REGIONS), start, part_o,
                  part_ml, out, B, H, Hkv, D, cache.s_bulk, L, n_splits,
                  float(logit_cap), _sqrt_hd(D))
    return out


__all__ = ["attention_prefill_plain", "attention_prefill_cuda",
           "attention_decode_cache_plain", "attention_decode_cache_cuda",
           "cache_kv_in_position_order", "DECODE_SPLIT", "NEG_INF"]
