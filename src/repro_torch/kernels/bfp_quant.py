"""FP->BFP converter kernels of the serving path, with their plain versions.

K1 ``quantize_kv_pair`` replaces ``repro.kernels.bfp_quant
.bfp_quantize_kv_pair_kernel``: fresh prefill K in per-token 32-groups
along head_dim and V in 32-token groups per channel, 8-bit mantissas,
truncation — the layouts the prefill attention kernel reads.

K2 ``convert_prefill_cache`` replaces ``repro.kernels.bfp_quant
.convert_prefill_cache_kernel``: a dense prefill chunk (K minus the online
offsets, and V) -> all 12 packed regions of ``AsymKVCache``.

``*_plain`` are the plain PyTorch versions (the CPU route, and the
reference the CUDA kernels are held to bit for bit); ``*_cuda`` check
their arguments, allocate the outputs and launch ``csrc/bfp_quant.cu``.
Callers use the device-dispatching wrappers in ``kernels.ops``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.core import bfp
from repro_torch.core.kvcache import (GROUP, INIT_TOKENS, LOCAL_TOKENS,
                                      REGION_NAMES, V_LOCAL_GROUPS,
                                      quantize_k, quantize_v_groups)
from repro_torch.kernels import _build

LIB = "bfp_quant"


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape,
           device: torch.device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _kv_shape(k: torch.Tensor):
    if k.ndim != 4:
        raise ValueError(f"expected (B, S, Hkv, hd), got {tuple(k.shape)}")
    B, S, H, D = k.shape
    if S < GROUP or S % GROUP or D % GROUP:
        raise ValueError("S and head_dim must be positive multiples of 32")
    return B, S, H, D


# ---------------------------------------------------------------------------
# K1: fresh K/V converter for the prefill attention kernel
# ---------------------------------------------------------------------------

def quantize_kv_pair_plain(k: torch.Tensor, v: torch.Tensor,
                           mantissa_bits: int = 8):
    """k, v: (B, S, Hkv, hd) float32 -> (k_mant (B, S, Hkv, hd) i8,
    k_exp (B, S, Hkv, hd/32) i8, v_mant (B, S, Hkv, hd) i8,
    v_exp (B, S/32, Hkv, hd) i8)."""
    _kv_shape(k)
    km, ke = quantize_k(k.to(torch.float32), mantissa_bits)
    vm, ve = quantize_v_groups(v.to(torch.float32), mantissa_bits)
    return km, ke, vm, ve


def quantize_kv_pair_cuda(k: torch.Tensor, v: torch.Tensor,
                          mantissa_bits: int = 8):
    B, S, H, D = _kv_shape(k)
    if not 2 <= mantissa_bits <= 8:
        raise ValueError(f"mantissa_bits {mantissa_bits} not in [2, 8]")
    if D > 1024:
        raise ValueError(f"head_dim {D} > 1024")
    dev = k.device
    _check("k", k, torch.float32, (B, S, H, D), dev)
    _check("v", v, torch.float32, (B, S, H, D), dev)
    i8 = dict(dtype=torch.int8, device=dev)
    km = torch.empty((B, S, H, D), **i8)
    ke = torch.empty((B, S, H, D // GROUP), **i8)
    vm = torch.empty((B, S, H, D), **i8)
    ve = torch.empty((B, S // GROUP, H, D), **i8)
    _build.launch(LIB, "bfp_quantize_kv_pair", "ppppppiiiii",
                  k, v, km, ke, vm, ve, B, S, H, D, mantissa_bits)
    return km, ke, vm, ve


# ---------------------------------------------------------------------------
# K2: dense prefill chunk -> the 12 packed cache regions
# ---------------------------------------------------------------------------

def region_shapes(B: int, H: int, D: int,
                  s_bulk: int) -> Dict[str, Tuple[int, ...]]:
    ng = D // GROUP
    return {
        "k_init_mant": (B, INIT_TOKENS, H, D),
        "k_init_exp": (B, INIT_TOKENS, H, ng),
        "k_local_mant": (B, LOCAL_TOKENS, H, D),
        "k_local_exp": (B, LOCAL_TOKENS, H, ng),
        "k_bulk_mant": (B, s_bulk, H, D // 2),
        "k_bulk_exp": (B, s_bulk, H, ng),
        "v_init_mant": (B, GROUP, H, D),
        "v_init_exp": (B, 1, H, D),
        "v_local_mant": (B, V_LOCAL_GROUPS * GROUP, H, D),
        "v_local_exp": (B, V_LOCAL_GROUPS, H, D),
        "v_bulk_mant": (B, s_bulk // 2, H, D),
        "v_bulk_exp": (B, s_bulk // GROUP, H, D),
    }


def _check_prefill(k, s_bulk):
    B, S, H, D = _kv_shape(k)
    if s_bulk % GROUP or s_bulk < LOCAL_TOKENS + GROUP:
        raise ValueError(f"s_bulk {s_bulk} must be a multiple of {GROUP} "
                         f"and >= {LOCAL_TOKENS + GROUP}")
    if S > s_bulk + INIT_TOKENS:
        raise ValueError(f"prefill length {S} exceeds capacity "
                         f"{s_bulk + INIT_TOKENS}")
    return B, S, H, D


def convert_prefill_cache_plain(k: torch.Tensor, v: torch.Tensor,
                                k_offsets: torch.Tensor,
                                s_bulk: int) -> Dict[str, torch.Tensor]:
    """k, v: (B, S, Hkv, hd) float32; k_offsets (B, Hkv, hd) float32.

    Token-to-region map at length S (cg = S // 32):
      K: t < 32 -> init; t in [max(32, S-64), S) -> ring slot (t-32)%64;
         t in [32, S-64) -> 4-bit bulk slot t-32.
      V: group 0 -> init; groups {cg-2, cg-1} (>= 1) -> ring slot g%2;
         groups 1 .. cg-3 -> 4-bit bulk, exponent slot g-1.
    Every byte that holds no token is zero."""
    B, S, H, D = _check_prefill(k, s_bulk)
    dev = k.device
    k = k.to(torch.float32) - k_offsets.to(torch.float32)[:, None]
    v = v.to(torch.float32)
    out = {n: torch.zeros(s, dtype=torch.int8, device=dev)
           for n, s in region_shapes(B, H, D, s_bulk).items()}

    out["k_init_mant"], out["k_init_exp"] = quantize_k(k[:, :INIT_TOKENS], 8)
    if S > INIT_TOKENS:
        ring_lo = max(INIT_TOKENS, S - LOCAL_TOKENS)
        slots = (torch.arange(ring_lo, S, device=dev)
                 - INIT_TOKENS) % LOCAL_TOKENS
        m, e = quantize_k(k[:, ring_lo:S], 8)
        out["k_local_mant"][:, slots] = m
        out["k_local_exp"][:, slots] = e
    n_bulk = max(0, S - LOCAL_TOKENS - INIT_TOKENS)
    if n_bulk:
        m, e = quantize_k(k[:, INIT_TOKENS:INIT_TOKENS + n_bulk], 4)
        out["k_bulk_mant"][:, :n_bulk] = bfp.pack_int4(m, axis=-1)
        out["k_bulk_exp"][:, :n_bulk] = e

    cg = S // GROUP
    out["v_init_mant"], out["v_init_exp"] = quantize_v_groups(v[:, :GROUP], 8)
    for g in (cg - V_LOCAL_GROUPS, cg - 1):
        if g >= 1:
            m, e = quantize_v_groups(v[:, g * GROUP:(g + 1) * GROUP], 8)
            slot = g % V_LOCAL_GROUPS
            out["v_local_mant"][:, slot * GROUP:(slot + 1) * GROUP] = m
            out["v_local_exp"][:, slot:slot + 1] = e
    n_bulk_g = max(0, cg - V_LOCAL_GROUPS - 1)
    if n_bulk_g:
        m, e = quantize_v_groups(v[:, GROUP:(1 + n_bulk_g) * GROUP], 4)
        out["v_bulk_mant"][:, :n_bulk_g * GROUP // 2] = bfp.pack_int4(
            m, axis=1)
        out["v_bulk_exp"][:, :n_bulk_g] = e
    return out


def convert_prefill_cache_cuda(k: torch.Tensor, v: torch.Tensor,
                               k_offsets: torch.Tensor,
                               s_bulk: int) -> Dict[str, torch.Tensor]:
    B, S, H, D = _check_prefill(k, s_bulk)
    if D > 1024:
        raise ValueError(f"head_dim {D} > 1024")
    dev = k.device
    _check("k", k, torch.float32, (B, S, H, D), dev)
    _check("v", v, torch.float32, (B, S, H, D), dev)
    _check("k_offsets", k_offsets, torch.float32, (B, H, D), dev)
    out = {n: torch.empty(s, dtype=torch.int8, device=dev)
           for n, s in region_shapes(B, H, D, s_bulk).items()}
    _build.launch(LIB, "convert_prefill_cache", "ppp" + "p" * 12 + "iiiii",
                  k, v, k_offsets, *(out[n] for n in REGION_NAMES),
                  B, S, H, D, s_bulk)
    return out


__all__ = ["quantize_kv_pair_plain", "quantize_kv_pair_cuda",
           "convert_prefill_cache_plain", "convert_prefill_cache_cuda",
           "region_shapes"]
