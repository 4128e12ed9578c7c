"""Packed asymmetric BFP KV cache (paper Sec. III-B, Fig. 6b) — the port of
``repro.core.kvcache``'s serving cache.

K is grouped per token along head_dim (hd/32 groups); V along the token dim
per channel (32-token groups, the P.V contraction direction).

  K: ``k_init``  — tokens < 32 at 8 bits ("attention sink"),
     ``k_local`` — ring of the 64 most recent tokens at 8 bits, slot
                   (t-32) % 64,
     ``k_bulk``  — older tokens at 4 bits, nibble-packed along head_dim,
                   slot t-32; a token is demoted 8b -> 4b when it leaves
                   the ring.
  V: ``v_resid`` — the incomplete trailing group, raw float32; attention
                   re-quantizes it at its current length every step,
     ``v_init``  — group 0 at 8 bits,
     ``v_local`` — ring of the two most recent complete groups (slot g % 2),
     ``v_bulk``  — groups 1 .. cg-3 at 4 bits, packed in token pairs;
                   ``v_bulk_exp`` slot j holds group j + 1.

Every batch row shares one position counter ``length`` (the engine
left-pads prompts; per-row validity is a mask in attention).  ``length``
is a Python int here: the host drives the decode loop, so every
region index is known without reading the device.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.core import bfp

INIT_TOKENS = 32
LOCAL_TOKENS = 64
GROUP = 32
V_LOCAL_GROUPS = 2

# the 12 packed regions, in the order the prefill converter returns them
REGION_NAMES = ("k_init_mant", "k_init_exp", "k_local_mant", "k_local_exp",
                "k_bulk_mant", "k_bulk_exp", "v_init_mant", "v_init_exp",
                "v_local_mant", "v_local_exp", "v_bulk_mant", "v_bulk_exp")


@dataclasses.dataclass
class AsymKVCache:
    """Packed per-layer KV cache.  All token axes are axis 1."""

    k_init_mant: torch.Tensor   # (B, INIT, n_kv, hd)        int8
    k_init_exp: torch.Tensor    # (B, INIT, n_kv, hd//G)     int8
    k_local_mant: torch.Tensor  # (B, LOCAL, n_kv, hd)       int8 (ring)
    k_local_exp: torch.Tensor   # (B, LOCAL, n_kv, hd//G)    int8
    k_bulk_mant: torch.Tensor   # (B, S_bulk, n_kv, hd//2)   int8 (4b pairs)
    k_bulk_exp: torch.Tensor    # (B, S_bulk, n_kv, hd//G)   int8
    v_resid: torch.Tensor       # (B, G, n_kv, hd)           float32 raw
    v_init_mant: torch.Tensor   # (B, G, n_kv, hd)           int8 (group 0)
    v_init_exp: torch.Tensor    # (B, 1, n_kv, hd)           int8
    v_local_mant: torch.Tensor  # (B, 2*G, n_kv, hd)         int8 (ring)
    v_local_exp: torch.Tensor   # (B, 2, n_kv, hd)           int8
    v_bulk_mant: torch.Tensor   # (B, S_bulk//2, n_kv, hd)   int8 (4b pairs
                                #   along the token axis)
    v_bulk_exp: torch.Tensor    # (B, S_bulk//G, n_kv, hd)   int8 (slot j =
                                #   group j+1)
    k_offsets: torch.Tensor     # (B, n_kv, hd)              float32
    length: int = 0

    @property
    def max_seq(self) -> int:
        return INIT_TOKENS + self.k_bulk_mant.shape[1]

    @property
    def s_bulk(self) -> int:
        return self.k_bulk_mant.shape[1]

    def tensors(self) -> Dict[str, torch.Tensor]:
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self) if f.name != "length"}


def init_cache(batch: int, n_kv: int, head_dim: int, max_seq: int,
               device=None) -> AsymKVCache:
    if head_dim % GROUP != 0:
        raise ValueError(f"head_dim {head_dim} must be a multiple of {GROUP}")
    if max_seq % GROUP != 0 or max_seq < INIT_TOKENS + LOCAL_TOKENS + GROUP:
        raise ValueError(f"max_seq {max_seq} must be a multiple of {GROUP} "
                         f"and >= {INIT_TOKENS + LOCAL_TOKENS + GROUP}")
    s_bulk = max_seq - INIT_TOKENS
    ng = head_dim // GROUP

    def z(*shape, dtype=torch.int8):
        return torch.zeros(shape, dtype=dtype, device=device)

    return AsymKVCache(
        k_init_mant=z(batch, INIT_TOKENS, n_kv, head_dim),
        k_init_exp=z(batch, INIT_TOKENS, n_kv, ng),
        k_local_mant=z(batch, LOCAL_TOKENS, n_kv, head_dim),
        k_local_exp=z(batch, LOCAL_TOKENS, n_kv, ng),
        k_bulk_mant=z(batch, s_bulk, n_kv, head_dim // 2),
        k_bulk_exp=z(batch, s_bulk, n_kv, ng),
        v_resid=z(batch, GROUP, n_kv, head_dim, dtype=torch.float32),
        v_init_mant=z(batch, GROUP, n_kv, head_dim),
        v_init_exp=z(batch, 1, n_kv, head_dim),
        v_local_mant=z(batch, V_LOCAL_GROUPS * GROUP, n_kv, head_dim),
        v_local_exp=z(batch, V_LOCAL_GROUPS, n_kv, head_dim),
        v_bulk_mant=z(batch, s_bulk // 2, n_kv, head_dim),
        v_bulk_exp=z(batch, s_bulk // GROUP, n_kv, head_dim),
        k_offsets=z(batch, n_kv, head_dim, dtype=torch.float32),
        length=0,
    )


# -- quantization helpers on (B, T, n_kv, hd) slabs --

def quantize_k(x: torch.Tensor, bits: int):
    """K tokens along head_dim -> (mant int8 (..., hd), exp int8
    (..., hd//G))."""
    mant, exp = bfp.bfp_quantize(x, GROUP, bits, axis=-1)
    return mant.reshape(x.shape), exp


def dequantize_k(mant: torch.Tensor, exp: torch.Tensor,
                 bits: int) -> torch.Tensor:
    g = mant.reshape(*mant.shape[:-1], mant.shape[-1] // GROUP, GROUP)
    return bfp.dequantize_grouped(g, exp, bits).reshape(mant.shape)


def quantize_v_groups(x: torch.Tensor, bits: int):
    """Complete V groups along the token axis: x (B, n*G, n_kv, hd) ->
    (mant int8 (B, n*G, n_kv, hd), exp int8 (B, n, n_kv, hd))."""
    B, T, H, D = x.shape
    xg = x.reshape(B, T // GROUP, GROUP, H, D).movedim(2, -1)
    mant, exp = bfp.quantize_grouped(xg, bits)          # (B,n,H,D,G)
    mant = mant.movedim(-1, 2).reshape(B, T, H, D)
    return mant.to(torch.int8), exp.to(torch.int8)


def dequantize_v_groups(mant: torch.Tensor, exp: torch.Tensor,
                        bits: int) -> torch.Tensor:
    B, T, H, D = mant.shape
    g = mant.reshape(B, T // GROUP, GROUP, H, D).to(torch.float32)
    step = bfp.exp2i(exp.to(torch.int32) - (bits - 2))[:, :, None]
    return (g * step).reshape(B, T, H, D)


# ---------------------------------------------------------------------------
# Prefill: every region from a dense (B, S, n_kv, hd) chunk
# ---------------------------------------------------------------------------

def prefill_cache(cache: AsymKVCache, k: torch.Tensor, v: torch.Tensor,
                  k_offsets: torch.Tensor | None = None) -> AsymKVCache:
    """Build the packed cache from a prefill chunk (S a multiple of GROUP,
    S <= max_seq).  ``k_offsets`` (B, n_kv, hd), the online-smoothing
    offsets, are subtracted from every key before quantization.

    The 12 regions come from one launch of the prefill-cache converter
    (``kernels.ops.convert_prefill_cache``): the CUDA kernel for tensors on
    the card, its plain version for tensors on the CPU.  Returns a new
    cache; ``v_resid`` stays zero because S is a multiple of GROUP."""
    from repro_torch.kernels import ops

    B, S, H, D = k.shape
    if S % GROUP != 0:
        raise ValueError(f"prefill length {S} must be a multiple of {GROUP}")
    if k_offsets is None:
        k_offsets = torch.zeros((B, H, D), dtype=torch.float32,
                                device=k.device)
    k_offsets = k_offsets.to(torch.float32).contiguous()
    regions = ops.convert_prefill_cache(
        k.to(torch.float32).contiguous(), v.to(torch.float32).contiguous(),
        k_offsets, s_bulk=cache.s_bulk)
    return dataclasses.replace(cache, **regions, k_offsets=k_offsets,
                               length=S)


# ---------------------------------------------------------------------------
# Decode append: one token, with demotion
# ---------------------------------------------------------------------------

def append_token(cache: AsymKVCache, k_new: torch.Tensor,
                 v_new: torch.Tensor) -> AsymKVCache:
    """Append one (B, n_kv, hd) K/V token at position t = length.

    Writes IN PLACE into the cache's tensors (and returns the same cache):
    the new K goes to the init region (t < 32) or to ring slot (t-32)%64,
    after the ring's previous occupant, token t-64, is demoted to the 4-bit
    bulk; V goes to the residual group, which on completion (t%32 == 31)
    is committed at 8 bits to the init group or ring slot g%2, after the
    group leaving the ring, g-2, is demoted to the 4-bit bulk.  The caller
    checks capacity (the engine refuses prompts that would overflow)."""
    t = cache.length
    if t >= cache.max_seq:
        raise ValueError(f"cache full: length {t} == max_seq {cache.max_seq}")
    k_new = k_new.to(torch.float32) - cache.k_offsets
    km, ke = quantize_k(k_new[:, None], 8)               # (B,1,H,D)
    if t < INIT_TOKENS:
        cache.k_init_mant[:, t:t + 1] = km
        cache.k_init_exp[:, t:t + 1] = ke
    else:
        slot = (t - INIT_TOKENS) % LOCAL_TOKENS
        demote_tok = t - LOCAL_TOKENS
        if demote_tok >= INIT_TOKENS:
            old = dequantize_k(cache.k_local_mant[:, slot:slot + 1],
                               cache.k_local_exp[:, slot:slot + 1], 8)
            dm, de = quantize_k(old, 4)
            j = demote_tok - INIT_TOKENS
            cache.k_bulk_mant[:, j:j + 1] = bfp.pack_int4(dm, axis=-1)
            cache.k_bulk_exp[:, j:j + 1] = de
        cache.k_local_mant[:, slot:slot + 1] = km
        cache.k_local_exp[:, slot:slot + 1] = ke

    r = t % GROUP
    cache.v_resid[:, r] = v_new.to(torch.float32)
    if r == GROUP - 1:
        g = t // GROUP
        gm, ge = quantize_v_groups(cache.v_resid, 8)
        if g == 0:
            cache.v_init_mant.copy_(gm)
            cache.v_init_exp.copy_(ge)
        else:
            vslot = g % V_LOCAL_GROUPS
            rows = slice(vslot * GROUP, (vslot + 1) * GROUP)
            gd = g - V_LOCAL_GROUPS
            if gd >= 1:
                old = dequantize_v_groups(
                    cache.v_local_mant[:, rows],
                    cache.v_local_exp[:, vslot:vslot + 1], 8)
                dm, de = quantize_v_groups(old, 4)
                j = (gd - 1) * (GROUP // 2)
                cache.v_bulk_mant[:, j:j + GROUP // 2] = bfp.pack_int4(
                    dm, axis=1)
                cache.v_bulk_exp[:, gd - 1:gd] = de
            cache.v_local_mant[:, rows] = gm
            cache.v_local_exp[:, vslot:vslot + 1] = ge
        # stale values must never leak into the next group's exponent
        cache.v_resid.zero_()
    cache.length = t + 1
    return cache


def cache_bytes(cache: AsymKVCache) -> int:
    """Physical bytes of the packed cache, counted as the JAX package
    counts its leaves (the int32 ``length`` included)."""
    return sum(x.numel() * x.element_size()
               for x in cache.tensors().values()) + 4


def fp16_cache_bytes(batch: int, n_kv: int, head_dim: int,
                     max_seq: int) -> int:
    return batch * n_kv * head_dim * max_seq * 2 * 2  # K and V, fp16


__all__ = ["AsymKVCache", "init_cache", "prefill_cache", "append_token",
           "cache_bytes", "fp16_cache_bytes", "quantize_k", "dequantize_k",
           "quantize_v_groups", "dequantize_v_groups", "REGION_NAMES",
           "INIT_TOKENS", "LOCAL_TOKENS", "GROUP", "V_LOCAL_GROUPS"]
