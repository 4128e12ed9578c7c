"""Block floating point (BFP) numerics — the port of ``repro.core.bfp``.

A BFP group is ``group_size`` contiguous elements along one axis that share
one exponent ``E = floor(log2(max|x|))``, clipped to the 5-bit FP16 range
[-14, 15]; each element keeps an ``m``-bit signed mantissa, so values
dequantize as ``M * 2^(E - m + 2)``.  Truncation (round toward zero) is the
paper's mode; round-to-nearest (half to even) is the other option.

The shared exponent is read from the float's exponent bits, and every power
of two is built from bits as well, so both are exact.  The JAX reference
computes ``floor(log2(absmax))`` and ``exp2`` through XLA's CPU
approximations, which are off at a few exact powers of two (``ROADMAP.md``,
caveat A); the hand-written CUDA kernels use the same bit arithmetic as this
module, so kernel and plain version agree exactly.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

# FP16 exponent range for the 5-bit shared exponent.
EXP_MIN = -14
EXP_MAX = 15

DEFAULT_GROUP_SIZE = 32
DEFAULT_MANTISSA_BITS = 8


def shared_exponent(absmax: torch.Tensor) -> torch.Tensor:
    """floor(log2(absmax)) clipped to [EXP_MIN, EXP_MAX], as int32.

    Read from the exponent field of the float32 bits: exact for every
    normal value; zero and subnormal groups fall below EXP_MIN and clip to
    it, so their mantissas quantize to zero."""
    bits = absmax.to(torch.float32).contiguous().view(torch.int32)
    e = ((bits >> 23) & 0xFF) - 127
    return e.clamp(EXP_MIN, EXP_MAX)


def exp2i(e: torch.Tensor) -> torch.Tensor:
    """Exact 2^e as float32 for integer ``e`` in the normal range."""
    return ((e.to(torch.int32) + 127) << 23).view(torch.float32)


def _group_reshape(x: torch.Tensor, group_size: int, axis: int):
    """Move ``axis`` last and split it into (n_groups, group_size), padding
    a ragged tail with zeros (which never raise the shared exponent)."""
    axis = axis % x.ndim
    x = x.movedim(axis, -1)
    n = x.shape[-1]
    if n % group_size:
        x = F.pad(x, (0, group_size - n % group_size))
    return x.reshape(*x.shape[:-1], -1, group_size), n


def _group_unreshape(grouped: torch.Tensor, orig_len: int, axis: int,
                     ndim: int) -> torch.Tensor:
    x = grouped.reshape(*grouped.shape[:-2], -1)[..., :orig_len]
    return x.movedim(-1, axis % ndim)


def quantize_grouped(grouped: torch.Tensor, mantissa_bits: int,
                     rounding: str = "trunc"):
    """Quantize a (..., n_groups, group_size) tensor.

    Returns (mantissas as float32 integers in [-(2^(m-1)-1), 2^(m-1)-1],
    exponents int32 of shape (..., n_groups))."""
    if rounding not in ("trunc", "nearest"):
        raise ValueError(f"unknown rounding mode {rounding!r}")
    e = shared_exponent(grouped.abs().amax(dim=-1))
    inv_step = exp2i(mantissa_bits - 2 - e)[..., None]
    scaled = grouped.to(torch.float32) * inv_step
    mant = torch.trunc(scaled) if rounding == "trunc" else torch.round(scaled)
    lim = float(2 ** (mantissa_bits - 1) - 1)
    return mant.clamp(-lim, lim), e


def dequantize_grouped(mant: torch.Tensor, exp: torch.Tensor,
                       mantissa_bits: int) -> torch.Tensor:
    """(..., n_groups, group_size) mantissas x (..., n_groups) exponents ->
    float32 values."""
    return mant.to(torch.float32) * exp2i(
        exp.to(torch.int32) - (mantissa_bits - 2))[..., None]


def bfp_fake_quant(x: torch.Tensor, group_size: int = DEFAULT_GROUP_SIZE,
                   mantissa_bits: int = DEFAULT_MANTISSA_BITS,
                   rounding: str = "trunc", axis: int = -1) -> torch.Tensor:
    """Quantize -> dequantize, returned in the input dtype."""
    grouped, n = _group_reshape(x, group_size, axis)
    mant, exp = quantize_grouped(grouped, mantissa_bits, rounding)
    deq = dequantize_grouped(mant, exp, mantissa_bits)
    return _group_unreshape(deq, n, axis, x.ndim).to(x.dtype)


def bfp_quantize(x: torch.Tensor, group_size: int = DEFAULT_GROUP_SIZE,
                 mantissa_bits: int = DEFAULT_MANTISSA_BITS,
                 rounding: str = "trunc",
                 axis: int = -1) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed BFP in the moved-last layout of ``repro.core.bfp``:
    mant (..., n_groups, group_size) int8, exp (..., n_groups) int8."""
    if mantissa_bits > 8:
        raise ValueError("packed path supports mantissa_bits <= 8")
    grouped, _ = _group_reshape(x, group_size, axis)
    mant, exp = quantize_grouped(grouped, mantissa_bits, rounding)
    return mant.to(torch.int8), exp.to(torch.int8)


def bfp_dequantize(mant: torch.Tensor, exp: torch.Tensor, orig_len: int,
                   mantissa_bits: int = DEFAULT_MANTISSA_BITS,
                   axis: int = -1, ndim: int | None = None,
                   dtype=torch.float32) -> torch.Tensor:
    """Inverse of :func:`bfp_quantize` back to the original layout (the
    group size is the last dim of ``mant``)."""
    deq = dequantize_grouped(mant, exp, mantissa_bits)
    ndim = ndim if ndim is not None else deq.ndim - 1
    return _group_unreshape(deq, orig_len, axis, ndim).to(dtype)


# ---------------------------------------------------------------------------
# int4 nibble packing (two 4-bit mantissas per int8 byte)
# ---------------------------------------------------------------------------

def pack_int4(mant: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Pack int4 values (int8 in [-8, 7]) two per byte along ``axis``
    (even length).  Low nibble = even index, high nibble = odd index."""
    axis = axis % mant.ndim
    m = mant.movedim(axis, -1)
    if m.shape[-1] % 2:
        raise ValueError("pack_int4 needs an even axis length")
    lo = m[..., 0::2].to(torch.int32) & 0xF
    hi = m[..., 1::2].to(torch.int32) & 0xF
    byte = lo | (hi << 4)
    packed = torch.where(byte >= 128, byte - 256, byte).to(torch.int8)
    return packed.movedim(-1, axis)


def unpack_nibbles(packed: torch.Tensor):
    """Sign-extended (low, high) nibbles of int8 bytes, as int8."""
    lo = ((packed & 0xF) ^ 8) - 8
    hi = packed >> 4                      # arithmetic shift sign-extends
    return lo, hi


def unpack_int4(packed: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Inverse of :func:`pack_int4` -> int8 values in [-8, 7]."""
    axis = axis % packed.ndim
    p = packed.movedim(axis, -1)
    lo, hi = unpack_nibbles(p)
    out = torch.stack([lo, hi], dim=-1).reshape(*p.shape[:-1], -1)
    return out.movedim(-1, axis)


# ---------------------------------------------------------------------------
# Site-specific helpers (paper Fig. 6a grouping directions)
# ---------------------------------------------------------------------------

def quant_per_token(x: torch.Tensor, mantissa_bits: int = 8,
                    group_size: int = 32,
                    rounding: str = "trunc") -> torch.Tensor:
    """Groups along the last (hidden / head) dim: linear inputs, Q, K."""
    return bfp_fake_quant(x, group_size, mantissa_bits, rounding, axis=-1)


def quant_v_cache(v: torch.Tensor, mantissa_bits: int = 8,
                  group_size: int = 32, rounding: str = "trunc",
                  token_axis: int = -2) -> torch.Tensor:
    """V groups along the token dim per channel (the P.V contraction dim);
    a trailing partial group is zero-padded, like the residual group."""
    return bfp_fake_quant(v, group_size, mantissa_bits, rounding,
                          axis=token_axis)


__all__ = [
    "shared_exponent", "exp2i", "quantize_grouped", "dequantize_grouped",
    "bfp_fake_quant", "bfp_quantize", "bfp_dequantize", "pack_int4",
    "unpack_int4", "unpack_nibbles", "quant_per_token", "quant_v_cache",
    "EXP_MIN", "EXP_MAX", "DEFAULT_GROUP_SIZE", "DEFAULT_MANTISSA_BITS",
]
