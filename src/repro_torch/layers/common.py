"""Norms, activations and the BFP x INT4 linear — the port of
``repro.layers.common``.

Every linear goes through :func:`qlinear`: BFP-quantized activations (group
32 along the contraction dim) times INT4 weights.  The packed weight is
dequantized and multiplied with ``torch.matmul``, as the JAX serving path
leaves the product to XLA; the fused M8W4 GEMM kernel is a later port.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch
import torch.nn.functional as F

from repro_torch.core import bfp
from repro_torch.core.quant_config import QuantConfig


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
             zero_centered: bool = False) -> torch.Tensor:
    """RMSNorm in float32, returned in the input dtype."""
    xf = x.to(torch.float32)
    var = xf.square().mean(dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    w = scale.to(torch.float32)
    if zero_centered:
        w = 1.0 + w
    return (xf * w).to(x.dtype)


def activation(x: torch.Tensor, kind: str) -> torch.Tensor:
    """The gated MLP's activation; the ported configs use SiLU only."""
    if kind == "silu":
        return F.silu(x)
    raise NotImplementedError(f"activation {kind!r} is not ported")


class QuantizedWeight(NamedTuple):
    """Symmetric INT4 weight, groups along the contraction (in) dim.

    packed: (in_dim // 2, out_dim) int8 — two 4-bit values per byte along in.
    scale:  (in_dim // group, out_dim) float32.
    """
    packed: torch.Tensor
    scale: torch.Tensor

    @property
    def in_dim(self) -> int:
        return self.packed.shape[0] * 2

    @property
    def out_dim(self) -> int:
        return self.packed.shape[-1]


def weight_dequant(qw: QuantizedWeight,
                   dtype=torch.bfloat16) -> torch.Tensor:
    """packed (in/2, out), scale (in/group, out) -> (in, out) ``dtype``;
    the product with the scale is taken in float32, as in the reference."""
    lo, hi = bfp.unpack_nibbles(qw.packed)
    half, out_dim = qw.packed.shape
    mant = torch.stack([lo, hi], dim=1).reshape(2 * half, out_dim)
    ngroups = qw.scale.shape[0]
    w = mant.reshape(ngroups, -1, out_dim).to(torch.float32) \
        * qw.scale[:, None, :]
    return w.reshape(2 * half, out_dim).to(dtype)


WeightLike = Union[torch.Tensor, QuantizedWeight]


def qlinear(x: torch.Tensor, w: WeightLike,
            quant: Optional[QuantConfig] = None) -> torch.Tensor:
    """y = BFP(x) @ W[int4], in the activation's dtype."""
    if quant is not None and quant.enabled and quant.quant_linear_acts:
        x = bfp.bfp_fake_quant(x, quant.group_size, quant.act_mantissa_bits,
                               quant.rounding, axis=-1)
    if isinstance(w, QuantizedWeight):
        w = weight_dequant(w, x.dtype)
    return torch.matmul(x, w.to(x.dtype))


def embed_lookup(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    return table[tokens]


__all__ = ["rms_norm", "activation", "QuantizedWeight", "weight_dequant",
           "WeightLike", "qlinear", "embed_lookup"]
