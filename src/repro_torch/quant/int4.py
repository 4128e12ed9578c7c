"""INT4 weight quantization (group 128, symmetric) — the port of
``repro.quant.int4.quantize_weight`` / ``pack_params``."""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.core import bfp
from repro_torch.layers.common import QuantizedWeight

DEFAULT_GROUP = 128
INT4_MAX = 7.0

# linear weights quantized to INT4; embeddings and norms stay floating point
QUANTIZABLE_KEYS = frozenset({
    "wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "lm_head",
})


def quantize_weight(w: torch.Tensor, group: int = DEFAULT_GROUP,
                    clip: float = 1.0) -> QuantizedWeight:
    """(in, out) float -> packed INT4 with one float32 scale per group of
    ``group`` input rows; values round half to even, as in the reference."""
    if w.shape[0] % group != 0:
        raise ValueError(f"in_dim {w.shape[0]} not divisible by {group}")
    gin = w.to(torch.float32).reshape(w.shape[0] // group, group, -1)
    scales = (gin.abs().amax(dim=1) * clip / INT4_MAX).clamp_min(1e-8)
    q = torch.round(gin / scales[:, None]).clamp(-INT4_MAX, INT4_MAX)
    mant = q.reshape(w.shape).to(torch.int8)
    return QuantizedWeight(packed=bfp.pack_int4(mant, axis=0), scale=scales)


def pack_params(params: Dict, group: int = DEFAULT_GROUP) -> Dict:
    """Parameter tree -> the same tree with every quantizable linear weight
    (in-dim divisible by ``group``) packed to INT4."""
    def pack(d: Dict) -> Dict:
        return {k: quantize_weight(w, group)
                if k in QUANTIZABLE_KEYS and isinstance(w, torch.Tensor)
                and w.ndim == 2 and w.shape[0] % group == 0 else w
                for k, w in d.items()}

    out = pack({k: v for k, v in params.items() if k != "layers"})
    out["layers"] = [pack(layer) for layer in params["layers"]]
    return out


__all__ = ["quantize_weight", "pack_params", "QUANTIZABLE_KEYS",
           "DEFAULT_GROUP"]
