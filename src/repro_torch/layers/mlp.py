"""Gated MLP — the port of ``repro.layers.mlp.gated_mlp``."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.quant_config import QuantConfig
from repro_torch.layers.common import activation, qlinear


def gated_mlp(x: torch.Tensor, p: dict, act: str,
              quant: Optional[QuantConfig] = None) -> torch.Tensor:
    """SwiGLU-style MLP: down(act(gate(x)) * up(x))."""
    g = qlinear(x, p["w_gate"], quant)
    u = qlinear(x, p["w_up"], quant)
    return qlinear(activation(g, act) * u, p["w_down"], quant)


__all__ = ["gated_mlp"]
