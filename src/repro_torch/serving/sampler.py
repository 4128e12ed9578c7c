"""Token samplers — the port of ``repro.serving.sampler`` (greedy and
temperature).

Samplers are ``(logits (B, V)) -> (B,) int64`` closures.  Temperature
sampling draws Gumbel noise from the engine's ``torch.Generator``; it
cannot replay ``jax.random`` (ROADMAP caveat D), so only greedy decoding is
compared with the reference token for token.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch


def greedy(logits: torch.Tensor) -> torch.Tensor:
    return logits.argmax(dim=-1)


def temperature(logits: torch.Tensor, generator: torch.Generator,
                temp: float = 0.8) -> torch.Tensor:
    """Categorical draw from softmax(logits / temp) by the Gumbel-max
    trick."""
    u = torch.rand(logits.shape, generator=generator, dtype=torch.float32,
                   device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(1e-20)))
    return (logits.to(torch.float32) / temp + gumbel).argmax(dim=-1)


def make_sampler(name: str, *, temperature_value: float = 0.8,
                 generator: Optional[torch.Generator] = None
                 ) -> Callable[[torch.Tensor], torch.Tensor]:
    if name == "greedy":
        return greedy
    if name == "temperature":
        if generator is None:
            raise ValueError("temperature sampling needs a generator")
        return lambda lg: temperature(lg, generator, temperature_value)
    raise ValueError(f"unknown sampler {name!r}")


__all__ = ["greedy", "temperature", "make_sampler"]
