"""Parameter initialization — the port of ``repro.models.init`` for the
``attn`` block kind.

The tree is a dict: ``embed`` (vocab, d), ``final_norm`` (d), ``lm_head``
(d, vocab) unless embeddings are tied, and ``layers``, one dict per layer
with ``ln1``, ``wq``, ``wk``, ``wv``, ``wo``, ``ln2``, ``w_gate``, ``w_up``,
``w_down``.  Every weight is (in_dim, out_dim).  Draws come from a seeded
``torch.Generator`` on the target device, so a full-size model is made
where it runs; the numbers differ from ``jax.random``'s
(``interop.params_from_jax`` converts the JAX tree for parity tests).
"""
from __future__ import annotations

import math
from typing import Dict

import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[cfg.param_dtype]


def _check_supported(cfg: ModelConfig) -> None:
    unsupported = []
    if set(cfg.block_pattern) != {"attn"}:
        unsupported.append(f"block_pattern {cfg.block_pattern}")
    if cfg.n_experts or cfg.mlp_style != "gated" or cfg.mixer_only:
        unsupported.append("non-gated or MoE MLP")
    if cfg.act_fn != "silu":
        unsupported.append(f"act_fn {cfg.act_fn!r}")
    if cfg.norm_type != "rms" or cfg.qkv_bias or cfg.post_block_norm:
        unsupported.append("layer norm, qkv bias or post-block norms")
    if cfg.cross_attention or cfg.frontend != "none" or cfg.embed_scale:
        unsupported.append("cross-attention, frontends or embed scaling")
    if cfg.pos_embed != "rope":
        unsupported.append(f"pos_embed {cfg.pos_embed!r}")
    if unsupported:
        raise NotImplementedError(
            f"{cfg.name}: the port serves dense GQA decoders only; "
            f"unsupported: {', '.join(unsupported)}")


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> Dict:
    """Random parameters for ``cfg`` from ``seed``, on ``device`` (the GPU
    unless the caller passes ``device="cpu"``)."""
    _check_supported(cfg)
    dev = resolve_device(device)
    dt = _dtype(cfg)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def normal(*shape, scale):
        x = torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=dev)
        return (x * scale).to(dt)

    def dense(fan_in, fan_out):
        return normal(fan_in, fan_out, scale=1.0 / math.sqrt(fan_in))

    def ones(n):
        return torch.ones((n,), dtype=dt, device=dev)

    d = cfg.d_model
    params: Dict = {"embed": normal(cfg.vocab_size, d, scale=0.02),
                    "final_norm": ones(d)}
    if not cfg.tie_embeddings:
        params["lm_head"] = dense(d, cfg.vocab_size)
    params["layers"] = [{
        "ln1": ones(d),
        "wq": dense(d, cfg.q_dim), "wk": dense(d, cfg.kv_dim),
        "wv": dense(d, cfg.kv_dim), "wo": dense(cfg.q_dim, d),
        "ln2": ones(d),
        "w_gate": dense(d, cfg.d_ff), "w_up": dense(d, cfg.d_ff),
        "w_down": dense(cfg.d_ff, d),
    } for _ in range(cfg.n_layers)]
    return params


def to_device(tree, device):
    """A copy of a parameter tree (dicts, lists, ``QuantizedWeight``s of
    tensors) on ``device``."""
    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_device(v, device) for v in tree]
    if isinstance(tree, tuple):
        return type(tree)(*(to_device(v, device) for v in tree))
    return tree.to(device)


__all__ = ["init_params", "to_device"]
