"""Dense GQA decoder on the serving path — the port of ``repro.models.lm``'s
``prefill``, ``decode_step`` and ``generate_loop`` for the ``attn`` block
kind, as the JAX package runs them with ``use_pallas=True``.

Prefill runs embed -> per layer (RMSNorm -> BFP x INT4 Q/K/V -> RoPE ->
K1 + K3 attention -> O projection -> gated MLP) -> final norm -> LM head on
the last position, and builds each layer's packed cache with K2 (after the
online K offsets of the first 32 tokens).  A decode step appends the new
K/V to each layer's cache in place (with demotion) and runs K4.  Layers run
in a Python loop; the decode loop is a Python loop as well.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional

import torch

from repro_torch.core import kvcache
from repro_torch.core.quant_config import QuantConfig
from repro_torch.core.smoothing import compute_online_offsets
from repro_torch.layers.attention import attention_decode, attention_prefill
from repro_torch.layers.common import embed_lookup, qlinear, rms_norm
from repro_torch.layers.mlp import gated_mlp
from repro_torch.layers.rope import apply_rope
from repro_torch.models.config import ModelConfig


def _online(quant: Optional[QuantConfig]) -> bool:
    return (quant is not None and quant.enabled and quant.quant_attention
            and quant.smoothing.online)


def _attn_block(h: torch.Tensor, p: Dict, cfg: ModelConfig,
                quant: Optional[QuantConfig], positions: torch.Tensor,
                cache: Optional[kvcache.AsymKVCache], *, max_seq: int = 0,
                pad_prefix: Optional[torch.Tensor] = None):
    """One attention block in ``prefill`` (``cache`` None: builds it) or
    ``decode`` mode (appends to ``cache`` in place).  Returns (h, cache)."""
    B, S, _ = h.shape
    x = rms_norm(h, p["ln1"], cfg.norm_eps, cfg.zero_centered_norm)
    q = qlinear(x, p["wq"], quant).reshape(B, S, cfg.n_heads, cfg.head_dim)
    k = qlinear(x, p["wk"], quant).reshape(B, S, cfg.n_kv_heads,
                                           cfg.head_dim)
    v = qlinear(x, p["wv"], quant).reshape(B, S, cfg.n_kv_heads,
                                           cfg.head_dim)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)

    if cache is None:
        if S % kvcache.GROUP or cfg.head_dim % kvcache.GROUP:
            raise ValueError(f"prefill needs S ({S}) and head_dim "
                             f"({cfg.head_dim}) multiples of 32")
        attn = attention_prefill(q, k, v, causal=True,
                                 logit_cap=cfg.attn_logit_softcap,
                                 quant=quant)
        off = None
        if _online(quant):
            w = min(quant.smoothing.online_window, S)
            off = compute_online_offsets(k[:, :w].to(torch.float32),
                                         quant.smoothing.online_topk)
        cache = kvcache.prefill_cache(
            kvcache.init_cache(B, cfg.n_kv_heads, cfg.head_dim, max_seq,
                               device=h.device),
            k.to(torch.float32), v.to(torch.float32), off)
    else:
        kvcache.append_token(cache, k[:, 0], v[:, 0])
        attn = attention_decode(q, cache, logit_cap=cfg.attn_logit_softcap,
                                quant=quant, pad_prefix=pad_prefix)

    attn = attn.to(h.dtype).reshape(B, S, cfg.q_dim)
    h = h + qlinear(attn, p["wo"], quant)
    x = rms_norm(h, p["ln2"], cfg.norm_eps, cfg.zero_centered_norm)
    return h + gated_mlp(x, p, cfg.act_fn, quant), cache


def _head(params: Dict, cfg: ModelConfig, h: torch.Tensor,
          quant: Optional[QuantConfig]) -> torch.Tensor:
    h = rms_norm(h, params["final_norm"], cfg.norm_eps,
                 cfg.zero_centered_norm)
    if cfg.tie_embeddings:
        logits = torch.matmul(h, params["embed"].to(h.dtype).T)
    else:
        logits = qlinear(h, params["lm_head"], quant)
    if cfg.final_logit_softcap > 0:
        cap = cfg.final_logit_softcap
        logits = (cap * torch.tanh(logits.to(torch.float32) / cap)
                  ).to(logits.dtype)
    return logits


def prefill(params: Dict, cfg: ModelConfig, tokens: torch.Tensor, *,
            max_seq: int, quant: Optional[QuantConfig] = None):
    """tokens (B, S) -> (logits of the last position (B, V), one packed
    cache per layer)."""
    B, S = tokens.shape
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    h = embed_lookup(tokens, params["embed"])
    caches: List[kvcache.AsymKVCache] = []
    for p in params["layers"]:
        h, c = _attn_block(h, p, cfg, quant, positions, None,
                           max_seq=max_seq)
        caches.append(c)
    return _head(params, cfg, h[:, -1:], quant)[:, 0], caches


def decode_step(params: Dict, cfg: ModelConfig, token: torch.Tensor,
                caches: List[kvcache.AsymKVCache], *,
                quant: Optional[QuantConfig] = None,
                pad_prefix: Optional[torch.Tensor] = None) -> torch.Tensor:
    """token (B,) at position ``caches[0].length`` -> logits (B, V).  The
    caches are updated in place."""
    B = token.shape[0]
    t = caches[0].length
    positions = torch.full((B, 1), t, dtype=torch.int64, device=token.device)
    h = embed_lookup(token[:, None], params["embed"])
    for p, c in zip(params["layers"], caches):
        h, _ = _attn_block(h, p, cfg, quant, positions, c,
                           pad_prefix=pad_prefix)
    return _head(params, cfg, h, quant)[:, 0]


def generate_loop(params: Dict, cfg: ModelConfig,
                  caches: List[kvcache.AsymKVCache], *, num_steps: int,
                  logits0: torch.Tensor,
                  sample_fn: Optional[Callable] = None,
                  eos_id: Optional[int] = None,
                  quant: Optional[QuantConfig] = None,
                  pad_prefix: Optional[torch.Tensor] = None) -> Dict:
    """Emit ``num_steps`` tokens per row: the first sampled from the prefill
    logits, then ``num_steps - 1`` decode steps.  With ``eos_id`` set, a row
    that has emitted EOS keeps stepping (the rows share one position
    counter) but its fed-back and emitted tokens stay ``eos_id``.

    ``sample_fn(logits) -> (B,) int64`` defaults to greedy.  Returns
    {"tokens": (B, num_steps), "finished": (B,) bool, "last_tok": (B,)}."""
    if num_steps < 1:
        raise ValueError(f"num_steps must be >= 1, got {num_steps}")
    if sample_fn is None:
        def sample_fn(lg):
            return lg.argmax(dim=-1)
    finished = torch.zeros(logits0.shape[0], dtype=torch.bool,
                           device=logits0.device)

    def emit(logits, finished):
        tok = sample_fn(logits)
        if eos_id is not None:
            tok = torch.where(finished, eos_id, tok)
            finished = finished | (tok == eos_id)
        return tok, finished

    tok, finished = emit(logits0, finished)
    out = [tok]
    for _ in range(num_steps - 1):
        logits = decode_step(params, cfg, tok, caches, quant=quant,
                             pad_prefix=pad_prefix)
        tok, finished = emit(logits, finished)
        out.append(tok)
    return {"tokens": torch.stack(out, dim=1), "finished": finished,
            "last_tok": tok}


__all__ = ["prefill", "decode_step", "generate_loop"]
