"""ModelConfig — one dataclass that spans all assigned architectures.

A copy of ``repro.models.config``, so that the port needs no JAX.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # layer pattern, tiled to n_layers (remainder blocks use its prefix)
    block_pattern: Tuple[str, ...] = ("attn",)   # attn|local_attn|ssd|rglru
    mixer_only: bool = False          # mamba2: block = mixer, no MLP
    window_size: int = 4096           # local-attention window
    attn_logit_softcap: float = 0.0   # gemma2: 50.0
    final_logit_softcap: float = 0.0  # gemma2: 30.0
    qkv_bias: bool = False            # qwen2.5
    rope_theta: float = 10000.0
    pos_embed: str = "rope"           # rope | sinusoidal | none
    act_fn: str = "silu"
    mlp_style: str = "gated"          # gated | plain (whisper)
    norm_type: str = "rms"            # rms | layer
    norm_eps: float = 1e-6
    zero_centered_norm: bool = False  # gemma (1 + w)
    post_block_norm: bool = False     # gemma2 post-attn/post-mlp norms
    embed_scale: bool = False         # gemma: embeddings * sqrt(d)
    tie_embeddings: bool = True

    # MoE
    n_experts: int = 0
    moe_top_k: int = 0
    shared_expert: bool = False       # llama4-style always-on expert
    capacity_factor: float = 1.25

    # SSM (mamba2)
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_groups: int = 1
    ssm_expand: int = 2

    # RG-LRU (recurrentgemma)
    lru_width: int = 0
    lru_blocks: int = 16

    # encoder-decoder (whisper)
    encoder_layers: int = 0
    encoder_tokens: int = 0           # precomputed frame embeddings length
    cross_attention: bool = False

    # modality frontends (stubs per task spec)
    frontend: str = "none"            # none | audio_stub | vision_stub
    n_frontend_tokens: int = 0        # vision tokens prepended to the LM

    param_dtype: str = "bfloat16"     # bfloat16 (big cfgs) | float32 (smoke)

    @property
    def ssm_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def is_encoder_decoder(self) -> bool:
        return self.encoder_layers > 0

    @property
    def attention_free(self) -> bool:
        return all(k in ("ssd", "rglru") for k in self.block_pattern)

    @property
    def sub_quadratic(self) -> bool:
        """True when no block does full-context O(S^2) attention."""
        return all(k in ("ssd", "rglru", "local_attn")
                   for k in self.block_pattern)

    def pattern_layout(self):
        """(n_repeats, remainder_kinds) for scan-over-pattern execution."""
        p = len(self.block_pattern)
        return self.n_layers // p, self.block_pattern[: self.n_layers % p]

    def kind_counts(self) -> dict:
        n_rep, rem = self.pattern_layout()
        counts: dict = {}
        for k in self.block_pattern:
            counts[k] = counts.get(k, 0) + n_rep
        for k in rem:
            counts[k] = counts.get(k, 0) + 1
        return counts

    def param_count(self) -> int:
        """Analytic parameter count (for roofline MODEL_FLOPS)."""
        d, ff, V = self.d_model, self.d_ff, self.vocab_size
        total = V * d  # embed
        if not self.tie_embeddings:
            total += d * V
        for kind, n in self.kind_counts().items():
            if kind in ("attn", "local_attn"):
                blk = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
                if self.cross_attention:
                    blk *= 2
                if not self.mixer_only:
                    if self.n_experts:
                        e = self.n_experts * 3 * d * ff + d * self.n_experts
                        if self.shared_expert:
                            e += 3 * d * ff
                        blk += e
                    elif self.mlp_style == "gated":
                        blk += 3 * d * ff
                    else:
                        blk += 2 * d * ff
            elif kind == "ssd":
                di, N, H = self.ssm_inner, self.ssm_state, self.ssm_heads
                blk = d * (2 * di + 2 * self.ssm_groups * N + H) + di * d
            elif kind == "rglru":
                w = self.lru_width
                blk = 2 * d * w + w * d
                blk += 2 * self.lru_blocks * (w // self.lru_blocks) ** 2
                if not self.mixer_only:
                    blk += 3 * d * ff
            else:
                raise ValueError(kind)
            total += n * blk
        if self.encoder_layers:
            enc_blk = 4 * d * self.q_dim + \
                (3 if self.mlp_style == "gated" else 2) * d * ff
            total += self.encoder_layers * enc_blk
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k + shared experts only)."""
        if not self.n_experts:
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        n_attn = sum(n for k, n in self.kind_counts().items()
                     if k in ("attn", "local_attn"))
        inactive = (self.n_experts - self.moe_top_k) * 3 * d * ff * n_attn
        return self.param_count() - inactive


__all__ = ["ModelConfig"]
