"""Quantization configuration — which sites get BFP, at what precision.

A copy of ``repro.core.quant_config``: the PyTorch port imports nothing of
the JAX package, and ``repro.core`` imports JAX when it is loaded.

The paper's final configuration ("Harmonia"):
  * group size 32, 5-bit shared exponent everywhere,
  * 8-bit mantissas for all activations (linear inputs, Q, K, V-fresh,
    attention scores P),
  * KV cache: asymmetric — initial 32 tokens and local (most recent) 64
    tokens at 8-bit mantissa, everything else at 4-bit,
  * INT4 weights (group 128, OmniQuant-style),
  * offline per-channel K smoothing folded into W_Q / W_K,
  * online per-channel K offsets from the initial 32-token window (top-k
    channels, offset = value-at-max/2).

Baselines from Table I are expressible as other instances of this config
(FIGNA ≈ BFP16 activations / FP16 attention; Anda-m{4,6,8} ≈ BFPx linear
activations / FP16 attention; Harmonia-Naïve = Harmonia minus asymmetric
allocation and smoothing).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class KvQuantConfig:
    """Asymmetric KV-cache quantization policy (paper Sec. III-B)."""

    mantissa_bits: int = 4            # bulk-of-sequence precision
    high_mantissa_bits: int = 8       # initial + local token precision
    initial_tokens: int = 32          # "attention sink" region
    local_tokens: int = 64            # most-recent window
    asymmetric: bool = True           # False => flat `mantissa_bits` for all
    group_size: int = 32

    def storage_fraction(self, seq_len: int) -> float:
        """Fraction of FP16 storage used at a given sequence length,
        in the paper's accounting: mantissa + ~1 bit/value of shared-
        exponent + metadata overhead (their 68.75% reduction at m4 means
        5 bits/value; the asymmetric 4K-seq figure 3.05x -> 32.8% is
        0.976*(4+1) + 0.024*(8+1) bits)."""
        ovh = 1.0
        if self.mantissa_bits >= 16:
            return 1.0
        if not self.asymmetric:
            return (self.mantissa_bits + ovh) / 16.0
        hi = min(self.initial_tokens + self.local_tokens, seq_len)
        lo = max(seq_len - hi, 0)
        bits = (hi * (self.high_mantissa_bits + ovh)
                + lo * (self.mantissa_bits + ovh))
        return bits / (seq_len * 16.0)


@dataclasses.dataclass(frozen=True)
class SmoothingConfig:
    """Offline-online hybrid outlier smoothing (paper Sec. III-C)."""

    offline: bool = True        # learned per-channel scale folded into W_Q/W_K
    online: bool = True         # per-channel K offsets (softmax shift-invar.)
    online_topk: int = 16       # channels that receive a non-zero offset
    online_window: int = 32     # initial-token window for offset selection
    calib_steps: int = 100      # offline calibration iterations
    calib_lr: float = 5e-3


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Full model quantization recipe."""

    enabled: bool = True

    # --- activations (BFP) ---
    group_size: int = 32
    act_mantissa_bits: int = 8        # linear inputs, Q, K, fresh V
    score_mantissa_bits: int = 8      # post-softmax attention scores P
    rounding: str = "trunc"           # "trunc" (paper) | "nearest" (beyond)
    quant_linear_acts: bool = True    # BFP on linear-layer inputs
    quant_attention: bool = True      # BFP on Q/K/V/P (paper's key extension)
    ste: bool = False                 # straight-through grads (calibration)

    # --- weights (INT) ---
    weight_bits: int = 4
    weight_group_size: int = 128      # OmniQuant setting used in the paper
    quant_weights: bool = True

    # --- KV cache ---
    kv: KvQuantConfig = dataclasses.field(default_factory=KvQuantConfig)

    # --- smoothing ---
    smoothing: SmoothingConfig = dataclasses.field(
        default_factory=SmoothingConfig)

    def replace(self, **kw) -> "QuantConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Named recipes (Table I rows)
# ---------------------------------------------------------------------------

def full_precision() -> QuantConfig:
    return QuantConfig(enabled=False)


def weight_only_int4() -> QuantConfig:
    """Omniquant row: INT4 weights, FP16 activations everywhere."""
    return QuantConfig(quant_linear_acts=False, quant_attention=False,
                       kv=KvQuantConfig(mantissa_bits=16,
                                        high_mantissa_bits=16,
                                        asymmetric=False))


def figna_like() -> QuantConfig:
    """FIGNA: BFP-16-ish linear activations (lossless-extended mantissa),
    FP16 attention + KV."""
    return QuantConfig(act_mantissa_bits=16, quant_attention=False,
                       kv=KvQuantConfig(mantissa_bits=16,
                                        high_mantissa_bits=16,
                                        asymmetric=False))


def anda_like(mantissa_bits: int) -> QuantConfig:
    """Anda-m{x}: BFPx linear activations, FP16 attention + KV."""
    return QuantConfig(act_mantissa_bits=mantissa_bits,
                       quant_attention=False,
                       kv=KvQuantConfig(mantissa_bits=16,
                                        high_mantissa_bits=16,
                                        asymmetric=False))


def harmonia(kv_mantissa_bits: int = 4) -> QuantConfig:
    """The paper's full recipe. kv_mantissa_bits=8 is the conservative row."""
    return QuantConfig(kv=KvQuantConfig(mantissa_bits=kv_mantissa_bits))


def harmonia_naive(kv_mantissa_bits: int = 4) -> QuantConfig:
    """Ablation: no asymmetric allocation, no smoothing (Table II row)."""
    return QuantConfig(
        kv=KvQuantConfig(mantissa_bits=kv_mantissa_bits, asymmetric=False),
        smoothing=SmoothingConfig(offline=False, online=False))


RECIPES = {
    "full": full_precision,
    "weight_only_int4": weight_only_int4,
    "figna": figna_like,
    "anda_m4": lambda: anda_like(4),
    "anda_m6": lambda: anda_like(6),
    "anda_m8": lambda: anda_like(8),
    "harmonia_kv8": lambda: harmonia(8),
    "harmonia_kv4": lambda: harmonia(4),
    "harmonia_naive_kv4": lambda: harmonia_naive(4),
}


def get_recipe(name: str) -> QuantConfig:
    if name not in RECIPES:
        raise KeyError(f"unknown quant recipe {name!r}; "
                       f"available: {sorted(RECIPES)}")
    return RECIPES[name]()


__all__ = ["QuantConfig", "KvQuantConfig", "SmoothingConfig", "RECIPES",
           "get_recipe", "full_precision", "weight_only_int4", "figna_like",
           "anda_like", "harmonia", "harmonia_naive"]
