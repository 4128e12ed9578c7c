"""PyTorch port, numerics and configs against the JAX package: BFP
quantization, nibble packing, online smoothing offsets, INT4 weights, RMSNorm
and RoPE, config dataclasses — plus the port's package rules (no JAX
imports, entry points on the GPU unless the caller asks for the CPU)."""
import ast
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch
from repro.core import bfp as jbfp
from repro.core import quant_config as jqc
from repro.core.smoothing import compute_online_offsets as j_offsets
from repro.layers import common as jcommon
from repro.layers.rope import apply_rope as j_rope
from repro.quant import int4 as jint4

from repro_torch.configs import get_arch as t_get_arch
from repro_torch.core import bfp as tbfp
from repro_torch.core import quant_config as tqc
from repro_torch.core.smoothing import compute_online_offsets as t_offsets
from repro_torch.layers import common as tcommon
from repro_torch.layers.rope import apply_rope as t_rope
from repro_torch.quant import int4 as tint4

from test_torch_parity_helpers import rel_err, to_torch

ROOT = Path(__file__).resolve().parents[1]
RNG = np.random.default_rng(11)


def _x(*shape, scale=3.0):
    return (RNG.normal(size=shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("recipe", sorted(jqc.RECIPES))
def test_recipes_equal_reference(recipe):
    assert dataclasses.asdict(tqc.get_recipe(recipe)) == \
        dataclasses.asdict(jqc.get_recipe(recipe))


@pytest.mark.parametrize("which", ["config", "smoke"])
def test_model_configs_equal_reference(which):
    j = getattr(get_arch("harmonia-llama3.1-8b"), which)
    t = getattr(t_get_arch("harmonia-llama3.1-8b"), which)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.param_count() == j.param_count()


# ---------------------------------------------------------------------------
# BFP numerics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bits,rounding,axis", [
    (8, "trunc", -1), (4, "trunc", -1), (8, "nearest", -1), (6, "trunc", 1),
    (4, "nearest", 0)])
def test_bfp_quantize_and_fake_quant_bit_exact(bits, rounding, axis):
    x = _x(3, 70, 64)            # ragged along axis 1 (70 = 2*32 + 6)
    jm, je = jbfp.bfp_quantize(jnp.asarray(x), 32, bits, rounding, axis)
    tm, te = tbfp.bfp_quantize(to_torch(x), 32, bits, rounding, axis)
    np.testing.assert_array_equal(np.asarray(jm), tm.numpy())
    np.testing.assert_array_equal(np.asarray(je), te.numpy())
    jf = jbfp.bfp_fake_quant(jnp.asarray(x), 32, bits, rounding, axis)
    tf = tbfp.bfp_fake_quant(to_torch(x), 32, bits, rounding, axis)
    np.testing.assert_array_equal(np.asarray(jf), tf.numpy())
    n = x.shape[axis]
    jd = jbfp.bfp_dequantize(jm, je, n, 32, bits, axis, ndim=x.ndim)
    td = tbfp.bfp_dequantize(tm, te, n, bits, axis, ndim=x.ndim)
    np.testing.assert_array_equal(np.asarray(jd), td.numpy())
    np.testing.assert_array_equal(td.numpy(), tf.numpy())


def test_bfp_bf16_fake_quant_bit_exact():
    x = _x(4, 256)
    jf = jbfp.quant_per_token(jnp.asarray(x, jnp.bfloat16))
    tf = tbfp.quant_per_token(to_torch(x).to(torch.bfloat16))
    np.testing.assert_array_equal(np.asarray(jf.astype(jnp.float32)),
                                  tf.float().numpy())


def test_quant_v_cache_bit_exact():
    x = _x(2, 45, 3, 32)         # token axis -3 with a partial group
    jf = jbfp.quant_v_cache(jnp.asarray(x), token_axis=1)
    tf = tbfp.quant_v_cache(to_torch(x), token_axis=1)
    np.testing.assert_array_equal(np.asarray(jf), tf.numpy())


def test_shared_exponent_caveat_a():
    """The port's exponent is exact at every power of two; the reference's
    floor(log2) is one low at 2^13 and 2^15 on XLA's CPU (ROADMAP caveat A).
    Groups with those maxima are the only ones that differ."""
    powers = np.arange(-14, 16)
    x = np.zeros((len(powers), 32), np.float32)
    x[:, 0] = 2.0 ** powers
    x[:, 1:] = 0.3 * x[:, :1] * RNG.uniform(-1, 1, (len(powers), 31))
    te = tbfp.bfp_quantize(to_torch(x))[1][:, 0].numpy()
    np.testing.assert_array_equal(te, powers)
    je = np.asarray(jbfp.bfp_quantize(jnp.asarray(x))[1])[:, 0]
    differ = powers[je != te]
    assert set(differ.tolist()) <= {13, 15}
    for p in differ:
        assert je[powers == p][0] == p - 1


def test_exp2_caveat_e():
    """Groups with absmax in [2^-7, 2^-6) have the 8-bit step 2^-13, which
    the reference builds with ``jnp.exp2(-13.0)``, one not quite a power of
    two on XLA's CPU (ROADMAP caveat E).  Already-quantized values: the
    port's fake quantization returns them unchanged, the reference's moves
    them by less than 1e-6 of the group maximum."""
    mant = RNG.integers(-127, 128, size=(4, 32)).astype(np.float32)
    mant[:, 0] = 100.0
    x = mant * np.float32(2.0 ** -13)
    tf = tbfp.bfp_fake_quant(to_torch(x)).numpy()
    jf = np.asarray(jbfp.bfp_fake_quant(jnp.asarray(x)))
    np.testing.assert_array_equal(tf, x)
    assert not np.array_equal(jf, x)
    assert rel_err(x, jf) < 1e-6
    np.testing.assert_array_equal(np.asarray(jbfp.bfp_quantize(
        jnp.asarray(x))[1]), tbfp.bfp_quantize(to_torch(x))[1].numpy())


def test_pack_unpack_int4_roundtrip_and_parity():
    m = RNG.integers(-8, 8, size=(6, 10, 4)).astype(np.int8)
    for axis in (0, 1, -1):
        if m.shape[axis] % 2:
            continue
        jp = jbfp.pack_int4(jnp.asarray(m), axis)
        tp = tbfp.pack_int4(to_torch(m), axis)
        np.testing.assert_array_equal(np.asarray(jp), tp.numpy())
        np.testing.assert_array_equal(tbfp.unpack_int4(tp, axis).numpy(), m)


def test_online_offsets_bit_exact():
    k = _x(2, 32, 3, 64)
    k[0, 5, 1, 7] = 40.0          # an outlier channel
    k[1, :, 0, 3] = 2.5           # a channel of ties: the first index wins
    jo = j_offsets(jnp.asarray(k), 16)
    to = t_offsets(to_torch(k), 16)
    np.testing.assert_array_equal(np.asarray(jo), to.numpy())
    assert (to.numpy() != 0).sum(-1).min() >= 16


# ---------------------------------------------------------------------------
# Weights and dense layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_weight_and_dequant_bit_exact(dtype):
    w = _x(256, 96, scale=0.05)
    jw = jnp.asarray(w, dtype)
    tw = to_torch(w).to(getattr(torch, dtype))
    jq = jint4.quantize_weight(jw)
    tq = tint4.quantize_weight(tw)
    np.testing.assert_array_equal(np.asarray(jq.packed), tq.packed.numpy())
    np.testing.assert_array_equal(np.asarray(jq.scale), tq.scale.numpy())
    jd = jcommon.weight_dequant(jq, jnp.float32)
    td = tcommon.weight_dequant(tq, torch.float32)
    np.testing.assert_array_equal(np.asarray(jd), td.numpy())


def test_qlinear_bit_exact_at_prefill_shape():
    """BFP8 activations x INT4 weights: the product is bit-exact on the CPU
    at prefill shapes (both libraries take the same GEMM summation order
    there; at one-row decode shapes the order differs in the last bit)."""
    x = _x(2, 160, 128, scale=1.0)
    w = jint4.quantize_weight(jnp.asarray(_x(128, 64, scale=0.1)))
    tw = tcommon.QuantizedWeight(to_torch(w.packed), to_torch(w.scale))
    q = jqc.harmonia(4)
    jy = jcommon.qlinear(jnp.asarray(x), w, q)
    ty = tcommon.qlinear(to_torch(x), tw, tqc.harmonia(4))
    np.testing.assert_array_equal(np.asarray(jy), ty.numpy())


def test_rms_norm_and_rope_close():
    """Transcendentals and reductions round differently in XLA and PyTorch;
    both stay within 4 float32 ulps of the output scale."""
    x = _x(2, 64, 4, 32, scale=1.0)
    pos = np.arange(64)[None].repeat(2, 0)
    jr = j_rope(jnp.asarray(x), jnp.asarray(pos), 500000.0)
    tr = t_rope(to_torch(x), to_torch(pos), 500000.0)
    assert rel_err(jr, tr) < 4 * 2.0 ** -23 * 8
    s = _x(128, scale=1.0)
    jn = jcommon.rms_norm(jnp.asarray(x[..., 0, :].reshape(2, 64, 32)),
                          jnp.asarray(s[:32]))
    tn = tcommon.rms_norm(to_torch(x[..., 0, :].reshape(2, 64, 32)),
                          to_torch(s[:32]))
    assert rel_err(jn, tn) < 4 * 2.0 ** -23


# ---------------------------------------------------------------------------
# Package rules
# ---------------------------------------------------------------------------

def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module


def test_port_imports_neither_jax_nor_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    bad = [(f.relative_to(ROOT), m) for f in files
           for m in _imported_modules(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad


def test_entry_points_default_to_the_gpu(monkeypatch):
    from repro_torch.device import resolve_device
    from repro_torch.models.init import init_params
    cfg = t_get_arch("harmonia-llama3.1-8b").smoke
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(cfg)
    params = init_params(cfg, device="cpu")
    assert params["embed"].device.type == "cpu"
