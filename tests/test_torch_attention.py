"""PyTorch port of the attention kernels' plain versions against the JAX
Pallas kernels (interpret mode): K3 (``bfp_attention_prefill_batched``)
and K4 (``bfp_attention_decode_asym_batched``, the single-launch decode).

Both sides dequantize the same packed bytes exactly and keep scores and P
in float32, so they differ only in summation order and in the last bits of
``exp``: the bound is 4e-6 of the output's largest magnitude (32 float32
ulps).  Each case prints its gap (``pytest -s``).  K4 is held to
that bound and not to bit-exactness (``ROADMAP.md`` caveat B: the
reference's own two decode forms differ by up to 1.9e-7)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import kvcache as jkv
from repro.kernels import ops as jops

from repro_torch.core import kvcache as tkv
from repro_torch.kernels import bfp_attention as tattn
from repro_torch.kernels import ops as tops
from repro_torch.interop import cache_from_jax

from test_torch_parity_helpers import rel_err, to_torch

REL_BOUND = 4e-6
RNG = np.random.default_rng(3)


def _packed_prefill(B, S, H, Hkv, D):
    q = RNG.normal(size=(B, S, H, D)).astype(np.float32)
    k = (RNG.normal(size=(B, S, Hkv, D)) * 2).astype(np.float32)
    v = RNG.normal(size=(B, S, Hkv, D)).astype(np.float32)
    km, ke, vm, ve = jops.bfp_quantize_kv_pair(jnp.asarray(k), jnp.asarray(v),
                                               8, interpret=True)
    return q, (km, ke, vm, ve)


@pytest.mark.parametrize("B,S,H,Hkv,D,cap,window", [
    (2, 96, 4, 2, 32, 0.0, 0),
    (1, 160, 8, 2, 64, 0.0, 0),
    (2, 128, 4, 1, 32, 30.0, 0),
    (1, 192, 4, 2, 32, 0.0, 64),
])
def test_k3_prefill_plain_vs_pallas(B, S, H, Hkv, D, cap, window):
    q, packed = _packed_prefill(B, S, H, Hkv, D)
    ref = jops.bfp_attention_prefill(jnp.asarray(q), *packed,
                                     mantissa_bits=8, causal=True,
                                     logit_cap=cap, window=window,
                                     block_q=64, block_s=64, interpret=True)
    got = tops.bfp_attention_prefill(to_torch(q),
                                     *(to_torch(x) for x in packed),
                                     causal=True, logit_cap=cap,
                                     window=window)
    assert got.shape == (B, S, H, D)
    err = rel_err(ref, got.numpy())
    print(f"relative error {err:.3e}")
    assert err < REL_BOUND


def _decode_case(S_pre, n_append, H, Hkv, D, max_seq=384):
    B = 2
    total = S_pre + n_append
    k = (RNG.normal(size=(B, total, Hkv, D)) * 2).astype(np.float32)
    v = RNG.normal(size=(B, total, Hkv, D)).astype(np.float32)
    off = (RNG.normal(size=(B, Hkv, D)) * 0.3).astype(np.float32)
    c = jkv.prefill_cache(jkv.init_cache(B, Hkv, D, max_seq),
                          jnp.asarray(k[:, :S_pre]),
                          jnp.asarray(v[:, :S_pre]), jnp.asarray(off))
    app = jax.jit(jkv.append_token)
    for t in range(S_pre, total):
        c = app(c, jnp.asarray(k[:, t]), jnp.asarray(v[:, t]))
    q = RNG.normal(size=(B, H, D)).astype(np.float32)
    return q, c


@pytest.mark.parametrize("S_pre,n_append,H,Hkv,D,cap,start", [
    (32, 1, 4, 2, 32, 0.0, None),       # one group: init + residual
    (64, 37, 4, 2, 32, 0.0, None),      # ring only, no bulk yet
    (128, 5, 4, 2, 64, 0.0, (0, 37)),   # bulk + band + left padding
    (256, 0, 8, 2, 32, 0.0, (5, 70)),   # group-aligned, empty residual
    (224, 43, 4, 1, 32, 30.0, None),    # softcap, rep 4, mid-group
    (320, 31, 4, 4, 64, 0.0, (100, 0)), # rep 1, a bulk tile fully padded
])
def test_k4_decode_plain_vs_single_launch(S_pre, n_append, H, Hkv, D, cap,
                                          start):
    q, c = _decode_case(S_pre, n_append, H, Hkv, D)
    st = None if start is None else np.asarray(start, np.int32)
    ref = jops.bfp_attention_decode_cache(
        jnp.asarray(q), c, None if st is None else jnp.asarray(st),
        logit_cap=cap, interpret=True)
    got = tops.bfp_attention_decode_cache(
        to_torch(q), cache_from_jax(c), None if st is None else to_torch(st),
        logit_cap=cap)
    assert got.shape == q.shape
    err = rel_err(ref, got.numpy())
    print(f"relative error {err:.3e}")
    assert err < REL_BOUND


def test_k4_position_order_matches_reference_gather():
    """The plain version's position-ordered dequantization equals the
    reference's ``gather_kv`` over every valid position (bit-exact: both
    are exact products of mantissas and powers of two)."""
    q, c = _decode_case(160, 45, 4, 2, 32)
    k_ref, v_ref, valid = jkv.gather_kv(c)
    k, v = tattn.cache_kv_in_position_order(cache_from_jax(c))
    L = int(valid.sum())
    assert k.shape[1] == v.shape[1] == L
    np.testing.assert_array_equal(np.asarray(k_ref)[:, :L], k.numpy())
    np.testing.assert_array_equal(np.asarray(v_ref)[:, :L], v.numpy())
