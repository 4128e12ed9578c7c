"""PyTorch port of the FP->BFP converters and the packed cache against the
JAX package: K1 (``bfp_quantize_kv_pair_kernel``) and K2
(``convert_prefill_cache_kernel``) plain versions against the Pallas kernels
run in interpret mode and against the XLA ``prefill_cache``, and the port's
in-place ``append_token`` against JAX's across the cache's seams.

Integer outputs must be byte-equal.  The one known exception is caveat A of
``ROADMAP.md``: groups whose absmax is exactly 2^13 or 2^15, where the
reference's ``floor(log2)`` is one low; those groups are built into the data
and their difference is asserted."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kvcache as jkv
from repro.kernels import ops as jops

from repro_torch.core import kvcache as tkv
from repro_torch.kernels import ops as tops
from repro_torch.interop import cache_from_jax

from test_torch_parity_helpers import region_mismatches, to_torch

RNG = np.random.default_rng(5)
B, H, D = 2, 2, 64
MAX_SEQ = 512


def _kv(S, scale=2.0):
    k = (RNG.normal(size=(B, S, H, D)) * scale).astype(np.float32)
    v = (RNG.normal(size=(B, S, H, D)) * scale).astype(np.float32)
    return k, v


def _plant_caveat_a(k, v):
    """Give one K group (token 1, head 0, channels 0..31) absmax 2^13 and one
    V group (group 0, head 1, channel 5) absmax 2^15; returns the masks of
    the K mantissa / exponent and V mantissa / exponent entries they own."""
    k[0, 1, 0, 3] = 8192.0
    v[1, 7, 1, 5] = -32768.0
    S = k.shape[1]
    km = np.zeros(k.shape, bool)
    km[0, 1, 0, :32] = True
    ke = np.zeros((B, S, H, D // 32), bool)
    ke[0, 1, 0, 0] = True
    vm = np.zeros(v.shape, bool)
    vm[1, :32, 1, 5] = True
    ve = np.zeros((B, S // 32, H, D), bool)
    ve[1, 0, 1, 5] = True
    return km, ke, vm, ve


def test_k1_quantize_kv_pair_bit_exact():
    k, v = _kv(160)
    masks = _plant_caveat_a(k, v)
    ref = jops.bfp_quantize_kv_pair(jnp.asarray(k), jnp.asarray(v), 8,
                                    interpret=True)
    got = tops.bfp_quantize_kv_pair(to_torch(k), to_torch(v), 8)
    for name, r, g, mask in zip(("k_mant", "k_exp", "v_mant", "v_exp"), ref,
                                got, masks):
        r, g = np.asarray(r), g.numpy()
        assert r.shape == g.shape and r.dtype == g.dtype, name
        np.testing.assert_array_equal(r[~mask], g[~mask], err_msg=name)
    # caveat A: the reference's exponent is one low, its mantissas clip
    assert got[1].numpy()[masks[1]].tolist() == [13]
    assert np.asarray(ref[1])[masks[1]].tolist() == [12]
    assert got[3].numpy()[masks[3]].tolist() == [15]
    assert np.asarray(ref[3])[masks[3]].tolist() == [14]


@pytest.mark.parametrize("S", [32, 96, 128, 480])
def test_k2_prefill_cache_regions_byte_equal(S):
    """All 12 regions, with online offsets, against both the Pallas
    converter (interpret mode) and the XLA ``prefill_cache``."""
    k, v = _kv(S)
    off = (RNG.normal(size=(B, H, D)) * 0.5).astype(np.float32)
    c = jkv.init_cache(B, H, D, MAX_SEQ)
    ref_x = jkv.prefill_cache(c, jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(off))
    ref_p = jkv.prefill_cache(c, jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(off), use_pallas=True,
                              interpret=True)
    got = tkv.prefill_cache(tkv.init_cache(B, H, D, MAX_SEQ), to_torch(k),
                            to_torch(v), to_torch(off))
    assert got.length == S
    assert region_mismatches(ref_x, got) == {}
    assert region_mismatches(ref_p, got) == {}


def test_k2_caveat_a_groups():
    """A K bulk token and a V ring group with absmax 2^13 / 2^15 (after the
    offsets): only their own exponent and mantissa bytes differ."""
    S = 160
    k, v = _kv(S)
    off = np.zeros((B, H, D), np.float32)
    k[1, 40, 1, 33] = 8192.0          # bulk slot 8, channel group 1
    v[0, 130, 0, 9] = 32768.0         # group 4 -> ring slot 0
    c = jkv.init_cache(B, H, D, MAX_SEQ)
    ref = jkv.prefill_cache(c, jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(off), use_pallas=True, interpret=True)
    got = tkv.prefill_cache(tkv.init_cache(B, H, D, MAX_SEQ), to_torch(k),
                            to_torch(v), to_torch(off))
    bad = region_mismatches(ref, got)
    assert set(bad) == {"k_bulk_mant", "k_bulk_exp", "v_local_mant",
                        "v_local_exp"}, bad
    assert got.k_bulk_exp[1, 8, 1, 1].item() == 13
    assert int(np.asarray(ref.k_bulk_exp)[1, 8, 1, 1]) == 12
    assert got.v_local_exp[0, 0, 0, 9].item() == 15
    assert int(np.asarray(ref.v_local_exp)[0, 0, 0, 9]) == 14
    assert bad["k_bulk_exp"] == 1 and bad["v_local_exp"] == 1
    assert bad["k_bulk_mant"] <= 16 and bad["v_local_mant"] <= 32


@pytest.mark.parametrize("S0,n_append", [(32, 110), (96, 75)])
def test_append_token_byte_equal_across_seams(S0, n_append):
    """Appends from prefill length S0 cross the token-32 hand-off to the
    ring (S0=32), the ring wrap and first K demotion (t=96), V-group commits
    with V demotion (t%32 == 31, group >= 3), and end on a partial group.
    The cache must be byte-equal after every append."""
    total = S0 + n_append
    k, v = _kv(total)
    off = (RNG.normal(size=(B, H, D)) * 0.5).astype(np.float32)
    jc = jkv.prefill_cache(jkv.init_cache(B, H, D, 256),
                           jnp.asarray(k[:, :S0]), jnp.asarray(v[:, :S0]),
                           jnp.asarray(off))
    tc = tkv.prefill_cache(tkv.init_cache(B, H, D, 256),
                           to_torch(k[:, :S0]), to_torch(v[:, :S0]),
                           to_torch(off))
    app = jax.jit(jkv.append_token)
    for t in range(S0, total):
        jc = app(jc, jnp.asarray(k[:, t]), jnp.asarray(v[:, t]))
        out = tkv.append_token(tc, to_torch(k[:, t]), to_torch(v[:, t]))
        assert out is tc and tc.length == t + 1 == int(jc.length)
        assert region_mismatches(jc, tc) == {}, t
    assert total % 32 != 0


def test_cache_bytes_match_reference():
    jc = jkv.init_cache(B, H, D, MAX_SEQ)
    tc = tkv.init_cache(B, H, D, MAX_SEQ)
    assert tkv.cache_bytes(tc) == jkv.cache_bytes(jc)
    assert cache_from_jax(jc).max_seq == tc.max_seq == MAX_SEQ


def test_wrappers_route_cpu_tensors_to_the_plain_versions():
    tops.reset_launch_counts()
    k, v = _kv(64)
    tops.bfp_quantize_kv_pair(to_torch(k), to_torch(v))
    assert tops.launch_counts() == {n: 0 for n in tops.KERNELS}
    with pytest.raises(ValueError, match="meta"):
        tops.bfp_quantize_kv_pair(to_torch(k), torch.empty(v.shape,
                                                           device="meta"))
