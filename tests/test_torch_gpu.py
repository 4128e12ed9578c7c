"""The port's CUDA kernels against their plain PyTorch versions on the GPU.

Marked ``gpu``: each test asks the ``cuda`` fixture for the card and skips
with a reason where there is none.  On the machine with the card:

  python -m pytest -m gpu tests/test_torch_gpu.py

This file imports no JAX (the GPU machine has none).  K1 and K2 must be
bit-exact; K3 and K4 within ``REL_BOUND`` (float32 sums in another order and
the device's ``expf``)."""
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.core import kvcache
from repro_torch.kernels import bfp_attention as A
from repro_torch.kernels import bfp_quant as Q
from repro_torch.kernels import ops

pytestmark = pytest.mark.gpu

REL_BOUND = 4e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _rand(*shape, seed=0, scale=1.0, device="cuda"):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return (torch.randn(shape, generator=g) * scale).to(device)


def _rel(ref, got):
    return float((ref.double() - got.double()).abs().max()
                 / ref.double().abs().max())


@pytest.mark.parametrize("S,H,D", [(96, 2, 32), (160, 8, 128)])
def test_k1_bit_exact(cuda, S, H, D):
    k, v = _rand(2, S, H, D, seed=1, scale=3), _rand(2, S, H, D, seed=2)
    k[0, 1, 0, 3] = 8192.0                    # exact power of two
    got = Q.quantize_kv_pair_cuda(k, v)
    ref = Q.quantize_kv_pair_plain(k, v)
    for r, g in zip(ref, got):
        assert torch.equal(r, g)


@pytest.mark.parametrize("S", [32, 64, 96, 128, 480])
def test_k2_bit_exact(cuda, S):
    B, H, D = 2, 2, 64
    k, v = _rand(B, S, H, D, seed=S), _rand(B, S, H, D, seed=S + 1)
    off = _rand(B, H, D, seed=3, scale=0.3)
    got = Q.convert_prefill_cache_cuda(k, v, off, 480)
    ref = Q.convert_prefill_cache_plain(k, v, off, 480)
    for name in ref:
        assert torch.equal(ref[name], got[name]), name


@pytest.mark.parametrize("S,H,Hkv,D,cap,window", [
    (96, 4, 2, 32, 0.0, 0), (256, 32, 8, 128, 0.0, 0),
    (128, 4, 1, 64, 30.0, 0), (192, 4, 2, 32, 0.0, 64)])
def test_k3_within_bound(cuda, S, H, Hkv, D, cap, window):
    q = _rand(2, S, H, D, seed=4)
    packed = Q.quantize_kv_pair_cuda(_rand(2, S, Hkv, D, seed=5, scale=2),
                                     _rand(2, S, Hkv, D, seed=6))
    kw = dict(causal=True, logit_cap=cap, window=window)
    got = A.attention_prefill_cuda(q, *packed, **kw)
    ref = A.attention_prefill_plain(q, *packed, **kw)
    assert _rel(ref, got) < REL_BOUND


@pytest.mark.parametrize("S_pre,n_append,H,Hkv,D,cap", [
    (32, 1, 4, 2, 32, 0.0), (64, 37, 4, 2, 32, 0.0),
    (256, 75, 32, 8, 128, 0.0), (224, 43, 4, 1, 32, 30.0),
    (320, 31, 4, 4, 64, 0.0)])
def test_k4_within_bound(cuda, S_pre, n_append, H, Hkv, D, cap):
    B, total = 2, S_pre + n_append
    k, v = _rand(B, total, Hkv, D, seed=7, scale=2), _rand(B, total, Hkv, D,
                                                          seed=8)
    c = kvcache.prefill_cache(kvcache.init_cache(B, Hkv, D, 512, cuda),
                              k[:, :S_pre], v[:, :S_pre],
                              _rand(B, Hkv, D, seed=9, scale=0.3))
    for t in range(S_pre, total):
        kvcache.append_token(c, k[:, t], v[:, t])
    q = _rand(B, H, D, seed=10)
    start = torch.tensor([0, min(total - 1, 70)], dtype=torch.int32,
                         device=cuda)
    for st in (None, start):
        got = A.attention_decode_cache_cuda(q, c, st, logit_cap=cap)
        ref = A.attention_decode_cache_plain(q, c, st, logit_cap=cap)
        assert _rel(ref, got) < REL_BOUND


def test_wrappers_launch_and_count(cuda):
    ops.reset_launch_counts()
    k, v = _rand(1, 64, 2, 32, seed=11), _rand(1, 64, 2, 32, seed=12)
    packed = ops.bfp_quantize_kv_pair(k, v)
    ops.bfp_attention_prefill(_rand(1, 64, 4, 32, seed=13), *packed)
    c = kvcache.prefill_cache(kvcache.init_cache(1, 2, 32, 256, cuda), k, v)
    ops.bfp_attention_decode_cache(_rand(1, 4, 32, seed=14), c)
    assert ops.launch_counts() == {n: 1 for n in ops.KERNELS}
    with pytest.raises(ValueError, match="contiguous"):
        Q.quantize_kv_pair_cuda(k.transpose(1, 2).contiguous()
                                .transpose(1, 2), v)


def test_smoke_engine_card_matches_cpu(cuda):
    """llama31-smoke on the card (kernels) against the CPU (plain versions),
    same weights: ``chip_smoke.py``'s phase 4, which raises where logits or
    greedy tokens disagree beyond its stated bounds."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    chip_smoke.smoke_card_vs_cpu()
