"""On-card check of the PyTorch port: serve harmonia-llama3.1-8b on one GPU
through the hand-written CUDA kernels and hold every kernel against its
plain PyTorch version.

  python3 chip_smoke.py

Phases (any failure raises and exits nonzero):
  1. card and build: the card's name and power limit, then nvcc builds of
     every kernel source (in parallel), with the build time;
  2. serve: full-width harmonia-llama3.1-8b (all 32 layers, random weights
     from a seed, INT4-packed) answers 4 prompts of 150 to ~1000 tokens,
     64 new greedy tokens each, max_seq 2048.  Launch counts are reset just
     before and read just after: K1, K2 and K3 must launch once per layer of
     the prefill, K4 once per layer of every decode step;
  3. kernels: each kernel against its plain version on the card, on the
     inputs of the served run's first layer (K2 and K4 on the caches it
     built): K1 and K2 bit-exact, K3 and K4 within REL_BOUND; the device
     time of the kernel, of its plain version and of the library call where
     one PyTorch call computes the same function (the kernels' summed time
     in torch.profiler's trace), their wall times with CUDA events, and the
     least time the card needs (bound);
  4. smoke model, card against CPU: llama31-smoke on the card (kernels) and
     on the CPU (plain versions) from the same weights, both fed the CPU's
     greedy tokens: prefill and decode logits within LOGITS_BOUND, and with
     the linear layers' BFP input quantization off within the much tighter
     LINEAR_OFF_*_BOUND; greedy tokens equal, a row parting only where the
     CPU's top-two margin is below LOGITS_BOUND.

The line before the last is the card's name and power limit; the last line
is {"ok": true, "device": {...}}.  One line before them lists the kernels.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

SEED = 0
MAX_SEQ = 2048
NEW_TOKENS = 64
PROMPT_CHARS = (1000, 700, 420, 150)
# kernel against plain version: the attention kernels sum in another order
# and use the device's expf; 32 float32 ulps of the output scale
REL_BOUND = 4e-6
# card (kernels) against CPU (plain versions) on the whole smoke model: a
# last-bit difference can flip one BFP truncation step of a linear input,
# which later layers carry (the tests' bound for the port against JAX)
LOGITS_BOUND = 5e-2
# the same with the linear layers' BFP input quantization off: what is left
# is float rounding (bf16 GEMMs included) through the BFP K/V cache.  A
# few times the gaps read on an H100 80GB HBM3 at 700 W (prefill 3.5e-4,
# decode steps up to 1.6e-3); an attention that quantizes P reads 2.9e-2
# and more against the port (tests/test_torch_engine.py)
LINEAR_OFF_PREFILL_BOUND = 1e-3
LINEAR_OFF_DECODE_BOUND = 5e-3
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, 700 W
FP32_FLOPS = 67e12              # H100 SXM float32 outside the tensor cores

KERNEL_INFO = {
    "bfp_quantize_kv_pair": ("src/repro_torch/kernels/csrc/bfp_quant.cu",
                             "src/repro/kernels/bfp_quant.py:252"),
    "convert_prefill_cache": ("src/repro_torch/kernels/csrc/bfp_quant.cu",
                              "src/repro/kernels/bfp_quant.py:395"),
    "bfp_attention_prefill": (
        "src/repro_torch/kernels/csrc/bfp_attention_prefill.cu",
        "src/repro/kernels/bfp_attention.py:321"),
    "bfp_attention_decode_cache": (
        "src/repro_torch/kernels/csrc/bfp_attention_decode.cu",
        "src/repro/kernels/bfp_attention.py:828"),
}


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, reps: int = 20, warmup: int = 3):
    """(device ms, wall ms) of one call of ``fn``, each the mean over
    ``reps`` back-to-back calls.  Device time is the summed time of the
    kernels the calls launch, from torch.profiler's CUDA trace; wall time
    is read with CUDA events around the calls and includes the host's
    launch work wherever the host is slower than the kernels."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    wall = start.elapsed_time(end) / reps
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    busy_us = sum(e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    if not busy_us > 0:
        raise RuntimeError("torch.profiler recorded no device time")
    return busy_us / 1e3 / reps, wall


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: float, n_flops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rel_err(ref: torch.Tensor, got: torch.Tensor) -> float:
    ref, got = ref.double(), got.double()
    return float((ref - got).abs().max() / ref.abs().max().clamp_min(1e-30))


def max_abs(ref: torch.Tensor, got: torch.Tensor) -> float:
    return float((ref.double() - got.double()).abs().max())


def prompts_from_seed(chars, seed: int):
    rng = np.random.default_rng(seed)
    return ["".join(chr(c) for c in rng.integers(32, 127, n)) for n in chars]


# ---------------------------------------------------------------------------
# phase 2: serve the full model
# ---------------------------------------------------------------------------

def serve_full_model():
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models.init import init_params
    from repro_torch.quant.int4 import pack_params
    from repro_torch.serving.engine import Engine, EngineConfig

    cfg = get_arch("harmonia-llama3.1-8b").config
    t0 = time.perf_counter()
    params = pack_params(init_params(cfg, seed=SEED, device="cuda"))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"initialised and packed {cfg.name} ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, INT4) in {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated")
    eng = Engine(params, cfg, EngineConfig(max_seq=MAX_SEQ,
                                           max_new_tokens=NEW_TOKENS,
                                           seed=SEED), device="cuda")
    prompts = prompts_from_seed(PROMPT_CHARS, SEED)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    out = eng.generate(prompts)
    launches = ops.launch_counts()
    toks, _ = eng.prepare(prompts)
    S = toks.shape[1]
    stats = out["cache_stats"]
    log(f"served {len(prompts)} prompts ({[len(p) + 1 for p in prompts]} "
        f"tokens, padded to {S}) x {NEW_TOKENS} new tokens: "
        f"{out['tokens_per_s']:.2f} tok/s raw, "
        f"{out['useful_tokens_per_s']:.2f} useful, wall {out['wall_s']:.2f} "
        f"s (prefill {out['prefill_s']:.3f} s), peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, KV storage "
        f"fraction {stats['storage_fraction']:.4f}, packed cache "
        f"{stats['packed_cache_bytes_total'] / 2**20:.1f} MiB")
    log(f"launches {launches}")
    expected = {"bfp_quantize_kv_pair": cfg.n_layers,
                "convert_prefill_cache": cfg.n_layers,
                "bfp_attention_prefill": cfg.n_layers,
                "bfp_attention_decode_cache": cfg.n_layers * (NEW_TOKENS - 1)}
    if launches != expected:
        raise RuntimeError(f"launch counts {launches} != expected {expected}")
    tokens = out["tokens"]
    if tokens.shape != (len(prompts), NEW_TOKENS) or \
            not ((0 <= tokens) & (tokens < cfg.vocab_size)).all():
        raise RuntimeError(f"bad generated tokens {tokens.shape}")
    return eng, toks, out, launches


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------

def layer0_inputs(eng, toks):
    """Layer 0's prefill inputs, computed as the served prefill computed
    them: post-RoPE q/k/v and the online K offsets."""
    from repro_torch.core.smoothing import compute_online_offsets
    from repro_torch.layers.attention import quant_qk
    from repro_torch.layers.common import embed_lookup, qlinear, rms_norm
    from repro_torch.layers.rope import apply_rope

    cfg, q8, p = eng.cfg, eng.quant, eng.params["layers"][0]
    B, S = toks.shape
    pos = torch.arange(S, device=toks.device)[None].expand(B, S)
    x = rms_norm(embed_lookup(toks, eng.params["embed"]), p["ln1"],
                 cfg.norm_eps)
    q = qlinear(x, p["wq"], q8).reshape(B, S, cfg.n_heads, cfg.head_dim)
    k = qlinear(x, p["wk"], q8).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    v = qlinear(x, p["wv"], q8).reshape(B, S, cfg.n_kv_heads, cfg.head_dim)
    q = quant_qk(apply_rope(q, pos, cfg.rope_theta), q8).float().contiguous()
    k = apply_rope(k, pos, cfg.rope_theta).float().contiguous()
    v = v.float().contiguous()
    off = compute_online_offsets(k[:, :q8.smoothing.online_window],
                                 q8.smoothing.online_topk).contiguous()
    return q, k, v, off


def check_kernels(eng, toks, served, launches):
    import torch.nn.functional as F

    from repro_torch.core import kvcache
    from repro_torch.kernels import bfp_attention as A
    from repro_torch.kernels import bfp_quant as Q

    results = []

    def record(name, err_abs, err_rel, exact, kernel_fn, plain_fn, lib_fn,
               n_bytes, n_flops):
        ok = err_abs == 0.0 if exact else err_rel < REL_BOUND
        log(f"{name}: max_abs_err {err_abs:.3e}, max_rel_err {err_rel:.3e} "
            f"({'bit-exact required' if exact else f'bound {REL_BOUND}'})")
        if not ok:
            raise RuntimeError(f"{name} disagrees with its plain version")
        ms, wall = time_ms(kernel_fn)
        plain_ms, plain_wall = time_ms(plain_fn, reps=5)
        lib_ms, lib_wall = time_ms(lib_fn) if lib_fn else (None, None)
        b_ms, b_by = bound(n_bytes, n_flops)
        log(f"  device ms: kernel {ms:.4f}, plain {plain_ms:.4f}, library "
            f"{'-' if lib_ms is None else f'{lib_ms:.4f}'}; wall ms: kernel "
            f"{wall:.4f}, plain {plain_wall:.4f}, library "
            f"{'-' if lib_wall is None else f'{lib_wall:.4f}'}; bound "
            f"{b_ms:.4f} ms ({b_by})")
        src, replaces = KERNEL_INFO[name]
        results.append({"name": name, "route": "cuda", "source": src,
                        "replaces": replaces, "launches": launches[name],
                        "max_abs_err": err_abs, "max_rel_err": err_rel,
                        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                        "bound_by": b_by, "library_ms": lib_ms,
                        "wall_ms": wall, "plain_wall_ms": plain_wall,
                        "library_wall_ms": lib_wall})

    q, k, v, off = layer0_inputs(eng, toks)
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    s_bulk = MAX_SEQ - kvcache.INIT_TOKENS

    # K1
    got = Q.quantize_kv_pair_cuda(k, v)
    ref = Q.quantize_kv_pair_plain(k, v)
    err = max(max_abs(r.float(), g.float()) for r, g in zip(ref, got))
    record("bfp_quantize_kv_pair", err, err, True,
           lambda: Q.quantize_kv_pair_cuda(k, v),
           lambda: Q.quantize_kv_pair_plain(k, v), None,
           nbytes(k, v, *got), 0.0)
    packed = got

    # K2, on the layer-0 cache the served prefill built
    fresh = eng.prefill(toks)[1][0]
    got = Q.convert_prefill_cache_cuda(k, v, off, s_bulk)
    ref = Q.convert_prefill_cache_plain(k, v, off, s_bulk)
    err = max(max_abs(ref[n].float(), got[n].float()) for n in ref)
    err = max(err, max(max_abs(getattr(fresh, n).float(), got[n].float())
                       for n in ref))
    record("convert_prefill_cache", err, err, True,
           lambda: Q.convert_prefill_cache_cuda(k, v, off, s_bulk),
           lambda: Q.convert_prefill_cache_plain(k, v, off, s_bulk), None,
           nbytes(k, v, off, *got.values()), 0.0)

    # K3
    kw = dict(mantissa_bits=8, causal=True)
    got = A.attention_prefill_cuda(q, *packed, **kw)
    ref = A.attention_prefill_plain(q, *packed, **kw)
    kd = kvcache.dequantize_k(packed[0], packed[1], 8).transpose(1, 2)
    vd = kvcache.dequantize_v_groups(packed[2], packed[3], 8).transpose(1, 2)
    qt = q.transpose(1, 2)
    pairs = B * H * S * (S + 1) // 2            # causal (query, key) pairs
    record("bfp_attention_prefill", max_abs(ref, got), rel_err(ref, got),
           False, lambda: A.attention_prefill_cuda(q, *packed, **kw),
           lambda: A.attention_prefill_plain(q, *packed, **kw),
           lambda: F.scaled_dot_product_attention(qt, kd, vd, is_causal=True,
                                                  enable_gqa=True),
           nbytes(q, *packed, got), 4.0 * D * pairs)

    # K4, on the layer-0 cache after the served decode
    cache = served["caches"][0]
    L = cache.length
    _, pad = eng.prepare(prompts_from_seed(PROMPT_CHARS, SEED))
    start = pad.to(torch.int32).contiguous()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    qd = torch.randn((B, H, D), generator=gen, device="cuda")
    got = A.attention_decode_cache_cuda(qd, cache, start)
    ref = A.attention_decode_cache_plain(qd, cache, start)
    kp, vp = A.cache_kv_in_position_order(cache)
    mask = (torch.arange(L, device="cuda")[None] >= start[:, None])
    mask = mask[:, None, None, :]
    cg, r = divmod(L, kvcache.GROUP)
    per_head = (32 * D * 33 // 32                      # K init
                + max(0, L - 96) * D * 17 // 32         # K bulk below ring
                + min(64, L - 32) * D * 33 // 32        # K ring
                + 33 * D                                # V init group
                + max(0, cg - 3) * 17 * D               # V bulk groups
                + min(2, cg - 1) * 33 * D               # V ring groups
                + r * D * 4)                            # V residual
    record("bfp_attention_decode_cache", max_abs(ref, got), rel_err(ref, got),
           False, lambda: A.attention_decode_cache_cuda(qd, cache, start),
           lambda: A.attention_decode_cache_plain(qd, cache, start),
           lambda: F.scaled_dot_product_attention(
               qd[:, :, None], kp.transpose(1, 2), vp.transpose(1, 2),
               attn_mask=mask, enable_gqa=True),
           B * Hkv * per_head + nbytes(qd, got) + 4 * B, 4.0 * D * L * B * H)
    log(f"decode check at cache length {L}")
    return results


# ---------------------------------------------------------------------------
# phase 4: smoke model, card against CPU
# ---------------------------------------------------------------------------

def forced_logits(eng, toks, pad, tokens, quant):
    """Prefill and per-step decode logits under ``quant``, with every row
    fed ``tokens``."""
    from repro_torch.models import lm
    out = []
    with torch.inference_mode():
        logits, caches = lm.prefill(eng.params, eng.cfg, toks,
                                    max_seq=eng.ecfg.max_seq, quant=quant)
        out.append(logits.float().cpu())
        for s in range(tokens.shape[1] - 1):
            tok = torch.as_tensor(tokens[:, s], device=toks.device)
            out.append(lm.decode_step(eng.params, eng.cfg, tok, caches,
                                      quant=quant, pad_prefix=pad)
                       .float().cpu())
    return out


def smoke_card_vs_cpu(new: int = 48):
    """llama31-smoke on the card (kernels) against the CPU (plain versions)
    from the same weights; raises where they disagree."""
    from repro_torch.configs import get_arch
    from repro_torch.kernels import ops
    from repro_torch.models.init import init_params, to_device
    from repro_torch.quant.int4 import pack_params
    from repro_torch.serving.engine import Engine, EngineConfig

    cfg = get_arch("harmonia-llama3.1-8b").smoke
    cpu_params = pack_params(init_params(cfg, seed=SEED, device="cpu"))

    ecfg = EngineConfig(max_seq=256, max_new_tokens=new, seed=SEED)
    prompts = prompts_from_seed((150, 90), SEED + 2)
    cpu = Engine(cpu_params, cfg, ecfg, device="cpu")
    card = Engine(to_device(cpu_params, "cuda"), cfg, ecfg, device="cuda")
    out_cpu = cpu.generate(prompts)
    ops.reset_launch_counts()
    out_card = card.generate(prompts)
    if ops.launch_counts()["bfp_attention_decode_cache"] != \
            cfg.n_layers * (new - 1):
        raise RuntimeError("the card's smoke run missed the kernels")

    # both sides fed the CPU's greedy tokens: logits step by step, with the
    # linear layers' BFP input quantization on (the recipe) and off
    toks, pad = cpu.prepare(prompts)
    tokens = out_cpu["tokens"]
    off = cpu.quant.replace(quant_linear_acts=False)
    ref = None
    for label, quant, b_pre, b_dec in (
            ("on", cpu.quant, LOGITS_BOUND, LOGITS_BOUND),
            ("off", off, LINEAR_OFF_PREFILL_BOUND, LINEAR_OFF_DECODE_BOUND)):
        r = forced_logits(cpu, toks, pad, tokens, quant)
        g = forced_logits(card, toks.cuda(), pad.cuda(), tokens, quant)
        gaps = [rel_err(x, y) for x, y in zip(r, g)]
        log(f"smoke model {cfg.name}, BFP linear inputs {label}: logits card "
            f"vs CPU rel gap, prefill {gaps[0]:.3e} (bound {b_pre}), decode "
            f"steps max {max(gaps[1:]):.3e} (bound {b_dec})")
        if not (gaps[0] < b_pre and max(gaps[1:]) < b_dec):
            raise RuntimeError(f"smoke logits (BFP linear inputs {label}): "
                               "card and CPU disagree")
        if label == "on":
            ref = r

    # free-running greedy tokens; a row may part only at a near-tie of the
    # CPU's top two logits (below the logits bound), after which the two
    # histories differ and the forced logits above carry the comparison
    for row, (a, b) in enumerate(zip(out_cpu["tokens"], out_card["tokens"])):
        diff = np.nonzero(a != b)[0]
        if not len(diff):
            log(f"  row {row}: greedy tokens equal for all {new} steps")
            continue
        step = int(diff[0])
        lg = ref[step][row]
        top2 = torch.topk(lg, 2).values
        margin = float(top2[0] - top2[1])
        log(f"  row {row}: greedy tokens equal for {step} steps, then part "
            f"where the CPU's top-two margin is {margin:.3e} "
            f"({margin / float(lg.abs().max()):.3e} of the largest logit)")
        if not margin < LOGITS_BOUND * float(lg.abs().max()):
            raise RuntimeError("smoke greedy tokens differ at a clear margin")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the GPU",
              file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (fails outside a checkout)
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card, flush=True)
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, {torch.cuda.device_count()} device(s)")
    t0 = time.perf_counter()
    builds = _build.build_all()
    log(f"built {sorted(builds)} with nvcc for sm_90a in "
        f"{time.perf_counter() - t0:.1f} s")
    for name, b in builds.items():
        for line in b["log"].splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    eng, toks, served, launches = serve_full_model()
    kernels = check_kernels(eng, toks, served, launches)
    del eng, served
    torch.cuda.empty_cache()
    smoke_card_vs_cpu()

    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
