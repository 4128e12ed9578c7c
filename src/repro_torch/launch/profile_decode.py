"""Where a decode step's time goes on the GPU.

  python -m repro_torch.launch.profile_decode [--steps 3] [--top 15]

Serves harmonia-llama3.1-8b as ``chip_smoke.py`` does (full width, random
INT4 weights from a seed, 4 prompts padded to 1024 tokens, max_seq 2048),
runs a few decode steps untraced and times them, then traces ``--steps``
decode steps with ``torch.profiler`` and prints, per step: wall time,
device-busy time (the sum of kernel times) and its share of the wall, the
device time of each stage of the step (the stages are wrapped in profiler
ranges for this run only), and the top kernels by device time.  Needs the
GPU; prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import subprocess
import time
from collections import defaultdict

import numpy as np
import torch


# (module, attribute, stage): the functions a decode step spends its time in
STAGES = (
    ("repro_torch.layers.common", "weight_dequant", "qlinear: INT4 dequant"),
    ("repro_torch.core.bfp", "bfp_fake_quant", "BFP fake quant (acts, Q)"),
    ("repro_torch.models.lm", "qlinear", "qlinear (all)"),
    ("repro_torch.layers.mlp", "qlinear", "qlinear (all)"),
    ("repro_torch.models.lm", "attention_decode", "attention (K4)"),
    ("repro_torch.core.kvcache", "append_token", "append_token"),
    ("repro_torch.models.lm", "rms_norm", "rms_norm"),
    ("repro_torch.models.lm", "apply_rope", "rope"),
)


@contextlib.contextmanager
def stage_ranges():
    """Wrap each stage function in a ``record_function`` range, and put the
    originals back afterwards."""
    import importlib
    saved = []
    for mod_name, attr, label in STAGES:
        mod = importlib.import_module(mod_name)
        fn = getattr(mod, attr)

        @functools.wraps(fn)
        def wrapped(*a, _fn=fn, _label=label, **kw):
            with torch.profiler.record_function(_label):
                return _fn(*a, **kw)
        saved.append((mod, attr, fn))
        setattr(mod, attr, wrapped)
    try:
        yield
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from repro_torch.configs import get_arch
    from repro_torch.device import resolve_device
    from repro_torch.models import lm
    from repro_torch.models.init import init_params
    from repro_torch.quant.int4 import pack_params
    from repro_torch.serving.engine import Engine, EngineConfig

    dev = resolve_device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    cfg = get_arch("harmonia-llama3.1-8b").config
    params = pack_params(init_params(cfg, seed=args.seed, device=dev))
    eng = Engine(params, cfg, EngineConfig(max_seq=2048), device=dev)
    rng = np.random.default_rng(args.seed)
    prompts = ["".join(chr(c) for c in rng.integers(32, 127, n))
               for n in (1000, 700, 420, 150)]
    toks, pad = eng.prepare(prompts)

    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = eng.prefill(toks)
        torch.cuda.synchronize()
        print(f"[profile] prefill B={toks.shape[0]} S={toks.shape[1]}: "
              f"{(time.perf_counter() - t0) * 1e3:.1f} ms wall", flush=True)
        tok = logits.argmax(-1)

        def step(tok):
            return lm.decode_step(params, cfg, tok, caches, quant=eng.quant,
                                  pad_prefix=pad).argmax(-1)

        for _ in range(3):
            tok = step(tok)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.steps):
            tok = step(tok)
        torch.cuda.synchronize()
        untraced = (time.perf_counter() - t0) / args.steps
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with stage_ranges(), torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for _ in range(args.steps):
                tok = step(tok)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / args.steps

    labels = {label for _, _, label in STAGES}
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
    per_kernel = defaultdict(lambda: [0.0, 0])
    stage_ms = defaultdict(lambda: [0.0, 0])
    for evt in prof.events():
        if evt.device_type == cuda and evt.name not in labels:
            # a kernel (the ranges also appear on the device timeline as
            # annotations spanning their kernels and the gaps between)
            per_kernel[evt.name][0] += evt.time_range.elapsed_us() / 1e3
            per_kernel[evt.name][1] += 1
        elif evt.device_type == cpu and evt.name in labels:
            # kernels launched inside the range, its sub-ranges included
            stage_ms[evt.name][0] += evt.device_time_total / 1e3
            stage_ms[evt.name][1] += 1
    busy = sum(ms for ms, _ in per_kernel.values()) / args.steps
    print(f"[profile] decode step at context {caches[0].length}: untraced "
          f"wall {untraced * 1e3:.2f} ms; traced wall {wall * 1e3:.2f} ms, "
          f"device busy {busy:.2f} ms ({100 * busy / (untraced * 1e3):.1f}% "
          f"of the untraced wall)", flush=True)
    for label, (ms, n) in sorted(stage_ms.items(), key=lambda kv: -kv[1][0]):
        print(f"[profile]   stage {ms / args.steps:8.3f} ms/step "
              f"x{n // args.steps:<5d} {label}")
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][0])[:args.top]
    for name, (ms, n) in top:
        print(f"[profile]   kernel {ms / args.steps:8.3f} ms/step "
              f"x{n // args.steps:<5d} {name[:100]}")


if __name__ == "__main__":
    main()
