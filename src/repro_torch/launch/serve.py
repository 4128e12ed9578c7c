"""Serving driver CLI of the PyTorch port.

  python -m repro_torch.launch.serve --smoke --device cpu \\
      --prompts "hello" "world" --max-new 32     # smoke config, CPU
  python -m repro_torch.launch.serve               # full model, GPU

Initializes random weights from ``--seed``, INT4-packs them and serves the
prompts through the engine.  On the GPU the serving path runs the CUDA
kernels (built on first use); on the CPU, their plain versions.
"""
from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="harmonia-llama3.1-8b")
    ap.add_argument("--smoke", action="store_true",
                    help="serve the arch's reduced smoke config")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--prompts", nargs="+",
                    default=["the shared exponent", "attention is"])
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--recipe", default="harmonia_kv4")
    ap.add_argument("--sampler", default="greedy")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from repro_torch.configs import get_arch
    from repro_torch.core.quant_config import get_recipe
    from repro_torch.models.init import init_params
    from repro_torch.quant.int4 import pack_params
    from repro_torch.serving.engine import Engine, EngineConfig

    spec = get_arch(args.arch)
    cfg = spec.smoke if args.smoke else spec.config
    params = pack_params(init_params(cfg, seed=args.seed, device=args.device))
    eng = Engine(params, cfg, EngineConfig(
        max_seq=args.max_seq, max_new_tokens=args.max_new,
        quant=get_recipe(args.recipe), sampler=args.sampler, seed=args.seed),
        device=args.device)
    out = eng.generate(args.prompts)
    for p, t in zip(args.prompts, out["texts"]):
        print(f"[serve] {p!r} -> {t!r}")
    print(f"[serve] {eng.device}: {out['tokens_per_s']:.1f} tok/s raw, "
          f"{out['useful_tokens_per_s']:.1f} tok/s useful (EOS-truncated), "
          f"prefill {out['prefill_s']:.3f} s, KV storage fraction "
          f"{out['cache_stats']['storage_fraction']:.3f}")


if __name__ == "__main__":
    main()
