"""Batched serving engine — the port of ``repro.serving.engine.Engine`` with
``use_pallas_kernels=True``.

Request flow:
  1. prompts are byte-tokenized and left-padded to a shared multiple of 32
     tokens (the packed cache shares one position counter; per-row
     validity is the ``pad_prefix`` mask of decode attention),
  2. ``prefill``: INT4 weights x BFP activations, K1 + K3 attention, the
     packed asymmetric cache built by K2 with the online K offsets,
  3. decode: a host loop of decode steps (K4 over the cache, appends in
     place), sampling after each; a row that emits EOS is frozen to EOS.

Throughput is reported as raw tokens/s (every emitted position) and useful
tokens/s (up to each row's first EOS); prefill wall time is reported on its
own as well.  Timings end in a device synchronization.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import kvcache
from repro_torch.core.quant_config import QuantConfig, harmonia
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.models.config import ModelConfig
from repro_torch.serving import sampler as sampler_lib

ALIGN = 32  # prefill lengths are multiples of the BFP group


def ceil_align(n: int) -> int:
    return -(-n // ALIGN) * ALIGN


@dataclasses.dataclass
class EngineConfig:
    max_seq: int = 512
    max_new_tokens: int = 64
    quant: Optional[QuantConfig] = None      # defaults to harmonia(4)
    sampler: str = "greedy"
    temperature: float = 0.8
    seed: int = 0


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Engine:
    """Serves a parameter tree made by ``models.init.init_params`` (or
    ``interop.params_from_jax``), INT4-packed by ``quant.int4.pack_params``.

    ``device`` is where the engine computes: the GPU unless the caller
    passes ``device="cpu"``; the parameters must already lie there."""

    def __init__(self, params: Dict, cfg: ModelConfig, ecfg: EngineConfig,
                 device=None):
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"parameters are on {params['embed'].device}, "
                             f"the engine on {self.device}")
        self.params = params
        self.cfg = cfg
        self.ecfg = ecfg
        self.quant = ecfg.quant or harmonia(4)
        self.tok = ByteTokenizer()
        gen = torch.Generator(device=self.device)
        gen.manual_seed(ecfg.seed)
        self._sample = sampler_lib.make_sampler(
            ecfg.sampler, temperature_value=ecfg.temperature, generator=gen)

    def prepare(self, prompts: List[str]):
        """Encode, truncate, vocab-clip and left-pad to a shared multiple of
        ALIGN.  Returns (tokens (B, S) int64, pad_prefix (B,) int32)."""
        if not prompts:
            raise ValueError("prompts must be a non-empty list")
        ids = [self.tok.encode(p)[: self.ecfg.max_seq - ALIGN]
               for p in prompts]
        padded_len = max(ALIGN, ceil_align(max(len(x) for x in ids)))
        toks = np.full((len(ids), padded_len), self.tok.pad_id, np.int64)
        pad_prefix = np.zeros((len(ids),), np.int32)
        for i, x in enumerate(ids):
            if x:
                toks[i, padded_len - len(x):] = x
            pad_prefix[i] = padded_len - len(x)
        toks = np.minimum(toks, self.cfg.vocab_size - 1)
        return (torch.from_numpy(toks).to(self.device),
                torch.from_numpy(pad_prefix).to(self.device))

    @torch.inference_mode()
    def prefill(self, toks: torch.Tensor):
        return lm.prefill(self.params, self.cfg, toks,
                          max_seq=self.ecfg.max_seq, quant=self.quant)

    @torch.inference_mode()
    def generate(self, prompts: List[str],
                 max_new_tokens: Optional[int] = None) -> dict:
        """Returns {texts, tokens (B, m) numpy, tokens_per_s,
        useful_tokens_per_s, wall_s, prefill_s, cache_stats}."""
        m = max_new_tokens or self.ecfg.max_new_tokens
        toks, pad_prefix = self.prepare(prompts)
        B, S = toks.shape
        if S + m - 1 > self.ecfg.max_seq:
            # m emitted tokens append m-1 to the cache; past capacity the
            # ring would wrap over live tokens
            raise ValueError(
                f"prompt length {S} + max_new_tokens {m} - 1 exceeds "
                f"max_seq {self.ecfg.max_seq}")

        _sync(self.device)
        t0 = time.perf_counter()
        logits, caches = self.prefill(toks)
        _sync(self.device)
        prefill_s = time.perf_counter() - t0
        out = lm.generate_loop(self.params, self.cfg, caches, num_steps=m,
                               logits0=logits, sample_fn=self._sample,
                               eos_id=self.tok.eos_id, quant=self.quant,
                               pad_prefix=pad_prefix)
        gen = out["tokens"].cpu().numpy()
        dt = time.perf_counter() - t0

        texts, useful = [], 0
        for row in gen:
            stop = np.where(row == self.tok.eos_id)[0]
            row = row[: stop[0]] if len(stop) else row
            useful += len(row)
            texts.append(self.tok.decode(row.tolist()))
        return {"texts": texts, "tokens": gen, "tokens_per_s": B * m / dt,
                "useful_tokens_per_s": useful / dt, "wall_s": dt,
                "prefill_s": prefill_s, "caches": caches,
                "cache_stats": self.cache_stats(caches, S + m)}

    def cache_stats(self, caches: List[kvcache.AsymKVCache],
                    seq_len: int) -> dict:
        # + 4: the reference also counts its int32 position counter
        packed = sum(kvcache.cache_bytes(c) for c in caches) + 4
        fp16 = self.cfg.n_layers * kvcache.fp16_cache_bytes(
            1, self.cfg.n_kv_heads, self.cfg.head_dim, self.ecfg.max_seq)
        return {"packed_cache_bytes_total": int(packed),
                "fp16_equiv_per_row": int(fp16),
                "storage_fraction":
                    self.quant.kv.storage_fraction(seq_len)}


__all__ = ["Engine", "EngineConfig", "ALIGN", "ceil_align"]
