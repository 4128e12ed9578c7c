"""Byte-level tokenizer (vocab 256 + specials), dependency-free.

A copy of ``repro.data.tokenizer``.  Large-scale runs would swap in
SentencePiece; the interface (encode/
decode/vocab_size) is all the pipeline depends on.
"""
from __future__ import annotations

from typing import List

PAD, BOS, EOS = 256, 257, 258
N_SPECIAL = 3


class ByteTokenizer:
    vocab_size = 256 + N_SPECIAL
    pad_id, bos_id, eos_id = PAD, BOS, EOS

    def encode(self, text: str, add_bos: bool = True,
               add_eos: bool = False) -> List[int]:
        ids = list(text.encode("utf-8", errors="replace"))
        if add_bos:
            ids = [BOS] + ids
        if add_eos:
            ids = ids + [EOS]
        return ids

    def decode(self, ids) -> str:
        b = bytes(i for i in ids if i < 256)
        return b.decode("utf-8", errors="replace")


__all__ = ["ByteTokenizer", "PAD", "BOS", "EOS"]
