"""The offline hashing tokenizer and batch padding.

A copy of `HashTokenizer` and `pad_and_stack` from
`rag_serving_system_tpu/models/tokenizer.py`. Only the Python blake2b path
is kept: the JAX package's C fast path for ASCII text (`native/hashtok.c`)
gives the same ids, faster, and is not carried over, so the port builds no
host library. The HF tokenizer adapter is not ported (the engine refuses a
local model directory).
"""

from __future__ import annotations

import hashlib
import re
from typing import List, Tuple

import numpy as np


class HashTokenizer:
    """Deterministic whitespace+punctuation hashing tokenizer: stable across
    runs and processes, about one token per word."""

    def __init__(self, vocab_size: int, bos_id: int = 0, eos_id: int = 2,
                 pad_id: int = 1):
        self.vocab_size = vocab_size
        self.bos_id = bos_id
        self.eos_id = eos_id
        self.pad_id = pad_id
        self._reserved = 10  # low ids are kept for specials
        self._word_re = re.compile(r"\w+|[^\w\s]")

    def _tok2id(self, tok: str) -> int:
        h = int.from_bytes(hashlib.blake2b(tok.encode("utf-8"), digest_size=4).digest(), "little")
        return self._reserved + (h % (self.vocab_size - self._reserved))

    def encode(self, text: str) -> List[int]:
        return [self.bos_id] + [self._tok2id(t) for t in self._word_re.findall(text)] + [self.eos_id]

    def decode(self, ids) -> str:
        # lossy: hashing is one-way; emit token placeholders
        return " ".join(f"<{int(i)}>" for i in ids if int(i) not in
                        (self.bos_id, self.eos_id, self.pad_id))

    def encode_many(self, texts: List[str]) -> List[List[int]]:
        return [self.encode(t) for t in texts]


def pad_and_stack(rows: List[List[int]], max_len: int, pad_id: int,
                  pad_side: str, truncate_side: str = "right"
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Pad a ragged batch to (B, max_len) + mask. Right-pad for the encoder,
    left-pad for the decoder. truncate_side="left" keeps the tail of an
    over-long row: a RAG prompt's question and answer cue sit at its end."""
    b = len(rows)
    ids = np.full((b, max_len), pad_id, dtype=np.int32)
    mask = np.zeros((b, max_len), dtype=np.int32)
    for i, row in enumerate(rows):
        row = row[:max_len] if truncate_side == "right" else row[-max_len:]
        n = len(row)
        if pad_side == "right":
            ids[i, :n] = row
            mask[i, :n] = 1
        else:
            ids[i, max_len - n:] = row
            mask[i, max_len - n:] = 1
    return ids, mask
