"""Tokenization with an offline fallback, and batch padding.

A copy of `rag_serving_system_tpu/models/tokenizer.py`: an HF tokenizer when
a local snapshot holds one (`HFTokenizer`, which imports `transformers`
inside its constructor only), else the deterministic hashing tokenizer, so
that the whole pipeline runs with no network and no `transformers`. The
hashing tokenizer encodes ASCII text through the C library of
`native/hashtok.c` (the same ids as the Python blake2b path, faster, and the
interpreter lock released during the call) and every other text through the
exact Python path; where no host compiler can build the library, it logs so
and encodes all text in Python.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import re
from typing import List, Tuple

import numpy as np

logger = logging.getLogger(__name__)


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
        from rag_serving_system_torch.native import NativeBuildError, get_hashtok_lib

        try:
            self._lib = get_hashtok_lib()
        except NativeBuildError as e:
            logger.warning("tokenizing in Python: the C path did not build: %s", e)
            self._lib = None

    def _tok2id(self, tok: str) -> int:
        h = int.from_bytes(hashlib.blake2b(tok.encode("utf-8"), digest_size=4).digest(), "little")
        return self._reserved + (h % (self.vocab_size - self._reserved))

    def _encode_py(self, text: str) -> List[int]:
        return [self.bos_id] + [self._tok2id(t) for t in self._word_re.findall(text)] + [self.eos_id]

    def encode(self, text: str) -> List[int]:
        if self._lib is None:
            return self._encode_py(text)
        try:
            raw = text.encode("ascii")
        except UnicodeEncodeError:
            return self._encode_py(text)  # non-ASCII: the exact Python path
        cap = len(raw) + 2  # at most one token a byte, and bos and eos
        out = (ctypes.c_int32 * cap)()
        n = self._lib.hashtok_encode(raw, len(raw), out, cap, self.vocab_size,
                                     self._reserved, self.bos_id, self.eos_id)
        return list(out[:n]) if n >= 0 else self._encode_py(text)

    def decode(self, ids) -> str:
        # lossy: hashing is one-way; emit token placeholders
        return " ".join(f"<{int(i)}>" for i in ids if int(i) not in
                        (self.bos_id, self.eos_id, self.pad_id))

    def encode_many(self, texts: List[str]) -> List[List[int]]:
        return [self.encode(t) for t in texts]

    def encode_batch(self, texts: List[str], max_len: int,
                     pad_side: str = "right",
                     truncate_side: str = "right") -> Tuple[np.ndarray, np.ndarray]:
        return pad_and_stack(self.encode_many(texts), max_len, self.pad_id,
                             pad_side, truncate_side)


class HFTokenizer:
    """Thin adapter over a locally stored HF tokenizer."""

    def __init__(self, model_name: str):
        from transformers import AutoTokenizer  # local snapshot only
        self.tok = AutoTokenizer.from_pretrained(model_name, local_files_only=True)
        if self.tok.pad_token_id is None:
            self.tok.pad_token = self.tok.eos_token
        self.pad_id = self.tok.pad_token_id
        self.eos_id = self.tok.eos_token_id

    def encode(self, text: str) -> List[int]:
        return self.tok.encode(text)

    def encode_many(self, texts: List[str]) -> List[List[int]]:
        """One call of the Rust `tokenizers` batch API for the whole batch
        (it releases the GIL and spreads the rows over its own threads);
        the ids are those of per-row `encode`."""
        if not texts:
            return []
        fast = getattr(self.tok, "_tokenizer", None)  # rust backend
        if fast is not None:
            return [e.ids for e in fast.encode_batch(list(texts))]
        return [self.tok.encode(t) for t in texts]

    def decode(self, ids) -> str:
        return self.tok.decode([int(i) for i in ids], skip_special_tokens=True)

    def encode_batch(self, texts: List[str], max_len: int,
                     pad_side: str = "right",
                     truncate_side: str = "right") -> Tuple[np.ndarray, np.ndarray]:
        return pad_and_stack(self.encode_many(texts), max_len, self.pad_id,
                             pad_side, truncate_side)


def get_tokenizer(model_name: str, vocab_size: int):
    """The HF tokenizer of `model_name` if it can be loaded from local files;
    otherwise the hash fallback (no `transformers`, no tokenizer files, or a
    broken snapshot)."""
    try:
        return HFTokenizer(model_name)
    except Exception:
        return HashTokenizer(vocab_size=vocab_size)


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
