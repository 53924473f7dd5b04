"""Retriever classes: the serving-facing wrapper around the top-k ops.

Port of `rag_serving_system_tpu/core/retriever.py`, with the same interface:

    retrieve(query_embedding, k) -> list[str]
    batch_retrieve(query_embeddings, ks) -> list[list[str]]

- `SimpleRetriever` - numpy exact cosine top-k, the correctness oracle
  (a copy: the JAX module imports jax)
- `TorchRetriever`  - one device, f32 / bf16 corpus (kernel B1) or int8,
  chunked past TOPK_CHUNK_ROWS rows (kernel B4); counterpart of TpuRetriever
- `IvfRetriever`    - approximate IVF for very large corpora
- `ShardedRetriever` - the corpus sharded on N over a mesh
  (`parallel/`): B1 on every shard, the candidates merged on the lead device

Requests are clamped to a fixed `max_k` and sliced per query on the host.
Malformed input (wrong dimension, empty corpus) returns empty results
rather than raising.
"""

from __future__ import annotations

import logging
import os
from typing import List, Sequence

import numpy as np
import torch

from rag_serving_system_torch.device import resolve_device
from rag_serving_system_torch.ops.ivf import build_ivf, ivf_search
from rag_serving_system_torch.ops.topk import (
    cosine_topk,
    cosine_topk_int8_chunked,
    pad_depth,
    quantize_corpus_int8_chunked,
)
from rag_serving_system_torch.parallel.mesh import make_mesh
from rag_serving_system_torch.parallel.sharded_topk import shard_corpus, sharded_cosine_topk

logger = logging.getLogger(__name__)


def _l2n(x: np.ndarray) -> np.ndarray:
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)


class SimpleRetriever:
    """Numpy exact cosine top-k: the correctness oracle.

    Equal scores rank the lowest index first, as `lax.top_k` does: a stable
    argsort over negated scores."""

    def __init__(self, embeddings: np.ndarray, documents: Sequence[str]):
        self.documents = list(documents)
        self.embeddings = _l2n(np.asarray(embeddings, dtype=np.float32))

    def retrieve(self, query_embedding: np.ndarray, k: int = 2) -> List[str]:
        q = _l2n(np.asarray(query_embedding, dtype=np.float32).reshape(-1))
        n = len(self.documents)
        if n == 0 or q.shape[0] != self.embeddings.shape[-1]:
            logger.error("retrieve: bad query shape %s or empty corpus", q.shape)
            return []
        k = max(1, min(int(k), n))
        sims = self.embeddings @ q
        idx = np.argsort(-sims, kind="stable")[:k]
        return [self.documents[i] for i in idx]

    def batch_retrieve(self, query_embeddings: np.ndarray,
                       ks: Sequence[int]) -> List[List[str]]:
        return [self.retrieve(q, k) for q, k in zip(np.asarray(query_embeddings), ks)]


class _DeviceRetriever:
    """Shared serving surface of the device retrievers: validation, the
    fixed-max_k clamp, one device-to-host index copy, per-query slicing.
    Subclasses set `documents`, `n`, `max_k`, `_dim` and `device` and
    implement `topk_indices(queries, k) -> (scores, indices)`."""

    documents: List[str]
    n: int
    max_k: int
    _dim: int
    device: torch.device

    def topk_indices(self, query_embeddings: torch.Tensor, k: int):
        raise NotImplementedError

    def retrieve(self, query_embedding: np.ndarray, k: int = 2) -> List[str]:
        return self.batch_retrieve(np.asarray(query_embedding)[None, :], [k])[0]

    def batch_retrieve(self, query_embeddings: np.ndarray,
                       ks: Sequence[int]) -> List[List[str]]:
        if len(ks) == 0:
            return []
        q = np.asarray(query_embeddings, dtype=np.float32)
        if q.ndim != 2 or q.shape[1] != self._dim or self.n == 0:
            logger.error("batch_retrieve: bad query shape %s (corpus n=%d)",
                         q.shape, self.n)
            return [[] for _ in ks]
        want = [max(1, min(int(k), self.n)) for k in ks]
        ks = [min(k, self.max_k) for k in want]
        if ks != want:
            logger.warning("k clamped to max_k=%d (requested up to %d)",
                           self.max_k, max(want))
        _, idx = self.topk_indices(torch.as_tensor(q, device=self.device), max(ks))
        idx = idx.cpu().numpy()
        # -1 marks below-capacity slots (IVF padding)
        return [[self.documents[i] for i in row[:k] if i >= 0]
                for row, k in zip(idx, ks)]


class TorchRetriever(_DeviceRetriever):
    """One device, the whole corpus resident: exact top-k over an f32 or
    bf16 corpus (kernel B1), or an int8 one (kernel B4), split into
    TOPK_CHUNK_ROWS-row chunks (default 4,194,304). bf16 and int8 can
    reorder near-ties against the f32 oracle. Any max_k is served (clamped
    to N)."""

    def __init__(self, embeddings: np.ndarray, documents: Sequence[str],
                 max_k: int = 16, corpus_dtype: str = "float32",
                 device: str | torch.device | None = None):
        self.documents = list(documents)
        self.device = resolve_device(device)
        corpus = _l2n(np.asarray(embeddings, dtype=np.float32))
        self.corpus_dtype = corpus_dtype
        self.n = corpus.shape[0]
        self._dim = corpus.shape[1] if corpus.ndim == 2 else 0
        self.max_k = max(1, min(max_k, self.n))
        if corpus.ndim == 2:
            # the kernels read rows in 16-byte pieces: zero columns, which
            # change no score, fill the depth; topk_indices pads the queries
            corpus = pad_depth(corpus)
        if corpus_dtype == "int8":
            chunk_rows = int(os.environ.get("TOPK_CHUNK_ROWS", str(4_194_304)))
            self.corpus_chunks, self.corpus_mean = quantize_corpus_int8_chunked(
                corpus, chunk_rows=chunk_rows, device=self.device)
        else:
            dt = torch.bfloat16 if corpus_dtype == "bfloat16" else torch.float32
            self.corpus = torch.as_tensor(corpus, device=self.device).to(dt)

    def topk_indices(self, query_embeddings: torch.Tensor, k: int):
        query_embeddings = pad_depth(query_embeddings)
        if self.corpus_dtype == "int8":
            return cosine_topk_int8_chunked(self.corpus_chunks, query_embeddings, k,
                                            corpus_mean=self.corpus_mean)
        return cosine_topk(self.corpus, query_embeddings, k)


class IvfRetriever(_DeviceRetriever):
    """Approximate (IVF) retriever: O(C + nprobe * cap) rows scanned per
    query instead of O(N); nprobe = C is exact."""

    def __init__(self, embeddings: np.ndarray, documents: Sequence[str],
                 n_clusters: int = 64, nprobe: int = 8, iters: int = 10,
                 max_k: int = 16, device: str | torch.device | None = None):
        self.documents = list(documents)
        self.device = resolve_device(device)
        corpus = _l2n(np.asarray(embeddings, dtype=np.float32))
        self.n = corpus.shape[0]
        self._dim = corpus.shape[1] if corpus.ndim == 2 else 0
        self.max_k = max(1, min(max_k, self.n))
        self.index = build_ivf(torch.as_tensor(corpus, device=self.device),
                               n_clusters=min(n_clusters, self.n), iters=iters)
        # the clusters actually built: a small corpus gets fewer
        self.nprobe = min(nprobe, self.index.centroids.shape[0])

    def topk_indices(self, query_embeddings: torch.Tensor, k: int):
        return ivf_search(self.index, query_embeddings, k, nprobe=self.nprobe)


class ShardedRetriever(_DeviceRetriever):
    """The corpus sharded on N over a mesh (every visible CUDA device on
    "data" by default): exact top-k, B1 on each shard, the per-shard
    candidates gathered to the lead device and merged."""

    def __init__(self, embeddings: np.ndarray, documents: Sequence[str],
                 mesh=None, max_k: int = 16):
        self.documents = list(documents)
        self.mesh = mesh if mesh is not None else make_mesh()
        self.device = self.mesh.lead
        corpus = _l2n(np.asarray(embeddings, dtype=np.float32))
        self.n = corpus.shape[0]
        self._dim = corpus.shape[1] if corpus.ndim == 2 else 0
        self.max_k = max(1, min(max_k, self.n))
        self.corpus = shard_corpus(torch.as_tensor(corpus), self.mesh)

    def topk_indices(self, query_embeddings: torch.Tensor, k: int):
        return sharded_cosine_topk(self.corpus, query_embeddings, k, self.mesh,
                                   valid_n=self.n)
