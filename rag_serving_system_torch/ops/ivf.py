"""IVF (inverted-file) approximate retrieval for very large corpora.

Port of `rag_serving_system_tpu/ops/ivf.py`: spherical k-means, clusters
packed into a fixed-capacity (C, cap, D) tensor (zero rows, id -1 as
padding), and a search that scores the centroids, gathers the nprobe best
clusters and takes an exact top-k within them. Scan cost per query is
O(C + nprobe * cap) rows instead of O(N); nprobe = C degenerates to exact.

All of it is plain tensor code: the JAX package has no Pallas kernel here.
Equal scores rank the lower position first, as `lax.top_k` does, and
k-means assignment ties go to the lower cluster (`argmax` takes the first
maximum in both packages).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from rag_serving_system_torch.ops.topk import l2_normalize, stable_topk

NEG_INF = -3.0e38  # the JAX package's padding score


class IvfIndex(NamedTuple):
    centroids: torch.Tensor   # (C, D) f32, L2-normalized
    packed: torch.Tensor      # (C, cap, D) f32, cluster-major corpus rows
    packed_idx: torch.Tensor  # (C, cap) i32, original doc ids, -1 = padding


def _kmeans(corpus: torch.Tensor, n_clusters: int, iters: int, seed: int = 0,
            init: torch.Tensor | None = None) -> torch.Tensor:
    """Spherical k-means (cosine). Returns (C, D) centroids. `init` (C, D)
    gives the starting centroids; without it they are n_clusters distinct
    corpus rows drawn by a torch.Generator seeded with `seed`."""
    n = corpus.shape[0]
    if init is None:
        g = torch.Generator().manual_seed(seed)
        init = corpus[torch.randperm(n, generator=g)[:n_clusters].to(corpus.device)]
    centroids = l2_normalize(init.float())
    for _ in range(iters):
        assign = torch.argmax(corpus @ centroids.T, dim=1)             # (N,)
        sums = torch.zeros_like(centroids).index_add_(0, assign, corpus)
        counts = torch.bincount(assign, minlength=n_clusters)[:, None].float()
        new = torch.where(counts > 0, sums / torch.clamp(counts, min=1), centroids)
        centroids = l2_normalize(new)
    return centroids


def build_ivf(corpus: torch.Tensor, n_clusters: int = 256, iters: int = 10,
              cap: int | None = None, seed: int = 0,
              init: torch.Tensor | None = None) -> IvfIndex:
    """Build the index on `corpus`'s device. `corpus` (N, D) should be
    L2-normalized. Clusters are packed on the host (numpy bucketing)."""
    corpus = corpus.float()
    centroids = _kmeans(corpus, n_clusters, iters, seed, init)
    assign = torch.argmax(corpus @ centroids.T, dim=1).cpu().numpy()
    corpus_np = corpus.cpu().numpy()

    buckets = [np.where(assign == c)[0] for c in range(n_clusters)]
    max_sz = max(1, max(len(b) for b in buckets))
    if cap is None:
        cap = max_sz
    elif max_sz > cap:
        raise ValueError(f"cluster capacity {cap} < largest cluster {max_sz}")

    n, d = corpus_np.shape
    packed = np.zeros((n_clusters, cap, d), np.float32)
    packed_idx = np.full((n_clusters, cap), -1, np.int32)
    for c, b in enumerate(buckets):
        packed[c, :len(b)] = corpus_np[b]
        packed_idx[c, :len(b)] = b
    dev = corpus.device
    return IvfIndex(centroids=centroids,
                    packed=torch.as_tensor(packed, device=dev),
                    packed_idx=torch.as_tensor(packed_idx, device=dev))


def ivf_search(index: IvfIndex, queries: torch.Tensor, k: int,
               nprobe: int = 8) -> tuple[torch.Tensor, torch.Tensor]:
    """Approximate cosine top-k. Returns ((B, k) f32 scores, (B, k) i32 doc
    ids); id -1 marks missing slots when fewer than k candidates exist."""
    q = l2_normalize(queries.float())                          # (B, D)
    nprobe = min(nprobe, index.centroids.shape[0])
    _, probe = stable_topk(q @ index.centroids.T, nprobe)      # (B, nprobe)
    cand = index.packed[probe]                                 # (B, nprobe, cap, D)
    cand_idx = index.packed_idx[probe]                         # (B, nprobe, cap)
    b = q.shape[0]
    scores = torch.einsum("bd,bpcd->bpc", q, cand).reshape(b, -1)
    cand_idx = cand_idx.reshape(b, -1)
    scores = torch.where(cand_idx >= 0, scores, torch.full_like(scores, NEG_INF))
    k_eff = min(k, scores.shape[1])
    top_s, pos = stable_topk(scores, k_eff)
    top_i = torch.gather(cand_idx, 1, pos)
    if k_eff < k:  # keep the (B, k) contract; -1 marks missing candidates
        top_s = torch.nn.functional.pad(top_s, (0, k - k_eff), value=NEG_INF)
        top_i = torch.nn.functional.pad(top_i, (0, k - k_eff), value=-1)
    return top_s, top_i
