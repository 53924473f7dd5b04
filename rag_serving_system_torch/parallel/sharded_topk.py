"""Exact cosine top-k over a corpus sharded on N across the mesh.

Counterpart of `rag_serving_system_tpu/parallel/sharded_topk.py:32-107`. The
(N, D) corpus is split into one row shard per mesh position (data-major);
each shard runs the one-device top-k (`ops.topk.cosine_topk`: kernel B1 on
a CUDA device, with the score kernel and the select beyond LIST_K), and
only the per-shard (score, global index) candidates are gathered to the
lead device and merged. The corpus is never gathered: the traffic is
n_shards * B * k_local * 8 bytes. Exact: the global top-k is a subset of the
union of the shards' top-k.

Over a mesh of several processes (`mesh.make_global_mesh`) each process
places and searches only its own shards, the candidates cross the process
boundary through the host (`mesh.process_allgather`), and every process
merges the same tensor, so each returns the whole, identical result.
"""

from __future__ import annotations

import torch

from rag_serving_system_torch.ops.topk import (
    cosine_topk,
    l2_normalize,
    pad_depth,
    stable_topk,
)
from rag_serving_system_torch.parallel.mesh import Mesh, gather_to, process_allgather

NEG_INF = -3.0e38   # the JAX package's top-k fill value


def shard_corpus(corpus: torch.Tensor, mesh: Mesh) -> list[torch.Tensor | None]:
    """The (N, D) corpus as one (N_pad / n_dev, D) shard on each mesh
    position's device, data-major, each a tensor of its own; None at a
    position another process holds (that process places it). N is padded
    to a multiple of the position count with zero rows, the depth to the
    kernels' alignment (`pad_depth`, zero columns).

    A pad row scores 0 against any query, which CAN beat a real row of
    negative similarity: `sharded_cosine_topk` stays exact by widening each
    shard's selection by the pad count before it masks them."""
    corpus = pad_depth(corpus)
    devices = mesh.devices
    n, d = corpus.shape
    shard_n = -(-n // len(devices))
    shards = []
    for i, (dev, mine) in enumerate(zip(devices, mesh.addressable)):
        if not mine:
            shards.append(None)
            continue
        rows = corpus[i * shard_n:(i + 1) * shard_n]
        shard = torch.zeros((shard_n, d), dtype=corpus.dtype, device=dev)
        shard[:rows.shape[0]] = rows.to(dev)
        shards.append(shard)
    return shards


def sharded_cosine_topk(corpus_sharded: list[torch.Tensor | None], queries: torch.Tensor,
                        k: int, mesh: Mesh, valid_n: int):
    """Exact global top-k over `shard_corpus`'s shards; `valid_n` is the
    true corpus size. Returns ((B, k) f32 scores, (B, k) i32 global indices)
    on this process's first device (`mesh.local_lead`: the lead device on
    one process); equal scores rank the lower global index first, as on one
    device. Over several processes every process calls it with the same
    queries and k."""
    n_dev = len(corpus_sharded)
    shard_n = next(s for s in corpus_sharded if s is not None).shape[0]
    n_pad = n_dev * shard_n
    # a shard holds at most n_pad - valid_n pad rows: selecting that many
    # more keeps every shard's true top-k real rows past the mask below
    k_local = min(k + (n_pad - valid_n), shard_n)
    q = pad_depth(l2_normalize(queries.float()))
    cand_s, cand_i = [], []
    for di, shard in enumerate(corpus_sharded):
        if shard is None:
            continue
        s, i = cosine_topk(shard, q.to(shard.device), k_local, normalize_queries=False)
        gidx = i + di * shard_n
        cand_s.append(torch.where(gidx < valid_n, s, NEG_INF))
        cand_i.append(gidx)
    lead = mesh.local_lead
    cand_s = torch.cat(gather_to(cand_s, lead), dim=1)   # (B, local shards * k_local)
    cand_i = torch.cat(gather_to(cand_i, lead), dim=1)
    if mesh.process_count > 1:
        # every process's candidates, side by side in rank order
        cand_s = process_allgather(cand_s.T).T.to(lead)
        cand_i = process_allgather(cand_i.T).T.to(lead)
    # candidates in global-index order, so the stable selection breaks ties
    # toward the lowest index, as the single-device top-k does
    cand_i, order = torch.sort(cand_i, dim=1)
    cand_s = torch.gather(cand_s, 1, order)
    top_s, pos = stable_topk(cand_s, k)
    return top_s, torch.gather(cand_i, 1, pos)
