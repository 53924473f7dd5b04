"""PyTorch port: the retriever classes against the JAX package's, on the
CPU (plain versions), and the verify skill's interface probes."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from rag_serving_system_tpu.core import retriever as jr  # noqa: E402
from rag_serving_system_tpu.ops import topk as jt  # noqa: E402
from rag_serving_system_torch.core import retriever as tr  # noqa: E402


def clustered_corpus(rng, n_clusters=16, per=64, d=64):
    """Well-separated clusters, as tests/test_ivf.py builds them."""
    centers = rng.standard_normal((n_clusters, d)).astype(np.float32) * 5
    rows = np.concatenate([
        centers[i] + rng.standard_normal((per, d)).astype(np.float32) * 0.3
        for i in range(n_clusters)])
    return rows / np.linalg.norm(rows, axis=-1, keepdims=True)


def _corpus(seed, n=300, d=64, b=6):
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((n, d)).astype(np.float32)
    return emb, [f"doc {i}" for i in range(n)], rng.standard_normal((b, d)).astype(np.float32)


def test_simple_retriever_equals_jax():
    emb, docs, q = _corpus(0)
    emb[10] = emb[3]            # an exact tie: the lower index first in both
    q[0] = emb[3]
    ks = [1, 2, 5, 300, 0, 7]
    ours = tr.SimpleRetriever(emb, docs)
    ref = jr.SimpleRetriever(emb, docs)
    assert ours.batch_retrieve(q, ks) == ref.batch_retrieve(q, ks)
    assert ours.retrieve(q[0], 2) == ["doc 3", "doc 10"]
    assert ours.retrieve(np.ones(5, np.float32), 2) == ref.retrieve(np.ones(5, np.float32), 2) == []


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_torch_retriever_equals_jax(dtype, monkeypatch):
    """int8 runs in 3 chunks (TOPK_CHUNK_ROWS=120 of 300 rows) in both."""
    monkeypatch.setenv("TOPK_CHUNK_ROWS", "120")
    emb, docs, q = _corpus(1)
    ks = [1, 3, 5, 16, 2, 4]
    ours = tr.TorchRetriever(emb, docs, corpus_dtype=dtype, device="cpu")
    ref = jr.TpuRetriever(emb, docs, corpus_dtype=dtype, use_pallas=False)
    if dtype == "int8":
        assert [c.shape[0] for c, _ in ours.corpus_chunks] == [120, 120, 60]
    assert ours.batch_retrieve(q, ks) == ref.batch_retrieve(q, ks)


def test_torch_retriever_bfloat16_follows_the_kernel():
    """bf16 corpus, bf16-rounded queries: cosine_topk_pallas's semantics."""
    emb, docs, q = _corpus(2)
    ours = tr.TorchRetriever(emb, docs, corpus_dtype="bfloat16", device="cpu")
    assert ours.corpus.dtype == torch.bfloat16
    unit = emb / np.linalg.norm(emb, axis=1, keepdims=True)
    _, want = jt.cosine_topk_pallas(jnp.asarray(unit).astype(jnp.bfloat16),
                                    jnp.asarray(q), 5, block_n=128, interpret=True)
    assert ours.batch_retrieve(q, [5] * 6) == [[docs[i] for i in row]
                                               for row in np.asarray(want)]


def test_ivf_retriever_recall_and_full_probe():
    rng = np.random.default_rng(3)
    corpus = clustered_corpus(rng)
    docs = [f"d{i}" for i in range(len(corpus))]
    queries = corpus[rng.choice(len(corpus), 32, replace=False)]
    queries = queries + rng.standard_normal(queries.shape).astype(np.float32) * 0.05
    exact = tr.SimpleRetriever(corpus, docs)
    ivf = tr.IvfRetriever(corpus, docs, n_clusters=16, nprobe=4, iters=8, device="cpu")
    got = ivf.batch_retrieve(queries, [5] * 32)
    want = exact.batch_retrieve(queries, [5] * 32)
    assert sum(len(set(g) & set(w)) for g, w in zip(got, want)) / (5 * 32) >= 0.9
    full = tr.IvfRetriever(corpus, docs, n_clusters=16, nprobe=16, iters=8, device="cpu")
    assert full.batch_retrieve(queries, [5] * 32) == want


@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8", "ivf"])
def test_interface_probes(kind):
    """The verify skill's probes: an empty batch, a wrong dimension, and k
    clamped to [1, min(max_k, N)]."""
    emb, docs, q = _corpus(4, n=40)
    if kind == "ivf":
        r = tr.IvfRetriever(emb, docs, n_clusters=4, nprobe=4, max_k=8, device="cpu")
    else:
        r = tr.TorchRetriever(emb, docs, max_k=8, corpus_dtype=kind, device="cpu")
    assert r.batch_retrieve(np.zeros((0, 64), np.float32), []) == []
    assert r.batch_retrieve(np.ones((2, 32), np.float32), [2, 2]) == [[], []]
    out = r.batch_retrieve(q[[0, 0, 0, 0]], [0, 1, 500, 8])
    assert [len(row) for row in out] == [1, 1, 8, 8]
    assert out[0] == out[1] == out[2][:1] and out[2] == out[3]
    assert len(r.retrieve(q[0], 3)) == 3
    big = tr.TorchRetriever(emb[:5], docs[:5], max_k=16, device="cpu")
    assert big.max_k == 5 and len(big.retrieve(q[0], 16)) == 5


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_torch_retriever_refuses_k_beyond_the_kernels(dtype, monkeypatch):
    """There is no k beyond the kernels any more: max_k past the warp
    lists' 256, up to N, serves the JAX retriever's ids (SimpleRetriever for
    f32; TpuRetriever over 3 int8 chunks of at most 120 rows), k = N
    included."""
    monkeypatch.setenv("TOPK_CHUNK_ROWS", "120")
    emb, docs, q = _corpus(5)                      # 300 rows
    ks = [300, 257, 5, 1, 299, 300]
    ours = tr.TorchRetriever(emb, docs, max_k=300, corpus_dtype=dtype, device="cpu")
    if dtype == "float32":
        ref = jr.SimpleRetriever(emb, docs)
    else:
        ref = jr.TpuRetriever(emb, docs, corpus_dtype="int8", use_pallas=False, max_k=300)
    got = ours.batch_retrieve(q, ks)
    assert [len(r) for r in got] == ks
    assert got == ref.batch_retrieve(q, ks)
    r = tr.TorchRetriever(emb[:40], docs[:40], max_k=257, corpus_dtype=dtype,
                          device="cpu")
    assert r.max_k == 40 and len(r.retrieve(q[0], 300)) == 40


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("d", [50, 100])
def test_torch_retriever_pads_a_ragged_depth(d, dtype, monkeypatch):
    """D = 50 and 100: the corpus is held with zero columns up to a multiple
    of 16 (what the kernels read), queries of the true depth are padded a
    call, a wrong depth is still refused, and the documents are those the
    retriever over the unpadded corpus finds (the JAX retriever's for f32
    and int8)."""
    monkeypatch.setenv("TOPK_CHUNK_ROWS", "120")
    emb, docs, q = _corpus(d, d=d)
    ours = tr.TorchRetriever(emb, docs, corpus_dtype=dtype, device="cpu")
    held = ours.corpus_chunks[0][0] if dtype == "int8" else ours.corpus
    assert held.shape[1] == -(-d // 16) * 16 and not held[:, d:].any()
    ks = [1, 3, 5, 16, 2, 4]
    got = ours.batch_retrieve(q, ks)
    if dtype == "bfloat16":
        unit = emb / np.linalg.norm(emb, axis=1, keepdims=True)
        _, want = jt.cosine_topk_pallas(jnp.asarray(unit).astype(jnp.bfloat16),
                                        jnp.asarray(q), 16, block_n=128, interpret=True)
        assert got == [[docs[i] for i in row[:k]] for row, k in zip(np.asarray(want), ks)]
    else:
        ref = jr.TpuRetriever(emb, docs, corpus_dtype=dtype, use_pallas=False)
        assert got == ref.batch_retrieve(q, ks)
    assert ours.batch_retrieve(np.ones((2, held.shape[1]), np.float32), [2, 2]) == [[], []]

