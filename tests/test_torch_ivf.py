"""PyTorch port: IVF retrieval (k-means, index build, search, the engine's
recall gate) against the JAX package. k-means starts from JAX's own draw of
initial rows, which torch.Generator cannot reproduce; centroids must agree
within 1e-5 and search ids exactly."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rag_serving_system_tpu.ops import ivf as jivf  # noqa: E402
from rag_serving_system_torch.config import Settings  # noqa: E402
from rag_serving_system_torch.core import engine as port_engine  # noqa: E402
from rag_serving_system_torch.models.weights import ivf_index_from_jax  # noqa: E402
from rag_serving_system_torch.ops import ivf as tivf  # noqa: E402


def _settings(**over):
    """Tiny engine settings with IVF on (the port serves PREFIX_CACHE=0)."""
    return Settings(model_preset="tiny", dtype="float32", prefix_cache=False,
                    batch_buckets=[2], max_batch_size=2, encode_len_buckets=[16],
                    prompt_len_buckets=[64], max_new_tokens=2, decode_mode="fixed",
                    quant_weights="none", quant_act="none", spec_gamma=0,
                    mesh_shape="", weights_dir=None, embed_model_name="e5",
                    llm_model_name="qwen", retriever="ivf", **over)


def clustered_corpus(rng, n_clusters=16, per=64, d=64):
    """Well-separated clusters, as tests/test_ivf.py builds them."""
    centers = rng.standard_normal((n_clusters, d)).astype(np.float32) * 5
    rows = np.concatenate([
        centers[i] + rng.standard_normal((per, d)).astype(np.float32) * 0.3
        for i in range(n_clusters)])
    return rows / np.linalg.norm(rows, axis=-1, keepdims=True)


def _jax_init(corpus, n_clusters, seed=0):
    """The rows jax's _kmeans starts from."""
    pick = jax.random.choice(jax.random.PRNGKey(seed), corpus.shape[0],
                             shape=(n_clusters,), replace=False)
    return np.asarray(corpus)[np.asarray(pick)]


@pytest.mark.parametrize("n_clusters,iters", [(16, 5), (8, 10)])
def test_kmeans_with_jax_init_matches_jax(n_clusters, iters):
    corpus = clustered_corpus(np.random.default_rng(n_clusters))
    ref = np.asarray(jivf._kmeans(jnp.asarray(corpus), n_clusters, iters))
    ours = tivf._kmeans(torch.tensor(corpus), n_clusters, iters,
                        init=torch.tensor(_jax_init(corpus, n_clusters)))
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-5, rtol=0)


def test_kmeans_argmax_ties_match_jax():
    """Four distinct rows, each repeated 16 times: JAX's 8 initial rows
    repeat, so assignment scores tie exactly; both packages give a tie to
    the first cluster, and a cluster left empty keeps its centroid."""
    rng = np.random.default_rng(9)
    pats = rng.standard_normal((4, 64)).astype(np.float32)
    corpus = (pats / np.linalg.norm(pats, axis=1, keepdims=True))[np.arange(64) % 4]
    init = _jax_init(corpus, 8)
    assert len({r.tobytes() for r in init}) < 8
    ref = np.asarray(jivf._kmeans(jnp.asarray(corpus), 8, 3))
    ours = tivf._kmeans(torch.tensor(corpus), 8, 3, init=torch.tensor(init))
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-6, rtol=0)


def test_build_ivf_with_jax_init_packs_as_jax():
    corpus = clustered_corpus(np.random.default_rng(1), n_clusters=8, per=32)
    ref = jivf.build_ivf(corpus, n_clusters=8, iters=6)
    ours = tivf.build_ivf(torch.tensor(corpus), n_clusters=8, iters=6,
                          init=torch.tensor(_jax_init(corpus, 8)))
    np.testing.assert_array_equal(ours.packed_idx.numpy(), np.asarray(ref.packed_idx))
    np.testing.assert_allclose(ours.packed.numpy(), np.asarray(ref.packed), atol=0)


@pytest.mark.parametrize("k,nprobe", [(5, 4), (16, 1), (40, 2)])
def test_search_on_converted_index_gives_jax_ids(k, nprobe):
    """k=40 at nprobe=2 of 8-row clusters pads with -1 ids in both."""
    rng = np.random.default_rng(2)
    corpus = clustered_corpus(rng, n_clusters=12, per=8 if k == 40 else 48)
    index = jivf.build_ivf(corpus, n_clusters=12, iters=8)
    queries = corpus[rng.choice(len(corpus), 6, replace=False)]
    queries = queries + 0.05 * rng.standard_normal(queries.shape).astype(np.float32)
    rs, ri = jivf.ivf_search(index, jnp.asarray(queries), k, nprobe=nprobe)
    s, i = tivf.ivf_search(ivf_index_from_jax(jax.device_get(index)),
                           torch.tensor(queries), k, nprobe=nprobe)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    np.testing.assert_allclose(s.numpy(), np.asarray(rs), atol=1e-6)
    assert ((i < 0).any().item()) == (k == 40)


def test_engine_recall_gate_refuses_unclusterable():
    """Uniform random embeddings do not cluster: the startup gate refuses to
    serve rather than degrade recall."""
    corpus = np.random.default_rng(3).standard_normal((512, 64)).astype(np.float32)
    docs = [f"doc {i}" for i in range(512)]
    s = _settings(ivf_clusters=64, ivf_nprobe=1, ivf_recall_gate=0.9)
    with pytest.raises(ValueError, match="recall"):
        port_engine.RagEngine(s, docs, corpus, device="cpu")


def test_engine_drops_ivf_sentinels():
    """Tight clusters of 4, nprobe=1, k=16: ivf_search pads with -1, and the
    engine drops them instead of indexing documents[-1]."""
    corpus = clustered_corpus(np.random.default_rng(4), n_clusters=8, per=4)
    docs = [f"doc {i}" for i in range(corpus.shape[0])]
    s = _settings(ivf_clusters=8, ivf_nprobe=1, ivf_recall_gate=0.0, max_k=16,
                  query_cache_size=0)
    eng = port_engine.RagEngine(s, docs, corpus, device="cpu")
    assert eng.ivf_index is not None and eng.corpus is None
    _, raw = tivf.ivf_search(eng.ivf_index, eng._embed_queries(["doc 3", "doc 7"]), 16,
                             nprobe=1)
    assert (raw < 0).any()
    rows = eng.embed_and_retrieve(["doc 3", "doc 7"], [16, 16])
    for row in rows:
        assert row and all(i >= 0 for i in row) and len(row) < 16
        assert len(row) == len(set(row))
    assert len(eng.process(["doc 3"], [16])) == 1
