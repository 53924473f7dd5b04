"""PyTorch port: exact cosine top-k (the plain version of kernel B1) against
the JAX oracle and the Pallas kernel in interpret mode. Indices must be
identical and scores within 1e-5."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from rag_serving_system_tpu.ops import topk as jt  # noqa: E402
from rag_serving_system_torch.ops import topk as tt  # noqa: E402

DATA = os.path.join(os.path.dirname(__file__), "..", "data")


def _unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def _assert_same(ours, ref):
    (s, i), (rs, ri) = ours, ref
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    np.testing.assert_allclose(s.numpy(), np.asarray(rs), atol=1e-5, rtol=0)


@pytest.mark.parametrize("n,b,k", [
    (300, 1, 1),      # N a multiple of no block size
    (300, 5, 2),
    (1000, 5, 16),
    (130, 1, 16),
    (300, 3, 48),     # a list wider than one register a lane
])
def test_matches_oracle_and_pallas(n, b, k):
    rng = np.random.default_rng(n + b + k)
    corpus = _unit(rng.standard_normal((n, 64)))
    queries = rng.standard_normal((b, 64)).astype(np.float32)
    ours = tt.cosine_topk(torch.tensor(corpus), torch.tensor(queries), k)
    assert ours[1].dtype == torch.int32
    _assert_same(ours, jt.cosine_topk_reference(jnp.asarray(corpus),
                                                jnp.asarray(queries), k))
    _assert_same(ours, jt.cosine_topk_pallas(jnp.asarray(corpus),
                                             jnp.asarray(queries), k,
                                             block_n=128, interpret=True))


@pytest.mark.parametrize("n,b", [(300, 2), (700, 3)])
def test_widest_list_matches_oracle(n, b):
    """k = LIST_K = 256, against the oracle only (interpret mode would take
    256 selection rounds a block)."""
    rng = np.random.default_rng(n + b)
    corpus = _unit(rng.standard_normal((n, 64)))
    queries = rng.standard_normal((b, 64)).astype(np.float32)
    ours = tt.cosine_topk(torch.tensor(corpus), torch.tensor(queries), tt.LIST_K)
    assert tt.LIST_K == 256 and ours[1].shape == (b, 256)
    _assert_same(ours, jt.cosine_topk_reference(jnp.asarray(corpus),
                                                jnp.asarray(queries), 256))


def test_bfloat16_corpus_matches_pallas():
    """A bf16 corpus meets bf16-rounded queries in both packages."""
    rng = np.random.default_rng(3)
    corpus = jnp.asarray(_unit(rng.standard_normal((500, 64)))).astype(jnp.bfloat16)
    queries = rng.standard_normal((5, 64)).astype(np.float32)
    tcorpus = torch.tensor(np.asarray(corpus.astype(jnp.float32))).to(torch.bfloat16)
    ours = tt.cosine_topk(tcorpus, torch.tensor(queries), 16)
    _assert_same(ours, jt.cosine_topk_pallas(corpus, jnp.asarray(queries), 16,
                                             block_n=128, interpret=True))


def test_exact_ties_rank_lowest_index_first():
    """Rows of +-1/8 entries (unit norm at D = 64) give exactly representable
    dot products, so duplicated rows tie exactly; the lower index wins."""
    rng = np.random.default_rng(4)
    patterns = np.where(rng.random((4, 64)) < 0.5, -0.125, 0.125).astype(np.float32)
    corpus = patterns[rng.integers(0, 4, 200)]
    queries = patterns[[0, 1, 2]] * np.float32(1.0)
    ours = tt.cosine_topk(torch.tensor(corpus), torch.tensor(queries), 16)
    ref = jt.cosine_topk_reference(jnp.asarray(corpus), jnp.asarray(queries), 16)
    _assert_same(ours, ref)
    _assert_same(ours, jt.cosine_topk_pallas(jnp.asarray(corpus),
                                             jnp.asarray(queries), 16,
                                             block_n=128, interpret=True))
    s, i = ours
    for row in range(3):   # equal scores come in ascending index order
        for j in range(15):
            if s[row, j] == s[row, j + 1]:
                assert i[row, j] < i[row, j + 1]


def test_squad_real_embeddings_noisy_queries():
    """The repo's real e5 corpus (1000 x 1024) with seeded noisy copies of
    corpus rows as queries."""
    corpus = np.load(os.path.join(DATA, "squad_real_embeddings.npy")).astype(np.float32)
    corpus = _unit(corpus)
    rng = np.random.default_rng(5)
    rows = rng.integers(0, corpus.shape[0], 8)
    queries = (corpus[rows] + 0.02 * rng.standard_normal((8, corpus.shape[1]))
               ).astype(np.float32)
    ours = tt.cosine_topk(torch.tensor(corpus), torch.tensor(queries), 16)
    _assert_same(ours, jt.cosine_topk_reference(jnp.asarray(corpus),
                                                jnp.asarray(queries), 16))
    _assert_same(ours, jt.cosine_topk_pallas(jnp.asarray(corpus),
                                             jnp.asarray(queries), 16,
                                             block_n=256, interpret=True))
    np.testing.assert_array_equal(ours[1][:, 0].numpy(), rows)


def test_cuda_wrapper_refuses_other_devices():
    """No fallback: a tensor that is neither on the CPU nor on a CUDA device
    raises instead of taking the plain version."""
    c = torch.empty((8, 64), device="meta")
    with pytest.raises(ValueError):
        tt.cosine_topk(c, torch.empty((1, 64), device="meta"), 2)


@pytest.mark.parametrize("n,k", [(300, 257), (300, 300), (700, 512)])
def test_beyond_the_warp_lists_matches_oracle(n, k):
    """k past LIST_K, k = N included, with duplicated rows: the JAX oracle's
    ids and scores."""
    rng = np.random.default_rng(n + k)
    corpus = _unit(rng.standard_normal((n, 64)))
    corpus[n // 2:n // 2 + 40] = corpus[:40]      # 40 exact ties a query
    queries = rng.standard_normal((3, 64)).astype(np.float32)
    ours = tt.cosine_topk(torch.tensor(corpus), torch.tensor(queries), k)
    assert ours[1].shape == (3, k)
    _assert_same(ours, jt.cosine_topk_reference(jnp.asarray(corpus),
                                                jnp.asarray(queries), k))


def _tied_scores(seed, b=4, n=1000):
    """Scores on a coarse grid (many exact ties), with -0.0 and +0.0."""
    rng = np.random.default_rng(seed)
    s = np.round(rng.standard_normal((b, n)), 1).astype(np.float32)
    s[:, ::7] = 0.0
    s[:, 3::7] = -0.0
    return torch.tensor(s)


@pytest.mark.parametrize("rows", [64, 100, 1000])
@pytest.mark.parametrize("k", [1, 257, 999, 1000])
def test_scan_select_chunks_equal_one_stable_topk(rows, k):
    """The chunk loop and merge of the k > LIST_K path (scores of `rows`
    rows at a time, each chunk's best selected, then merged) give the
    ids and scores of one stable sort of the whole row: ties, -0.0 against
    +0.0, and chunk boundaries included."""
    full = _tied_scores(rows + k)
    got = tt.scan_select(full.shape[1], k, rows, lambda lo, hi: full[:, lo:hi].contiguous())
    want_s, want_pos = tt.stable_topk(full, k)
    assert torch.equal(got[1], want_pos.to(torch.int32))
    assert torch.equal(got[0], want_s)


def test_select_topk_plain_maps_positions_to_indices():
    s = _tied_scores(9, b=2, n=50)
    idx = torch.arange(1000, 1050, dtype=torch.int32).repeat(2, 1).contiguous()
    a = tt.select_topk(s, 20, indices=idx)
    b = tt.select_topk(s, 20, base=1000)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert int(b[1].min()) >= 1000
