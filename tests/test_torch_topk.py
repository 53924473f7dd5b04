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
    (300, 3, 48),     # past the warp lists (the select on the card)
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
    """k = 256, past the warp lists (on the card: the score kernel and
    select_topk), against the oracle only (interpret mode would take 256
    selection rounds a block)."""
    rng = np.random.default_rng(n + b)
    corpus = _unit(rng.standard_normal((n, 64)))
    queries = rng.standard_normal((b, 64)).astype(np.float32)
    ours = tt.cosine_topk(torch.tensor(corpus), torch.tensor(queries), 256)
    assert max(tt.LIST_K.values()) <= tt.LIST_MAX < 256 and ours[1].shape == (b, 256)
    _assert_same(ours, jt.cosine_topk_reference(jnp.asarray(corpus),
                                                jnp.asarray(queries), 256))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("side", [0, 1])
def test_matches_pallas_beside_the_list_limit(dtype, side):
    """k just below (at) and just above LIST_K for the corpus dtype, where
    the card switches from the warp lists to the scores and the select: the
    plain version against the Pallas kernel in interpret mode."""
    tdt = getattr(torch, dtype)
    k = tt.LIST_K[tdt] + side
    rng = np.random.default_rng(k)
    corpus = jnp.asarray(_unit(rng.standard_normal((300, 64)))).astype(getattr(jnp, dtype))
    queries = rng.standard_normal((2, 64)).astype(np.float32)
    tcorpus = torch.tensor(np.asarray(corpus.astype(jnp.float32))).to(tdt)
    ours = tt.cosine_topk(tcorpus, torch.tensor(queries), k)
    assert ours[1].shape == (2, k)
    _assert_same(ours, jt.cosine_topk_pallas(corpus, jnp.asarray(queries), k,
                                             block_n=128, interpret=True))


@pytest.mark.parametrize("n,b,rows,sms,per_sm,want", [
    (1 << 20, 32, 128, 132, 2, (32, 256)),    # B4 at 1M rows: one wave of 264 CTAs
    (1 << 20, 32, 512, 132, 1, (16, 128)),    # the float tile, one CTA an SM
    (1000, 32, 128, 132, 2, (1, 8)),          # fewer tiles than CTAs: a tile each
    (1 << 20, 64, 128, 132, 2, (63, 131)),    # two query groups share the wave
    (4_194_304, 33, 128, 132, 1, (497, 66)),  # D = 2048: one CTA an SM
    (5, 1, 128, 1, 1, (1, 1)),
])
def test_one_wave_grid(n, b, rows, sms, per_sm, want):
    """The int8 and float tiles' grid: every tile in one span, no more CTAs
    than one wave holds, no CTA without a tile."""
    tiles_per_cta, n_ctas = tt.one_wave(n, b, rows, sms, per_sm)
    assert (tiles_per_cta, n_ctas) == want
    n_tiles = -(-n // rows)
    assert n_ctas * -(-b // 32) <= max(1, per_sm * sms)
    assert (n_ctas - 1) * tiles_per_cta < n_tiles <= n_ctas * tiles_per_cta


@pytest.mark.parametrize("b,ln,k,sms,want", [
    (32, 1 << 20, 1024, 132, (8, 1024)),    # the timed select: 256 CTAs, one wave
    (1, 1 << 20, 1, 132, (128, 2)),         # one row: a slice an 8,192-score tile
    (65, 777, 700, 132, (1, 1024)),
    (300, 1 << 20, 16, 132, (1, 16)),       # more rows than a wave holds
    (3, 50_000, 20_000, 132, (7, 32_768)),
    (2, 1000, 1000, 132, (1, 1024)),        # k = L
])
def test_select_sizes(b, ln, k, sms, want):
    """The select's slices, sort width, scratch and candidate sizes."""
    size = tt.select_sizes(b, ln, k, sms)
    assert (size.slices, size.width) == want
    assert size.width >= max(k, 2) and size.width & (size.width - 1) == 0
    assert size.scratch_words == b * (size.slices * tt.SELECT_BINS + 8 + 3 * size.slices)
    assert size.candidates == b * min(ln, tt.SELECT_CAND_CAP)


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", [50, 100])
def test_ragged_depths_match_pallas(d, dtype):
    """D = 50 and 100, rows of no whole number of 16-byte pieces: the JAX
    wrapper pads and takes them, and so does the port's, the ids of the
    Pallas kernel in interpret mode."""
    rng = np.random.default_rng(d)
    corpus = jnp.asarray(_unit(rng.standard_normal((400, d)))).astype(getattr(jnp, dtype))
    queries = rng.standard_normal((4, d)).astype(np.float32)
    tcorpus = torch.tensor(np.asarray(corpus.astype(jnp.float32))).to(getattr(torch, dtype))
    ref = jt.cosine_topk_pallas(corpus, jnp.asarray(queries), 16, block_n=128, interpret=True)
    _assert_same(tt.cosine_topk(tcorpus, torch.tensor(queries), 16), ref)
    # what the wrapper does with such a depth on the card, and a holder of a
    # corpus at set-up: zero columns up to a multiple of 16
    padded = tt.cosine_topk(tt.pad_depth(tcorpus), tt.pad_depth(torch.tensor(queries)), 16)
    _assert_same(padded, ref)


def test_pad_depth_appends_zero_columns():
    x = torch.arange(12, dtype=torch.float32).reshape(2, 6)
    y = tt.pad_depth(x)
    assert y.shape == (2, tt.DEPTH_ALIGN) and y.is_contiguous()
    assert torch.equal(y[:, :6], x) and not y[:, 6:].any()
    assert tt.pad_depth(y) is y                       # already whole: no copy
    w = tt.pad_depth(x.numpy())                       # a corpus at set-up
    assert isinstance(w, np.ndarray) and np.array_equal(w, y.numpy())
    assert tt.pad_depth(w) is w
    for dtype in (torch.bfloat16, torch.int8):
        z = tt.pad_depth(x.to(dtype))
        assert z.dtype == dtype and z.shape == (2, 16) and not z[:, 6:].any()
        assert (z.shape[1] * z.element_size()) % 16 == 0
    assert tt.pad_depth(torch.zeros((3, 50))).shape == (3, 64)
    assert tt.pad_depth(torch.zeros((3, 100))).shape == (3, 112)

