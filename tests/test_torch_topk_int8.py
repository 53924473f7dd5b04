"""PyTorch port: the int8-corpus top-k (the plain version of kernel B4) and
its quantizers against the JAX package, the Pallas kernel run in interpret
mode. Indices must be identical and scores within 1e-6 after the mean term."""

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


def _corpus(seed, n, d, b):
    rng = np.random.default_rng(seed)
    return _unit(rng.standard_normal((n, d))), _unit(rng.standard_normal((b, d)))


def _assert_same(ours, ref, atol=1e-6):
    (s, i), (rs, ri) = ours, ref
    np.testing.assert_array_equal(i.numpy(), np.asarray(ri))
    np.testing.assert_allclose(s.numpy(), np.asarray(rs), atol=atol, rtol=0)


def _jax_chunks(chunks):
    return [(np.asarray(v), np.asarray(s)) for v, s in chunks]


def test_numpy_chunked_quantizer_bit_identical_to_jax():
    corpus, _ = _corpus(0, 1000, 128, 1)
    ours, mean = tt.quantize_corpus_int8_chunked(corpus, chunk_rows=300)
    ref, ref_mean = jt.quantize_corpus_int8_chunked(corpus, chunk_rows=300)
    assert [v.shape[0] for v, _ in ours] == [300, 300, 300, 100]
    np.testing.assert_array_equal(mean.numpy(), np.asarray(ref_mean))
    for (v, s), (rv, rs) in zip(ours, _jax_chunks(ref)):
        assert v.dtype == torch.int8 and s.dtype == torch.float32
        np.testing.assert_array_equal(v.numpy(), rv)
        np.testing.assert_array_equal(s.numpy(), rs)


def test_torch_quantizer_within_one_of_jax():
    """jnp.mean and torch.mean differ in the last bits, which can move a
    value across a rounding boundary: values within 1, scales at 1e-6."""
    corpus, _ = _corpus(1, 700, 64, 1)
    v, s, m = tt.quantize_corpus_int8(torch.tensor(corpus))
    rv, rs, rm = jt.quantize_corpus_int8(jnp.asarray(corpus))
    assert v.dtype == torch.int8 and s.shape == (1, 700) and m.shape == (1, 64)
    assert np.abs(v.numpy().astype(int) - np.asarray(rv).astype(int)).max() <= 1
    np.testing.assert_allclose(s.numpy(), np.asarray(rs), rtol=1e-6)
    np.testing.assert_allclose(m.numpy(), np.asarray(rm), rtol=0, atol=1e-7)


@pytest.mark.parametrize("n,d,b,k", [
    (300, 64, 1, 1),      # N a multiple of no block size
    (1000, 128, 5, 16),
    (130, 64, 3, 32),     # the widest list a warp holds
    (2000, 64, 8, 5),
    (300, 64, 3, 48),     # past the warp lists (the select on the card)
])
def test_matches_pallas_int8(n, d, b, k):
    """Pre-normalized queries (normalize_queries=False): the two packages
    normalize in different summation orders, which could move a query
    value across an int8 rounding boundary."""
    corpus, queries = _corpus(n + k, n, d, b)
    (cv, cs), = _jax_chunks(jt.quantize_corpus_int8_chunked(corpus, chunk_rows=n)[0])
    mean = corpus.mean(axis=0, keepdims=True)
    ours = tt.cosine_topk_int8(torch.tensor(cv), torch.tensor(cs), torch.tensor(queries),
                               k, corpus_mean=torch.tensor(mean), normalize_queries=False)
    assert ours[1].dtype == torch.int32 and ours[0].shape == (b, k)
    ref = jt.cosine_topk_pallas_int8(jnp.asarray(cv), jnp.asarray(cs), jnp.asarray(queries),
                                     k, corpus_mean=jnp.asarray(mean), block_n=256,
                                     interpret=True, normalize_queries=False)
    _assert_same(ours, ref)


def test_normalized_queries_match_pallas_int8_except_near_ties():
    """With normalization on, a query's int8 rounding may flip; indices must
    still agree wherever the two neighbouring f32 scores are not within
    1e-3 of each other."""
    corpus, _ = _corpus(3, 1500, 64, 1)
    queries = np.random.default_rng(4).standard_normal((8, 64)).astype(np.float32) * 3
    chunks, mean = tt.quantize_corpus_int8_chunked(corpus, chunk_rows=1500)
    (cv, cs), = chunks
    s, i = tt.cosine_topk_int8(cv, cs, torch.tensor(queries), 16, corpus_mean=mean)
    rs, ri = jt.cosine_topk_pallas_int8(jnp.asarray(cv.numpy()), jnp.asarray(cs.numpy()),
                                        jnp.asarray(queries), 16,
                                        corpus_mean=jnp.asarray(mean.numpy()),
                                        interpret=True)
    rs, ri = np.asarray(rs), np.asarray(ri)
    gaps = np.abs(np.diff(rs, axis=1))
    near = np.zeros_like(ri, dtype=bool)
    near[:, :-1] |= gaps < 1e-3
    near[:, 1:] |= gaps < 1e-3
    assert (~near).sum() >= 64   # at least half the ranks are checked
    np.testing.assert_array_equal(i.numpy()[~near], ri[~near])
    np.testing.assert_allclose(s.numpy(), rs, atol=1e-5)


def test_exact_ties_rank_lowest_index_first():
    """Duplicated rows quantize identically and tie exactly; the lower index
    wins in the port, the JAX kernel and across chunk boundaries."""
    rng = np.random.default_rng(5)
    patterns = _unit(rng.standard_normal((4, 64)))
    corpus = patterns[rng.integers(0, 4, 400)]
    queries = patterns[[0, 1, 2]]
    single, mean = tt.quantize_corpus_int8_chunked(corpus, chunk_rows=400)
    ours = tt.cosine_topk_int8(*single[0], torch.tensor(queries), 16, corpus_mean=mean,
                               normalize_queries=False)
    ref = jt.cosine_topk_pallas_int8(*map(jnp.asarray, _jax_chunks(single)[0]),
                                     jnp.asarray(queries), 16,
                                     corpus_mean=jnp.asarray(mean.numpy()),
                                     block_n=256, interpret=True, normalize_queries=False)
    _assert_same(ours, ref)
    s, i = ours
    for row in range(3):
        want = np.flatnonzero((corpus == queries[row]).all(axis=1))[:16]
        np.testing.assert_array_equal(i[row].numpy(), want)
    chunks, _ = tt.quantize_corpus_int8_chunked(corpus, chunk_rows=70)
    cs, ci = tt.cosine_topk_int8_chunked(chunks, torch.tensor(queries), 16,
                                         corpus_mean=mean, normalize_queries=False)
    assert torch.equal(ci, i) and torch.equal(cs, s)


def test_chunked_matches_single_chunk_and_jax():
    corpus, queries = _corpus(11, 1000, 128, 4)
    one, m1 = tt.quantize_corpus_int8_chunked(corpus, chunk_rows=10**9)
    four, m4 = tt.quantize_corpus_int8_chunked(corpus, chunk_rows=300)
    q = torch.tensor(queries)
    s1, i1 = tt.cosine_topk_int8_chunked(one, q, 5, corpus_mean=m1)
    s4, i4 = tt.cosine_topk_int8_chunked(four, q, 5, corpus_mean=m4)
    assert torch.equal(i1, i4) and torch.equal(s1, s4)
    assert int(i4.max()) >= 300   # global indices past the first chunk
    ref = jt.cosine_topk_int8_chunked(
        [tuple(map(jnp.asarray, c)) for c in _jax_chunks(four)], jnp.asarray(queries), 5,
        corpus_mean=jnp.asarray(m4.numpy()), interpret=True)
    np.testing.assert_array_equal(i4.numpy(), np.asarray(ref[1]))
    np.testing.assert_allclose(s4.numpy(), np.asarray(ref[0]), atol=1e-6)


def test_squad_real_embeddings_noisy_queries():
    """The repo's real e5 corpus (1000 x 1024), seeded noisy copies of
    corpus rows as queries (the ranks that matter: a tight cone of
    embeddings, which is why the quantizer centres on the mean)."""
    corpus = _unit(np.load(os.path.join(DATA, "squad_real_embeddings.npy")))
    rng = np.random.default_rng(6)
    rows = rng.integers(0, corpus.shape[0], 8)
    queries = _unit(corpus[rows] + 0.02 * rng.standard_normal((8, corpus.shape[1])))
    chunks, mean = tt.quantize_corpus_int8_chunked(corpus, chunk_rows=400)
    ours = tt.cosine_topk_int8_chunked(chunks, torch.tensor(queries), 16, corpus_mean=mean,
                                       normalize_queries=False)
    jchunks = [tuple(map(jnp.asarray, c)) for c in _jax_chunks(chunks)]
    allc = (jnp.concatenate([c for c, _ in jchunks]), jnp.concatenate([s for _, s in jchunks], 1))
    ref = jt.cosine_topk_pallas_int8(*allc, jnp.asarray(queries), 16,
                                     corpus_mean=jnp.asarray(mean.numpy()), block_n=512,
                                     interpret=True, normalize_queries=False)
    _assert_same(ours, ref)
    np.testing.assert_array_equal(ours[1][:, 0].numpy(), rows)


def test_plain_int8_dots_stay_exact_past_2_24():
    """At D = 1056, D * 127^2 > 2^24: an f32 product of int8 values could
    round, so the plain version takes f64; its dots equal int64 ones."""
    rng = np.random.default_rng(8)
    c = rng.choice([-127, 127], size=(60, 1056)).astype(np.int8)
    c[7] = c[3]                                  # an exact tie
    scales = np.full((1, 60), 0.01, np.float32)
    q = c[[3, 5]].astype(np.float32)
    s, i = tt.cosine_topk_int8(torch.tensor(c), torch.tensor(scales), torch.tensor(q), 4,
                               normalize_queries=False)
    dots = q.astype(np.int64) @ c.astype(np.int64).T
    assert dots.max() >= 2 ** 24
    order = np.argsort(-dots, axis=1, kind="stable")[:, :4]
    np.testing.assert_array_equal(i.numpy(), order)
    want = (torch.tensor(np.take_along_axis(dots, order, 1)).float() * 0.01
            * tt._quantize_queries_int8(torch.tensor(q))[1])
    assert torch.equal(s, want)
    assert i[0, :2].tolist() == [3, 7]


@pytest.mark.parametrize("side", [0, 1])
def test_matches_pallas_int8_beside_the_list_limit(side):
    """k just below (at) and just above LIST_K for an int8 corpus, where the
    card switches from B4's warp lists to the scores and the select: the
    plain version against the Pallas kernel in interpret mode."""
    k = tt.LIST_K[torch.int8] + side
    corpus, queries = _corpus(k, 300, 64, 2)
    (cv, cs), = _jax_chunks(jt.quantize_corpus_int8_chunked(corpus, chunk_rows=300)[0])
    mean = corpus.mean(axis=0, keepdims=True)
    ours = tt.cosine_topk_int8(torch.tensor(cv), torch.tensor(cs), torch.tensor(queries),
                               k, corpus_mean=torch.tensor(mean), normalize_queries=False)
    assert ours[0].shape == (2, k)
    ref = jt.cosine_topk_pallas_int8(jnp.asarray(cv), jnp.asarray(cs), jnp.asarray(queries),
                                     k, corpus_mean=jnp.asarray(mean), block_n=128,
                                     interpret=True, normalize_queries=False)
    _assert_same(ours, ref)


def test_cuda_wrapper_refuses_other_devices():
    """No fallback: a tensor that is neither on the CPU nor on a CUDA device
    raises instead of taking the plain version."""
    c = torch.empty((8, 64), dtype=torch.int8, device="meta")
    with pytest.raises(ValueError):
        tt.cosine_topk_int8(c, torch.empty((1, 8), device="meta"),
                            torch.empty((1, 64), device="meta"), 2)


@pytest.mark.parametrize("chunk_rows", [120, 1000])
def test_chunked_beyond_the_warp_lists_equals_one_array(chunk_rows):
    """k = 300 of 360 rows (past LIST_K) over int8 chunks of 120 rows (the
    merge is select_topk) and in one chunk: the ids and scores of the plain
    scan over the whole corpus, duplicated rows included."""
    rng = np.random.default_rng(chunk_rows)
    emb = rng.standard_normal((360, 64)).astype(np.float32)
    emb[200:230] = emb[10:40]
    emb /= np.linalg.norm(emb, axis=1, keepdims=True)
    q = torch.tensor(rng.standard_normal((3, 64)).astype(np.float32))
    chunks, mean = tt.quantize_corpus_int8_chunked(emb, chunk_rows=chunk_rows)
    s, i = tt.cosine_topk_int8_chunked(chunks, q, 300, corpus_mean=mean)
    whole, _ = tt.quantize_corpus_int8_chunked(emb, chunk_rows=360)
    rs, ri = tt.cosine_topk_int8_reference(whole[0][0], whole[0][1], q, 300,
                                           corpus_mean=mean)
    assert torch.equal(i, ri) and torch.equal(s, rs)


@pytest.mark.parametrize("d", [50, 100])
def test_ragged_depths_match_pallas_int8(d):
    """D = 50 and 100 (no multiple of 16): the ids and scores of the JAX
    wrapper, which pads and takes them; and a corpus padded with zero
    columns before quantization, as the engine and the retrievers hold it,
    quantizes to the same values and scales and retrieves the same ids."""
    corpus, queries = _corpus(d, 400, d, 4)
    (cv, cs), = _jax_chunks(jt.quantize_corpus_int8_chunked(corpus, chunk_rows=400)[0])
    mean = corpus.mean(axis=0, keepdims=True)
    ours = tt.cosine_topk_int8(torch.tensor(cv), torch.tensor(cs), torch.tensor(queries),
                               16, corpus_mean=torch.tensor(mean), normalize_queries=False)
    ref = jt.cosine_topk_pallas_int8(jnp.asarray(cv), jnp.asarray(cs), jnp.asarray(queries),
                                     16, corpus_mean=jnp.asarray(mean), block_n=128,
                                     interpret=True, normalize_queries=False)
    _assert_same(ours, ref)
    wide = np.pad(corpus, ((0, 0), (0, -d % tt.DEPTH_ALIGN)))
    ((pv, ps),), pmean = tt.quantize_corpus_int8_chunked(wide, chunk_rows=400)
    assert pv.shape == (400, -(-d // 16) * 16)
    np.testing.assert_array_equal(pv[:, :d].numpy(), cv)
    np.testing.assert_array_equal(ps.numpy(), cs)
    assert not pv[:, d:].any() and not pmean[:, d:].any()
    padded = tt.cosine_topk_int8(pv, ps, tt.pad_depth(torch.tensor(queries)), 16,
                                 corpus_mean=pmean, normalize_queries=False)
    _assert_same(padded, ref)

