"""PyTorch port: each CUDA kernel against its plain version, on the card.

Skipped without a CUDA device (the kernels have no CPU mode; their plain
versions are pinned to the JAX package by the other test_torch_* files).
On a machine with an NVIDIA GPU and nvcc:

    python -m pytest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from unittest import mock  # noqa: E402

from rag_serving_system_torch.device import resolve_device  # noqa: E402
from rag_serving_system_torch.ops import attention as ta  # noqa: E402
from rag_serving_system_torch.ops import probes as tp  # noqa: E402
from rag_serving_system_torch.ops import topk as tt  # noqa: E402


@pytest.fixture(autouse=True)
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return resolve_device("cuda")


def _randn(dev, shape, seed, dtype=torch.float32):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev).to(dtype)


@pytest.mark.parametrize("n,b,k,dtype", [
    (1000, 32, 16, torch.float32),
    (777, 5, 1, torch.float32),        # N a multiple of no tile, k = 1
    (5000, 64, 16, torch.float32),     # two query groups of 32
    (4099, 3, 2, torch.bfloat16),
    (300, 2, 32, torch.float32),       # the widest list: one register a lane
    (1300, 4, 33, torch.float32),      # past the lists: the scores and select_topk
    (777, 5, 64, torch.float32),
    (2000, 3, 64, torch.bfloat16),
    (5000, 40, 100, torch.float32),    # two query groups
    (3001, 2, 256, torch.float32),
    (3001, 2, 256, torch.bfloat16),
])
def test_topk_kernel_matches_plain(dev, n, b, k, dtype):
    corpus = tt.l2_normalize(_randn(dev, (n, 1024), n)).to(dtype)
    q = _randn(dev, (b, 1024), n + 1)
    before = tt.cosine_topk.launches
    s, i = tt.cosine_topk(corpus, q, k)
    assert tt.cosine_topk.launches == before + 1
    rs, ri = tt.cosine_topk_reference(corpus, q, k + 1)
    torch.testing.assert_close(s, rs[:, :k], atol=1e-5, rtol=0)
    if k <= 32:
        assert torch.equal(i, ri[:, :k])
    else:
        # a long list spans scores a few 1e-5 apart: the kernel's summation
        # order (an fmaf chain) and cuBLAS's may swap two ranks whose plain
        # scores lie within 1e-6, and nowhere else
        assert not _swaps_beyond_near_ties(i, rs, ri).any()


@pytest.mark.parametrize("d,dtype", [(20, torch.float32), (72, torch.float32),
                                     (40, torch.bfloat16), (88, torch.bfloat16)])
def test_topk_kernel_ragged_depth(dev, d, dtype):
    """Rows of 80, 288, 80 and 176 bytes: the last 64-byte chunk of each row
    is partly past D and must read as 0."""
    corpus = tt.l2_normalize(_randn(dev, (1500, d), d)).to(dtype)
    q = _randn(dev, (3, d), d + 1)
    s, i = tt.cosine_topk(corpus, q, 40)
    rs, ri = tt.cosine_topk_reference(corpus, q, 41)
    torch.testing.assert_close(s, rs[:, :40], atol=1e-5, rtol=0)
    assert not _swaps_beyond_near_ties(i, rs, ri).any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [50, 100, 20])
def test_topk_kernel_pads_depths_of_no_whole_16_bytes(dev, d, dtype):
    """D = 50 and 100 (and bf16 rows of 40 bytes), which the TPU wrapper
    pads and takes: the wrapper appends zero columns to corpus and queries
    and launches; scores and ids are the plain version's on the unpadded
    tensors. A corpus padded beforehand (as the engine holds it) gives the
    same."""
    corpus = tt.l2_normalize(_randn(dev, (1500, d), d)).to(dtype)
    q = _randn(dev, (3, d), d + 1)
    before = tt.cosine_topk.launches
    s, i = tt.cosine_topk(corpus, q, 16)
    assert tt.cosine_topk.launches == before + 1
    rs, ri = tt.cosine_topk_reference(corpus, q, 17)
    torch.testing.assert_close(s, rs[:, :16], atol=1e-5, rtol=0)
    assert not _swaps_beyond_near_ties(i, rs, ri).any()
    s2, i2 = tt.cosine_topk(tt.pad_depth(corpus), tt.pad_depth(q), 16)
    assert torch.equal(i2, i) and torch.equal(s2, s)


@pytest.mark.parametrize("d,k", [(50, 16), (100, 16), (50, 40), (8, 4)])
def test_topk_int8_kernel_pads_depths_off_16(dev, d, k):
    """B4 at D = 50, 100 and 8: zero columns up to a multiple of 16 in the
    wrapper; ids and scores bit-identical to the plain version on the
    unpadded tensors."""
    c, scales = _int8_corpus(dev, 1200, d, d)
    q = _randn(dev, (5, d), d + 1)
    mean = _randn(dev, (1, d), d + 2) * 0.1
    before = tt.cosine_topk_int8.launches
    s, i = tt.cosine_topk_int8(c, scales, q, k, corpus_mean=mean)
    assert tt.cosine_topk_int8.launches == before + 1
    rs, ri = tt.cosine_topk_int8_reference(c, scales, q, k, corpus_mean=mean)
    assert torch.equal(i, ri)
    # the mean term is an f32 product over D or padded-D terms: one order
    torch.testing.assert_close(s, rs, atol=1e-6, rtol=0)
    s0, i0 = tt.cosine_topk_int8(c, scales, q, k)
    rs0, ri0 = tt.cosine_topk_int8_reference(c, scales, q, k)
    assert torch.equal(i0, ri0) and torch.equal(s0, rs0)


def _swaps_beyond_near_ties(i, rs, ri, tie=1e-6):
    """Ranks where the kernel's index differs from the plain one with no
    plain-score near-tie beside them. rs / ri hold k + 1 plain columns."""
    k = i.shape[1]
    gaps = (rs[:, :-1] - rs[:, 1:]).abs()
    near = torch.zeros_like(i, dtype=torch.bool)
    near |= gaps[:, :k] < tie
    near[:, 1:] |= gaps[:, :k - 1] < tie
    return (i != ri[:, :k]) & ~near


def test_topk_kernel_ties_lowest_index_first(dev):
    pat = torch.where(_randn(dev, (4, 64), 9) > 0, 0.125, -0.125)
    corpus = pat[torch.arange(600, device=dev) % 4].contiguous()
    s, i = tt.cosine_topk(corpus, pat[:2].clone(), 16)
    rs, ri = tt.cosine_topk_reference(corpus, pat[:2].clone(), 16)
    assert torch.equal(i, ri) and torch.equal(s, rs)
    assert i[0].tolist() == list(range(0, 64, 4))


def test_topk_kernel_ties_cross_list_registers(dev):
    """150 exact ties a query at k = 48, past the one-register lists: the
    scores and select_topk keep them in index order."""
    pat = torch.where(_randn(dev, (4, 64), 9) > 0, 0.125, -0.125)
    corpus = pat[torch.arange(600, device=dev) % 4].contiguous()
    s, i = tt.cosine_topk(corpus, pat[:2].clone(), 48)
    rs, ri = tt.cosine_topk_reference(corpus, pat[:2].clone(), 48)
    assert torch.equal(i, ri) and torch.equal(s, rs)
    assert i[0].tolist() == list(range(0, 192, 4))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,s,hq,hk,d", [(3, 200, 12, 2, 128), (2, 128, 4, 4, 64)])
def test_flash_kernel_matches_plain(dev, dtype, tol, b, s, hq, hk, d):
    q = _randn(dev, (b, s, hq, d), 1, dtype)
    k = _randn(dev, (b, s, hk, d), 2, dtype)
    v = _randn(dev, (b, s, hk, d), 3, dtype)
    mask = torch.ones((b, s), dtype=torch.int32, device=dev)
    mask[0, :77] = 0
    mask[-1] = 0
    for causal in (True, False):
        out = ta.flash_attention(q, k, v, mask, causal=causal)
        ref = ta.flash_attention_plain(q, k, v, mask, causal=causal)
        torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
        assert not out[-1].any()


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4), (torch.bfloat16, 2e-2)])
def test_flash_packed_kernel_matches_plain(dev, dtype, tol):
    lens = [300, 1, 150, 64, 260]
    t = 1024
    seg = torch.full((1, t), len(lens), dtype=torch.int32, device=dev)
    seg[0, :sum(lens)] = torch.repeat_interleave(
        torch.arange(len(lens), device=dev), torch.tensor(lens, device=dev)).int()
    q = _randn(dev, (1, t, 12, 128), 4, dtype)
    k = _randn(dev, (1, t, 2, 128), 5, dtype)
    v = _randn(dev, (1, t, 2, 128), 6, dtype)
    out = ta.flash_attention_packed(q, k, v, seg)
    ref = ta.flash_attention_packed_plain(q, k, v, seg)
    n = sum(lens)
    torch.testing.assert_close(out[:, :n].float(), ref[:, :n].float(), atol=tol, rtol=tol)


def test_kernel_wrappers_check_inputs(dev):
    q = _randn(dev, (1, 64, 4, 96), 7)           # head size without a kernel
    with pytest.raises(ValueError):
        ta.flash_attention(q, q[:, :, :2], q[:, :, :2],
                           torch.ones((1, 64), device=dev))
    with pytest.raises(ValueError):                # k = 0
        tt.cosine_topk(_randn(dev, (300, 64), 8), _randn(dev, (1, 64), 9), 0)
    with pytest.raises(ValueError):                # k > N
        tt.cosine_topk(_randn(dev, (100, 64), 8), _randn(dev, (1, 64), 9), 101)
    with pytest.raises(ValueError):                # queries of another depth
        tt.cosine_topk(_randn(dev, (100, 20), 8, torch.bfloat16), _randn(dev, (1, 24), 9), 4)
    assert np.isfinite(tt.cosine_topk(_randn(dev, (100, 64), 8),
                                      _randn(dev, (1, 64), 9), 4)[0].cpu().numpy()).all()


def _int8_corpus(dev, n, d, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    c = torch.randint(-127, 128, (n, d), generator=g, device=dev, dtype=torch.int8)
    scales = torch.rand((1, n), generator=g, device=dev) / 127 + 1e-4
    return c, scales


@pytest.mark.parametrize("n,d,b,k", [
    (1000, 1024, 32, 16),
    (777, 1024, 5, 1),       # N a multiple of no tile, k = 1
    (5000, 1024, 64, 16),    # two query groups of 32
    (300, 80, 2, 32),        # D not a multiple of the 128-byte chunk; the widest list
    (4099, 64, 3, 2),
    (300, 80, 2, 33),        # past the lists: the score kernel and select_topk
    (1000, 1024, 4, 64),
    (3000, 128, 2, 256),
    (1001, 16, 33, 16),      # one 32-byte step, half of it past D; 33 queries
    (2049, 48, 1, 33),       # a half step at the end of the depth; B = 1
    (1500, 80, 64, 1),
    (777, 2048, 33, 256),    # a 64 KB query block (one CTA an SM)
    (1300, 1024, 1, 33),
])
def test_topk_int8_kernel_bit_identical_to_plain(dev, n, d, b, k):
    c, scales = _int8_corpus(dev, n, d, n + d)
    q = _randn(dev, (b, d), n + 1)
    mean = _randn(dev, (1, d), n + 2) * 0.1
    before = tt.cosine_topk_int8.launches
    s, i = tt.cosine_topk_int8(c, scales, q, k, corpus_mean=mean)
    assert tt.cosine_topk_int8.launches == before + 1
    rs, ri = tt.cosine_topk_int8_reference(c, scales, q, k, corpus_mean=mean)
    assert torch.equal(i, ri)
    assert torch.equal(s, rs)


@pytest.mark.parametrize("d,k", [(1024, 16), (2048, 1), (2048, 256), (48, 33)])
def test_topk_int8_kernel_largest_dots_exact(dev, d, k):
    """Rows and queries of +-127 only: |acc| reaches D * 127^2 (33M at
    D = 2048, past f32's 2^24), and duplicated rows tie exactly."""
    g = torch.Generator(device=dev).manual_seed(d + k)
    sign = torch.randint(0, 2, (997, d), generator=g, device=dev, dtype=torch.int8)
    c = (sign * 2 - 1) * 127
    c[500:540] = c[3:43]
    scales = torch.full((1, 997), 0.01, device=dev)
    q = c[[3, 10, 20]].float()
    q[2] = -q[2]
    s, i = tt.cosine_topk_int8(c, scales, q, k, normalize_queries=False)
    rs, ri = tt.cosine_topk_int8_reference(c, scales, q, k, normalize_queries=False)
    assert torch.equal(i, ri) and torch.equal(s, rs)
    assert i[0, 0].item() == 3 and (k == 1 or i[0, 1].item() == 500)


def test_int8_tile_fits_the_sm(dev):
    """The occupancy calculator's count for the kernels that run: the
    (32, 1024) query block, the ring and B4's score tile leave room for 2
    CTAs an SM at D = 1024, in at most 128 registers a thread."""
    for kernel in ("topk", "scores", "dot"):
        info = tt.int8_tile_info(kernel, 1024, dev.index)
        assert info.ctas_per_sm == 2 and info.registers <= 128, (kernel, info)
    assert tt.int8_tile_info("topk", 2048, dev.index).ctas_per_sm == 1


def test_topk_int8_kernel_ties_lowest_index_first(dev):
    pat, _ = _int8_corpus(dev, 4, 128, 3)
    c = pat[torch.arange(900, device=dev) % 4].contiguous()
    scales = torch.full((1, 900), 0.01, device=dev)
    q = pat[:2].float()
    s, i = tt.cosine_topk_int8(c, scales, q, 16)
    rs, ri = tt.cosine_topk_int8_reference(c, scales, q, 16)
    assert torch.equal(i, ri) and torch.equal(s, rs)
    assert i[0].tolist() == list(range(0, 64, 4))


def test_topk_int8_kernel_ties_cross_list_registers(dev):
    pat, _ = _int8_corpus(dev, 4, 128, 3)
    c = pat[torch.arange(900, device=dev) % 4].contiguous()
    scales = torch.full((1, 900), 0.01, device=dev)
    q = pat[:2].float()
    s, i = tt.cosine_topk_int8(c, scales, q, 48)
    rs, ri = tt.cosine_topk_int8_reference(c, scales, q, 48)
    assert torch.equal(i, ri) and torch.equal(s, rs)
    assert i[0].tolist() == list(range(0, 192, 4))


def test_topk_int8_chunked_kernel_matches_plain(dev):
    g = torch.Generator(device=dev).manual_seed(5)
    emb = tt.l2_normalize(torch.randn((3000, 128), generator=g, device=dev))
    chunks, mean = tt.quantize_corpus_int8_chunked(emb.cpu().numpy(), chunk_rows=700,
                                                   device=dev)
    q = _randn(dev, (7, 128), 6)
    before = tt.cosine_topk_int8.launches
    s, i = tt.cosine_topk_int8_chunked(chunks, q, 16, corpus_mean=mean)
    assert tt.cosine_topk_int8.launches == before + len(chunks) == before + 5
    with mock.patch.object(tt, "cosine_topk_int8", tt.cosine_topk_int8_reference):
        rs, ri = tt.cosine_topk_int8_chunked(chunks, q, 16, corpus_mean=mean)
    assert torch.equal(i, ri) and torch.equal(s, rs)


def _sum_order_tol(terms, n_chain):
    """A change of summation order moves an f32 sum by at most about
    n_chain * 2^-24 * (sum of the terms' absolute values)."""
    return n_chain * 2.0 ** -24 * terms


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
@pytest.mark.parametrize("n,d,block_n", [(5000, 1024, 512), (4096, 64, 128),
                                         (3000, 80, 100), (700, 2048, 300)])
def test_stream_probe_matches_plain(dev, dtype, n, d, block_n):
    if dtype == torch.int8:
        c, _ = _int8_corpus(dev, n, d, 11)
    else:
        c = _randn(dev, (n, d), 11, dtype)
    before = tp.stream_probe.launches
    out = tp.stream_probe(c, block_n)
    assert tp.stream_probe.launches == before + 1
    ref = tp.stream_probe_plain(c, block_n)
    assert out.shape == ref.shape == (1, d)
    tol = _sum_order_tol(tp.abs_terms(c, None, block_n), 2 * (n // block_n))
    assert ((out - ref).abs() <= tol).all()


@pytest.mark.parametrize("dtype,highest", [(torch.float32, True), (torch.float32, False),
                                           (torch.bfloat16, True), (torch.int8, True)])
@pytest.mark.parametrize("n,d,b,block_n", [
    (5000, 1024, 40, 512),
    (1024, 64, 3, 256),
    (2500, 1024, 3, 128),    # 2432 rows: the last 512-row tile is ragged
    (72000, 64, 5, 128),     # 141 tiles: two a CTA, the last CTA one ragged tile
])
def test_dot_probe_matches_plain(dev, dtype, highest, n, d, b, block_n):
    if dtype == torch.int8:
        c, _ = _int8_corpus(dev, n, d, 12)
        q, _ = _int8_corpus(dev, b, d, 13)
    else:
        c = tt.l2_normalize(_randn(dev, (n, d), 12)).to(dtype)
        q = _randn(dev, (b, d), 13)
    before = tp.dot_probe.launches
    out = tp.dot_probe(c, q, block_n, highest)
    assert tp.dot_probe.launches == before + 1
    ref = tp.dot_probe_plain(c, q, block_n, highest)
    assert out.shape == ref.shape == (b, 128)
    # random-sign sums: 32 is a wide margin over the error these sums show
    tol = _sum_order_tol(tp.abs_terms(c, q, block_n, highest), 32)
    assert ((out - ref).abs() <= tol).all()


@pytest.mark.parametrize("n,d,b", [(1280, 16, 33), (2560, 48, 1), (1024, 80, 64),
                                   (768, 2048, 33)])
def test_dot_probe_int8_tile_depths(dev, n, d, b):
    """P2 on the int8 tile at depths with a half 32-byte step, a 64 KB query
    block, and query counts off the group of 32: exact int32 dots, folded in
    f32 (the summation-order bound of test_dot_probe_matches_plain)."""
    c, _ = _int8_corpus(dev, n, d, d)
    q, _ = _int8_corpus(dev, b, d, d + 1)
    out = tp.dot_probe(c, q, 128)
    ref = tp.dot_probe_plain(c, q, 128)
    tol = _sum_order_tol(tp.abs_terms(c, q, 128), 32)
    assert ((out - ref).abs() <= tol).all()


def test_int8_and_probe_wrappers_check_inputs(dev):
    c, scales = _int8_corpus(dev, 300, 64, 14)
    q = _randn(dev, (2, 64), 15)
    for bad in (dict(corpus_q=c.float()),                    # not int8
                dict(corpus_scales=scales[:, :100]),         # wrong length
                dict(corpus_scales=scales.double()),         # not f32
                dict(queries=q[:, :40]),                     # queries of another depth
                dict(k=301), dict(k=0),
                dict(corpus_q=c[::2], corpus_scales=scales[:, :150]),  # strided
                dict(corpus_q=torch.zeros((300, 4112), dtype=torch.int8, device=dev),
                     queries=_randn(dev, (2, 4112), 15))):   # D past the query block
        args = dict(corpus_q=c, corpus_scales=scales, queries=q, k=4)
        args.update(bad)
        with pytest.raises(ValueError):
            tt.cosine_topk_int8(**args)
    with pytest.raises(ValueError):                           # k > N
        tt.cosine_topk_int8(c[:8], scales[:, :8].contiguous(), q, 16)
    with pytest.raises(ValueError):                           # block_n % 128
        tp.dot_probe(_randn(dev, (512, 64), 16), q, 200)
    with pytest.raises(ValueError):                           # int8 corpus, f32 queries
        tp.dot_probe(c, q, 128)
    with pytest.raises(ValueError):                           # block_n > N
        tp.stream_probe(c, 512)
    with pytest.raises(ValueError):                           # D * itemsize % 16
        tp.stream_probe(_randn(dev, (256, 6), 17), 128)


def _assert_duplicates_in_index_order(i, n, first, count=64):
    """Rows first .. first + count - 1 duplicate rows 0 .. count - 1 (exact
    ties): wherever both of a pair are selected, the lower index ranks
    first."""
    for row in i.long():
        pos = torch.full((n,), -1, dtype=torch.long, device=i.device)
        pos[row] = torch.arange(row.numel(), device=i.device)
        lo, hi = pos[:count], pos[first:first + count]
        both = (lo >= 0) & (hi >= 0)
        assert (lo[both] < hi[both]).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,k,chunk_bytes", [
    (1 << 20, 257, None),
    (1000, 1000, None),          # k = N
    (1 << 20, 4096, None),
    (1 << 20, 1024, 1 << 24),    # 8 score chunks of 131,072 rows, then a merge
])
def test_topk_beyond_the_warp_lists_matches_plain(dev, dtype, n, k, chunk_bytes):
    """k > LIST_K: the score kernel and select_topk against
    cosine_topk_reference, with 64 duplicated rows (exact ties, lower index
    first) and one query equal to a duplicated row. No torch.sort or
    torch.topk runs on this path."""
    corpus = tt.l2_normalize(_randn(dev, (n, 1024), n + k))
    corpus[n // 2:n // 2 + 64] = corpus[:64]
    corpus = corpus.to(dtype)
    q = _randn(dev, (32, 1024), n + k + 1)
    q[0] = corpus[5].float()

    def refuse(*a, **kw):
        raise AssertionError("torch.sort / torch.topk on the select path")

    before = tt.select_topk.launches
    with mock.patch.object(torch, "sort", refuse), mock.patch.object(torch, "topk", refuse):
        if chunk_bytes:
            with mock.patch.object(tt, "SCORE_CHUNK_BYTES", chunk_bytes):
                s, i = tt.cosine_topk(corpus, q, k)
        else:
            s, i = tt.cosine_topk(corpus, q, k)
    assert tt.select_topk.launches == before + (1 if chunk_bytes is None else 9)
    kk = min(k + 1, n)
    rs, ri = tt.cosine_topk_reference(corpus, q, kk)
    torch.testing.assert_close(s, rs[:, :k], atol=1e-5, rtol=0)
    if kk > k:
        assert not _swaps_beyond_near_ties(i, rs, ri).any()
    else:
        assert torch.equal(torch.sort(i, dim=1)[0], torch.sort(ri, dim=1)[0])
    _assert_duplicates_in_index_order(i, n, n // 2)
    assert i[0, :2].tolist() == [5, n // 2 + 5] and s[0, 0] == s[0, 1]


@pytest.mark.parametrize("n,k", [(1 << 20, 257), (1000, 1000), (1 << 20, 4096)])
def test_topk_int8_beyond_the_warp_lists_bit_identical(dev, n, k):
    c, scales = _int8_corpus(dev, n, 1024, n + k)
    c[n // 2:n // 2 + 64] = c[:64]
    scales[:, n // 2:n // 2 + 64] = scales[:, :64]
    q = _randn(dev, (32, 1024), k)
    mean = _randn(dev, (1, 1024), k + 1) * 0.03
    s, i = tt.cosine_topk_int8(c, scales, q, k, corpus_mean=mean)
    rs, ri = tt.cosine_topk_int8_reference(c, scales, q, k, corpus_mean=mean)
    assert torch.equal(i, ri) and torch.equal(s, rs)
    _assert_duplicates_in_index_order(i, n, n // 2)


def test_topk_int8_chunked_beyond_the_warp_lists_bit_identical(dev):
    """Three chunks (the last ragged), k = 1024: per-chunk selects, then a
    select over the 3 x 1024 candidates."""
    sizes = (400_000, 400_000, 248_576)
    chunks = [_int8_corpus(dev, m, 1024, 40 + j) for j, m in enumerate(sizes)]
    chunks[2][0][:64] = chunks[0][0][:64]           # ties across chunks
    chunks[2][1][:, :64] = chunks[0][1][:, :64]
    q = _randn(dev, (32, 1024), 41)
    s, i = tt.cosine_topk_int8_chunked(chunks, q, 1024)
    with mock.patch.object(tt, "cosine_topk_int8", tt.cosine_topk_int8_reference):
        rs, ri = tt.cosine_topk_int8_chunked(chunks, q, 1024)
    assert torch.equal(i, ri) and torch.equal(s, rs)


@pytest.mark.parametrize("b,n,k", [
    (3, 5000, 300),
    (2, 50_000, 20_000),      # a sort of 32,768: steps across shared-memory tiles
    (1, 4096, 4096),
    (65, 777, 700),
])
def test_select_topk_matches_plain(dev, b, n, k):
    """Scores on a coarse grid: many exact ties, -0.0 beside +0.0, and a row
    of one value (every key equal to the k-th); positions mapped through
    indices too."""
    g = torch.Generator(device=dev).manual_seed(n + k)
    s = torch.round(torch.randn((b, n), generator=g, device=dev) * 10) / 10
    s[:, ::7] = 0.0
    s[:, 3::7] = -0.0
    s[-1] = 0.25
    idx = torch.randint(0, 1 << 30, (b, n), generator=g, device=dev, dtype=torch.int32)
    for kw in (dict(base=17), dict(indices=idx)):
        got = tt.select_topk(s, k, **kw)
        want = tt.select_topk_plain(s, k, **kw)
        assert torch.equal(got[1], want[1])
        assert torch.equal(got[0], want[0])


@pytest.mark.parametrize("kind,b,k", [
    ("crowded", 32, 1024),     # every score in one 12-bit bin: candidates = L
    ("crowded", 1, 1),
    ("equal", 2, 1024),        # every key equal to the k-th: the lowest positions
    ("equal", 1, 1 << 20),     # k = L
    ("grid", 65, 1024),
    ("grid", 1, 1),
    ("grid", 3, 1 << 20),      # k = L, many ties
    ("mixed", 4, 1024),        # rows that stop their search at each level, side by side
])
def test_select_topk_million_scores_matches_plain(dev, kind, b, k):
    """L = 1,048,576: a crowded bin (scores in a 1e-3 band around 0.8, on a
    1e-7 grid: many ties), every score equal, a 0.001 grid of normal scores,
    and those with cosine-like scores (uniform in [0.6, 0.95]) in one batch,
    at k = 1, 1024 and L, B = 1 to 65."""
    n = 1 << 20
    g = torch.Generator(device=dev).manual_seed(b + k)
    crowded = 0.8 + torch.round((torch.rand((b, n), generator=g, device=dev) - 0.5) * 1e4) * 1e-7
    grid = torch.round(torch.randn((b, n), generator=g, device=dev) * 1000) / 1000
    s = {"crowded": crowded, "equal": torch.full((b, n), 0.8, device=dev), "grid": grid,
         "mixed": grid}[kind]
    if kind == "mixed":
        s[1] = crowded[1]
        s[2] = 0.6 + 0.35 * torch.rand((n,), generator=g, device=dev)
        s[3] = 0.8
    got = tt.select_topk(s, k)
    want = tt.select_topk_plain(s, k)
    assert torch.equal(got[1], want[1]) and torch.equal(got[0], want[0])


def _left_padded_mask(dev, b, s, seed):
    """Seeded left padding; of two rows or more, the last has every key
    masked."""
    rng = np.random.default_rng(seed)
    pads = rng.integers(0, s, size=b)
    if b > 1:
        pads[-1] = s
    return torch.as_tensor((np.arange(s)[None, :] >= pads[:, None]).astype(np.int32),
                           device=dev)


@pytest.mark.parametrize("b,s,hq,hk,d", [
    (32, 512, 12, 2, 128),    # the served padded batch
    (1, 256, 12, 2, 128),     # the lone request
    (4, 300, 8, 2, 64),       # S not a multiple of the 64-key tile, D = 64
    (3, 77, 4, 4, 64),
])
def test_flash_bf16_tensor_core_matches_plain(dev, b, s, hq, hk, d):
    """B2's bf16 tensor-core kernel: within 2e-2 of the plain version at
    real positions, 0 on rows with no visible key."""
    q = _randn(dev, (b, s, hq, d), 21, torch.bfloat16)
    k = _randn(dev, (b, s, hk, d), 22, torch.bfloat16)
    v = _randn(dev, (b, s, hk, d), 23, torch.bfloat16)
    mask = _left_padded_mask(dev, b, s, b + s)
    out = ta.flash_attention(q, k, v, mask)
    ref = ta.flash_attention_plain(q, k, v, mask)
    real = mask.bool()
    assert (out.float() - ref.float())[real].abs().max().item() <= 2e-2
    assert not out[~real].any()


@pytest.mark.parametrize("t,d,lens", [
    (8192, 128, None),                    # the served stream: 32 seeded segments
    (1000, 64, [300, 1, 150, 64, 260]),   # T not a multiple of the tile
    (1000, 128, [300, 1, 150, 64, 260]),
])
def test_flash_packed_bf16_tensor_core_matches_plain(dev, t, d, lens):
    """B3's bf16 tensor-core kernel: segments cross q-blocks and key tiles."""
    if lens is None:
        rng = np.random.default_rng(2)
        while True:
            lens = (64 + np.floor(448 * rng.random(32) ** 2)).astype(int).tolist()
            if sum(lens) < t:
                break
    seg = torch.full((1, t), len(lens), dtype=torch.int32, device=dev)
    seg[0, :sum(lens)] = torch.repeat_interleave(
        torch.arange(len(lens), device=dev), torch.tensor(lens, device=dev)).int()
    q = _randn(dev, (1, t, 12, d), 24, torch.bfloat16)
    k = _randn(dev, (1, t, 2, d), 25, torch.bfloat16)
    v = _randn(dev, (1, t, 2, d), 26, torch.bfloat16)
    out = ta.flash_attention_packed(q, k, v, seg)
    ref = ta.flash_attention_packed_plain(q, k, v, seg)
    n = sum(lens)
    assert (out[:, :n].float() - ref[:, :n].float()).abs().max().item() <= 2e-2


def _right_padded_mask(dev, b, s, seed):
    """Seeded right padding, every row with at least one real token (the
    engine gives its pad rows mask[:, 0] = 1); of two rows or more, one is
    full and one holds a single token."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, s + 1, size=b)
    if b > 1:
        lens[0], lens[-1] = s, 1
    return torch.as_tensor((np.arange(s)[None, :] < lens[:, None]).astype(np.int32),
                           device=dev)


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 2e-2), (torch.float32, 2e-4)])
@pytest.mark.parametrize("b,s", [(32, 512), (8, 768), (1, 128), (3, 200),
                                 (10, 640), (1, 640)])
def test_flash_kernel_matches_plain_under_right_padding(dev, dtype, tol, b, s):
    """B2 as `compute_prefix_kv` calls it: RIGHT-padded rows of pool_len
    tokens ((M, 640) is what the default engine gives it over the shipped
    corpus, whose pool length sizes itself to 640). The first unmasked key is 0 and the wholly masked key tiles sit
    at the end; a pad query (i >= n) still sees the keys j < n, so no row is
    empty. Every position is held against the plain version, the pad
    queries too, within the left-padded check's tolerances."""
    q = _randn(dev, (b, s, 12, 128), 31, dtype)
    k = _randn(dev, (b, s, 2, 128), 32, dtype)
    v = _randn(dev, (b, s, 2, 128), 33, dtype)
    mask = _right_padded_mask(dev, b, s, b + s)
    before = ta.flash_attention.launches
    out = ta.flash_attention(q, k, v, mask)
    assert ta.flash_attention.launches == before + 1
    ref = ta.flash_attention_plain(q, k, v, mask)
    assert (out.float() - ref.float()).abs().max().item() <= tol
    assert out[:, 0].float().abs().sum().item() > 0      # query 0 sees key 0


# the bf16 wgmma body at every group size G = Hq / Hk the wrapper meets: 1
# (the tests' (4, 4)), 2 (the tiny preset's (4, 2)), 4 ((8, 2) at D = 64), 6
# (the served (12, 2) and a mesh position's (6, 1))
WG_HEADS = [(4, 4), (4, 2), (8, 2), (12, 2), (6, 1)]


@pytest.mark.parametrize("padding", ["left", "right"])
@pytest.mark.parametrize("s", [77, 300])
@pytest.mark.parametrize("hq,hk", WG_HEADS)
@pytest.mark.parametrize("d", [64, 128])
def test_flash_bf16_wgmma_body_matches_plain(dev, d, hq, hk, s, padding):
    """B2's bf16 body (a CTA serves every query head of its KV head) within
    2e-2 of the plain version at real positions, with S not a multiple of
    the 64-key tile, under left and right padding; a batch row with every
    key masked and the left-padded rows with no visible key come out
    exactly 0."""
    b = 3
    q = _randn(dev, (b, s, hq, d), 41, torch.bfloat16)
    k = _randn(dev, (b, s, hk, d), 42, torch.bfloat16)
    v = _randn(dev, (b, s, hk, d), 43, torch.bfloat16)
    mask = (_left_padded_mask(dev, b, s, s + hq) if padding == "left"
            else _right_padded_mask(dev, b, s, s + hq))
    mask[-1] = 0                                      # a row with every key masked
    before = ta.flash_attention.launches
    out = ta.flash_attention(q, k, v, mask)
    assert ta.flash_attention.launches == before + 1
    ref = ta.flash_attention_plain(q, k, v, mask)
    visible = mask.bool()[:, None, :] & torch.tril(
        torch.ones((s, s), dtype=torch.bool, device=dev))
    live = visible.any(-1)                            # (B, S): some key visible
    assert (out.float() - ref.float())[live].abs().max().item() <= 2e-2
    assert not out[~live].any()
    assert not out[-1].any() and out[0][live[0]].float().abs().sum().item() > 0


def _packed_stream(dev, lens, t):
    seg = torch.full((1, t), len(lens), dtype=torch.int32, device=dev)
    seg[0, :sum(lens)] = torch.repeat_interleave(
        torch.arange(len(lens), device=dev), torch.tensor(lens, device=dev)).int()
    return seg


@pytest.mark.parametrize("dtype,d,hq,hk", [
    *[(torch.bfloat16, d, hq, hk) for d in (64, 128) for hq, hk in WG_HEADS],
    (torch.float32, 128, 12, 2), (torch.float32, 64, 4, 4),      # the f32 body
    (torch.bfloat16, 16, 4, 2), (torch.float32, 32, 8, 2),       # the narrow heads
])
def test_flash_packed_n_real_matches_plain(dev, dtype, d, hq, hk):
    """B3 with n_real < T, the pad tail (700 tokens) spanning several query
    blocks of every body: the real rows within the tolerance of the plain
    version (2e-2 bf16, 2e-4 f32), every row past n_real exactly 0; with
    n_real = T (None) every row, the pad tail's too, against the plain
    version; n_real = 0 launches nothing and gives zeros."""
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-4
    lens = [300, 1, 150, 64, 260, 77]
    n, t = sum(lens), sum(lens) + 700
    seg = _packed_stream(dev, lens, t)
    q = _randn(dev, (1, t, hq, d), 44, dtype)
    k = _randn(dev, (1, t, hk, d), 45, dtype)
    v = _randn(dev, (1, t, hk, d), 46, dtype)
    before = ta.flash_attention_packed.launches
    out = ta.flash_attention_packed(q, k, v, seg, n_real=n)
    assert ta.flash_attention_packed.launches == before + 1
    ref = ta.flash_attention_packed_plain(q, k, v, seg, n_real=n)
    assert not out[:, n:].any() and not ref[:, n:].any()
    assert (out[:, :n].float() - ref[:, :n].float()).abs().max().item() <= tol
    whole = ta.flash_attention_packed(q, k, v, seg)
    ref_whole = ta.flash_attention_packed_plain(q, k, v, seg)
    assert (whole.float() - ref_whole.float()).abs().max().item() <= tol
    assert torch.equal(whole[:, :n], out[:, :n])
    assert not ta.flash_attention_packed(q, k, v, seg, n_real=0).any()
    assert ta.flash_attention_packed.launches == before + 2


@pytest.mark.parametrize("int8", [False, True], ids=["compute", "int8"])
def test_prefix_pool_gather_returns_inserted_bits_across_growth(dev, int8):
    """The pool on the card at the served entry shape (28 layers, 2 kv heads
    of 128, PL = 128): entries inserted before and after two growths
    (2 -> 4 -> 8 slots) gather back bit for bit, the zeros row stays 0, and
    rows beyond a batch's keys land in the scratch row."""
    from rag_serving_system_torch.core.prefix_cache import PrefixKVCache

    shape = (28, 2, 128, 2, 128)
    dtype = torch.bfloat16
    per = int(np.prod(shape)) * (1 if int8 else 2)
    cache = PrefixKVCache(pool_len=128, entry_bytes=per, budget_mb=64, entry_shape=shape,
                          dtype=dtype, int8=int8, initial_slots=2, device=dev)
    assert cache._pool.is_cuda and cache.capacity >= 8

    def payload(seed, m=1):
        x = _randn(dev, (m,) + shape, seed, dtype)
        if not int8:
            return x
        return ((x * 40).clamp(-127, 127).to(torch.int8),
                _randn(dev, (m,) + shape[:-1] + (1,), seed + 1).abs())

    kept = {}
    for j in range(7):
        rows = payload(50 + j, m=2)          # one key, one row for the scratch slot
        e = cache.put_batch([("k", j)], [(j,)], rows)[("k", j)]
        kept[j] = (e.slot, rows)
    assert cache.grows == 2 and cache.n_slots == 8
    got = cache.gather([kept[j][0] for j in range(7)] + [cache.zero_slot])
    vals = got[0] if int8 else got
    for j in range(7):
        want = kept[j][1]
        if int8:
            assert torch.equal(vals[j], want[0][0]) and torch.equal(got[1][j], want[1][0]), j
        else:
            assert torch.equal(vals[j], want[0]), j
    zero = got[0][-1] if int8 else got[-1]
    assert not zero.any()
    if int8:
        assert (got[1][-1] == 1).all()


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-3), (torch.bfloat16, 6e-2)])
def test_compute_prefix_kv_kernel_matches_plain(dev, dtype, tol):
    """`compute_prefix_kv` at the decoder's full width (2 layers, random
    weights from a seed) on right-padded prefixes of 384 slots: through B2
    and with `flash_attention_plain` patched in, at real positions."""
    import dataclasses

    from rag_serving_system_torch.models import qwen2 as tq
    from rag_serving_system_torch.models.configs import QWEN25_15B
    from rag_serving_system_torch.models.weights import init_decoder_params

    cfg = dataclasses.replace(QWEN25_15B, num_layers=2)
    params = init_decoder_params(cfg, seed=3, dtype=dtype, device=dev)
    g = torch.Generator(device=dev).manual_seed(4)
    ids = torch.randint(0, cfg.vocab_size, (5, 384), generator=g, device=dev)
    mask = _right_padded_mask(dev, 5, 384, 11)
    before = ta.flash_attention.launches
    kv = tq.compute_prefix_kv(params, cfg, ids, mask, dtype=dtype)
    assert ta.flash_attention.launches == before + cfg.num_layers
    with mock.patch.object(tq, "flash_attention", ta.flash_attention_plain):
        ref = tq.compute_prefix_kv(params, cfg, ids, mask, dtype=dtype)
    assert ta.flash_attention.launches == before + cfg.num_layers
    assert kv.shape == (5, 2, 2, 384, cfg.num_kv_heads, cfg.head_dim) and kv.dtype == dtype
    real = mask.bool()[:, None, None, :, None, None].expand_as(kv)
    assert (kv.float() - ref.float())[real].abs().max().item() <= tol
    assert torch.isfinite(kv.float()).all()


# ---------------------------------------------------------------------------
# the narrow heads, the quantized products, the decode pool
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,s,hq,hk,d", [(3, 200, 4, 2, 16), (2, 130, 8, 2, 32),
                                         (1, 64, 4, 4, 16), (4, 33, 2, 1, 32)])
def test_flash_kernel_narrow_heads_match_plain(dev, dtype, tol, b, s, hq, hk, d):
    """B2 at head sizes 16 and 32 (the scalar body, f32 math for both
    types), left- and right-padded rows and one row with every key masked."""
    q = _randn(dev, (b, s, hq, d), 1, dtype)
    k = _randn(dev, (b, s, hk, d), 2, dtype)
    v = _randn(dev, (b, s, hk, d), 3, dtype)
    mask = torch.ones((b, s), dtype=torch.int32, device=dev)
    mask[0, :s // 3] = 0
    if b > 2:
        mask[1, s // 2:] = 0
    if b > 1:
        mask[-1] = 0
    before = ta.flash_attention.launches
    for causal in (True, False):
        out = ta.flash_attention(q, k, v, mask, causal=causal)
        ref = ta.flash_attention_plain(q, k, v, mask, causal=causal)
        torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
        if b > 1:
            assert not out[-1].any()
    assert ta.flash_attention.launches == before + 2


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("d,hq,hk", [(16, 4, 2), (32, 8, 2)])
def test_flash_packed_kernel_narrow_heads_match_plain(dev, dtype, tol, d, hq, hk):
    lens = [130, 1, 75, 64, 40]
    t = 384
    seg = torch.full((1, t), len(lens), dtype=torch.int32, device=dev)
    seg[0, :sum(lens)] = torch.repeat_interleave(
        torch.arange(len(lens), device=dev), torch.tensor(lens, device=dev)).int()
    q = _randn(dev, (1, t, hq, d), 4, dtype)
    k = _randn(dev, (1, t, hk, d), 5, dtype)
    v = _randn(dev, (1, t, hk, d), 6, dtype)
    out = ta.flash_attention_packed(q, k, v, seg)
    ref = ta.flash_attention_packed_plain(q, k, v, seg)
    n = sum(lens)
    torch.testing.assert_close(out[:, :n].float(), ref[:, :n].float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("m,k,n", [
    (8192, 1536, 2048), (8192, 1536, 17920), (8192, 8960, 1536),   # Qwen2.5-1.5B's four
    (640, 1536, 1536), (17, 64, 128), (16, 64, 128), (1, 128, 64), (5, 2048, 8),
    (48, 64, 256), (48, 96, 64), (128, 64, 128)])
def test_int_mm_route_equals_plain_exactly(dev, m, k, n):
    """`int_matmul` (`torch._int_mm`, rows padded past 16) against
    `int_matmul_plain` (f32 over K-chunks of 1024): identical int32 sums, at
    extreme values too."""
    from rag_serving_system_torch.models import layers as tl

    g = torch.Generator(device=dev).manual_seed(m + k + n)
    xq = torch.randint(-127, 128, (m, k), generator=g, device=dev, dtype=torch.int8)
    wq = torch.randint(-127, 128, (k, n), generator=g, device=dev, dtype=torch.int8)
    xq[0] = 127
    wq[:, 0] = -127
    got = tl.int_matmul(xq, wq)
    assert got.dtype == torch.int32 and got.shape == (m, n)
    assert torch.equal(got, tl.int_matmul_plain(xq, wq))
    assert got[0, 0].item() == -127 * 127 * k


def test_int_mm_refuses_what_it_does_not_take(dev):
    """A width that is no multiple of 8 raises: no other route is taken."""
    from rag_serving_system_torch.models import layers as tl

    xq = torch.zeros((32, 36), dtype=torch.int8, device=dev)
    with pytest.raises(RuntimeError):
        tl.int_matmul(xq, torch.zeros((36, 16), dtype=torch.int8, device=dev))
    with pytest.raises(RuntimeError):
        tl.int_matmul(xq[:, :32].contiguous(), torch.zeros((32, 12), dtype=torch.int8,
                                                         device=dev))


@pytest.mark.parametrize("kind", ["int8", "int4"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2.0 ** -6)])
def test_dense_w8a8_on_the_card_matches_the_cpu(dev, kind, dtype, tol):
    """The W8A8 / W4A8 product through `torch._int_mm` against the same
    function on the CPU (an int32 matmul), relative to the largest output."""
    from rag_serving_system_torch.models import layers as tl
    from rag_serving_system_torch.ops import quant as tquant

    x = _randn(dev, (3, 40, 256), 1, dtype)
    w = _randn(dev, (256, 64), 2) * 0.05
    qw = (tquant.quantize_int8 if kind == "int8" else tquant.quantize_int4)(w)
    b = _randn(dev, (64,), 3, dtype)
    ours = tl.dense_w8a8(x, qw, b).float().cpu()
    ref = tl.dense_w8a8(x.cpu(), type(qw)(qw.q.cpu(), qw.scale.cpu()), b.cpu()).float()
    assert (ours - ref).abs().max() <= tol * ref.abs().max()


def _pool_tokens(params, cfg, ids, mask, mnt, dtype, slots, window, cursor, order):
    """Greedy tokens of every row through `prefill_for_pool`, `_insert_rows`
    (rows `order`, two waves) and `decode_chunk`."""
    from rag_serving_system_torch.core.decode_pool import _insert_rows
    from rag_serving_system_torch.models import qwen2 as tq

    dev = ids.device
    b = ids.shape[0]
    shape = (cfg.num_layers, slots, window, cfg.num_kv_heads, cfg.head_dim)
    state = [torch.zeros(shape, dtype=dtype, device=dev), torch.zeros(shape, dtype=dtype, device=dev),
             torch.zeros((slots, window), dtype=torch.bool, device=dev),
             torch.full((slots,), cfg.pad_token_id, dtype=torch.int32, device=dev),
             torch.zeros((slots,), dtype=torch.int32, device=dev),
             torch.zeros((slots,), dtype=torch.bool, device=dev),
             torch.zeros((slots,), dtype=torch.int32, device=dev)]
    tok0, k, v, cmask = tq.prefill_for_pool(params, cfg, ids, mask, None, do_sample=False,
                                            dtype=dtype,
                                            row_valid=torch.ones(b, dtype=torch.bool, device=dev))
    budgets = torch.full((b,), mnt, dtype=torch.int32, device=dev)
    out = {r: [int(tok0[r])] for r in range(b)}
    half = b // 2
    for wave in (order[:half], order[half:]):
        rows = torch.tensor(wave, device=dev)
        slot_of = {r: s for s, r in enumerate(wave)}         # the second wave reuses slots
        _insert_rows(*state, k, v, cmask, tok0, rows,
                     torch.tensor([slot_of[r] for r in wave], device=dev), cursor, budgets,
                     tq.eos_id_set(cfg))
        *_, cursor, toks = tq.decode_chunk(params, cfg, *state, cursor, None, chunk=mnt - 1,
                                           do_sample=False, dtype=dtype)
        toks = toks.cpu().numpy()
        for r in wave:
            out[r] += [int(t) for t in toks[:, slot_of[r]]]
    return [[t for t in out[r] if t != cfg.pad_token_id][:mnt] for r in range(b)]


@pytest.mark.parametrize("preset", ["tiny", "full_width_2_layers"])
def test_pool_tokens_equal_the_fixed_path_on_the_card(dev, preset):
    """f32, greedy: `decode_chunk` over a ring with a wrapped cursor, rows in
    two waves that reuse slots, against `generate`, at the tiny preset and
    at Qwen2.5-1.5B's full width cut to 2 layers (weights scaled so that the
    trajectories vary)."""
    import dataclasses

    from rag_serving_system_torch.models import qwen2 as tq
    from rag_serving_system_torch.models.configs import QWEN2_TINY, QWEN25_15B
    from rag_serving_system_torch.models.weights import init_decoder_params

    cfg = QWEN2_TINY if preset == "tiny" else dataclasses.replace(QWEN25_15B, num_layers=2)
    params = init_decoder_params(cfg, seed=3, dtype=torch.float32, device=dev)
    for key in ("qkv_w", "o_w", "gu_w", "down_w"):
        params["layers"][key] *= 8.0 if preset == "tiny" else 2.0
    params["embed"] *= 8.0 if preset == "tiny" else 2.0
    g = torch.Generator(device=dev).manual_seed(5)
    b, p, mnt = 4, 64, 6
    lens = [37, 12, 64, 23]
    ids = torch.randint(10, cfg.vocab_size, (b, p), generator=g, device=dev, dtype=torch.int32)
    mask = (torch.arange(p, device=dev)[None, :] >= p - torch.tensor(lens, device=dev)[:, None]
            ).to(torch.int32)
    ids = ids * mask
    fixed = tq.generate(params, cfg, ids, mask, None, max_new_tokens=mnt, do_sample=False,
                        dtype=torch.float32,
                        row_valid=torch.ones(b, dtype=torch.bool, device=dev)).cpu().numpy()
    want = [[int(t) for t in row if t != cfg.pad_token_id] for row in fixed]
    got = _pool_tokens(params, cfg, ids, mask, mnt, torch.float32, slots=2, window=96,
                       cursor=80, order=[2, 0, 3, 1])
    assert got == want
    assert any(len(set(row)) > 2 for row in want)


def _tiny_corpus():
    rng = np.random.default_rng(0)
    docs = [" ".join(f"w{rng.integers(0, 300)}" for _ in range(rng.integers(14, 24)))
            for _ in range(40)]
    return docs, rng.standard_normal((40, 64)).astype(np.float32)


TINY_QUERIES = ["what is w1 w2", "tell me w5", "w7 w8 w9 w10", "another question w3"]


def _tiny_engine(dev, **over):
    from rag_serving_system_torch.config import Settings
    from rag_serving_system_torch.core.engine import RagEngine
    from rag_serving_system_torch.models.weights import init_decoder_params
    from rag_serving_system_torch.ops.quant import quantize_decoder_params

    base = dict(model_preset="tiny", dtype="float32", do_sample=False, batch_buckets=[1, 4],
                max_batch_size=4, encode_len_buckets=[16, 32], prompt_len_buckets=[32, 128],
                packed_t_step=256, max_new_tokens=6, max_k=4, prefix_pool_len=48,
                decode_mode="fixed", quant_weights="none", quant_act="none",
                query_cache_size=0)
    base.update(over)
    docs, emb = _tiny_corpus()
    engine = RagEngine(Settings(**base), docs, emb, device=dev)
    # varied greedy answers: the decoder's matrices scaled by 8, then
    # quantized as the engine quantizes them
    fp = init_decoder_params(engine.dec_cfg, seed=1, dtype=torch.float32, device=engine.device)
    for key in ("qkv_w", "o_w", "gu_w", "down_w"):
        fp["layers"][key] *= 8.0
    fp["embed"] *= 8.0
    bits = {"none": 0, "int8": 8, "int4": 4}[base["quant_weights"]]
    engine.dec_params = quantize_decoder_params(fp, bits=bits) if bits else fp
    return engine


@pytest.mark.parametrize("prefix_cache", [True, False], ids=["prefix", "cold"])
def test_engine_serves_the_tiny_preset_on_the_card(dev, prefix_cache):
    """MODEL_PRESET=tiny (head size 16) is served on a CUDA device through
    B2 and B3: the engine's answers equal those with each kernel's plain
    version swapped in (f32, greedy)."""
    from rag_serving_system_torch.core import engine as engine_mod
    from rag_serving_system_torch.models import qwen2 as tq

    assert not engine_mod.unsupported_settings(
        _tiny_engine(dev, prefix_cache=prefix_cache).settings, dev)
    engine = _tiny_engine(dev, prefix_cache=prefix_cache)
    before = (ta.flash_attention.launches, ta.flash_attention_packed.launches)
    lone = engine.process(TINY_QUERIES[:1], [2])
    batch = engine.process(TINY_QUERIES, [2] * 4)
    b2 = ta.flash_attention.launches - before[0]
    b3 = ta.flash_attention_packed.launches - before[1]
    assert b2 > 0 and (prefix_cache or b3 > 0)
    if engine.prefix_cache is not None:
        engine.prefix_cache.clear()
    with mock.patch.object(engine_mod, "cosine_topk", tt.cosine_topk_reference), \
            mock.patch.object(tq, "flash_attention", ta.flash_attention_plain), \
            mock.patch.object(tq, "flash_attention_packed", ta.flash_attention_packed_plain):
        assert engine.process(TINY_QUERIES[:1], [2]) == lone
        assert engine.process(TINY_QUERIES, [2] * 4) == batch
    assert all(r["result"] for r in lone + batch)


@pytest.mark.parametrize("over", [
    dict(prefix_cache=True), dict(prefix_cache=False),
    dict(prefix_cache=False, packed_prefill=False, decode_slots=2),
    dict(prefix_cache=True, quant_weights="int8", quant_act="int8"),
], ids=["prefix", "packed", "padded_two_slots", "int8_w8a8_prefix"])
def test_engine_pool_answers_equal_fixed_on_the_card(dev, over):
    """DECODE_MODE=continuous at the tiny preset on the card: the pool's
    answers equal the fixed path's on the same weights (f32, greedy)."""
    fixed = _tiny_engine(dev, **over)
    cont = _tiny_engine(dev, decode_mode="continuous", **over)
    cont.enc_params, cont.dec_params = fixed.enc_params, fixed.dec_params
    want = fixed.process(TINY_QUERIES, [2] * 4)
    pool = cont.decode_pool
    pool.start()
    try:
        got = {}
        for tag in ("a", "b"):                       # the second batch hits the prefix cache
            pool.submit([f"{tag}{i}" for i in range(4)], cont.prepare(TINY_QUERIES, [2] * 4),
                        lambda rid, res: got.__setitem__(rid, res))
        assert pool.wait_idle(120.0)
    finally:
        pool.stop()
    for tag in ("a", "b"):
        assert [got[f"{tag}{i}"] for i in range(4)] == want, tag
    assert pool.stats()["completed"] == 8
    assert all(r["result"] for r in want)


@pytest.mark.parametrize("quant_weights", ["int8", "int4"])
def test_engine_serves_quantized_on_the_card(dev, quant_weights):
    """The tiny preset under QUANT_WEIGHTS with W8A8 prefill on the card:
    `torch._int_mm` computes every prefill product, and swapping in the plain
    int32 sums (exactly equal) leaves every answer as it was."""
    from rag_serving_system_torch.models import layers as tl

    engine = _tiny_engine(dev, prefix_cache=True, quant_weights=quant_weights,
                          quant_act="int8")
    assert engine.act_quant and engine.weight_bytes < engine.weight_bytes_init / 3
    calls = []
    real = tl.int_matmul

    def counted(xq, wq):
        calls.append(tuple(xq.shape))
        return real(xq, wq)

    with mock.patch.object(tl, "int_matmul", counted):
        got = engine.process(TINY_QUERIES, [2] * 4)
    assert calls and all(r["result"] for r in got)
    engine.prefix_cache.clear()
    with mock.patch.object(tl, "int_matmul", tl.int_matmul_plain):
        assert engine.process(TINY_QUERIES, [2] * 4) == got


@pytest.mark.parametrize("over", [
    dict(prefix_cache=True), dict(prefix_cache=False),
    dict(prefix_cache=False, packed_prefill=False),
], ids=["prefix", "packed", "padded"])
@pytest.mark.parametrize("gamma", [1, 3])
def test_engine_spec_decode_equals_sequential_on_the_card(dev, over, gamma):
    """SPEC_DECODE on the card at the tiny preset (f32, greedy, decoder scaled
    by 8): the speculative loop's answers equal the sequential loop's on the
    prefix (miss, then hit), packed and padded routes, in no more
    iterations than the sequential loop's steps."""
    engine = _tiny_engine(dev, spec_gamma=gamma, **over)
    assert engine.spec_gamma == gamma
    budgets = [None, 2, 6, 4]
    runs = []
    for g in (gamma, 0):
        engine.spec_gamma = g
        if engine.prefix_cache is not None:
            engine.prefix_cache.clear()
        before = engine.timer.counts["decode"]
        answers = [engine.process(TINY_QUERIES, [2] * 4, budgets) for _ in range(2)]
        runs.append((answers, engine.timer.counts["decode"] - before))
    (spec, spec_iters), (seq, seq_iters) = runs
    assert spec == seq
    assert 0 < spec_iters <= seq_iters <= 2 * 5
    assert all(r["result"] for r in seq[0])


def test_spec_decode_loop_draft_source_on_the_card(dev):
    """`_spec_decode_loop` on the card with every draft right and every
    draft wrong: sequential greedy's tokens, in ceil((mnt - 1) / (gamma +
    1)) and in mnt - 1 iterations (Qwen2.5-1.5B's width cut to 2 layers)."""
    import dataclasses
    import math

    from rag_serving_system_torch.models import qwen2 as tq
    from rag_serving_system_torch.models.configs import QWEN25_15B
    from rag_serving_system_torch.models.weights import init_decoder_params

    cfg = dataclasses.replace(QWEN25_15B, num_layers=2)
    params = init_decoder_params(cfg, seed=3, dtype=torch.float32, device=dev)
    for key in ("qkv_w", "o_w", "gu_w", "down_w"):
        params["layers"][key] *= 2.0
    params["embed"] *= 2.0
    g = torch.Generator(device=dev).manual_seed(5)
    b, p, mnt, gamma = 4, 64, 10, 3
    lens = torch.tensor([37, 12, 64, 23], device=dev)
    ids = torch.randint(10, cfg.vocab_size, (b, p), generator=g, device=dev, dtype=torch.int32)
    mask = (torch.arange(p, device=dev)[None, :] >= p - lens[:, None]).to(torch.int32)
    ids = ids * mask
    seq = tq.generate(params, cfg, ids, mask, max_new_tokens=mnt, do_sample=False,
                      dtype=torch.float32)
    assert not tq.token_is_eos(seq, tq.eos_id_set(cfg)).any()
    wrong = torch.full((b, mnt + gamma), 7, dtype=torch.int32, device=dev)
    assert not (seq == 7).any()
    for src, want in ((torch.cat([seq, seq[:, :gamma]], dim=1),
                       math.ceil((mnt - 1) / (gamma + 1))), (wrong, mnt - 1)):
        with torch.inference_mode():
            logits0, cache = tq.prefill(params, cfg, ids, mask, mnt + gamma,
                                        dtype=torch.float32)
            out, iters = tq._spec_decode_loop(params, cfg, logits0, cache, mask, mnt, gamma,
                                              torch.float32, None, p, ids, draft_source=src)
        assert torch.equal(out, seq) and iters == want


def test_checkpoint_round_trip_on_the_card(dev, tmp_path):
    """The tiny engine's models written as HF snapshots and read back through
    WEIGHTS_DIR on the card: every leaf bit-equal and on the device, the
    same greedy answers."""
    import sys

    sys.path.insert(0, str(__import__("pathlib").Path(__file__).resolve().parents[1]))
    import chip_smoke
    from rag_serving_system_torch.config import Settings
    from rag_serving_system_torch.core.engine import RagEngine
    from rag_serving_system_torch.models.weights import named_leaves

    seeded = _tiny_engine(dev, prefix_cache=True)
    chip_smoke.write_checkpoints(str(tmp_path), seeded, {"encoder": "enc", "decoder": "dec"})
    import dataclasses
    s = dataclasses.replace(seeded.settings, weights_dir=str(tmp_path),
                            embed_model_name="enc", llm_model_name="dec")
    docs, emb = _tiny_corpus()
    loaded = RagEngine(s, docs, emb, device=dev)
    assert loaded.weights_loaded == {"encoder": True, "decoder": True}
    for ours, ref in ((loaded.enc_params, seeded.enc_params),
                      (loaded.dec_params, seeded.dec_params)):
        ref = dict(named_leaves(ref))
        for name, leaf in named_leaves(ours):
            assert leaf.device == ref[name].device and torch.equal(leaf, ref[name]), name
    # no tokenizer files beside the weights: the loaded engine hashes with the
    # hash tokenizer's default special ids, the seeded one with the model's
    loaded.enc_tok, loaded.dec_tok = seeded.enc_tok, seeded.dec_tok
    assert loaded.process(TINY_QUERIES, [2] * 4) == seeded.process(TINY_QUERIES, [2] * 4)


@pytest.mark.parametrize("workers,fin_async", [("1", "1"), ("2", "1"), ("2", "0")])
def test_pipelined_processor_equals_serial_on_the_card(dev, monkeypatch, workers, fin_async):
    """13 greedy requests through the pipelined processor on the card (two
    threads launch CUDA work): each answer equals the serial mode's."""
    from rag_serving_system_torch.core.batch_processor import BatchProcessor
    from rag_serving_system_torch.core.request_queue import RequestQueue

    queries = [f"what is w{i} w{i + 1}" + " and more" * (i % 4) for i in range(13)]

    def serve(**kw):
        engine = _tiny_engine(dev, prefix_cache=True)
        q = RequestQueue(max_batch_size=4, max_wait_time=0.05, polling_interval=0.01)
        rids = [q.add_request(text, 2) for text in queries]
        proc = BatchProcessor(q, engine, polling_interval=0.01, **kw)
        proc.start()
        try:
            return [q.get_result(r, timeout=120) for r in rids]
        finally:
            proc.stop(drain_timeout=5.0)

    serial = serve(prefetch=False)
    monkeypatch.setenv("PREFETCH_WORKERS", workers)
    monkeypatch.setenv("FINALIZE_ASYNC", fin_async)
    assert serve() == serial
    assert all(isinstance(r.get("result"), str) for r in serial)


def test_training_step_on_the_card_equals_the_cpu(dev):
    """One tiny f32 contrastive step (loss, backward, AdamW) on the card and
    on the CPU from the same weights and batch: the loss within 1e-5, every
    gradient within 1e-4 of its leaf's largest magnitude, the parameters
    after the step within 2e-6, or 2 lr where the CPU's gradient is within
    1e-7 of zero (Adam moves such an element by lr times its sign)."""
    from rag_serving_system_torch.models.configs import E5_TINY
    from rag_serving_system_torch.models.tokenizer import HashTokenizer
    from rag_serving_system_torch.models.weights import init_encoder_params
    from rag_serving_system_torch.models.weights import named_leaves
    from rag_serving_system_torch.training import adamw, contrastive_loss, pair_batches

    lr = 5e-4
    pairs = [{"fact": f"the colour of object {i} is shade {i}",
              "query": f"what colour is object {i}?"} for i in range(16)]
    tok = HashTokenizer(E5_TINY.vocab_size, pad_id=E5_TINY.pad_token_id)
    runs = {}
    for where in (dev, torch.device("cpu")):
        params = init_encoder_params(E5_TINY, seed=0, dtype=torch.float32)
        params = {k: {n: t.to(where) for n, t in v.items()} for k, v in params.items()}
        opt = adamw(params, lr)
        batch = next(pair_batches(tok, pairs, 16, 32, device=where))
        loss, acc = contrastive_loss(params, E5_TINY, batch, dtype=torch.float32)
        loss.backward()
        grads = {n: t.grad.cpu().clone() for n, t in named_leaves(params)}
        opt.step()
        runs[where.type] = (float(loss), float(acc), grads,
                            {n: t.detach().cpu() for n, t in named_leaves(params)})
    (l_gpu, a_gpu, g_gpu, p_gpu), (l_cpu, a_cpu, g_cpu, p_cpu) = runs["cuda"], runs["cpu"]
    assert abs(l_gpu - l_cpu) <= 1e-5 and a_gpu == a_cpu
    for name, g in g_cpu.items():
        assert (g_gpu[name] - g).abs().max() <= 1e-4 * g.abs().max(), name
        allowed = 2e-6 + 2 * lr * (g.abs() <= 1e-7).float()
        assert ((p_gpu[name] - p_cpu[name]).abs() <= allowed).all(), name


@pytest.mark.parametrize("k", [16, 300])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_sharded_topk_on_four_positions_of_the_card_equals_unsharded(dev, k, dtype):
    """`sharded_cosine_topk` over a 2 x 2 mesh on [cuda:0] * 4 through B1 on
    each shard, at k = 16 (the warp lists) and 300 (the score kernel and
    the select): the ids and scores of unsharded B1. The f32 corpus has
    5003 rows (a pad row in the last shard: each shard selects k + 1, on the
    same path as k); the bf16 one 5004, as k = 17 would leave bf16's lists
    (LIST_K 16) for a path that sums in another order."""
    from rag_serving_system_torch.parallel.mesh import make_mesh
    from rag_serving_system_torch.parallel.sharded_topk import (shard_corpus,
                                                                 sharded_cosine_topk)

    n = 5003 if dtype == torch.float32 else 5004
    mesh = make_mesh("2,2", devices=[torch.device("cuda", 0)] * 4)
    corpus = tt.l2_normalize(_randn(dev, (n, 1024), 41)).to(dtype)
    q = _randn(dev, (32, 1024), 42)
    shards = shard_corpus(corpus, mesh)
    assert [s.shape[0] for s in shards] == [1251] * 4
    before = tt.cosine_topk.launches
    s, i = sharded_cosine_topk(shards, q, k, mesh, valid_n=n)
    assert tt.cosine_topk.launches > before
    rs, ri = tt.cosine_topk(corpus, q, k)
    assert torch.equal(i, ri)
    assert torch.equal(s, rs)


# ---------------------------------------------------------------------------
# the native host path and the multi-process mesh on the card
# ---------------------------------------------------------------------------

def test_native_front_serves_the_tiny_engine_on_the_card(dev, tmp_path, monkeypatch):
    """NATIVE_FRONT_PORT: `build_app(role="all")` serves the tiny preset on
    the card through the port's C++ front; B1 and B2 launch, the hash
    tokenizers encode through their C library, and the front counts every
    request."""
    import json
    import socket
    import urllib.request

    from rag_serving_system_torch import main as port_main
    from rag_serving_system_torch.config import Settings

    docs, emb = _tiny_corpus()
    (tmp_path / "docs.json").write_text(json.dumps(docs))
    np.save(tmp_path / "emb.npy", emb)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    monkeypatch.setenv("NATIVE_FRONT_PORT", str(port))
    monkeypatch.setenv("TORCH_DEVICE", "cuda")
    settings = Settings(model_preset="tiny", dtype="float32", batch_buckets=[1, 4],
                        max_batch_size=4, encode_len_buckets=[16, 32],
                        prompt_len_buckets=[32, 128], packed_t_step=256, max_new_tokens=6,
                        max_k=4, prefix_pool_len=48, max_wait_time=0.1, redis_url=None,
                        document_text_file=str(tmp_path / "docs.json"),
                        document_embeddings_file=str(tmp_path / "emb.npy"))
    before = (tt.cosine_topk.launches, ta.flash_attention.launches)
    app, proc, engine, _ = port_main.build_app(settings=settings, role="all")
    front = proc.request_queue._front
    try:
        assert engine.enc_tok._lib is not None and engine.dec_tok._lib is not None
        for q in TINY_QUERIES:
            req = urllib.request.Request(
                f"http://127.0.0.1:{port}/rag?wait=30", method="POST",
                data=json.dumps({"query": q, "k": 2}).encode(),
                headers={"content-type": "application/json"})
            with urllib.request.urlopen(req, timeout=60) as r:
                out = json.loads(r.read())
            assert out["status"] == "complete" and isinstance(out["result"]["result"], str)
        assert front.stats()["completed"] == len(TINY_QUERIES)
        assert tt.cosine_topk.launches > before[0] and ta.flash_attention.launches > before[1]
    finally:
        proc.stop(drain_timeout=5.0)
        front.stop()


def test_c_tokenizer_answers_as_the_python_path_on_the_card(dev):
    """The engine on the card answers alike whether its hash tokenizers
    encode through C or in Python."""
    engine = _tiny_engine(dev, prefix_cache=False)
    toks = (engine.enc_tok, engine.dec_tok)
    assert all(t._lib is not None for t in toks)
    with_c = engine.process(TINY_QUERIES, [2] * 4)
    with mock.patch.object(toks[0], "_lib", None), mock.patch.object(toks[1], "_lib", None):
        assert engine.process(TINY_QUERIES, [2] * 4) == with_c
    assert all(r["result"] for r in with_c)


def test_two_process_topk_on_the_card():
    """`dryrun_multihost` on the card (both workers on cuda:0 of one card, a
    card each where there are more): MULTIHOST PASS."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-m", "rag_serving_system_torch.dryrun_multihost"],
                         cwd=root, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "MULTIHOST PASS"
    assert out.stdout.count('"parity": "ok"') == 2


@pytest.mark.parametrize("over", [dict(prefix_cache=False),
                                  dict(prefix_cache=False, packed_prefill=False)],
                         ids=["packed_b3", "padded_b2"])
def test_spans_and_kernels_share_one_clock_on_the_card(dev, tmp_path, over):
    """Under `device_trace`, every B2/B3 launch call of the tiny engine's
    prefills (stamped by the profiler on the host) lies inside a `prefill`
    span, and no device event carries a span's name. A trace whose kernels
    all follow their launch calls passes `clock_ok` and has its B2/B3
    kernels (stamped by CUPTI on the card) inside the span within 0.2 ms;
    one with a kernel stamped before its launch call is flagged. On either,
    the kernels moved onto the host's clock by their launch calls
    (`host_shifts`, by which `idle_by_span` moves the gaps) lie inside the span
    within 0.2 ms. CUPTI stamps some sessions' kernels 0.08-5 ms early,
    drifting within the session: three traces are taken."""
    import re

    from torch.autograd import DeviceType

    from rag_serving_system_torch.utils import timing

    engine = _tiny_engine(dev, **over)
    engine.process(TINY_QUERIES, [2] * 4)          # builds the kernels
    torch.cuda.synchronize()
    slack = 200_000
    for attempt in range(3):
        engine.timer.reset()
        with timing.device_trace(str(tmp_path / str(attempt)), device=dev,
                                 spans=engine.timer) as prof:
            for _ in range(3):
                engine.process(TINY_QUERIES, [2] * 4)
            torch.cuda.synchronize()
        evs = prof.profiler.kineto_results.events()
        cuda = [e for e in evs if e.device_type() == DeviceType.CUDA]
        is_flash = [bool(re.search(r"flash_(wg_)?kernel", e.name())) for e in cuda]
        flash = [e for e, f in zip(cuda, is_flash) if f]
        launch = {e.correlation_id(): e for e in evs
                  if e.device_type() == DeviceType.CPU and "LaunchKernel" in e.name()}
        prefills = [(s[2], s[3]) for s in engine.timer.spans if s[0] == "prefill"]
        assert len(prefills) == 3 and len(flash) >= 3 * engine.dec_cfg.num_layers, \
            (len(prefills), len(flash), len(cuda))
        assert all(e.correlation_id() in launch for e in flash)

        def outside(intervals, slack):
            return [(a, b) for a, b in intervals
                    if not any(p0 - slack <= a and b <= p1 + slack for p0, p1 in prefills)]

        calls = [launch[e.correlation_id()] for e in flash]
        assert not outside([(c.start_ns(), c.start_ns() + c.duration_ns()) for c in calls], 0), \
            prefills
        span_names = {s[0] for s in engine.timer.spans}
        assert span_names >= {"generate", "stage_prompts", "prefill", "decode", "embed_retrieve"}
        assert not span_names & {e.name() for e in cuda}
        early = [e for e in flash if e.start_ns() < launch[e.correlation_id()].start_ns()]
        assert prof.clock_ok is not None and not (early and prof.clock_ok), \
            (len(early), prof.clock_ok)
        if prof.clock_ok:
            kernels = [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in flash]
            assert not outside(kernels, slack), (outside(kernels, slack)[:3], prefills)
        shifts = timing.host_shifts(timing.read_trace(prof))
        moved = [(e.start_ns() - sh, e.start_ns() - sh + e.duration_ns())
                 for e, sh, f in zip(cuda, shifts, is_flash) if f]
        assert not outside(moved, slack), (prof.clock_ok, outside(moved, slack)[:3], prefills)
        assert prof.idle_by_span["gaps"] > 0 and "decode" in prof.idle_by_span["by_span"], \
            prof.idle_by_span


# ---------------------------------------------------------------------------
# the decode step replayed from a CUDA graph (models/qwen2.py DecodeGraphs)
# ---------------------------------------------------------------------------

GRAPH_MNT = 6


def _graph_params(dev, dtype):
    """The tiny decoder with its matrices scaled by 8 (varied greedy
    answers), in `dtype`."""
    from rag_serving_system_torch.models.configs import QWEN2_TINY
    from rag_serving_system_torch.models.weights import init_decoder_params

    fp = init_decoder_params(QWEN2_TINY, seed=1, dtype=torch.float32, device=dev)
    for key in ("qkv_w", "o_w", "gu_w", "down_w"):
        fp["layers"][key] *= 8.0
    fp["embed"] *= 8.0

    def cast(tree):
        return {k: cast(v) if isinstance(v, dict) else v.to(dtype) for k, v in tree.items()}
    return cast(fp)


def _graph_batch(dev, route, seed):
    """(generate function, its positional inputs, its keywords): a packed
    batch of 32 rows, or 3 rows over cached prefixes at a bucket of 4."""
    from test_torch_decode_graphs import _left_padded, _pack

    from rag_serving_system_torch.models import qwen2 as tq
    from rag_serving_system_torch.models.configs import QWEN2_TINY

    rng = np.random.default_rng(seed)
    if route == "packed32":
        lens = rng.integers(3, 25, 32).tolist()
        ids, mask = _left_padded(seed, 32, 24, lens)
        *packed, valid = _pack(ids, mask, 1024, cap=32)
        return tq.generate_packed, [t.to(dev) for t in packed], dict(row_valid=valid.to(dev))
    ids, mask = _left_padded(seed, 4, 8, [8, 5, 2, 1])
    pl = 16
    pids = torch.tensor(rng.integers(3, QWEN2_TINY.vocab_size, (4, pl)), dtype=torch.int32)
    plen = torch.tensor([16, 9, 4, 0], dtype=torch.int32)
    pmask = (torch.arange(pl)[None, :] < plen[:, None]).to(torch.int32)
    return tq.generate, [ids.to(dev), mask.to(dev)], dict(
        row_valid=torch.tensor([True, True, True, False], device=dev),
        prefix_len=plen.to(dev), prefix_ids=(pids.to(dev), pmask.to(dev)))


def _run_graph_batch(params, cfg, dtype, fn, args, kw, graphs=None, timer=None,
                     eos_bias=0.0, budget=None):
    """The tokens of one generate call and every logits tensor its loop
    picked from (the prefill's first), through `pick_token`."""
    from rag_serving_system_torch.models import qwen2 as tq

    kw = dict(kw)
    if "prefix_ids" in kw:
        pids, pmask = kw.pop("prefix_ids")
        kw["prefix_kv"] = tq.compute_prefix_kv(params, cfg, pids, pmask, dtype=dtype)
    seen = []
    real = tq.pick_token

    def recorded(logits, *a, **k):
        seen.append(logits.clone())
        return real(logits, *a, **k)

    with mock.patch.object(tq, "pick_token", recorded):
        out = fn(params, cfg, *args, max_new_tokens=GRAPH_MNT, do_sample=False, dtype=dtype,
                 row_budget=budget, eos_bias=eos_bias, timer=timer, graphs=graphs, **kw)
    torch.cuda.synchronize()
    return out, seen


@pytest.mark.parametrize("route", ["packed32", "prefix_partial"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_replayed_decode_equals_the_eager_loop_on_the_card(dev, monkeypatch, dtype, route):
    """Every step replayed from the captured graph: the greedy tokens and
    every picked logit bit-equal to the eager loop's, in f32 (TF32 off) and
    bf16, with a row stopped early through `eos_bias` (the stop id made the
    runner-up of row 1's third pick, the bias its gap) and a row budget of 3."""
    import dataclasses

    from rag_serving_system_torch.models import qwen2 as tq
    from rag_serving_system_torch.models.configs import QWEN2_TINY
    from rag_serving_system_torch.utils.timing import StageTimer

    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    params = _graph_params(dev, dtype)
    fn, args, kw = _graph_batch(dev, route, 11)
    _, seen = _run_graph_batch(params, QWEN2_TINY, dtype, fn, args, kw)
    top = torch.topk(seen[2][1], 2)
    stop = int(top.indices[1])
    cfg = dataclasses.replace(QWEN2_TINY, eos_token_id=stop, eos_token_ids=(stop,))
    bias = float(top.values[0] - top.values[1]) * 1.01 + 1e-4
    rows = args[-1].shape[0]
    budget = torch.full((rows,), GRAPH_MNT, dtype=torch.int32, device=dev)
    budget[0] = 3
    want, want_logits = _run_graph_batch(params, cfg, dtype, fn, args, kw, eos_bias=bias,
                                         budget=budget)
    timer, graphs = StageTimer(), tq.DecodeGraphs()
    got, got_logits = _run_graph_batch(params, cfg, dtype, fn, args, kw, graphs=graphs,
                                       timer=timer, eos_bias=bias, budget=budget)
    assert torch.equal(got, want)
    assert len(got_logits) == len(want_logits) > 2
    for g, w in zip(got_logits, want_logits):
        assert torch.equal(g, w)
    assert timer.counts["decode_capture"] == 1
    assert timer.counts["decode_replay"] == timer.counts["decode"] == len(got_logits) - 1
    hit = (got == stop)
    assert hit[1, :3].any()                           # row 1 stopped through the bias
    assert (got[0, 3:] == cfg.pad_token_id).all()     # row 0 at its budget


def test_second_batch_on_a_key_replays_the_same_graph_on_the_card(dev):
    """A second packed batch of the key reuses the captured graph (one
    capture) and the cache whose decode slots hold the first batch's K/V,
    and its tokens equal its own eager run: stale slots stay masked."""
    from rag_serving_system_torch.models import qwen2 as tq
    from rag_serving_system_torch.models.configs import QWEN2_TINY
    from rag_serving_system_torch.utils.timing import StageTimer

    params = _graph_params(dev, torch.bfloat16)
    timer, graphs = StageTimer(), tq.DecodeGraphs()
    for seed in (21, 22):
        fn, args, kw = _graph_batch(dev, "packed32", seed)
        want, _ = _run_graph_batch(params, QWEN2_TINY, torch.bfloat16, fn, args, kw)
        got, _ = _run_graph_batch(params, QWEN2_TINY, torch.bfloat16, fn, args, kw,
                                  graphs=graphs, timer=timer)
        assert torch.equal(got, want)
    assert len(graphs.entries) == 1
    assert timer.counts["decode_capture"] == 1
    assert timer.counts["decode_replay"] == timer.counts["decode"] > 0


def test_a_trace_around_replayed_loops_holds_their_kernels_on_the_card(dev, tmp_path):
    """A `device_trace` around loops that replay their captured step holds
    the graphs' kernels, a SiLU a layer a step besides the prefills', so a
    trace reads graph work as busy; the tokens are the replayed loop's."""
    import re

    from torch.autograd import DeviceType

    from rag_serving_system_torch.models import qwen2 as tq
    from rag_serving_system_torch.models.configs import QWEN2_TINY
    from rag_serving_system_torch.utils import timing

    params = _graph_params(dev, torch.bfloat16)
    graphs = tq.DecodeGraphs()
    fn, args, kw = _graph_batch(dev, "packed32", 31)
    want, _ = _run_graph_batch(params, QWEN2_TINY, torch.bfloat16, fn, args, kw, graphs=graphs)
    timer = timing.StageTimer()
    with timing.device_trace(str(tmp_path), device=dev) as prof:
        for _ in range(2):
            got, _ = _run_graph_batch(params, QWEN2_TINY, torch.bfloat16, fn, args, kw,
                                      graphs=graphs, timer=timer)
            assert torch.equal(got, want)
    steps = timer.counts["decode"]
    assert steps > 0 and timer.counts["decode_replay"] == steps
    assert "decode_capture" not in timer.counts
    cuda = [e for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA]
    silu = sum(bool(re.search("silu", e.name(), re.I)) for e in cuda)
    assert silu >= QWEN2_TINY.num_layers * (steps + 2), (silu, steps)


def test_replays_beside_profiler_starts_and_stops_on_the_card(dev):
    """Loops replaying on one thread while another starts and stops a
    profiler, as the benchmark's trace does (its own synchronize, then
    stop): every stop returns and every loop's tokens are the eager ones.
    Unguarded, such a stop deadlocked against a graph launch on an H100."""
    import threading
    import time

    from torch.profiler import ProfilerActivity, profile

    from rag_serving_system_torch.models import qwen2 as tq
    from rag_serving_system_torch.models.configs import QWEN2_TINY
    from rag_serving_system_torch.utils.timing import StageTimer

    params = _graph_params(dev, torch.bfloat16)
    fn, args, kw = _graph_batch(dev, "packed32", 41)
    want, _ = _run_graph_batch(params, QWEN2_TINY, torch.bfloat16, fn, args, kw)
    graphs, timer = tq.DecodeGraphs(), StageTimer()
    stop, bad = threading.Event(), []

    def serve():
        while not stop.is_set():
            got, _ = _run_graph_batch(params, QWEN2_TINY, torch.bfloat16, fn, args, kw,
                                      graphs=graphs, timer=timer)
            if not torch.equal(got, want):
                bad.append(got)

    th = threading.Thread(target=serve, daemon=True)
    th.start()
    try:
        for _ in range(20):
            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.start()
            time.sleep(0.05)
            torch.cuda.synchronize()
            prof.stop()
    finally:
        stop.set()
        th.join(timeout=60)
    assert not th.is_alive() and not bad
    assert timer.counts["decode_replay"] == timer.counts["decode"] > 20
