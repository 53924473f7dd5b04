"""PyTorch port: plain versions of kernels B2 (padded) and B3 (packed)
against the JAX Pallas kernels in interpret mode and the einsum oracles, at
the tolerance of tests/test_attention.py (2e-4)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from rag_serving_system_tpu.models.layers import (  # noqa: E402
    attention, causal_padding_bias)
from rag_serving_system_tpu.ops import attention as ja  # noqa: E402
from rag_serving_system_torch.ops import attention as ta  # noqa: E402

TOL = dict(atol=2e-4, rtol=2e-4)


def _qkv(seed, b, s, hq, hk, d):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, hq, d), (b, s, hk, d), (b, s, hk, d))]


@pytest.mark.parametrize("b,s,hq,hk,d,blk", [
    (2, 128, 4, 2, 64, 64),     # GQA group 2
    (1, 256, 2, 2, 32, 128),    # MHA, multi-block
    (2, 128, 6, 2, 32, 128),    # group 3, single k block
])
def test_flash_matches_pallas(b, s, hq, hk, d, blk):
    q, k, v = _qkv(0, b, s, hq, hk, d)
    mask = np.ones((b, s), np.int32)
    ours = ta.flash_attention(*map(torch.tensor, (q, k, v, mask)))
    ref = ja.flash_attention(*map(jnp.asarray, (q, k, v, mask)),
                             blk_q=blk, blk_k=blk, interpret=True)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_padding_and_fully_masked_rows(causal):
    """Left padding (causal) or right padding (encoder style): real positions
    match Pallas and the einsum oracle; rows with no visible key are 0, as
    the Pallas kernel emits them, including a batch row with no real key."""
    b, s, hq, hk, d = 3, 128, 4, 2, 64
    q, k, v = _qkv(1, b, s, hq, hk, d)
    mask = np.ones((b, s), np.int32)
    if causal:
        mask[0, :40] = 0
    else:
        mask[0, 100:] = 0
    mask[2] = 0
    ours = ta.flash_attention(*map(torch.tensor, (q, k, v, mask)),
                              causal=causal).numpy()
    pallas = np.asarray(ja.flash_attention(*map(jnp.asarray, (q, k, v, mask)),
                                           causal=causal, blk_q=64, blk_k=64,
                                           interpret=True))
    np.testing.assert_allclose(ours, pallas, **TOL)
    visible = (np.tril(np.ones((s, s), bool)) if causal else np.ones((s, s), bool))
    dead = ~(visible[None] & (mask[:, None, :] > 0)).any(-1)      # (B, S)
    assert dead[0].any() == causal and dead[2].all()
    assert not ours[dead].any()
    real = mask.astype(bool) & ~dead
    bias = (causal_padding_bias(jnp.asarray(mask)) if causal else
            jnp.where(jnp.asarray(mask)[:, None, None, :] > 0, 0.0, -1e9))
    oracle = np.asarray(attention(*map(jnp.asarray, (q, k, v)), bias))
    np.testing.assert_allclose(ours[real], oracle[real], **TOL)


def _packed(seed, lens, t, hq=4, hk=2, d=64):
    seg = np.full(t, len(lens), np.int32)      # pad tail: id = number of rows
    off = 0
    for i, n in enumerate(lens):
        seg[off:off + n] = i
        off += n
    q, k, v = [0.1 * a for a in _qkv(seed, 1, t, hq, hk, d)]
    return q, k, v, seg[None], off


@pytest.mark.parametrize("lens,t,max_seg", [
    ([300, 150, 260, 200], 1024, 512),   # ragged rows, pad tail of 114
    ([37, 1, 90, 64, 5], 256, 128),      # rows far below the block size
])
def test_packed_matches_pallas_and_reference(lens, t, max_seg):
    q, k, v, seg, n_real = _packed(2, lens, t)
    ours = ta.flash_attention_packed(*map(torch.tensor, (q, k, v, seg))).numpy()
    pallas = ja.flash_attention_packed(*map(jnp.asarray, (q, k, v, seg)),
                                       max_seg_len=max_seg, blk_q=128, blk_k=128,
                                       interpret=True)
    ref = ja.packed_attention_reference(*map(jnp.asarray, (q, k, v, seg)))
    # real tokens only: the pad tail is a don't-care segment
    np.testing.assert_allclose(ours[0, :n_real], np.asarray(pallas)[0, :n_real], **TOL)
    np.testing.assert_allclose(ours[0, :n_real], np.asarray(ref)[0, :n_real], **TOL)


@pytest.mark.parametrize("lens,t,max_seg", [
    ([300, 150, 260, 200], 1024, 512),   # pad tail of 114
    ([37, 1, 90, 64, 5], 256, 128),      # pad tail of 59
])
def test_packed_n_real_zeroes_the_pad_tail(lens, t, max_seg):
    """With n_real (the real tokens at the head of the stream) the plain
    version is 0 past it; before it, it equals the Pallas kernel and the
    einsum reference to TOL, and the call without n_real bit for bit."""
    q, k, v, seg, n_real = _packed(4, lens, t)
    args = [torch.tensor(x) for x in (q, k, v, seg)]
    ours = ta.flash_attention_packed_plain(*args, n_real=n_real).numpy()
    assert not ours[0, n_real:].any()
    pallas = ja.flash_attention_packed(*map(jnp.asarray, (q, k, v, seg)),
                                       max_seg_len=max_seg, blk_q=128, blk_k=128,
                                       interpret=True)
    ref = ja.packed_attention_reference(*map(jnp.asarray, (q, k, v, seg)))
    np.testing.assert_allclose(ours[0, :n_real], np.asarray(pallas)[0, :n_real], **TOL)
    np.testing.assert_allclose(ours[0, :n_real], np.asarray(ref)[0, :n_real], **TOL)
    whole = ta.flash_attention_packed_plain(*args).numpy()
    np.testing.assert_array_equal(ours[0, :n_real], whole[0, :n_real])
    assert whole[0, n_real:].any()                 # the pad tail, computed without it
    # the wrapper takes the plain version on the CPU, n_real and all
    np.testing.assert_array_equal(ta.flash_attention_packed(*args, n_real=n_real).numpy(),
                                  ours)


def test_packed_n_real_bounds():
    """n_real = T is the call without it, n_real = 0 gives zeros, and a count
    outside [0, T] is refused."""
    q, k, v, seg, _ = _packed(5, [20, 30], 64)
    args = [torch.tensor(x) for x in (q, k, v, seg)]
    np.testing.assert_array_equal(ta.flash_attention_packed(*args, n_real=64).numpy(),
                                  ta.flash_attention_packed(*args).numpy())
    assert not ta.flash_attention_packed(*args, n_real=0).any()
    for bad in (-1, 65):
        with pytest.raises(ValueError):
            ta.flash_attention_packed(*args, n_real=bad)


def test_packed_equals_padded_per_row():
    """Each packed row attends exactly as the same row alone, causally."""
    lens = [20, 33, 7]
    q, k, v, seg, _ = _packed(3, lens, 64)
    packed = ta.flash_attention_packed(*map(torch.tensor, (q, k, v, seg))).numpy()
    off = 0
    for n in lens:
        sl = slice(off, off + n)
        alone = ta.flash_attention(torch.tensor(q[:, sl]), torch.tensor(k[:, sl]),
                                   torch.tensor(v[:, sl]),
                                   torch.ones((1, n), dtype=torch.int32)).numpy()
        np.testing.assert_allclose(packed[:, sl], alone, atol=1e-6, rtol=1e-6)
        off += n


def test_cuda_wrappers_refuse_other_devices():
    q = torch.empty((1, 8, 2, 64), device="meta")
    with pytest.raises(ValueError):
        ta.flash_attention(q, q, q, torch.ones((1, 8), device="meta"))
    with pytest.raises(ValueError):
        ta.flash_attention_packed(q, q, q, torch.zeros((1, 8), device="meta"))
