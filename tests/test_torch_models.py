"""PyTorch port: e5 encoder and Qwen2 decoder against the JAX package at the
tiny presets in f32, with the JAX weights converted by `params_from_jax`.

Random-init decoder weights at std 0.02 make greedy decoding repeat one
token, so the generation tests scale the decoder's matrices by 8 (in both
packages) to get varied trajectories. Greedy equality is an f32 claim."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rag_serving_system_tpu.models import e5 as je  # noqa: E402
from rag_serving_system_tpu.models import qwen2 as jq  # noqa: E402
from rag_serving_system_tpu.models.configs import E5_TINY, QWEN2_TINY  # noqa: E402
from rag_serving_system_tpu.models.layers import NEG_INF  # noqa: E402
from rag_serving_system_tpu.models.weights import (  # noqa: E402
    init_decoder_params, init_encoder_params)
from rag_serving_system_torch.models import e5 as te  # noqa: E402
from rag_serving_system_torch.models import qwen2 as tq  # noqa: E402
from rag_serving_system_torch.models.weights import (  # noqa: E402
    params_from_jax,
    prefix_kv_from_jax,
)

F32 = dict(dtype=jnp.float32)
T32 = dict(dtype=torch.float32)


def _scaled(tree, f):
    return {k: (_scaled(v, f) if isinstance(v, dict) else
                v * f if k in ("embed", "qkv_w", "o_w", "gu_w", "down_w") else v)
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def dec():
    jp = _scaled(init_decoder_params(QWEN2_TINY, dtype=jnp.float32), 8.0)
    return jp, params_from_jax(jax.device_get(jp))


def _left_padded(seed, b, p, lens, pad=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, QWEN2_TINY.vocab_size, (b, p)).astype(np.int32)
    mask = np.zeros((b, p), np.int32)
    for i, n in enumerate(lens):
        mask[i, p - n:] = 1
        ids[i, :p - n] = pad
    return ids, mask


def _pack(ids, mask, t, cap):
    """The engine's packed staging of left-padded rows (engine._stage_packed)."""
    b, p = ids.shape
    stream = np.zeros((3, t), np.int32)
    stream[1] = cap
    gather = np.full((cap, p), -1, np.int32)
    last = np.full((cap,), -1, np.int32)
    off = 0
    for i in range(b):
        row = ids[i][mask[i] > 0]
        n = len(row)
        stream[0, off:off + n] = row
        stream[1, off:off + n] = i
        stream[2, off:off + n] = np.arange(n)
        gather[i, p - n:] = off + np.arange(n)
        last[i] = off + n - 1
        off += n
    prompt_mask = (gather >= 0).astype(np.int32)
    return (stream[0][None], stream[1][None], stream[2][None],
            np.maximum(last, 0), np.maximum(gather, 0), prompt_mask, last >= 0)


def test_e5_encode_matches_jax():
    jp = init_encoder_params(E5_TINY, dtype=jnp.float32)
    tp = params_from_jax(jax.device_get(jp))
    rng = np.random.default_rng(0)
    ids = rng.integers(3, E5_TINY.vocab_size, (3, 16)).astype(np.int32)
    mask = np.ones((3, 16), np.int32)
    mask[1, 9:] = 0
    ids[1, 9:] = E5_TINY.pad_token_id       # right padding, pooled over (mean_all)
    ref = je.encode(jp, E5_TINY, jnp.asarray(ids), jnp.asarray(mask), **F32)
    ours = te.encode(tp, E5_TINY, torch.tensor(ids), torch.tensor(mask), **T32)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)
    with pytest.raises(ValueError):          # the position-table guard
        te.encoder_forward(tp, E5_TINY, torch.zeros((1, 600), dtype=torch.int64),
                           torch.ones((1, 600), dtype=torch.int64), **T32)


def test_prefill_logits_match_jax(dec):
    jp, tp = dec
    ids, mask = _left_padded(1, 3, 24, [24, 11, 17])
    ref, _ = jq.prefill(jp, QWEN2_TINY, jnp.asarray(ids), jnp.asarray(mask), 4, **F32)
    ours, cache = tq.prefill(tp, QWEN2_TINY, torch.tensor(ids), torch.tensor(mask),
                             4, **T32)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)
    assert cache.k.shape == (QWEN2_TINY.num_layers, 3, 28, QWEN2_TINY.num_kv_heads,
                             QWEN2_TINY.head_dim)


def test_prefill_packed_logits_match_jax(dec):
    jp, tp = dec
    ids, mask = _left_padded(2, 3, 24, [24, 5, 17])
    args = _pack(ids, mask, 64, cap=4)
    ref, _ = jq.prefill_packed(jp, QWEN2_TINY, *map(jnp.asarray, args[:6]), 4,
                               max_seg_len=24, **F32)
    ours, _ = tq.prefill_packed(tp, QWEN2_TINY, *map(torch.tensor, args[:6]), 4, **T32)
    np.testing.assert_allclose(ours[:3].numpy(), np.asarray(ref)[:3],
                               atol=1e-4, rtol=1e-4)
    padded, _ = tq.prefill(tp, QWEN2_TINY, torch.tensor(ids), torch.tensor(mask), 4,
                           **T32)
    np.testing.assert_allclose(ours[:3].numpy(), padded.numpy(), atol=1e-4, rtol=1e-4)


def test_prefill_packed_n_real_leaves_real_tokens_bit_identical(dec):
    """prefill_packed told the stream's real count (B3 computes no pad-tail
    row) gives the same last-token logits and the same gathered cache as
    without it, bit for bit in f32, and the JAX package's logits within the
    existing tolerance: no real token reads a pad row."""
    jp, tp = dec
    ids, mask = _left_padded(2, 3, 24, [24, 5, 17])
    args = _pack(ids, mask, 64, cap=4)
    n_real = int(mask.sum())
    targs = [torch.tensor(x) for x in args[:6]]
    ours, cache = tq.prefill_packed(tp, QWEN2_TINY, *targs, 4, n_real=n_real, **T32)
    whole, cache_whole = tq.prefill_packed(tp, QWEN2_TINY, *targs, 4, **T32)
    assert n_real < 64
    assert torch.equal(ours, whole)
    assert torch.equal(cache.k, cache_whole.k) and torch.equal(cache.v, cache_whole.v)
    ref, _ = jq.prefill_packed(jp, QWEN2_TINY, *map(jnp.asarray, args[:6]), 4,
                               max_seg_len=24, **F32)
    np.testing.assert_allclose(ours[:3].numpy(), np.asarray(ref)[:3], atol=1e-4, rtol=1e-4)
    toks = tq.generate_packed(tp, QWEN2_TINY, *targs, None, max_new_tokens=8,
                              do_sample=False, row_valid=torch.tensor(args[6]),
                              n_real=n_real, **T32)
    assert torch.equal(toks, tq.generate_packed(tp, QWEN2_TINY, *targs, None,
                                                max_new_tokens=8, do_sample=False,
                                                row_valid=torch.tensor(args[6]), **T32))


@pytest.mark.parametrize("int8", [False, True], ids=["compute", "int8"])
def test_prefill_over_a_cached_prefix_fills_the_jax_cache(dec, int8):
    """Prefill of a suffix over a cached prefix (the JAX package's entry,
    exact or as an (int8, scales) pair): the logits and the cache's valid
    slots, [prefix < prefix_len | real suffix tokens], equal the JAX
    cache's (atol 1e-4 / 1e-5), and the slots for generated tokens are 0."""
    jp, tp = dec
    pre_lens, pl, p = [13, 0, 16], 16, 12
    rng = np.random.default_rng(7)
    pids = rng.integers(3, QWEN2_TINY.vocab_size, (3, pl)).astype(np.int32)
    pmask = (np.arange(pl)[None, :] < np.asarray(pre_lens)[:, None]).astype(np.int32)
    pmask[1, 0] = 1                      # the empty row stays well-defined
    jkv = jq.compute_prefix_kv(jp, QWEN2_TINY, jnp.asarray(pids), jnp.asarray(pmask), **F32)
    if int8:
        jkv = jq.quantize_prefix_kv(jkv)
    ids, mask = _left_padded(8, 3, p, [5, 12, 9])
    ref, rcache = jq.prefill(jp, QWEN2_TINY, jnp.asarray(ids), jnp.asarray(mask), 4, **F32,
                             prefix_kv=jkv, prefix_len=jnp.asarray(pre_lens, jnp.int32))
    ours, cache = tq.prefill(tp, QWEN2_TINY, torch.tensor(ids), torch.tensor(mask), 4, **T32,
                             prefix_kv=prefix_kv_from_jax(jax.device_get(jkv)),
                             prefix_len=torch.tensor(pre_lens, dtype=torch.int32))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-4, rtol=0)
    assert cache.k.shape == np.asarray(rcache.k).shape == (
        QWEN2_TINY.num_layers, 3, pl + p + 4, QWEN2_TINY.num_kv_heads, QWEN2_TINY.head_dim)
    valid = np.concatenate([np.arange(pl)[None, :] < np.asarray(pre_lens)[:, None],
                            mask > 0, np.zeros((3, 4), bool)], axis=1)
    for ours_t, ref_t in ((cache.k, rcache.k), (cache.v, rcache.v)):
        np.testing.assert_allclose(ours_t.numpy()[:, valid], np.asarray(ref_t)[:, valid],
                                   atol=1e-5, rtol=0)
        assert not ours_t[:, :, pl + p:].any()


@pytest.mark.parametrize("budgets,valid", [
    (None, None),
    ([8, 3, 1, 8], [True, True, True, False]),   # per-row budgets, a pad row
])
def test_generate_greedy_tokens_equal_jax(dec, budgets, valid):
    jp, tp = dec
    ids, mask = _left_padded(3, 4, 20, [20, 9, 14, 1])
    kw = dict(max_new_tokens=8, do_sample=False)
    jkw, tkw = dict(kw), dict(kw)
    if budgets is not None:
        jkw.update(row_budget=jnp.asarray(budgets, jnp.int32),
                   row_valid=jnp.asarray(valid))
        tkw.update(row_budget=torch.tensor(budgets, dtype=torch.int32),
                   row_valid=torch.tensor(valid))
    ref = np.asarray(jq.generate(jp, QWEN2_TINY, jnp.asarray(ids), jnp.asarray(mask),
                                 jax.random.PRNGKey(0), **jkw, **F32))
    ours = tq.generate(tp, QWEN2_TINY, torch.tensor(ids), torch.tensor(mask), None,
                       **tkw, **T32).numpy()
    np.testing.assert_array_equal(ours, ref)
    assert len(set(ref[0].tolist())) > 2          # a varied trajectory


def test_generate_packed_greedy_tokens_equal_jax(dec):
    jp, tp = dec
    ids, mask = _left_padded(4, 3, 24, [24, 6, 15])
    args = _pack(ids, mask, 64, cap=4)
    ref = np.asarray(jq.generate_packed(
        jp, QWEN2_TINY, *map(jnp.asarray, args[:6]), jax.random.PRNGKey(0),
        max_new_tokens=8, max_seg_len=24, do_sample=False,
        row_valid=jnp.asarray(args[6]), **F32))
    ours = tq.generate_packed(tp, QWEN2_TINY, *map(torch.tensor, args[:6]), None,
                              max_new_tokens=8, do_sample=False,
                              row_valid=torch.tensor(args[6]), **T32).numpy()
    np.testing.assert_array_equal(ours, ref)
    padded = tq.generate(tp, QWEN2_TINY, torch.tensor(ids), torch.tensor(mask), None,
                         max_new_tokens=8, do_sample=False, **T32).numpy()
    np.testing.assert_array_equal(ours[:3], padded)


def test_every_stop_id_ends_a_row(dec):
    """A token the greedy trajectory emits mid-row, declared a stop id, ends
    that row in both packages (pad_token_id after it)."""
    jp, tp = dec
    ids, mask = _left_padded(5, 2, 16, [16, 10])
    base = np.asarray(jq.generate(jp, QWEN2_TINY, jnp.asarray(ids), jnp.asarray(mask),
                                  jax.random.PRNGKey(0), max_new_tokens=8,
                                  do_sample=False, **F32))
    cfg = dataclasses.replace(QWEN2_TINY, eos_token_ids=(1, int(base[0, 3])))
    ref = np.asarray(jq.generate(jp, cfg, jnp.asarray(ids), jnp.asarray(mask),
                                 jax.random.PRNGKey(0), max_new_tokens=8,
                                 do_sample=False, **F32))
    ours = tq.generate(tp, cfg, torch.tensor(ids), torch.tensor(mask), None,
                       max_new_tokens=8, do_sample=False, **T32).numpy()
    np.testing.assert_array_equal(ours, ref)
    assert (ours[0, base[0].tolist().index(base[0, 3]) + 1:] == cfg.pad_token_id).all()


def test_sample_candidates_equal_jax_and_samples_stay_inside():
    """The kept top-k/top-p candidate set equals the JAX sampler's (the same
    steps as qwen2.sample_token); sampled tokens are never compared across
    packages, only checked to lie in the kept set."""
    rng = np.random.default_rng(6)
    logits = (3.0 * rng.standard_normal((4, 512))).astype(np.float32)
    vals, idx = jax.lax.top_k(jnp.asarray(logits), 20)
    vals = vals / jnp.float32(0.7)
    probs = jax.nn.softmax(vals, axis=-1)
    keep = jnp.cumsum(probs, axis=-1) - probs < 0.8
    ref_vals = np.asarray(jnp.where(keep, vals, NEG_INF))
    ours_vals, ours_idx = tq.sample_candidates(torch.tensor(logits))
    np.testing.assert_array_equal(ours_idx.numpy(), np.asarray(idx))
    np.testing.assert_array_equal(ours_vals.numpy() == NEG_INF, ref_vals == NEG_INF)
    np.testing.assert_allclose(ours_vals.numpy(), ref_vals, rtol=1e-6)
    g = torch.Generator().manual_seed(0)
    kept = [set(np.asarray(idx)[b][ref_vals[b] > NEG_INF].tolist()) for b in range(4)]
    for _ in range(50):
        tok = tq.sample_token(torch.tensor(logits), g).numpy()
        assert all(int(tok[b]) in kept[b] for b in range(4))
