"""PyTorch port: speculative greedy decode against the JAX package, at the
tiny preset in f32 with shared weights (decoder matrices scaled by 8 so the
greedy stream varies).

`draft_ngram` must give the JAX function's drafts, `decode_step_spec` its
logits (1e-4) and its cache at the written slots, `_spec_decode_loop` its
tokens AND its iteration count exactly, at gamma 1, 3 and 7, under left
padding, row budgets, pad rows, an early EOS, an EOS bias, a cached prefix
and a `draft_source`. Speculative must equal sequential greedy exactly, on
the padded and packed routes and through the engine. Greedy equality is an
f32 claim."""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rag_serving_system_tpu.models import qwen2 as jq  # noqa: E402
from rag_serving_system_tpu.models.configs import QWEN2_TINY  # noqa: E402
from rag_serving_system_tpu.models.weights import init_decoder_params  # noqa: E402
from rag_serving_system_torch.models import qwen2 as tq  # noqa: E402
from rag_serving_system_torch.models.weights import (  # noqa: E402
    params_from_jax,
    prefix_kv_from_jax,
)

from test_torch_engine import (  # noqa: E402
    QUERIES, jax_engine, jax_settings, port_engine, tiny_settings)
from test_torch_models import _left_padded, _pack, _scaled  # noqa: E402

CFG = QWEN2_TINY
F32 = dict(dtype=jnp.float32)
T32 = dict(dtype=torch.float32)
PROMPTS = np.asarray([[7, 23, 99, 45, 3, 8], [100, 3, 88, 12, 55, 2],
                      [1, 2, 1, 2, 1, 2], [9, 9, 9, 9, 9, 9]], np.int32)
MASK = np.ones_like(PROMPTS)


@pytest.fixture(scope="module")
def dec():
    jp = _scaled(init_decoder_params(CFG, dtype=jnp.float32), 8.0)
    return jp, params_from_jax(jax.device_get(jp))


# ---------------------------------------------------------------------------
# draft_ngram
# ---------------------------------------------------------------------------

HAND_CASES = [
    # (history, cur, gamma, drafts)
    ([9, 5, 6, 1, 2, 3, 5, 6, 0, 0, 0, 0], 8, 3, [1, 2, 3]),        # latest bigram
    ([1, 2, 7, 0, 0, 1, 2, 8, 1, 2, 0, 0, 0], 10, 1, [8]),          # most recent match
    ([4, 9, 17, 0, 0, 0], 3, 4, [17, 17, 17, 17]),                  # repeat-last fallback
    ([3, 8, 8, 3, 8, 0], 5, 1, [8]),                                # never its own bigram
    ([5, 1, 2, 9, 9, 1, 2, 7, 5, 1, 2, 0, 0], 11, 1, [9]),          # trigram beats bigram
    ([4, 1, 2, 3, 0, 0], 4, 2, [3, 3]),                             # own trigram excluded
]


@pytest.mark.parametrize("hist,cur,gamma,want", HAND_CASES,
                         ids=["latest_bigram", "most_recent", "fallback",
                              "not_own_bigram", "trigram_wins", "not_own_trigram"])
def test_draft_ngram_hand_cases(hist, cur, gamma, want):
    got = tq.draft_ngram(torch.tensor([hist], dtype=torch.int32),
                         torch.tensor([cur], dtype=torch.int32), gamma)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), [want])
    ref = jq.draft_ngram(jnp.asarray([hist], jnp.int32), jnp.asarray([cur], jnp.int32),
                         gamma, pad_id=0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("gamma", [1, 3, 7])
def test_draft_ngram_matches_jax_on_seeded_histories(seed, gamma):
    """A 5-symbol alphabet makes bigram and trigram repeats frequent; cur
    runs from 2 (the loop's least value) to the history's end."""
    rng = np.random.default_rng(seed)
    b, h = 16, 40
    hist = rng.integers(0, 5, (b, h)).astype(np.int32)
    cur = rng.integers(2, h, (b,)).astype(np.int32)
    cur[0], cur[1] = 2, h - 1
    ref = jq.draft_ngram(jnp.asarray(hist), jnp.asarray(cur), gamma, pad_id=0)
    got = tq.draft_ngram(torch.tensor(hist), torch.tensor(cur), gamma)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# ---------------------------------------------------------------------------
# decode_step_spec
# ---------------------------------------------------------------------------

def test_decode_step_spec_matches_jax(dec):
    """Rows at different offsets: logits within 1e-4, and the cache equal to
    the JAX cache at every slot the step wrote."""
    jp, tp = dec
    b, p, mnt, s = 3, 12, 8, 4
    ids, mask = _left_padded(3, b, p, [12, 5, 9])
    _, jc = jq.prefill(jp, CFG, jnp.asarray(ids), jnp.asarray(mask), mnt + s - 1, **F32)
    _, tc = tq.prefill(tp, CFG, torch.tensor(ids), torch.tensor(mask), mnt + s - 1, **T32)
    rng = np.random.default_rng(4)
    toks = rng.integers(3, CFG.vocab_size, (b, s)).astype(np.int32)
    step0 = np.asarray([0, 3, 5], np.int32)
    ref, jc2 = jq.decode_step_spec(jp, CFG, jc, jnp.asarray(toks), jnp.asarray(step0),
                                   p, jnp.asarray(mask), **F32)
    ours, tc2 = tq.decode_step_spec(tp, CFG, tc, torch.tensor(toks), torch.tensor(step0),
                                    p, torch.tensor(mask), **T32)
    assert ours.shape == (b, s, CFG.vocab_size) and ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)
    assert tc2.k is tc.k                                  # written in place
    jk, jv = np.asarray(jc2.k), np.asarray(jc2.v)
    for r in range(b):
        sl = slice(p + step0[r], p + step0[r] + s)
        np.testing.assert_allclose(tc2.k[:, r, sl].numpy(), jk[:, r, sl], atol=1e-4)
        np.testing.assert_allclose(tc2.v[:, r, sl].numpy(), jv[:, r, sl], atol=1e-4)
        # nothing past the chunk was touched
        assert not tc2.k[:, r, p + step0[r] + s:].any()


def test_decode_step_spec_of_one_position_is_decode_step(dec):
    _, tp = dec
    ids, mask = _left_padded(5, 2, 8, [8, 4])
    tok = torch.tensor([17, 33], dtype=torch.int32)
    _, c1 = tq.prefill(tp, CFG, torch.tensor(ids), torch.tensor(mask), 4, **T32)
    _, c2 = tq.prefill(tp, CFG, torch.tensor(ids), torch.tensor(mask), 4, **T32)
    one, _ = tq.decode_step(tp, CFG, c1, tok, 0, 8, torch.tensor(mask), **T32)
    spec, _ = tq.decode_step_spec(tp, CFG, c2, tok[:, None],
                                  torch.zeros(2, dtype=torch.int32), 8,
                                  torch.tensor(mask), **T32)
    np.testing.assert_allclose(spec[:, 0].numpy(), one.numpy(), atol=1e-5)


# ---------------------------------------------------------------------------
# _spec_decode_loop: tokens and iteration counts equal to JAX's
# ---------------------------------------------------------------------------

def _loops(dec, ids, mask, mnt, gamma, cfg=CFG, row_valid=None, row_budget=None,
           eos_bias=0.0, draft_source=None):
    """(JAX tokens, JAX iterations, port tokens, port iterations) of the
    speculative loop after each package's own prefill."""
    jp, tp = dec
    p = ids.shape[1]
    jl, jc = jq.prefill(jp, cfg, jnp.asarray(ids), jnp.asarray(mask), mnt + gamma, **F32)
    tl, tc = tq.prefill(tp, cfg, torch.tensor(ids), torch.tensor(mask), mnt + gamma, **T32)
    jo, ji = jq._spec_decode_loop(
        jp, cfg, jl, jc, jnp.asarray(mask), mnt, gamma, jnp.float32,
        None if row_valid is None else jnp.asarray(row_valid), p, jnp.asarray(ids),
        row_budget=None if row_budget is None else jnp.asarray(row_budget, jnp.int32),
        eos_bias=eos_bias,
        draft_source=None if draft_source is None else jnp.asarray(draft_source))
    to, ti = tq._spec_decode_loop(
        tp, cfg, tl, tc, torch.tensor(mask), mnt, gamma, torch.float32,
        None if row_valid is None else torch.tensor(row_valid), p, torch.tensor(ids),
        row_budget=None if row_budget is None else torch.tensor(row_budget,
                                                                dtype=torch.int32),
        eos_bias=eos_bias,
        draft_source=None if draft_source is None else torch.tensor(draft_source))
    assert to.dtype == torch.int32 and isinstance(ti, int)
    return np.asarray(jo), int(ji), to.numpy(), ti


def _seq(dec, ids, mask, mnt, cfg=CFG, **kw):
    """The port's sequential greedy tokens."""
    kw = {k: (torch.tensor(v) if isinstance(v, np.ndarray) else v) for k, v in kw.items()}
    return tq.generate(dec[1], cfg, torch.tensor(ids), torch.tensor(mask),
                       max_new_tokens=mnt, do_sample=False, **T32, **kw).numpy()


@pytest.mark.parametrize("gamma", [1, 3, 7])
def test_spec_loop_matches_jax_and_sequential(dec, gamma):
    jo, ji, to, ti = _loops(dec, PROMPTS, MASK, 12, gamma)
    np.testing.assert_array_equal(to, jo)
    assert ti == ji and 1 <= ti <= 11
    np.testing.assert_array_equal(to, _seq(dec, PROMPTS, MASK, 12))
    assert len(np.unique(to)) > 4           # the scaled decoder gives a varied stream


@pytest.mark.parametrize("gamma", [1, 3, 7])
def test_spec_loop_with_left_padding(dec, gamma):
    ids, mask = _left_padded(11, 4, 10, [10, 4, 7, 1])
    jo, ji, to, ti = _loops(dec, ids, mask, 10, gamma)
    np.testing.assert_array_equal(to, jo)
    assert ti == ji
    np.testing.assert_array_equal(to, _seq(dec, ids, mask, 10))


@pytest.mark.parametrize("gamma", [1, 3, 7])
def test_spec_loop_honors_row_budgets(dec, gamma):
    budgets = np.asarray([3, 12, 1, 7], np.int32)
    jo, ji, to, ti = _loops(dec, PROMPTS, MASK, 12, gamma, row_budget=budgets)
    np.testing.assert_array_equal(to, jo)
    assert ti == ji
    np.testing.assert_array_equal(to, _seq(dec, PROMPTS, MASK, 12, row_budget=budgets))
    for r, n in enumerate(budgets):
        assert (to[r, n:] == CFG.pad_token_id).all()


def test_spec_loop_pad_rows_are_born_done(dec):
    rv = np.asarray([True, True, False, False])
    jo, ji, to, ti = _loops(dec, PROMPTS, MASK, 12, 5, row_valid=rv)
    np.testing.assert_array_equal(to, jo)
    assert ti == ji
    np.testing.assert_array_equal(to, _seq(dec, PROMPTS, MASK, 12, row_valid=rv))
    assert (to[2:] == CFG.pad_token_id).all()


@pytest.mark.parametrize("gamma", [1, 4])
def test_spec_loop_eos_stops_a_row_mid_chunk(dec, gamma):
    """Row 0's third greedy token becomes the stop id: it is emitted, and
    pads follow, also when it lands inside an accepted chunk."""
    base = _seq(dec, PROMPTS, MASK, 12)
    cfg = dataclasses.replace(CFG, eos_token_id=int(base[0, 2]),
                              eos_token_ids=(int(base[0, 2]),))
    jo, ji, to, ti = _loops(dec, PROMPTS, MASK, 12, gamma, cfg=cfg)
    np.testing.assert_array_equal(to, jo)
    assert ti == ji
    np.testing.assert_array_equal(to, _seq(dec, PROMPTS, MASK, 12, cfg=cfg))
    assert (to[0, 3:] == cfg.pad_token_id).all() and to[0, 2] == cfg.eos_token_id


def test_spec_loop_with_eos_bias(dec):
    """A bias large enough to end rows early, on both stop ids."""
    cfg = dataclasses.replace(CFG, eos_token_ids=(1, 5))
    jo, ji, to, ti = _loops(dec, PROMPTS, MASK, 12, 3, cfg=cfg, eos_bias=6.0)
    np.testing.assert_array_equal(to, jo)
    assert ti == ji
    seq = _seq(dec, PROMPTS, MASK, 12, cfg=cfg, eos_bias=6.0)
    np.testing.assert_array_equal(to, seq)
    assert not np.array_equal(seq, _seq(dec, PROMPTS, MASK, 12, cfg=cfg))


def test_spec_loop_one_token(dec):
    jo, ji, to, ti = _loops(dec, PROMPTS, MASK, 1, 3)
    np.testing.assert_array_equal(to, jo)
    assert ti == ji == 0 and to.shape == (4, 1)


@pytest.mark.parametrize("gamma", [1, 3, 7])
def test_spec_loop_with_right_drafts_takes_the_fewest_iterations(dec, gamma):
    """`draft_source` = the sequential output: every draft is right, every
    iteration emits gamma + 1 tokens."""
    mnt = 12
    seq = _seq(dec, PROMPTS, MASK, mnt)
    src = np.concatenate([seq, np.zeros((4, gamma), np.int32)], axis=1)
    jo, ji, to, ti = _loops(dec, PROMPTS, MASK, mnt, gamma, draft_source=src)
    np.testing.assert_array_equal(to, jo)
    np.testing.assert_array_equal(to, seq)
    assert ti == ji == math.ceil((mnt - 1) / (gamma + 1))


def test_spec_loop_with_wrong_drafts_emits_one_token_an_iteration(dec):
    mnt, gamma = 12, 3
    seq = _seq(dec, PROMPTS, MASK, mnt)
    # a vocabulary id the stream never holds, so no draft can match
    wrong = next(v for v in range(10, CFG.vocab_size) if v not in seq)
    src = np.full((4, mnt + gamma), wrong, np.int32)
    jo, ji, to, ti = _loops(dec, PROMPTS, MASK, mnt, gamma, draft_source=src)
    np.testing.assert_array_equal(to, jo)
    np.testing.assert_array_equal(to, seq)
    assert ti == ji == mnt - 1


# ---------------------------------------------------------------------------
# generate / generate_packed
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gamma", [1, 3, 7])
def test_generate_spec_matches_jax_and_sequential(dec, gamma):
    jp, tp = dec
    ids, mask = _left_padded(21, 4, 16, [16, 9, 12, 3])
    rv = np.asarray([True, True, True, False])
    bud = np.asarray([10, 4, 10, 10], np.int32)
    ref = jq.generate(jp, CFG, jnp.asarray(ids), jnp.asarray(mask), jax.random.PRNGKey(0),
                      max_new_tokens=10, do_sample=False, row_valid=jnp.asarray(rv),
                      row_budget=jnp.asarray(bud), spec_gamma=gamma, **F32)
    stats = {}
    ours = tq.generate(tp, CFG, torch.tensor(ids), torch.tensor(mask), max_new_tokens=10,
                       do_sample=False, row_valid=torch.tensor(rv),
                       row_budget=torch.tensor(bud), spec_gamma=gamma, loop_stats=stats,
                       **T32)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(
        ours.numpy(), _seq(dec, ids, mask, 10, row_valid=rv, row_budget=bud))
    assert stats["calls"] == 1 and 1 <= stats["iters"] <= 9


@pytest.mark.parametrize("gamma", [1, 4])
def test_generate_spec_with_prefix_kv(dec, gamma):
    """Over a cached prefix the history is the suffix ids and the mask is
    [prefix mask | suffix mask]; tokens equal JAX's and the sequential
    loop's."""
    jp, tp = dec
    rng = np.random.default_rng(7)
    b, pl = 3, 8
    ctx = rng.integers(10, CFG.vocab_size - 10, (b, pl)).astype(np.int32)
    ctx_mask = np.ones((b, pl), np.int32)
    ctx_mask[1, 5:] = 0
    kv = jq.compute_prefix_kv(jp, CFG, jnp.asarray(ctx), jnp.asarray(ctx_mask), **F32)
    plen = ctx_mask.sum(-1).astype(np.int32)
    sids, smask = _left_padded(8, b, 6, [6, 3, 5])
    ref = jq.generate(jp, CFG, jnp.asarray(sids), jnp.asarray(smask),
                      jax.random.PRNGKey(0), max_new_tokens=10, do_sample=False,
                      prefix_kv=kv, prefix_len=jnp.asarray(plen), spec_gamma=gamma, **F32)
    tkv = prefix_kv_from_jax(jax.device_get(kv))
    kw = dict(prefix_kv=tkv, prefix_len=torch.tensor(plen))
    ours = tq.generate(tp, CFG, torch.tensor(sids), torch.tensor(smask),
                       max_new_tokens=10, do_sample=False, spec_gamma=gamma, **kw, **T32)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(ours.numpy(), _seq(dec, sids, smask, 10, **kw))


@pytest.mark.parametrize("gamma", [1, 3])
def test_generate_packed_spec_matches_jax_and_sequential(dec, gamma):
    jp, tp = dec
    ids, mask = _left_padded(2, 3, 24, [24, 5, 17])
    args = _pack(ids, mask, 64, cap=4)
    bud = np.asarray([8, 8, 3, 8], np.int32)
    ref = jq.generate_packed(jp, CFG, *map(jnp.asarray, args[:6]), jax.random.PRNGKey(0),
                             max_new_tokens=8, max_seg_len=24, do_sample=False,
                             row_valid=jnp.asarray(args[6]), row_budget=jnp.asarray(bud),
                             spec_gamma=gamma, **F32)
    targs = [torch.tensor(a) for a in args[:6]]
    kw = dict(max_new_tokens=8, do_sample=False, row_valid=torch.tensor(args[6]),
              row_budget=torch.tensor(bud), **T32)
    ours = tq.generate_packed(tp, CFG, *targs, spec_gamma=gamma, **kw)
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(ours.numpy(),
                                  tq.generate_packed(tp, CFG, *targs, **kw).numpy())


def test_spec_gamma_is_ignored_when_sampling(dec):
    """Sampling keeps the one-token loop: same generator state, same
    tokens."""
    _, tp = dec

    def run(gamma):
        g = torch.Generator().manual_seed(5)
        return tq.generate(tp, CFG, torch.tensor(PROMPTS), torch.tensor(MASK),
                           generator=g, max_new_tokens=6, do_sample=True,
                           spec_gamma=gamma, **T32).numpy()

    np.testing.assert_array_equal(run(4), run(0))


# ---------------------------------------------------------------------------
# the engine under SPEC_DECODE
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(0)
    docs = [" ".join(f"w{rng.integers(0, 300)}" for _ in range(rng.integers(14, 24)))
            for _ in range(40)]
    return docs, rng.standard_normal((40, 64)).astype(np.float32)


def _pair(corpus, **over):
    docs, emb = corpus
    je = jax_engine.RagEngine(jax_settings(**over), docs, emb)
    je.dec_params = _scaled(je.dec_params, 8.0)
    te = port_engine.RagEngine(tiny_settings(**over), docs, emb, device="cpu")
    te.enc_params = params_from_jax(jax.device_get(je.enc_params))
    te.dec_params = params_from_jax(jax.device_get(je.dec_params))
    return je, te


@pytest.mark.parametrize("packed", [False, True], ids=["padded", "packed"])
def test_engine_spec_parity(corpus, packed):
    """SPEC_DECODE=3 through the engine: the JAX engine's answers, and the
    port's own sequential answers, on the route named."""
    je, te = _pair(corpus, packed_prefill=packed, spec_gamma=3)
    assert te.spec_gamma == je.spec_gamma == 3
    ks = [2] * 4
    assert te.stage_prompts(te.prepare(QUERIES, ks))[0] == ("packed" if packed
                                                            else "padded")
    spec = te.process(QUERIES, ks)
    assert spec == je.process(QUERIES, ks)
    iters = te.loop_stats["iters"]
    assert te.loop_stats["calls"] == 1 and 1 <= iters <= 5
    te.spec_gamma = 0
    assert te.process(QUERIES, ks) == spec
    assert te.loop_stats["iters"] - iters == 5     # the sequential loop's steps


def test_engine_spec_parity_with_budgets_and_prefix_cache(corpus):
    je, te = _pair(corpus, spec_gamma=2, prefix_cache=True, prefix_pool_len=128)
    ks, budgets = [2] * 4, [2, 6, 1, 4]
    for _ in range(2):                      # misses, then hits
        spec = te.process(QUERIES, ks, budgets)
        assert spec == je.process(QUERIES, ks, budgets)
    assert te.prefix_cache.stats()["hits"] >= 4
    te.spec_gamma = 0
    assert te.process(QUERIES, ks, budgets) == spec


def test_engine_spec_ignored_when_sampling(corpus):
    docs, emb = corpus
    te = port_engine.RagEngine(tiny_settings(spec_gamma=4, do_sample=True), docs, emb,
                               device="cpu")
    assert te.spec_gamma == 0
    assert all(isinstance(r["result"], str) for r in te.process(QUERIES[:2], [2, 2]))
