"""PyTorch port: the continuous decode pool (DECODE_MODE=continuous) on the
CPU at the tiny preset, f32, greedy.

Device level: `_insert_rows` and `decode_chunk` against the JAX functions on
the same seeded pool state, step by step (an aligned and a wrapped cursor, a
mid-flight insert, per-row budgets): the bitmap, the per-slot scalars, the
cursor and the token blocks equal, the K/V at attendable columns within 1e-5
(f32 sums in two orders). Engine level: the pool's answers equal the port's
fixed path's and the JAX pool's on shared weights, under slot starvation, a
pool smaller than a batch, a window overflow, over the prefix cache, with
packed staging, and through the batch processor and /stats.

Every test runs under a SIGALRM time limit of its own, so a hang of the
pool's thread fails that test and not the run."""

import json
import signal
import time
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rag_serving_system_tpu import config as jax_config  # noqa: E402
from rag_serving_system_tpu.core import decode_pool as jax_pool  # noqa: E402
from rag_serving_system_tpu.core import engine as jax_engine  # noqa: E402
from rag_serving_system_tpu.models import qwen2 as jq  # noqa: E402
from rag_serving_system_tpu.models.configs import QWEN2_TINY  # noqa: E402
from rag_serving_system_tpu.models.weights import init_decoder_params  # noqa: E402
from rag_serving_system_torch import config as port_config  # noqa: E402
from rag_serving_system_torch.core import decode_pool as port_pool  # noqa: E402
from rag_serving_system_torch.core import engine as port_engine  # noqa: E402
from rag_serving_system_torch.core.batch_processor import BatchProcessor  # noqa: E402
from rag_serving_system_torch.core.request_queue import make_queue  # noqa: E402
from rag_serving_system_torch.models import qwen2 as tq  # noqa: E402
from rag_serving_system_torch.models.weights import params_from_jax  # noqa: E402

CFG = QWEN2_TINY
TIME_LIMIT_S = 420


@pytest.fixture(autouse=True)
def time_limit():
    """Each test's own limit: SIGALRM raises in the test's (main) thread."""
    def expired(signum, frame):
        raise TimeoutError(f"test exceeded its {TIME_LIMIT_S} s limit")

    old = signal.signal(signal.SIGALRM, expired)
    signal.alarm(TIME_LIMIT_S)
    yield
    signal.alarm(0)
    signal.signal(signal.SIGALRM, old)


def _scaled(tree, f):
    return {k: (_scaled(v, f) if isinstance(v, dict) else
                v * f if k in ("embed", "qkv_w", "o_w", "gu_w", "down_w") else v)
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def dec():
    jp = _scaled(init_decoder_params(CFG, dtype=jnp.float32), 8.0)
    return jp, params_from_jax(jax.device_get(jp))


def _left_pad(seed, p, lens):
    rng = np.random.default_rng(seed)
    ids = np.zeros((len(lens), p), np.int32)
    mask = np.zeros((len(lens), p), np.int32)
    for i, n in enumerate(lens):
        ids[i, p - n:] = rng.integers(10, CFG.vocab_size, n)
        mask[i, p - n:] = 1
    return ids, mask


# ---------------------------------------------------------------------------
# device level: the same pool state through both packages
# ---------------------------------------------------------------------------

class _JaxPool:
    def __init__(self, params, slots, window, cursor):
        shape = (CFG.num_layers, slots, window, CFG.num_kv_heads, CFG.head_dim)
        self.params, self.slots = params, slots
        self.state = [jnp.zeros(shape, jnp.float32), jnp.zeros(shape, jnp.float32),
                      jnp.zeros((slots, window), bool),
                      jnp.full((slots,), CFG.pad_token_id, jnp.int32),
                      jnp.zeros((slots,), jnp.int32), jnp.zeros((slots,), bool),
                      jnp.zeros((slots,), jnp.int32)]
        self.cursor = jnp.int32(cursor)

    def insert(self, ids, mask, rows, slots, budgets, prefix=None):
        b = ids.shape[0]
        kw = {} if prefix is None else dict(prefix_kv=prefix[0],
                                            prefix_len=jnp.asarray(prefix[1], jnp.int32))
        tok0, k, v, cmask = jq.prefill_for_pool(
            self.params, CFG, jnp.asarray(ids), jnp.asarray(mask), jax.random.PRNGKey(0),
            do_sample=False, dtype=jnp.float32, row_valid=jnp.ones(b, bool), **kw)
        slot_ids = np.full((b,), self.slots, np.int32)      # S: dropped
        slot_ids[rows] = slots
        row_valid = np.zeros((b,), bool)
        row_valid[rows] = True
        self.state = list(jax_pool._insert_rows(
            *self.state, k, v, cmask, tok0, jnp.asarray(slot_ids), self.cursor,
            jnp.asarray(row_valid), jnp.asarray(budgets, jnp.int32), jq.eos_id_set(CFG)))
        return np.asarray(tok0)

    def chunk(self, n):
        *self.state, self.cursor, toks = jq.decode_chunk(
            self.params, CFG, *self.state, self.cursor, jax.random.PRNGKey(0), chunk=n,
            do_sample=False, dtype=jnp.float32)
        return np.asarray(toks)

    def numpy(self):
        return [np.asarray(x) for x in self.state] + [int(self.cursor)]


class _TorchPool:
    def __init__(self, params, slots, window, cursor):
        shape = (CFG.num_layers, slots, window, CFG.num_kv_heads, CFG.head_dim)
        self.params = params
        self.state = [torch.zeros(shape), torch.zeros(shape),
                      torch.zeros((slots, window), dtype=torch.bool),
                      torch.full((slots,), CFG.pad_token_id, dtype=torch.int32),
                      torch.zeros((slots,), dtype=torch.int32),
                      torch.zeros((slots,), dtype=torch.bool),
                      torch.zeros((slots,), dtype=torch.int32)]
        self.cursor = cursor

    def insert(self, ids, mask, rows, slots, budgets, prefix=None):
        b = ids.shape[0]
        kw = {} if prefix is None else dict(
            prefix_kv=torch.from_numpy(np.array(prefix[0])),
            prefix_len=torch.tensor(prefix[1], dtype=torch.int32))
        tok0, k, v, cmask = tq.prefill_for_pool(
            self.params, CFG, torch.tensor(ids), torch.tensor(mask), None,
            do_sample=False, dtype=torch.float32, row_valid=torch.ones(b, dtype=torch.bool),
            **kw)
        port_pool._insert_rows(*self.state, k, v, cmask, tok0, torch.tensor(rows),
                               torch.tensor(slots), self.cursor,
                               torch.tensor(budgets, dtype=torch.int32), tq.eos_id_set(CFG))
        return tok0.numpy()

    def chunk(self, n):
        state = self.state
        *out, self.cursor, toks = tq.decode_chunk(
            self.params, CFG, *state, self.cursor, None, chunk=n, do_sample=False,
            dtype=torch.float32)
        assert all(a is b for a, b in zip(out, state))      # updated in place
        return toks.numpy()

    def numpy(self):
        return [x.numpy() for x in self.state] + [self.cursor]


def _same_state(ours, ref):
    """The whole pool state: bitmap, scalars and cursor equal; K/V within
    1e-5 at every attendable column (the port leaves a previous tenant's K/V
    at unattendable columns where the JAX insert writes zeros)."""
    k, v, valid, last, pos, active, rem, cursor = ours.numpy()
    rk, rv, rvalid, rlast, rpos, ractive, rrem, rcursor = ref.numpy()
    np.testing.assert_array_equal(valid, rvalid)
    for name, a, b in (("last_tok", last, rlast), ("next_pos", pos, rpos),
                       ("active", active, ractive), ("remaining", rem, rrem)):
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert cursor == rcursor
    for a, b in ((k, rk), (v, rv)):
        np.testing.assert_allclose(a[:, valid], b[:, rvalid], atol=1e-5, rtol=0)


def _fixed_tokens(tp, ids, mask, mnt, budgets=None):
    kw = {} if budgets is None else dict(row_budget=torch.tensor(budgets, dtype=torch.int32))
    out = tq.generate(tp, CFG, torch.tensor(ids), torch.tensor(mask), None,
                      max_new_tokens=mnt, do_sample=False, dtype=torch.float32,
                      row_valid=torch.ones(len(ids), dtype=torch.bool), **kw).numpy()
    return [[int(t) for t in row if t != CFG.pad_token_id] for row in out]


def _strip(tok0, col):
    return [int(t) for t in [tok0, *col] if t != CFG.pad_token_id]


@pytest.mark.parametrize("window,cursor,slots_for_rows", [
    (128, 64, [0, 1, 2, 3]),      # aligned: the ring layout is the fixed cache's
    (96, 0, [2, 0, 3, 1]),        # wrapped: the prompt fills the ring's tail
    (96, 90, [3, 2, 1, 0]),       # the prompt itself wraps
])
def test_insert_and_chunks_equal_jax_and_the_fixed_path(dec, window, cursor, slots_for_rows):
    jp, tp = dec
    p, mnt = 64, 6
    ids, mask = _left_pad(1, p, [37, 12, 55, 23])
    ours, ref = _TorchPool(tp, 4, window, cursor), _JaxPool(jp, 4, window, cursor)
    rows, budgets = [0, 1, 2, 3], [mnt] * 4
    tok0 = ours.insert(ids, mask, rows, slots_for_rows, budgets)
    np.testing.assert_array_equal(tok0, ref.insert(ids, mask, rows, slots_for_rows, budgets))
    _same_state(ours, ref)
    blocks = []
    for n in (3, 3):
        blocks.append(ours.chunk(n))
        np.testing.assert_array_equal(blocks[-1], ref.chunk(n))
        _same_state(ours, ref)
    toks = np.concatenate(blocks)
    want = _fixed_tokens(tp, ids, mask, mnt)
    for r, s in zip(rows, slots_for_rows):
        assert _strip(tok0[r], toks[:, s])[:mnt] == want[r], (r, s)
    assert not ours.numpy()[5].any()                 # every slot ran out of budget


def test_mid_flight_insert_budgets_and_a_partial_wave_equal_jax(dec):
    """Rows 0 and 2 of a batch enter slots 1 and 3 (the others wait), decode
    two steps, then row 1 joins mid-flight in slot 0 with a budget of 3 and
    row 3 with a budget of 1 (born inactive): both packages agree at every
    step, and each row decodes as it does alone on the fixed path."""
    jp, tp = dec
    p, mnt = 64, 6
    ids, mask = _left_pad(2, p, [40, 17, 29, 8])
    budgets = [mnt, 3, mnt, 1]
    ours, ref = _TorchPool(tp, 4, 160, p), _JaxPool(jp, 4, 160, p)
    tok0 = ours.insert(ids, mask, [0, 2], [1, 3], budgets)
    np.testing.assert_array_equal(tok0, ref.insert(ids, mask, [0, 2], [1, 3], budgets))
    _same_state(ours, ref)
    t1 = ours.chunk(2)
    np.testing.assert_array_equal(t1, ref.chunk(2))
    ours.insert(ids, mask, [1, 3], [0, 2], budgets)
    ref.insert(ids, mask, [1, 3], [0, 2], budgets)
    _same_state(ours, ref)
    state = ours.numpy()
    assert state[5].tolist() == [True, True, False, True]     # budget 1: never active
    assert state[4].tolist() == [17, 42, 8, 31]               # real tokens + steps taken
    t2 = ours.chunk(mnt - 1)
    np.testing.assert_array_equal(t2, ref.chunk(mnt - 1))
    _same_state(ours, ref)
    want = _fixed_tokens(tp, ids, mask, mnt, budgets)
    got = {0: _strip(tok0[0], np.concatenate([t1[:, 1], t2[:, 1]])),
           2: _strip(tok0[2], np.concatenate([t1[:, 3], t2[:, 3]])),
           1: _strip(tok0[1], t2[:, 0]), 3: _strip(tok0[3], t2[:, 2])}
    for r in range(4):
        assert got[r][:budgets[r]] == want[r], r
    assert len(got[1]) == 3 and len(got[3]) == 1


def test_pool_prefill_over_a_prefix_returns_the_combined_mask_like_jax(dec):
    """`prefill_for_pool` over cached prefix K/V: tok0, the (L, B, PL + P)
    K/V at valid positions and the [prefix mask | suffix mask] equal the JAX
    function's; inserted, the slot's `next_pos` counts the prefix too."""
    jp, tp = dec
    pl, p, pre_lens = 16, 12, [13, 0, 16]
    rng = np.random.default_rng(7)
    pids = rng.integers(3, CFG.vocab_size, (3, pl)).astype(np.int32)
    pmask = (np.arange(pl)[None, :] < np.asarray(pre_lens)[:, None]).astype(np.int32)
    pmask[1, 0] = 1
    jkv = jq.compute_prefix_kv(jp, CFG, jnp.asarray(pids), jnp.asarray(pmask),
                               dtype=jnp.float32)
    ids, mask = _left_pad(8, p, [5, 12, 9])
    ours, ref = _TorchPool(tp, 4, 64, 40), _JaxPool(jp, 4, 64, 40)
    tok0 = ours.insert(ids, mask, [0, 1, 2], [2, 0, 1], [4] * 3, prefix=(jkv, pre_lens))
    np.testing.assert_array_equal(
        tok0, ref.insert(ids, mask, [0, 1, 2], [2, 0, 1], [4] * 3, prefix=(jkv, pre_lens)))
    _same_state(ours, ref)
    assert ours.numpy()[4].tolist() == [12, 25, 18, 0]          # prefix + suffix tokens
    np.testing.assert_array_equal(ours.chunk(3), ref.chunk(3))
    _same_state(ours, ref)


def test_packed_pool_prefill_equals_jax(dec):
    from test_torch_models import _pack

    jp, tp = dec
    ids, mask = _left_pad(4, 24, [24, 6, 15])
    args = _pack(ids, mask, 64, cap=4)
    rt, rk, rv, rm = jq.prefill_packed_for_pool(
        jp, CFG, *map(jnp.asarray, args[:6]), jax.random.PRNGKey(0), max_seg_len=24,
        do_sample=False, dtype=jnp.float32, row_valid=jnp.asarray(args[6]))
    t, k, v, m = tq.prefill_packed_for_pool(
        tp, CFG, *map(torch.tensor, args[:6]), None, do_sample=False, dtype=torch.float32,
        row_valid=torch.tensor(args[6]))
    np.testing.assert_array_equal(t.numpy(), np.asarray(rt))
    np.testing.assert_array_equal(m.numpy(), np.asarray(rm))
    assert k.shape == np.asarray(rk).shape == (CFG.num_layers, 4, 24, CFG.num_kv_heads,
                                               CFG.head_dim)
    real = m.numpy() > 0
    np.testing.assert_allclose(k.numpy()[:, real], np.asarray(rk)[:, real], atol=1e-5, rtol=0)
    np.testing.assert_allclose(v.numpy()[:, real], np.asarray(rv)[:, real], atol=1e-5, rtol=0)
    assert t.numpy()[3] == CFG.pad_token_id                      # the pad row


# ---------------------------------------------------------------------------
# engine level: the host orchestrator
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def corpus():
    docs = [f"document {i} states fact number {i} about subject {i} "
            f"{'with extra detail ' * (i % 7)}" for i in range(24)]
    return docs, np.random.default_rng(0).standard_normal((24, 64)).astype(np.float32)


QS = ["document 3 states fact number 3",
      "document 11 states fact number 11 about subject 11",
      "what does document 7 say?",
      "tell me about subject 19"]


def _settings(cls, mode, **kw):
    base = dict(model_preset="tiny", batch_buckets=[4], max_batch_size=4,
                encode_len_buckets=[16], prompt_len_buckets=[64, 128], max_new_tokens=4,
                do_sample=False, prefix_cache=False, packed_prefill=False, decode_mode=mode,
                dtype="float32", query_cache_size=0, max_wait_time=0.05,
                embed_model_name="e5", llm_model_name="qwen")
    base.update(kw)
    return cls(**base)


@pytest.fixture(scope="module")
def weights():
    """One set of weights for every engine of this module: the JAX init, the
    decoder's matrices scaled by 8."""
    docs = ["a"]
    je = jax_engine.RagEngine(_settings(jax_config.Settings, "fixed"), docs,
                              np.ones((1, 64), np.float32))
    enc = jax.device_get(je.enc_params)
    dec = jax.device_get(_scaled(je.dec_params, 8.0))
    return enc, dec


def _engine(corpus, weights, mode, **kw):
    docs, emb = corpus
    te = port_engine.RagEngine(_settings(port_config.Settings, mode, **kw), docs, emb,
                               device="cpu")
    te.enc_params, te.dec_params = params_from_jax(weights[0]), params_from_jax(weights[1])
    return te


def _run_pool(eng, qs, ks, timeout=120.0):
    pool = eng.decode_pool
    if not pool._running:
        pool.start()
    results = {}
    rids = [f"r{i}" for i in range(len(qs))]
    pool.submit(rids, eng.prepare(qs, ks), lambda rid, res: results.__setitem__(rid, res))
    assert pool.wait_idle(timeout)
    assert set(results) == set(rids), (set(results), set(rids))
    return [results[r] for r in rids]


def test_pool_settings_and_sizes_follow_jax(corpus):
    docs, emb = corpus
    for kw in (dict(), dict(decode_slots=3, decode_window=256, decode_chunk=2),
               dict(max_new_tokens=70)):
        te = port_engine.RagEngine(_settings(port_config.Settings, "continuous", **kw),
                                   docs, emb, device="cpu")
        je = jax_engine.RagEngine(_settings(jax_config.Settings, "continuous", **kw),
                                  docs, emb)
        ours, ref = te.decode_pool, je.decode_pool
        assert (ours.slots, ours.window, ours.chunk) == (ref.slots, ref.window, ref.chunk)
        assert ours.pool_k.shape == ref.pool_k.shape
        assert sorted(ours.stats()) == sorted(ref.stats())
    assert (ours.slots, ours.window) == (8, 256)           # 2 x the bucket; ceil(198 / 128)
    with pytest.raises(ValueError, match="DECODE_WINDOW"):
        port_engine.RagEngine(_settings(port_config.Settings, "continuous", decode_window=2),
                              docs, emb, device="cpu")
    fixed = port_engine.RagEngine(_settings(port_config.Settings, "fixed"), docs, emb,
                                  device="cpu")
    assert fixed.decode_pool is None


def test_pool_end_to_end_matches_fixed_and_the_jax_pool(corpus, weights):
    docs, emb = corpus
    eng_c = _engine(corpus, weights, "continuous")
    eng_f = _engine(corpus, weights, "fixed")
    je = jax_engine.RagEngine(_settings(jax_config.Settings, "continuous"), docs, emb)
    je.dec_params = _scaled(je.dec_params, 8.0)
    for n in (4, 2):
        got = _run_pool(eng_c, QS[:n], [2] * n)
        assert got == eng_f.process(QS[:n], [2] * n), n
        assert got == _run_pool(je, QS[:n], [2] * n, timeout=300.0), n
        assert all(r["result"] for r in got)
    st, ref = eng_c.decode_pool.stats(), je.decode_pool.stats()
    for key in ("inserted", "completed", "tokens_emitted", "tokens_prefill", "free"):
        assert st[key] == ref[key], key
    assert st["inserted"] == st["completed"] == 6 and st["free"] == st["slots"] == 8
    assert 0 < st["occupancy"] <= 1
    eng_c.decode_pool.stop()
    je.decode_pool.stop()


def test_pool_slot_starvation_and_reuse(corpus, weights):
    """More requests in flight than slots: the head waits for completions,
    slots recycle, and every request still gets the fixed path's answer."""
    eng_c = _engine(corpus, weights, "continuous", decode_slots=4)
    eng_f = _engine(corpus, weights, "fixed")
    pool = eng_c.decode_pool
    assert pool.slots == 4
    pool.start()
    results, rids = {}, []
    for wave in range(3):
        qs = [QS[(wave + i) % 4] for i in range(4)]
        ids = [f"w{wave}_{i}" for i in range(4)]
        rids.extend(zip(ids, qs))
        pool.submit(ids, eng_c.prepare(qs, [2] * 4),
                    lambda rid, res: results.__setitem__(rid, res))
    assert pool.wait_idle(180.0)
    assert pool.completed == pool.inserted == 12
    want = dict(zip(QS, eng_f.process(QS, [2] * 4)))
    for rid, q in rids:
        assert results[rid] == want[q], rid
    pool.stop()


def test_pool_wave_insert_smaller_than_batch(corpus, weights):
    """A pool SMALLER than the batch bucket: a 4-row batch decodes on 2 slots
    in waves, and a second submission queued behind it completes too."""
    eng_c = _engine(corpus, weights, "continuous", decode_slots=2, decode_chunk=3)
    eng_f = _engine(corpus, weights, "fixed")
    pool = eng_c.decode_pool
    assert pool.slots == 2
    pool.start()
    results = {}
    pool.submit([f"a{i}" for i in range(4)], eng_c.prepare(QS, [2] * 4),
                lambda rid, res: results.__setitem__(rid, res))
    pool.submit(["b0", "b1"], eng_c.prepare(QS[:2], [2] * 2),
                lambda rid, res: results.__setitem__(rid, res))
    assert pool.wait_idle(180.0)
    assert [results[f"a{i}"] for i in range(4)] == eng_f.process(QS, [2] * 4)
    assert [results[f"b{i}"] for i in range(2)] == eng_f.process(QS[:2], [2] * 2)
    assert pool.inserted == 6 and pool.completed == 6 and len(pool._free) == 2
    pool.stop()


def test_pool_request_budgets_match_fixed(corpus, weights):
    eng_c = _engine(corpus, weights, "continuous")
    eng_f = _engine(corpus, weights, "fixed")
    budgets = [1, 3, None, 2]
    pool = eng_c.decode_pool
    pool.start()
    results = {}
    pool.submit(list("abcd"), eng_c.prepare(QS, [2] * 4, budgets),
                lambda rid, res: results.__setitem__(rid, res))
    assert pool.wait_idle(120.0)
    want = eng_f.process(QS, [2] * 4, budgets)
    assert [results[r] for r in "abcd"] == want
    assert [len(r["result"].split()) for r in want] == [1, 3, 4, 2]
    pool.stop()


def test_pool_window_overflow_falls_back_to_fixed(corpus, weights):
    """A staged bucket the ring cannot hold (T + budget > window) runs the
    fixed path inside the pool's thread and still delivers the answer."""
    eng_c = _engine(corpus, weights, "continuous", decode_window=64)
    eng_f = _engine(corpus, weights, "fixed")
    long_q = "filler word " * 40 + "what does document 5 say?"
    got = _run_pool(eng_c, [long_q], [2])
    assert got == eng_f.process([long_q], [2])
    pool = eng_c.decode_pool
    assert pool.inserted == 0 and pool.completed == 1 and pool.steps == 0
    short = _run_pool(eng_c, QS[:1], [2])          # a 64-token bucket does not fit either
    assert short == eng_f.process(QS[:1], [2])
    pool.stop()


def test_pool_with_prefix_cache_matches_fixed(corpus, weights):
    """Prefix-staged batches insert [prefix | suffix] K/V rows: the miss
    route, then the hit route, with the fixed path's answers and counters."""
    kw = dict(prefix_cache=True, prefix_pool_len=128)
    eng_c = _engine(corpus, weights, "continuous", decode_window=256, **kw)
    eng_f = _engine(corpus, weights, "fixed", **kw)
    for _ in range(2):
        assert _run_pool(eng_c, QS, [2] * 4) == eng_f.process(QS, [2] * 4)
    st, ref = eng_c.prefix_cache.stats(), eng_f.prefix_cache.stats()
    assert (st["hits"], st["misses"], st["entries"]) == (
        ref["hits"], ref["misses"], ref["entries"])
    assert st["hits"] >= 4
    eng_c.decode_pool.stop()


def test_pool_packed_staging_matches_fixed(corpus, weights, monkeypatch):
    monkeypatch.setattr(port_engine, "PACKED_MARGIN", 10.0)    # force the packed layout
    eng_c = _engine(corpus, weights, "continuous", packed_prefill=True)
    eng_f = _engine(corpus, weights, "fixed", packed_prefill=False)
    prompts = eng_c.prepare(QS[:3], [2] * 3)
    assert eng_c.stage_prompts(prompts)[0] == "packed"
    assert _run_pool(eng_c, QS[:3], [2] * 3) == eng_f.process(QS[:3], [2] * 3)
    eng_c.decode_pool.stop()


def test_pool_under_int8_w8a8_matches_fixed(corpus, weights):
    """Both features of the slice together: a quantized decoder with W8A8
    prefill feeding the pool, over the prefix cache."""
    kw = dict(quant_weights="int8", quant_act="int8", prefix_cache=True, prefix_pool_len=128)
    eng_c = _engine(corpus, weights, "continuous", **kw)
    eng_f = _engine(corpus, weights, "fixed", **kw)
    from rag_serving_system_torch.ops.quant import quantize_decoder_params
    eng_c.dec_params = eng_f.dec_params = quantize_decoder_params(eng_f.dec_params)
    assert eng_c.act_quant
    assert _run_pool(eng_c, QS, [2] * 4) == eng_f.process(QS, [2] * 4)
    eng_c.decode_pool.stop()


def test_pool_fails_a_batch_whose_prefill_raises_and_keeps_serving(corpus, weights):
    eng_c = _engine(corpus, weights, "continuous")
    real = eng_c.prefill_rows
    calls = []

    def flaky(staged, generator):
        calls.append(1)
        if len(calls) == 1:
            raise RuntimeError("device lost")
        return real(staged, generator)

    eng_c.prefill_rows = flaky
    bad = _run_pool(eng_c, QS[:2], [2] * 2)
    assert bad == [{"error": "device lost", "status": "failed"}] * 2
    good = _run_pool(eng_c, QS[:2], [2] * 2)
    assert all(isinstance(r.get("result"), str) for r in good)
    eng_c.decode_pool.stop()


def test_warmup_runs_one_batch_through_the_pool(corpus, weights):
    eng_c = _engine(corpus, weights, "continuous")
    eng_c.warmup()
    pool = eng_c.decode_pool
    assert pool._running and pool.inserted == pool.completed == 4
    eng_c.prefill_rows = lambda staged, generator: 1 / 0
    with pytest.raises(RuntimeError, match="decode-pool warmup batch incomplete"):
        eng_c.warmup()
    pool.stop()


def _http(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return json.loads(r.read())


@pytest.mark.parametrize("env", [
    dict(DECODE_MODE="continuous"),
    dict(DECODE_MODE="continuous", QUANT_WEIGHTS="int8", QUANT_ACT="int8"),
    dict(DECODE_MODE="continuous", QUANT_WEIGHTS="int4", PREFIX_CACHE="0"),
], ids=["continuous", "continuous_int8_w8a8", "continuous_int4_cold"])
def test_main_starts_and_answers_from_the_environment(corpus, tmp_path, monkeypatch, env):
    """`main.build_app` with the settings read from the environment, as
    `python -m rag_serving_system_torch.main` reads them, on the CPU: it
    warms up (one batch through the pool), answers POST /rag, and `stop`
    drains the pool."""
    pytest.importorskip("aiohttp")
    from rag_serving_system_torch.api.endpoints import ServerThread
    from rag_serving_system_torch.main import build_app

    docs, emb = corpus
    (tmp_path / "docs.json").write_text(json.dumps(docs))
    np.save(tmp_path / "emb.npy", emb)
    for var, value in dict(
            env, TORCH_DEVICE="cpu", MODEL_PRESET="tiny", COMPUTE_DTYPE="float32",
            BATCH_BUCKETS="1,4", MAX_BATCH_SIZE="4", ENCODE_LEN_BUCKETS="16,32",
            PROMPT_LEN_BUCKETS="64,128", MAX_NEW_TOKENS="4", MAX_WAIT_TIME="0.05",
            PREFIX_POOL_LEN="48", DOCUMENT_TEXT_FILE=str(tmp_path / "docs.json"),
            DOCUMENT_EMBEDDINGS_FILE=str(tmp_path / "emb.npy")).items():
        monkeypatch.setenv(var, value)
    app, proc, engine, settings = build_app()
    assert settings.decode_mode == "continuous" and engine.decode_pool._running
    assert engine.act_quant == (env.get("QUANT_ACT") == "int8")
    server = ServerThread(app).start()
    try:
        req = urllib.request.Request(
            server.url + "/rag", data=json.dumps({"query": QS[0], "k": 2}).encode(),
            method="POST", headers={"content-type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as r:
            rid = json.loads(r.read())["request_id"]
        deadline = time.time() + 60
        res = {"status": "processing"}
        while res["status"] != "complete" and time.time() < deadline:
            time.sleep(0.05)
            res = _http(server.url + f"/rag/result/{rid}")
        assert res["status"] == "complete" and isinstance(res["result"]["result"], str)
        assert _http(server.url + "/stats")["decode_pool"]["completed"] == 5   # 4 warm-up + 1
    finally:
        server.stop()
        proc.stop(drain_timeout=5.0)
        proc.join(timeout=10)
    assert not engine.decode_pool._thread.is_alive()


def test_pool_through_batch_processor_and_stats(corpus, weights):
    """The processor starts the pool, stages each batch and submits it;
    results land in the queue per request; `stop` drains the pool; /stats
    shows `decode_pool`."""
    pytest.importorskip("aiohttp")
    from rag_serving_system_torch.api.endpoints import ServerThread, create_api

    eng = _engine(corpus, weights, "continuous")
    eng_f = _engine(corpus, weights, "fixed")
    q = make_queue(eng.settings)
    bp = BatchProcessor(q, eng, polling_interval=0.02)
    bp.start()
    server = ServerThread(create_api(q, bp, eng)).start()
    try:
        rids = [q.add_request(QS[i % 4], k=2) for i in range(6)]
        results = {rid: q.get_result(rid, timeout=120) for rid in rids}
        want = dict(zip(QS, eng_f.process(QS, [2] * 4)))
        for i, rid in enumerate(rids):
            assert results[rid] == want[QS[i % 4]], i
        deadline = time.time() + 30
        while bp.requests_processed < 6 and time.time() < deadline:
            time.sleep(0.02)
        stats = _http(server.url + "/stats")
        assert stats["decode_pool"]["completed"] == 6 == stats["requests_processed"]
        assert stats["decode_pool"]["slots"] == 8 and stats["batches_processed"] >= 2
    finally:
        server.stop()
        bp.stop(drain_timeout=5.0)
        bp.join(timeout=10)
    assert not bp.is_alive() and not eng.decode_pool._thread.is_alive()
