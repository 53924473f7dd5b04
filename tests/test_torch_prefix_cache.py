"""PyTorch port: the exact prefix-KV cache against the JAX package.

Model side (QWEN2_TINY, f32, the JAX weights converted by `params_from_jax`,
matrices scaled by 8 so greedy trajectories vary): `compute_prefix_kv`,
`prefill` and `generate` with a cached prefix, and `quantize_prefix_kv`.
K/V at an entry's pad slots differs between routes and packages (the flash
kernels' plain version and the einsum path treat pad queries differently) and
is masked by `prefix_len`: only real positions are compared.

Cache side: `PrefixKVCache` bookkeeping against the JAX class on one seeded
sequence of calls (slots, stats and gathered payloads equal at every step),
then the port's own versions of the JAX package's cache tests."""

import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rag_serving_system_tpu.core import prefix_cache as jpc  # noqa: E402
from rag_serving_system_tpu.models import qwen2 as jq  # noqa: E402
from rag_serving_system_tpu.models.configs import QWEN2_TINY  # noqa: E402
from rag_serving_system_tpu.models.weights import init_decoder_params  # noqa: E402
from rag_serving_system_torch.core import prefix_cache as tpc  # noqa: E402
from rag_serving_system_torch.models import qwen2 as tq  # noqa: E402
from rag_serving_system_torch.models.weights import (  # noqa: E402
    params_from_jax,
    prefix_kv_from_jax,
)

CFG = QWEN2_TINY
F32 = dict(dtype=jnp.float32)
T32 = dict(dtype=torch.float32)
SHAPE = (2, 2, 8, 2, 4)   # the small pool of the JAX package's cache tests


def _scaled(tree, f):
    return {k: (_scaled(v, f) if isinstance(v, dict) else
                v * f if k in ("embed", "qkv_w", "o_w", "gu_w", "down_w") else v)
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def dec():
    jp = _scaled(init_decoder_params(CFG, seed=7, dtype=jnp.float32), 8.0)
    return jp, params_from_jax(jax.device_get(jp))


def _pad(rows, width, side, pad_id=0):
    ids = np.full((len(rows), width), pad_id, np.int32)
    mask = np.zeros((len(rows), width), np.int32)
    for i, r in enumerate(rows):
        sl = slice(width - len(r), width) if side == "left" else slice(0, len(r))
        ids[i, sl] = r
        mask[i, sl] = 1
    return ids, mask


def _tokens(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, CFG.vocab_size, size=n).tolist() for n in lens]


def _prefix_batch(dec, seed, pre_lens, pool_len):
    """Seeded prefixes, right-padded to pool_len, and their K/V from both
    packages. A row of length 0 gets mask[0] = 1, as the engine gives it."""
    jp, tp = dec
    pres = _tokens(seed, pre_lens)
    pids, pmask = _pad(pres, pool_len, "right")
    pmask[np.asarray(pre_lens) == 0, 0] = 1
    jkv = jq.compute_prefix_kv(jp, CFG, jnp.asarray(pids), jnp.asarray(pmask), **F32)
    tkv = tq.compute_prefix_kv(tp, CFG, torch.tensor(pids), torch.tensor(pmask), **T32)
    return pres, jkv, tkv


# ---------------------------------------------------------------------------
# the model functions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pre_lens,pool_len", [([14], 16), ([20, 12, 1, 24], 24)])
def test_compute_prefix_kv_matches_jax(dec, pre_lens, pool_len):
    """(M, L, 2, PL, Hk, D) post-RoPE K/V at real positions, atol 1e-5."""
    _, jkv, tkv = _prefix_batch(dec, 3, pre_lens, pool_len)
    assert tkv.shape == jkv.shape == (len(pre_lens), CFG.num_layers, 2, pool_len,
                                      CFG.num_kv_heads, CFG.head_dim)
    assert tkv.dtype == torch.float32
    for row, n in enumerate(pre_lens):
        np.testing.assert_allclose(tkv[row, :, :, :n].numpy(),
                                   np.asarray(jkv)[row, :, :, :n], atol=1e-5, rtol=0)


def test_compute_prefix_kv_matches_cold_prefill_cache(dec):
    """An entry equals the K/V a full prefill of the same leading tokens
    writes into its cache (positions 0..n-1), atol 1e-5."""
    _, tp = dec
    (prefix,) = _tokens(3, [14])
    pids, pmask = _pad([prefix], 16, "right")
    kv = tq.compute_prefix_kv(tp, CFG, torch.tensor(pids), torch.tensor(pmask), **T32)
    fids, fmask = _pad([prefix], 14, "left")   # exact length: no padding at all
    _, cache = tq.prefill(tp, CFG, torch.tensor(fids), torch.tensor(fmask), 1, **T32)
    for li in range(CFG.num_layers):
        torch.testing.assert_close(kv[0, li, 0, :14], cache.k[li, 0, :14], atol=1e-5, rtol=0)
        torch.testing.assert_close(kv[0, li, 1, :14], cache.v[li, 0, :14], atol=1e-5, rtol=0)


@pytest.mark.parametrize("pre_lens,suf_lens", [([20, 12], [6, 9]), ([20, 12, 0], [6, 9, 18])],
                         ids=["all_prefixed", "zero_prefix_row"])
def test_prefill_with_jax_entry_matches_jax_logits(dec, pre_lens, suf_lens):
    """The suffix route alone: the port's prefill fed the JAX package's own
    cached entry gives the JAX logits (atol 1e-4) and a cache of
    PL + P + max_new_tokens slots."""
    jp, tp = dec
    _, jkv, _ = _prefix_batch(dec, 11, pre_lens, 24)
    sids, smask = _pad(_tokens(12, suf_lens), 24, "left")
    ref, _ = jq.prefill(jp, CFG, jnp.asarray(sids), jnp.asarray(smask), 4, **F32,
                        prefix_kv=jkv, prefix_len=jnp.asarray(pre_lens, jnp.int32))
    ours, cache = tq.prefill(tp, CFG, torch.tensor(sids), torch.tensor(smask), 4, **T32,
                             prefix_kv=prefix_kv_from_jax(jax.device_get(jkv)),
                             prefix_len=torch.tensor(pre_lens, dtype=torch.int32))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-4, rtol=0)
    assert cache.k.shape == (CFG.num_layers, len(pre_lens), 24 + 24 + 4,
                             CFG.num_kv_heads, CFG.head_dim)


def test_generate_with_prefix_equals_jax_and_cold(dec):
    """Greedy tokens over [cached prefix | suffix] equal the JAX tokens and
    the port's own cold tokens over the whole prompt, a zero-prefix row
    included."""
    jp, tp = dec
    pre_lens, suf_lens = [20, 12, 0], [6, 9, 18]
    pres, jkv, tkv = _prefix_batch(dec, 11, pre_lens, 24)
    sufs = _tokens(12, suf_lens)
    sids, smask = _pad(sufs, 24, "left")
    kw = dict(max_new_tokens=6, do_sample=False)
    ref = np.asarray(jq.generate(jp, CFG, jnp.asarray(sids), jnp.asarray(smask),
                                 jax.random.PRNGKey(0), **kw, **F32, prefix_kv=jkv,
                                 prefix_len=jnp.asarray(pre_lens, jnp.int32)))
    ours = tq.generate(tp, CFG, torch.tensor(sids), torch.tensor(smask), None, **kw, **T32,
                       prefix_kv=tkv,
                       prefix_len=torch.tensor(pre_lens, dtype=torch.int32)).numpy()
    np.testing.assert_array_equal(ours, ref)
    fids, fmask = _pad([p + s for p, s in zip(pres, sufs)], 32, "left")
    cold = tq.generate(tp, CFG, torch.tensor(fids), torch.tensor(fmask), None, **kw,
                       **T32).numpy()
    np.testing.assert_array_equal(ours, cold)
    assert len(set(ours[0].tolist())) > 2          # a varied trajectory


def test_generate_with_prefix_sampled_stays_in_vocab(dec):
    _, tp = dec
    _, _, tkv = _prefix_batch(dec, 5, [10], 16)
    sids, smask = _pad(_tokens(6, [5]), 8, "left")
    out = tq.generate(tp, CFG, torch.tensor(sids), torch.tensor(smask),
                      torch.Generator().manual_seed(2), max_new_tokens=3, do_sample=True,
                      **T32, prefix_kv=tkv, prefix_len=torch.tensor([10], dtype=torch.int32))
    assert out.shape == (1, 3) and out.dtype == torch.int32
    assert ((out >= 0) & (out < CFG.vocab_size)).all()


def test_quantize_prefix_kv_bit_equal_to_jax(dec):
    """Values and scales equal the JAX quantizer's on the same array, and
    |err| <= scale / 2."""
    _, jkv, _ = _prefix_batch(dec, 9, [12, 7], 16)
    kv = np.array(jkv)
    kv[1, 0, 0, 3] = 0.0          # an all-zero head row: the 1e-8 floor
    kv[0, 1, 1, 2, 0, :2] = [0.5, 1.5]   # halves round to even after scaling
    jq8, js = jq.quantize_prefix_kv(jnp.asarray(kv))
    q8, s = tq.quantize_prefix_kv(torch.tensor(kv))
    assert q8.dtype == torch.int8 and s.dtype == torch.float32
    assert s.shape == kv.shape[:-1] + (1,)
    np.testing.assert_array_equal(q8.numpy(), np.asarray(jq8))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    err = np.abs(kv - q8.numpy().astype(np.float32) * s.numpy())
    assert (err <= s.numpy() * 0.5 + 1e-7).all()


def test_int8_prefix_logits_close_to_exact_and_equal_jax(dec):
    """An (int8, scales) prefix: logits equal the JAX package's on the same
    pair (atol 1e-4) and stay at cosine > 0.999 of the exact prefix's."""
    jp, tp = dec
    pre_lens = [14, 9]
    _, jkv, tkv = _prefix_batch(dec, 21, pre_lens, 16)
    sids, smask = _pad(_tokens(22, [5, 7]), 8, "left")
    plen = torch.tensor(pre_lens, dtype=torch.int32)
    args = (tp, CFG, torch.tensor(sids), torch.tensor(smask), 1)
    exact, _ = tq.prefill(*args, **T32, prefix_kv=tkv, prefix_len=plen)
    pair = jq.quantize_prefix_kv(jkv)
    quant, _ = tq.prefill(*args, **T32, prefix_kv=prefix_kv_from_jax(jax.device_get(pair)),
                          prefix_len=plen)
    ref, _ = jq.prefill(jp, CFG, jnp.asarray(sids), jnp.asarray(smask), 1, **F32,
                        prefix_kv=pair, prefix_len=jnp.asarray(pre_lens, jnp.int32))
    np.testing.assert_allclose(quant.numpy(), np.asarray(ref), atol=1e-4, rtol=0)
    cos = torch.nn.functional.cosine_similarity(exact, quant, dim=-1)
    assert (cos > 0.999).all()
    out = tq.generate(*args[:4], None, max_new_tokens=3, do_sample=False, **T32,
                      prefix_kv=tq.quantize_prefix_kv(tkv), prefix_len=plen)
    assert out.shape == (2, 3)


def test_prefix_kv_from_jax_keeps_bits():
    rng = np.random.default_rng(0)
    kv = rng.standard_normal((2,) + SHAPE).astype(np.float32)
    assert torch.equal(prefix_kv_from_jax(jnp.asarray(kv)), torch.tensor(kv))
    q8 = rng.integers(-127, 128, (2,) + SHAPE).astype(np.int8)
    sc = rng.random((2,) + SHAPE[:-1] + (1,)).astype(np.float32)
    got = prefix_kv_from_jax((jnp.asarray(q8), jnp.asarray(sc)))
    assert isinstance(got, tuple) and got[0].dtype == torch.int8
    assert torch.equal(got[0], torch.tensor(q8)) and torch.equal(got[1], torch.tensor(sc))


# ---------------------------------------------------------------------------
# PrefixKVCache against the JAX class
# ---------------------------------------------------------------------------

def _pair(int8=False, **kw):
    """The JAX cache and the port's, built alike over the small pool."""
    return (jpc.PrefixKVCache(entry_shape=SHAPE, dtype=jnp.float32, int8=int8, **kw),
            tpc.PrefixKVCache(entry_shape=SHAPE, dtype=torch.float32, int8=int8, **kw))


def _payload(rng, m, int8):
    if not int8:
        return rng.standard_normal((m,) + SHAPE).astype(np.float32)
    return (rng.integers(-127, 128, (m,) + SHAPE).astype(np.int8),
            rng.random((m,) + SHAPE[:-1] + (1,)).astype(np.float32))


def _as(payload, conv):
    return tuple(conv(x) for x in payload) if isinstance(payload, tuple) else conv(payload)


def _np(gathered):
    return [np.asarray(x) for x in (gathered if isinstance(gathered, tuple) else (gathered,))]


@pytest.mark.parametrize("int8", [False, True], ids=["compute", "int8"])
@pytest.mark.parametrize("seed", [0, 1])
def test_cache_bookkeeping_equals_jax(seed, int8):
    """One seeded sequence of should_attempt, get, put_batch, note_bypass and
    gather through both classes: 12 keys in two token variants over 6 slots
    (lazy growth 2 -> 4 -> 6, then LRU reuse), a 16-lookup adaptive window.
    Slots handed out, stats() and gathered payloads are equal at every
    step."""
    jc, tc = _pair(int8, pool_len=8, entry_bytes=1 << 20, budget_mb=6, initial_slots=2,
                   window=16, low_hit_rate=0.25, probe_every=3)
    assert jc.capacity == tc.capacity == 6
    rng = np.random.default_rng(seed)
    attempts = 0
    for step in range(120):
        go = tc.should_attempt()
        assert go == jc.should_attempt()
        # a cacheable stretch in the middle, thrash around it
        hot = 40 <= step < 80
        rows = [(int(rng.integers(0, 3 if hot else 12)), int(rng.integers(0, 1 if hot else 2)))
                for _ in range(int(rng.integers(1, 4)))]
        if not go:
            for _ in rows:
                jc.note_bypass()
                tc.note_bypass()
            assert tc.stats() == jc.stats()
            continue
        attempts += 1
        slots, need = [], {}
        for key, variant in rows:
            toks = (key, variant)
            je, te = jc.get(key, toks), tc.get(key, toks)
            assert (je is None) == (te is None)
            if te is None:
                need.setdefault(key, toks)
                slots.append(key)
            else:
                assert (te.slot, te.tokens) == (je.slot, je.tokens)
                slots.append(te)
        if need:
            keys = list(need)
            payload = _payload(rng, len(keys) + int(rng.integers(0, 2)), int8)  # a pad row
            protected = {e.slot for e in slots if not isinstance(e, int)}
            jf = jc.put_batch(keys, [need[k] for k in keys], _as(payload, jnp.asarray),
                              protected=protected)
            tf = tc.put_batch(keys, [need[k] for k in keys], _as(payload, torch.tensor),
                              protected=protected)
            assert {k: (e.slot, e.tokens) for k, e in tf.items()} == \
                {k: (e.slot, e.tokens) for k, e in jf.items()}
            slots = [tf[e] if isinstance(e, int) else e for e in slots]
        idx = [e.slot for e in slots] + [tc.zero_slot]
        for got, want in zip(_np(_as(tc.gather(idx), lambda t: t.numpy())), _np(jc.gather(idx))):
            np.testing.assert_array_equal(got, want)
        assert tc.stats() == jc.stats()
        assert len(tc) == len(jc) and sorted(tc._free) == sorted(jc._free)
    st = tc.stats()
    assert st["grows"] == 2 and st["slots"] == 6 and 3 <= st["entries"] <= 6
    assert st["probes"] > 0 and st["bypassed"] > 0 and 0 < attempts < 120


# ---------------------------------------------------------------------------
# the port's cache on its own
# ---------------------------------------------------------------------------

def _cache(**kw):
    kw = {"pool_len": 8, "entry_bytes": 1 << 20, "entry_shape": SHAPE,
          "dtype": torch.float32, **kw}
    return tpc.PrefixKVCache(**kw)


def _rows(n, fill):
    return torch.full((n,) + SHAPE, float(fill))


def test_split_prefix_tokens():
    full = [5, 6, 7, 8, 9, 10]
    assert tpc.split_prefix_tokens(full, [5, 6, 7], 16) == 3
    # a merge across the boundary: the separately tokenized prefix ends differently
    assert tpc.split_prefix_tokens(full, [5, 6, 99], 16) == 2
    assert tpc.split_prefix_tokens(full, [5, 6, 7, 8], 3) == 3   # the pool's length
    assert tpc.split_prefix_tokens(full, [99], 16) == 0
    assert tpc.split_prefix_tokens(full, [5, 99, 7], 16) == 1    # a mismatch inside
    for args in ((full, [5, 6, 99], 16), (full, [5, 99, 7], 16), (full, [], 4)):
        assert tpc.split_prefix_tokens(*args) == jpc.split_prefix_tokens(*args)


def test_prompt_spec_is_a_string():
    p = tpc.PromptSpec("hello world", prefix_text="hello", cache_key=("ctx", (1,)))
    assert p == "hello world" and len(p) == 11 and isinstance(p, str)
    assert p.prefix_text == "hello" and p.cache_key == ("ctx", (1,))
    assert p.sort_len == 6 and p.gen_budget is None
    j = jpc.PromptSpec("hello world", prefix_text="hello", gen_budget=3)
    t = tpc.PromptSpec("hello world", prefix_text="hello", gen_budget=3)
    assert (t.sort_len, t.gen_budget, t.cache_key) == (j.sort_len, j.gen_budget, j.cache_key)


def test_lru_eviction_and_verify():
    cache = _cache(budget_mb=2)
    assert cache.capacity == 2

    def put(key, toks, fill):
        return cache.put_batch([key], [toks], _rows(1, fill))[key]

    ea = put("a", (1, 2), 1.0)
    put("b", (3, 4), 2.0)
    assert cache.get("a", (1, 2)) is not None     # refreshes 'a'
    ec = put("c", (5, 6), 3.0)                    # evicts 'b', reuses its slot
    assert ec.slot != ea.slot and len(cache) == 2
    assert cache.get("b", (3, 4)) is None
    assert cache.get("a", (1, 2)) is not None
    # a key collision with other tokens must MISS, never serve wrong K/V
    assert cache.get("c", (5, 999)) is None
    s = cache.stats()
    assert s["entries"] == 2 and s["hits"] == 2 and s["misses"] == 2
    g = cache.gather([ea.slot, ec.slot, cache.zero_slot])
    assert (g[0] == 1.0).all() and (g[1] == 3.0).all() and (g[2] == 0.0).all()


def test_concurrent_gather_and_put_batch_across_growth():
    """Gathers on two threads race inserts on two others while the pool grows
    from 2 to 128 slots (each growth swaps the pool tensor under the lock).
    No call may fail, the zeros row stays zero, and every entry still reads
    back its own payload."""
    cache = _cache(entry_bytes=1 << 12, budget_mb=4, initial_slots=2)
    errs: list = []

    def putter(t):
        try:
            for i in range(40):
                cache.put_batch([(t, i)], [(i,)], _rows(1, 100 * t + i))
        except Exception as e:  # the failure path
            errs.append(e)

    def gatherer():
        try:
            for _ in range(200):
                g = cache.gather([cache.zero_slot, cache.scratch_slot])
                assert (g[0] == 0.0).all()
        except Exception as e:  # the failure path
            errs.append(e)

    threads = ([threading.Thread(target=putter, args=(t,)) for t in (1, 2)]
               + [threading.Thread(target=gatherer) for _ in range(2)])
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads) and not errs, errs
    assert cache.grows >= 5 and len(cache) == 80
    for t in (1, 2):
        for i in (0, 17, 39):
            e = cache.get((t, i), (i,))
            assert (cache.gather([e.slot]) == 100 * t + i).all()


def test_put_batch_never_overwrites_protected_slots():
    cache = _cache(budget_mb=3)
    assert cache.capacity == 3
    ea = cache.put_batch(["a"], [(1,)], _rows(1, 1.0))["a"]
    cache.put_batch(["b"], [(2,)], _rows(1, 2.0))
    cache.put_batch(["c"], [(3,)], _rows(1, 3.0))
    # full; a batch hits 'a', then inserts two misses protecting a's slot
    fresh = cache.put_batch(["d", "e"], [(4,), (5,)], _rows(2, 9.0), protected={ea.slot})
    assert ea.slot not in {e.slot for e in fresh.values()}
    assert len({e.slot for e in fresh.values()}) == 2
    assert (cache.gather([ea.slot]) == 1.0).all()


def test_put_batch_reinsert_recycles_slot():
    cache = _cache(budget_mb=2)
    for i in range(6):  # two token variants of one key in turn
        cache.put_batch(["k"], [(i,)], _rows(1, i))
        assert len(cache) == 1
        assert len(cache._free) + 1 == cache.capacity


def test_clear_drops_entries_and_keeps_pool_and_counters():
    cache = _cache(budget_mb=8, initial_slots=2)
    for i in range(5):
        cache.put_batch([i], [(i,)], _rows(1, i + 1))
    assert cache.get(3, (3,)) is not None and cache.grows == 2
    rows = cache._pool.shape[0]
    cache.clear()
    assert len(cache) == 0 and cache.get(3, (3,)) is None
    st = cache.stats()
    assert (st["hits"], st["misses"], st["grows"], st["slots"]) == (1, 1, 2, 8)
    assert cache._pool.shape[0] == rows and len(cache._free) == cache.n_slots
    e = cache.put_batch(["x"], [(9,)], _rows(1, 7.0))["x"]
    assert (cache.gather([e.slot]) == 7.0).all() and not cache.gather([0]).any()


def test_put_batch_sends_pad_rows_to_scratch():
    cache = _cache(budget_mb=8)
    rows = torch.cat([_rows(1, 5.0), _rows(7, -1.0)])
    e = cache.put_batch(["x"], [(1,)], rows)["x"]  # 1 real row and 7 pad rows
    g = cache.gather([e.slot, cache.zero_slot])
    assert (g[0] == 5.0).all() and (g[1] == 0.0).all()


def test_min_slots_overrides_budget(monkeypatch):
    assert _cache(budget_mb=2, min_slots=65).capacity == 65
    monkeypatch.setenv("PREFIX_MAX_ENTRIES", "3")
    assert _cache(budget_mb=64).capacity == 3
    assert _cache(budget_mb=64, min_slots=9).capacity == 9


@pytest.mark.parametrize("int8", [False, True], ids=["compute", "int8"])
def test_lazy_growth_keeps_slot_contents(int8):
    cache = _cache(entry_bytes=1 << 10, budget_mb=1, int8=int8, initial_slots=2)
    assert cache.capacity > 4 and cache.n_slots == 2
    rows0 = cache._pool.shape[0]

    def payload(fill):
        if not int8:
            return _rows(1, fill)
        return (_rows(1, fill).to(torch.int8), torch.full((1,) + SHAPE[:-1] + (1,), 0.5))

    first = cache.put_batch([("k", 0)], [(1, 2)], payload(1))[("k", 0)]
    for i in range(1, 5):  # two doublings
        cache.put_batch([("k", i)], [(1, 2)], payload(i + 1))
    assert cache.grows >= 1 and cache._pool.shape[0] > rows0
    st = cache.stats()
    assert st["slots"] >= 5 and len(cache) == 5
    assert st["pool_reserved_bytes"] == (cache.n_slots + 2) * cache.entry_bytes
    g = cache.gather([first.slot, cache.zero_slot])
    vals = g[0] if int8 else g
    assert (vals[0] == 1).all() and (vals[1] == 0).all()
    if int8:    # scales: the entry's own, and the pool's fill of 1 on the zeros row
        assert g[0].dtype == torch.int8 and cache._pool_scale.shape[0] == cache._pool.shape[0]
        assert (g[1][0] == 0.5).all() and (g[1][1] == 1.0).all()


def test_adaptive_bypass_engages_on_thrash_and_recovers():
    cache = _cache(budget_mb=4, adaptive=True, window=64, low_hit_rate=0.25, probe_every=4)
    assert cache.capacity < 32
    k = attempts = 0
    for _ in range(64):          # thrash: every lookup a key never seen again
        if cache.should_attempt():
            attempts += 1
            for _ in range(8):
                assert cache.get(("c", k), (k,)) is None
                cache.put_batch([("c", k)], [(k,)], _rows(1, 0))
                k += 1
    st = cache.stats()
    assert st["bypass_mode"] is True and st["probes"] > 0
    assert attempts < 40, attempts
    keys = [("h", i) for i in range(4)]
    for key in keys:
        cache.put_batch([key], [(0,)], _rows(1, 0))
    recovered = False
    for _ in range(200):         # the same few keys repeat: probes hit, bypass lifts
        if cache.should_attempt():
            for key in keys * 4:
                cache.get(key, (0,))
        if not cache.bypass_mode:
            recovered = True
            break
    assert recovered, cache.stats()


def test_adaptive_bypass_never_fires_during_warmup_misses():
    cache = _cache(entry_bytes=1 << 10, budget_mb=64, adaptive=True, window=256)
    for i in range(100):  # fewer than the window: all misses, still warming
        assert cache.should_attempt() is True
        cache.get(("w", i), (i,))
    assert cache.bypass_mode is False
    off = _cache(adaptive=False, window=4)
    for i in range(20):
        off.get(("w", i), (i,))
        assert off.should_attempt() is True
