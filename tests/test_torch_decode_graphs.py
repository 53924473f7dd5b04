"""PyTorch port: the decode step on a device step index, and the decode
loop's graph pool (`models/qwen2.py` `DecodeGraphs`) on the CPU.

The graphs themselves engage on CUDA only (`tests/test_torch_cuda.py`
holds their replays against the eager loop). Here: `decode_step` given its
step as a 0-d tensor equals the host-int call bit for bit; a pool on the
CPU leaves the loop eager; and, with a stub capture that runs the step
eagerly in place of a graph, the loop's replay path (token in, step
advanced on the device, a cache reused by the next batch of its key), the
eager loop under a profiler, and the pool's LRU cap.
"""

import gc
import weakref
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from rag_serving_system_torch.models import qwen2 as tq  # noqa: E402
from rag_serving_system_torch.models.configs import QWEN2_TINY as CFG  # noqa: E402
from rag_serving_system_torch.models.weights import init_decoder_params  # noqa: E402
from rag_serving_system_torch.utils.timing import StageTimer  # noqa: E402

T32 = dict(dtype=torch.float32)
MNT = 6


@pytest.fixture(scope="module")
def params():
    # varied greedy answers: the matrices scaled by 8
    fp = init_decoder_params(CFG, seed=1, dtype=torch.float32, device="cpu")
    for key in ("qkv_w", "o_w", "gu_w", "down_w"):
        fp["layers"][key] *= 8.0
    fp["embed"] *= 8.0
    return fp


def _left_padded(seed, b, p, lens):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, CFG.vocab_size, (b, p)).astype(np.int32)
    mask = np.zeros((b, p), np.int32)
    for i, n in enumerate(lens):
        mask[i, p - n:] = 1
        ids[i, :p - n] = 0
    return torch.tensor(ids), torch.tensor(mask)


def _pack(ids, mask, t, cap):
    """The engine's packed staging of left-padded rows (engine._stage_packed):
    `generate_packed`'s (ids, seg, positions, last, gather, prompt mask) and
    row_valid."""
    b, p = ids.shape
    stream = np.zeros((3, t), np.int32)
    stream[1] = cap
    gather = np.full((cap, p), -1, np.int32)
    last = np.full((cap,), -1, np.int32)
    off = 0
    for i in range(b):
        row = np.asarray(ids[i])[np.asarray(mask[i]) > 0]
        n = len(row)
        stream[0, off:off + n] = row
        stream[1, off:off + n] = i
        stream[2, off:off + n] = np.arange(n)
        gather[i, p - n:] = off + np.arange(n)
        last[i] = off + n - 1
        off += n
    args = (stream[0][None], stream[1][None], stream[2][None], np.maximum(last, 0),
            np.maximum(gather, 0), (gather >= 0).astype(np.int32), last >= 0)
    return tuple(torch.tensor(a) for a in args)


def _prefix(params, seed, lens, pl=12):
    """(prefix_kv (B, L, 2, PL, Hk, D), prefix_len) of right-padded
    prefixes of `lens` tokens."""
    rng = np.random.default_rng(seed)
    ids = torch.tensor(rng.integers(3, CFG.vocab_size, (len(lens), pl)).astype(np.int32))
    mask = torch.tensor((np.arange(pl)[None, :] < np.asarray(lens)[:, None]).astype(np.int32))
    kv = tq.compute_prefix_kv(params, CFG, ids, mask, **T32)
    return kv, torch.tensor(lens, dtype=torch.int32)


def _prefilled(params, route, seed=3):
    """(cache, combined mask, p) after a prefill with MNT decode slots."""
    ids, mask = _left_padded(seed, 3, 8, [8, 5, 2])
    kw = {}
    if route == "prefix":
        kw = dict(zip(("prefix_kv", "prefix_len"), _prefix(params, seed, [12, 7, 0])))
    _, cache = tq.prefill(params, CFG, ids, mask, MNT, **kw, **T32)
    cmask = tq._combined_mask(mask, kw.get("prefix_kv"), kw.get("prefix_len"))
    return cache, cmask, cmask.shape[1]


def _clone(cache):
    return tq.KVCache(cache.k.clone(), cache.v.clone())


@pytest.mark.parametrize("at", [0, 3], ids=["step0", "step3"])
@pytest.mark.parametrize("route", ["plain", "prefix"])
def test_decode_step_on_a_device_step_equals_the_host_int(params, route, at):
    cache, cmask, p = _prefilled(params, route)
    tok = torch.tensor([17, 33, 5], dtype=torch.int32)
    for s in range(at):     # the earlier steps' slots, written as the loop writes them
        _, cache = tq.decode_step(params, CFG, cache, tok + s, s, p, cmask, **T32)
    c_int, c_dev = _clone(cache), _clone(cache)
    want, _ = tq.decode_step(params, CFG, c_int, tok, at, p, cmask, **T32)
    got, _ = tq.decode_step(params, CFG, c_dev, tok, torch.tensor(at), p, cmask, **T32)
    assert torch.equal(got, want)
    assert torch.equal(c_dev.k, c_int.k) and torch.equal(c_dev.v, c_int.v)
    # the step's slot and nothing else was written
    assert not torch.equal(c_int.k[:, :, p + at], cache.k[:, :, p + at])
    assert torch.equal(c_int.k[:, :, p + at + 1:], cache.k[:, :, p + at + 1:])


def _loop(params, cache, cmask, p, graphs=None, timer=None, budget=None, eos_bias=0.0):
    logits0 = torch.zeros((cmask.shape[0], CFG.vocab_size))
    logits0[:, 7] = 1.0
    return tq._decode_loop(params, CFG, logits0, cache, cmask, None, MNT, 0.7, 20, 0.8,
                           False, torch.float32, None, p, row_budget=budget,
                           eos_bias=eos_bias, spans=tq._LoopSpans(timer), graphs=graphs)


@pytest.mark.parametrize("route", ["plain", "prefix"])
def test_decode_loop_given_a_pool_on_the_cpu_runs_eager(params, route):
    cache, cmask, p = _prefilled(params, route)
    want, steps = _loop(params, _clone(cache), cmask, p)
    graphs, timer = tq.DecodeGraphs(), StageTimer()
    assert graphs.cache_for(CFG, 3, p, p + MNT, torch.float32, "cpu") is None
    graphs.prepare(params, CFG, 3, p, p + MNT, torch.float32, "cpu")
    assert not graphs.entries
    got, got_steps = _loop(params, cache, cmask, p, graphs=graphs, timer=timer)
    assert torch.equal(got, want) and got_steps == steps > 0
    assert timer.counts["decode"] == steps
    assert "decode_replay" not in timer.counts and "decode_capture" not in timer.counts
    assert not graphs.entries


def test_generate_given_a_pool_on_the_cpu_returns_todays_tokens(params):
    ids, mask = _left_padded(4, 3, 8, [8, 5, 2])
    want = tq.generate(params, CFG, ids, mask, max_new_tokens=MNT, do_sample=False, **T32)
    got = tq.generate(params, CFG, ids, mask, max_new_tokens=MNT, do_sample=False,
                      graphs=tq.DecodeGraphs(), **T32)
    assert torch.equal(got, want)


class _EagerGraph:
    """A stub of a captured step: a replay runs the step's body eagerly and
    leaves its logits in the entry's one logits tensor."""

    def __init__(self, ent, body):
        self.ent, self.body = ent, body

    def replay(self):
        self.ent.logits.copy_(self.body())


def _stub_capture(self, ent, body, owner):
    ent.logits = body()         # the warm-up run, which advances the step
    ent.step.sub_(1)
    ent.graph, ent.owner = _EagerGraph(ent, body), owner


@pytest.fixture
def stub_graphs():
    with mock.patch.object(tq.DecodeGraphs, "engages", staticmethod(lambda device: True)), \
            mock.patch.object(tq.DecodeGraphs, "capture", _stub_capture):
        yield


@pytest.mark.parametrize("route", ["plain", "prefix"])
def test_replay_path_with_a_stub_capture_returns_the_eager_tokens(params, route, stub_graphs):
    """The loop's replay path over a pool entry: each step the token copied
    in and the step index advanced on the device; a second batch on the
    same key reuses the entry's graph and its cache, whose decode slots
    still hold the first batch's K/V, and equals its own eager run."""
    graphs, timer = tq.DecodeGraphs(), StageTimer()
    budget = torch.tensor([MNT, 3, MNT], dtype=torch.int32)
    for seed in (3, 8):
        cache, cmask, p = _prefilled(params, route, seed)
        want, steps = _loop(params, _clone(cache), cmask, p, budget=budget)
        ent_cache = graphs.cache_for(CFG, 3, p, cache.k.shape[2], torch.float32, "cpu")
        if seed == 8:
            assert ent_cache.k[:, :, p:].any()      # the first batch's decode slots
        ent_cache.k[:, :, :p] = cache.k[:, :, :p]   # what the prefill writes
        ent_cache.v[:, :, :p] = cache.v[:, :, :p]
        got, got_steps = _loop(params, ent_cache, cmask, p, graphs=graphs, timer=timer,
                               budget=budget)
        assert torch.equal(got, want) and got_steps == steps > 0
    assert timer.counts["decode_capture"] == 1
    assert timer.counts["decode_replay"] == timer.counts["decode"] > 0
    assert len(graphs.entries) == 1


def test_generate_with_a_stub_capture_fills_the_pool_cache(params, stub_graphs):
    """`generate` and `generate_packed` hand the prefill the pool's cache of
    the batch's key and return the eager tokens."""
    ids, mask = _left_padded(5, 3, 8, [8, 5, 2])
    want = tq.generate(params, CFG, ids, mask, max_new_tokens=MNT, do_sample=False, **T32)
    graphs = tq.DecodeGraphs()
    for _ in range(2):
        got = tq.generate(params, CFG, ids, mask, max_new_tokens=MNT, do_sample=False,
                          graphs=graphs, **T32)
        assert torch.equal(got, want)
    assert list(graphs.entries) == [(3, 8, 8 + MNT)]
    kv, plen = _prefix(params, 5, [12, 7, 0])
    want = tq.generate(params, CFG, ids, mask, max_new_tokens=MNT, do_sample=False,
                       prefix_kv=kv, prefix_len=plen, **T32)
    got = tq.generate(params, CFG, ids, mask, max_new_tokens=MNT, do_sample=False,
                      prefix_kv=kv, prefix_len=plen, graphs=graphs, **T32)
    assert torch.equal(got, want)
    assert list(graphs.entries)[-1] == (3, 20, 20 + MNT)
    *packed, valid = _pack(ids, mask, 32, cap=4)
    want = tq.generate_packed(params, CFG, *packed, max_new_tokens=MNT, do_sample=False,
                              row_valid=valid, **T32)
    got = tq.generate_packed(params, CFG, *packed, max_new_tokens=MNT, do_sample=False,
                             row_valid=valid, graphs=graphs, **T32)
    assert torch.equal(got, want) and torch.equal(got[:3], tq.generate(
        params, CFG, ids, mask, max_new_tokens=MNT, do_sample=False, **T32))
    assert list(graphs.entries)[-1] == (4, 8, 8 + MNT)
    # the speculative loop stays eager and takes no entry
    tq.generate(params, CFG, ids, mask, max_new_tokens=MNT, do_sample=False,
                spec_gamma=2, graphs=graphs, **T32)
    assert len(graphs.entries) == 3


def test_a_loop_under_a_profiler_replays(params, stub_graphs):
    """A loop that runs inside a profiler session replays like any other,
    with today's tokens: what a trace reads is the served path."""
    from torch.profiler import ProfilerActivity, profile

    graphs, timer = tq.DecodeGraphs(), StageTimer()
    cache, cmask, p = _prefilled(params, "plain")
    want, steps = _loop(params, _clone(cache), cmask, p)
    ent_cache = graphs.cache_for(CFG, 3, p, cache.k.shape[2], torch.float32, "cpu")
    ent_cache.k.copy_(cache.k)
    ent_cache.v.copy_(cache.v)
    with profile(activities=[ProfilerActivity.CPU]):
        got, got_steps = _loop(params, ent_cache, cmask, p, graphs=graphs, timer=timer)
    assert torch.equal(got, want) and got_steps == steps > 0
    assert timer.counts["decode_replay"] == timer.counts["decode"] == steps
    assert timer.counts["decode_capture"] == 1


def test_profiler_start_and_stop_wait_for_a_graph_launch():
    """Once guarded, a profiler session's start and its stop each wait
    while another thread holds the launch lock (a replay in flight), and
    the guard is installed once however often it is asked for."""
    import threading
    import time

    import torch.autograd.profiler as ap
    from torch.profiler import ProfilerActivity, profile

    from rag_serving_system_torch.utils import timing

    timing.guard_profiler()
    wrapped = ap._disable_profiler
    timing.guard_profiler()
    assert ap._disable_profiler is wrapped

    def held(seconds, started):
        with timing.GRAPH_LAUNCH_LOCK:
            started.set()
            time.sleep(seconds)

    prof = profile(activities=[ProfilerActivity.CPU])
    for step in (prof.start, prof.stop):
        started = threading.Event()
        th = threading.Thread(target=held, args=(0.3, started))
        th.start()
        started.wait()
        t0 = time.perf_counter()
        step()
        assert time.perf_counter() - t0 >= 0.25
        th.join()
    assert not timing.GRAPH_LAUNCH_LOCK.locked()


def test_prepare_captures_a_key_before_its_first_batch(params, stub_graphs):
    """`prepare` captures a key ahead of use: the key's first batch then
    replays with no capture, and returns the eager tokens."""
    graphs, timer = tq.DecodeGraphs(), StageTimer()
    cache, cmask, p = _prefilled(params, "prefix")
    t_max = cache.k.shape[2]
    graphs.prepare(params, CFG, 3, p, t_max, torch.float32, "cpu")
    assert graphs.entries[(3, p, t_max)].graph is not None
    want, steps = _loop(params, _clone(cache), cmask, p)
    ent_cache = graphs.cache_for(CFG, 3, p, t_max, torch.float32, "cpu")
    ent_cache.k[:, :, :p] = cache.k[:, :, :p]
    ent_cache.v[:, :, :p] = cache.v[:, :, :p]
    got, _ = _loop(params, ent_cache, cmask, p, graphs=graphs, timer=timer)
    assert torch.equal(got, want)
    assert timer.counts["decode_replay"] == steps and "decode_capture" not in timer.counts


def test_pool_cap_evicts_the_least_recently_used_key_and_frees_it(params, stub_graphs,
                                                                  monkeypatch):
    monkeypatch.setattr(tq, "DECODE_GRAPHS_CAP", 2)
    graphs = tq.DecodeGraphs()
    a = graphs.cache_for(CFG, 1, 8, 14, torch.float32, "cpu")
    graphs.cache_for(CFG, 2, 8, 14, torch.float32, "cpu")
    ent_b = graphs.entries[(2, 8, 14)]
    ent_b.graph = _EagerGraph(ent_b, None)
    freed = [weakref.ref(x) for x in (ent_b.cache.k, ent_b.cache.v, ent_b.graph,
                                      ent_b.tok, ent_b.mask)]
    del ent_b
    assert graphs.cache_for(CFG, 1, 8, 14, torch.float32, "cpu") is a   # (1, 8, 14) used last
    graphs.cache_for(CFG, 4, 8, 14, torch.float32, "cpu")
    assert list(graphs.entries) == [(1, 8, 14), (4, 8, 14)]
    gc.collect()
    assert all(r() is None for r in freed)
    graphs.clear()
    assert not graphs.entries


def test_a_new_parameter_tree_is_captured_again(params, stub_graphs):
    """An entry captured over one parameter tree is captured again when the
    loop runs another: a graph reads the tensors it was captured over."""
    graphs, timer = tq.DecodeGraphs(), StageTimer()
    other = {**params, "embed": params["embed"] * 0.5}
    for tree in (params, params, other):
        cache, cmask, p = _prefilled(tree, "plain")
        want, _ = _loop(tree, _clone(cache), cmask, p)
        ent_cache = graphs.cache_for(CFG, 3, p, cache.k.shape[2], torch.float32, "cpu")
        ent_cache.k.copy_(cache.k)
        ent_cache.v.copy_(cache.v)
        got, _ = _loop(tree, ent_cache, cmask, p, graphs=graphs, timer=timer)
        assert torch.equal(got, want)
    assert timer.counts["decode_capture"] == 2


def test_engine_owns_a_pool_on_one_device_only(params):
    from rag_serving_system_torch.config import Settings
    from rag_serving_system_torch.core.engine import RagEngine
    from rag_serving_system_torch.parallel.mesh import make_mesh

    rng = np.random.default_rng(0)
    docs = [f"document {i} about topic {i % 5}" for i in range(16)]
    emb = rng.standard_normal((16, 64)).astype(np.float32)
    s = Settings(model_preset="tiny", dtype="float32", do_sample=False,
                 batch_buckets=[1, 4], max_batch_size=4, encode_len_buckets=[16, 32],
                 prompt_len_buckets=[32, 128], max_new_tokens=4, max_k=4,
                 decode_mode="fixed", quant_weights="none", quant_act="none",
                 query_cache_size=0, prefix_pool_len=48)
    one = RagEngine(s, docs, emb, device="cpu")
    assert isinstance(one.decode_graphs, tq.DecodeGraphs)
    one.decode_graphs.entries["stale"] = None
    one.dec_params = params
    assert not one.decode_graphs.entries
    one.process(["what is topic 3?", "tell me about document 7"], [2, 2])
    assert one.timer.counts["decode"] > 0 and "decode_replay" not in one.timer.counts
    two = RagEngine(s, docs, emb, mesh=make_mesh("1,2", devices=["cpu"] * 2))
    assert two.decode_graphs is None


def test_engine_warmup_captures_every_full_batch_key(params, stub_graphs):
    """`warmup` captures the step at each key a full batch can form: every
    prompt bucket, the prefix pool plus every suffix bucket, at the largest
    batch bucket with the engine's decode slots; the warm-up query's own
    key besides. A speculative engine captures none."""
    from rag_serving_system_torch.config import Settings
    from rag_serving_system_torch.core.engine import SUFFIX_LEN_BUCKETS, RagEngine

    rng = np.random.default_rng(0)
    docs = [f"document {i} about topic {i % 5}" for i in range(16)]
    emb = rng.standard_normal((16, 64)).astype(np.float32)
    kw = dict(model_preset="tiny", dtype="float32", do_sample=False, batch_buckets=[1, 4],
              max_batch_size=4, encode_len_buckets=[16, 32], prompt_len_buckets=[32, 128],
              max_new_tokens=4, max_k=4, decode_mode="fixed", quant_weights="none",
              quant_act="none", query_cache_size=0, prefix_pool_len=48)
    eng = RagEngine(Settings(**kw), docs, emb, device="cpu")
    eng.dec_params = params
    eng.warmup()
    slots = {32, 128} | {48 + b for b in list(SUFFIX_LEN_BUCKETS) + [32, 128]}
    full = {(4, p, p + 4) for p in slots}
    keys = set(eng.decode_graphs.entries)
    assert full <= keys
    assert all(eng.decode_graphs.entries[k].graph is not None for k in full)
    assert all(k[0] == 1 for k in keys - full)
    spec = RagEngine(Settings(**kw, spec_gamma=2), docs, emb, device="cpu")
    spec.dec_params = params
    spec.warmup()
    assert not spec.decode_graphs.entries
