"""PyTorch port: the pipelined batch processor, the role split of `main` and
`/stats`, against the JAX package's.

On a stub engine the port's processor must hand stage 2 the same groups in
the same order as the JAX processor (two-batch regrouping by budget and
length), deliver through the async finalize worker without a follow-up
batch, hold FINALIZE_DEPTH, survive a dead result store, drain on `stop`,
and serve the serial `prefetch=False` mode. On the tiny engine (CPU, f32,
greedy) the pipelined answers equal the serial mode's. `build_app` splits
into ROLE=api (no engine, no torch) and ROLE=engine (no HTTP) over one
queue, and `/stats` has every key the JAX service's has.

Every test runs under a SIGALRM time limit of its own, so a hung worker
thread fails that test and not the run."""

import json
import os
import re
import signal
import threading
import time
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from rag_serving_system_tpu.core import batch_processor as jax_bp  # noqa: E402
from rag_serving_system_tpu.core import request_queue as jax_rq  # noqa: E402
from rag_serving_system_torch import main as port_main  # noqa: E402
from rag_serving_system_torch.core import batch_processor as port_bp  # noqa: E402
from rag_serving_system_torch.core import request_queue as port_rq  # noqa: E402

from test_torch_engine import (  # noqa: E402
    jax_engine, jax_settings, port_engine, tiny_settings)

TIME_LIMIT_S = 300


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


@pytest.fixture(autouse=True)
def default_pipeline_env(monkeypatch):
    for var in ("PREFETCH_WORKERS", "READY_DEPTH", "STAGE_PROMPTS", "FINALIZE_ASYNC",
                "FINALIZE_DEPTH", "NATIVE_FRONT_PORT", "ROLE"):
        monkeypatch.delenv(var, raising=False)


class _Prompt(str):
    """A prompt with the two fields the regrouping key reads."""
    def __new__(cls, text, gen_budget=None, sort_len=None):
        s = super().__new__(cls, text)
        s.gen_budget = gen_budget
        s.sort_len = len(text) if sort_len is None else sort_len
        return s


class StubEngine:
    """prompt = P:query, answer = ans:prompt; records what each stage saw."""

    class settings:
        max_new_tokens = 10

    def __init__(self, generate_s=0.0, finalize_s=0.0):
        self.groups = []          # stage 2's batches, in order
        self.threads = {}
        self.generate_s, self.finalize_s = generate_s, finalize_s

    def prepare(self, queries, ks, budgets=None):
        self.threads["prepare"] = threading.current_thread()
        budgets = budgets or [None] * len(queries)
        return [_Prompt(f"P:{q}", b) for q, b in zip(queries, budgets)]

    def generate_tokens(self, prompts, staged=None):
        self.threads["generate"] = threading.current_thread()
        self.groups.append((list(map(str, prompts)), staged))
        time.sleep(self.generate_s)
        return list(prompts)

    def finalize_tokens(self, handle):
        self.threads["finalize"] = threading.current_thread()
        time.sleep(self.finalize_s)
        return [f"ans:{p}" for p in handle]

    def process(self, queries, ks, budgets=None):
        self.threads["process"] = threading.current_thread()
        return [{"result": f"serial:{q}"} for q in queries]


def _queue(mod=port_rq, cap=4, **kw):
    kw = dict(dict(max_wait_time=0.05, polling_interval=0.01), **kw)
    return mod.RequestQueue(max_batch_size=cap, **kw)


def _results(q, rids, timeout=20):
    return [q.get_result(rid, timeout=timeout) for rid in rids]


# ---------------------------------------------------------------------------
# the pipeline on a stub engine
# ---------------------------------------------------------------------------

REQUESTS = [  # (query, max_new_tokens): lengths and budgets out of order
    ("long " * 40 + "q0", None), ("q1", 3), ("mid " * 9 + "q2", None), ("q3", None),
    ("long " * 30 + "q4", 3), ("q5", None), ("mid " * 5 + "q6", 8), ("q7", None),
    ("q8", None), ("long " * 20 + "q9", None), ("q10", 2), ("mid " * 3 + "q11", None),
]


def _run_stub(bp_mod, rq_mod, monkeypatch, workers="1", **proc_kw):
    monkeypatch.setenv("PREFETCH_WORKERS", workers)
    q = _queue(rq_mod)
    # enqueued before the start: the first get_batch sees a full batch and
    # a deep queue, which opens the two-batch window
    rids = [q.add_request(text, 1, mnt) for text, mnt in REQUESTS]
    engine = StubEngine()
    proc = bp_mod.BatchProcessor(q, engine, polling_interval=0.01, **proc_kw)
    proc.start()
    try:
        res = _results(q, rids)
    finally:
        proc.stop()
    return engine, res


def test_regrouping_order_matches_the_jax_processor(monkeypatch):
    """One stage-1 worker makes the order deterministic: 8 requests regrouped
    by (budget, length) into two batches, then the last 4 as they came."""
    ours, res = _run_stub(port_bp, port_rq, monkeypatch)
    ref, ref_res = _run_stub(jax_bp, jax_rq, monkeypatch)
    assert [g for g, _ in ours.groups] == [g for g, _ in ref.groups]
    assert res == ref_res == [{"result": f"ans:P:{text}"} for text, _ in REQUESTS]
    first = ours.groups[0][0]
    assert first[:2] == ["P:q1", "P:" + "long " * 30 + "q4"]     # budget 3 first
    assert [len(g) for g, _ in ours.groups] == [4, 4, 4]
    assert ours.groups[2][0] == [f"P:{text}" for text, _ in REQUESTS[8:]]


def test_length_aware_off_keeps_the_queue_order(monkeypatch):
    ours, res = _run_stub(port_bp, port_rq, monkeypatch, length_aware=False)
    ref, _ = _run_stub(jax_bp, jax_rq, monkeypatch, length_aware=False)
    assert [g for g, _ in ours.groups] == [g for g, _ in ref.groups]
    assert [g for g, _ in ours.groups] == [[f"P:{t}" for t, _ in REQUESTS[i:i + 4]]
                                           for i in (0, 4, 8)]


@pytest.mark.parametrize("workers", ["2", "3"])
def test_every_request_gets_its_own_answer_with_several_workers(monkeypatch, workers):
    ours, res = _run_stub(port_bp, port_rq, monkeypatch, workers=workers)
    assert res == [{"result": f"ans:P:{text}"} for text, _ in REQUESTS]
    assert sorted(p for g, _ in ours.groups for p in g) == sorted(
        f"P:{text}" for text, _ in REQUESTS)


@pytest.mark.parametrize("env,workers,ready,fin_async,fin_depth", [
    ({}, port_bp.DEFAULT_PREFETCH_WORKERS, port_bp.DEFAULT_PREFETCH_WORKERS, True, 2),
    ({"PREFETCH_WORKERS": "3"}, 3, 3, True, 2),
    ({"PREFETCH_WORKERS": "1", "READY_DEPTH": "4"}, 1, 4, True, 2),
    ({"READY_DEPTH": "0", "FINALIZE_DEPTH": "5"}, port_bp.DEFAULT_PREFETCH_WORKERS, 0, True, 5),
    ({"FINALIZE_ASYNC": "0", "FINALIZE_DEPTH": "0", "PREFETCH_WORKERS": "0"}, 1, 1, False, 1),
], ids=["defaults", "workers3", "ready4", "unbounded_ready", "sync_and_floors"])
def test_pipeline_settings_match_the_jax_processor(monkeypatch, env, workers, ready,
                                                   fin_async, fin_depth):
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    ours = port_bp.BatchProcessor(_queue(), StubEngine())
    assert (ours.prefetch_workers, ours._ready.maxsize, ours.finalize_async,
            ours._finalize_q.maxsize) == (workers, ready, fin_async, fin_depth)
    if "PREFETCH_WORKERS" in env:       # the default may differ, by measurement
        ref = jax_bp.BatchProcessor(_queue(jax_rq), StubEngine())
        assert (ref.prefetch_workers, ref._ready.maxsize, ref.finalize_async,
                ref._finalize_q.maxsize) == (workers, ready, fin_async, fin_depth)
    serial = port_bp.BatchProcessor(_queue(), StubEngine(), prefetch=False)
    assert serial.prefetch_workers == 0 and (serial.ready_backlog,
                                             serial.finalize_backlog) == (0, 0)


def test_async_finalize_delivers_without_a_followup_batch():
    q = _queue()
    engine = StubEngine()
    proc = port_bp.BatchProcessor(q, engine, polling_interval=0.01)
    assert proc.finalize_async
    proc.start()
    try:
        t0 = time.time()
        res = q.get_result(q.add_request("solo", 1), timeout=10)
        assert res == {"result": "ans:P:solo"} and time.time() - t0 < 2.0
        deadline = time.time() + 2
        while proc.batches_processed < 1 and time.time() < deadline:
            time.sleep(0.01)
        assert (proc.batches_processed, proc.requests_processed) == (1, 1)
        assert proc.last_batch_seconds > 0
    finally:
        proc.stop()
    # three stages, three threads
    assert len({engine.threads[k] for k in ("prepare", "generate", "finalize")}) == 3
    assert engine.threads["generate"] is proc


def test_finalize_depth_bounds_the_undelivered_batches(monkeypatch):
    monkeypatch.setenv("FINALIZE_DEPTH", "2")
    q = _queue(cap=2, max_wait_time=0.02)
    rids = [q.add_request(f"q{i}", 1) for i in range(12)]
    engine = StubEngine(finalize_s=0.05)
    proc = port_bp.BatchProcessor(q, engine, polling_interval=0.01)
    seen = []
    orig = proc._generate_and_store

    def spy(*a, **kw):
        orig(*a, **kw)
        seen.append(proc.finalize_backlog)

    proc._generate_and_store = spy
    proc.start()
    try:
        assert _results(q, rids) == [{"result": f"ans:P:q{i}"} for i in range(12)]
    finally:
        proc.stop()
    assert proc._finalize_q.maxsize == 2 and max(seen) <= 2


def test_sync_finalize_defers_one_batch_and_flushes_when_idle(monkeypatch):
    monkeypatch.setenv("FINALIZE_ASYNC", "0")
    q = _queue()
    engine = StubEngine()
    proc = port_bp.BatchProcessor(q, engine, polling_interval=0.01)
    proc.start()
    try:
        rids = [q.add_request(f"s{i}", 1) for i in range(8)]
        assert _results(q, rids) == [{"result": f"ans:P:s{i}"} for i in range(8)]
    finally:
        proc.stop()
    assert engine.threads["finalize"] is proc and proc._finalizer is None
    assert proc.requests_processed == 8


def test_serial_mode_runs_engine_process_on_one_thread():
    q = _queue()
    engine = StubEngine()
    proc = port_bp.BatchProcessor(q, engine, polling_interval=0.01, prefetch=False)
    proc.start()
    try:
        rids = [q.add_request(f"s{i}", 1) for i in range(6)]
        assert _results(q, rids) == [{"result": f"serial:s{i}"} for i in range(6)]
    finally:
        proc.stop()
        proc.join(timeout=5)
    assert engine.threads == {"process": proc} and not proc._prefetchers
    assert proc.requests_processed == 6 and not proc.is_alive()


def test_stage_prompts_runs_on_the_stage1_thread(monkeypatch):
    monkeypatch.setenv("STAGE_PROMPTS", "1")
    engine = StubEngine()
    engine.stage_prompts = lambda prompts: ("staged", len(prompts),
                                            threading.current_thread())
    q = _queue()
    proc = port_bp.BatchProcessor(q, engine, polling_interval=0.01)
    proc.start()
    try:
        rids = [q.add_request(f"s{i}", 1) for i in range(3)]
        assert all(r is not None for r in _results(q, rids))
    finally:
        proc.stop()
    assert engine.groups and all(st is not None and st[0] == "staged" and st[2] is not proc
                                 for _, st in engine.groups)


class FlakyQueue(port_rq.RequestQueue):
    """A result store that is down for its next `fail_next` calls."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.fail_next = 0

    def store_result(self, rid, result):
        if self.fail_next > 0:
            self.fail_next -= 1
            raise ConnectionError("result store down")
        return super().store_result(rid, result)


@pytest.mark.parametrize("broken", ["finalize", "generate", "prepare"])
def test_a_dead_result_store_does_not_kill_the_workers(broken):
    """The batch that meets the dead store is lost; the one after it is
    served by the same threads, whichever stage failed beside the store."""
    q = FlakyQueue(max_batch_size=2, max_wait_time=0.02, polling_interval=0.01)
    engine = StubEngine()
    if broken != "finalize":
        good = getattr(engine, "generate_tokens" if broken == "generate" else broken)
        state = {"fail": True}

        def flaky(*a, **kw):
            if state.pop("fail", False):
                raise RuntimeError("stage failed")
            return good(*a, **kw)

        setattr(engine, "generate_tokens" if broken == "generate" else "prepare", flaky)
    proc = port_bp.BatchProcessor(q, engine, polling_interval=0.01)
    proc.start()
    try:
        q.fail_next = 2
        lost = [q.add_request(f"lost{i}", 1) for i in range(2)]
        deadline = time.time() + 10
        while q.fail_next > 0 and time.time() < deadline:
            time.sleep(0.01)
        assert q.fail_next == 0
        rid = q.add_request("after", 1)
        assert q.get_result(rid, timeout=10) == {"result": "ans:P:after"}
        assert all(q.get_result(r, timeout=0) is None for r in lost)
        assert all(t.is_alive() for t in proc._prefetchers) and proc._finalizer.is_alive()
    finally:
        proc.stop()


def test_a_failed_generate_is_answered_and_counted_in_async_mode():
    q = _queue()
    engine = StubEngine()

    def boom(prompts, staged=None):
        raise RuntimeError("device lost")

    engine.generate_tokens = boom
    proc = port_bp.BatchProcessor(q, engine, polling_interval=0.01)
    proc.start()
    try:
        rids = [q.add_request(f"x{i}", 1) for i in range(3)]
        assert _results(q, rids) == [{"error": "device lost", "status": "failed"}] * 3
    finally:
        proc.stop()
    assert proc.requests_processed == 3 and proc.batches_processed >= 1


def test_stop_drains_dequeued_work(monkeypatch):
    """Requests in stage 1, prepared, generating or awaiting delivery when
    `stop(drain_timeout)` is called are answered before it returns; the
    workers are joined and the thread ends."""
    monkeypatch.setenv("PREFETCH_WORKERS", "2")
    q = _queue(cap=2, max_wait_time=0.02)
    engine = StubEngine(generate_s=0.05, finalize_s=0.05)
    proc = port_bp.BatchProcessor(q, engine, polling_interval=0.01)
    proc.start()
    rids = [q.add_request(f"d{i}", 1) for i in range(10)]
    deadline = time.time() + 10
    while q.queue_size() > 0 and time.time() < deadline:
        time.sleep(0.005)
    assert q.queue_size() == 0
    proc.stop(drain_timeout=10.0)
    assert [q.get_result(r, timeout=0) for r in rids] == [
        {"result": f"ans:P:d{i}"} for i in range(10)]
    assert proc._stage1_count == 0 and proc.ready_backlog == 0
    assert proc.finalize_backlog == 0
    proc.join(timeout=5)
    assert not proc.is_alive() and not any(t.is_alive() for t in proc._prefetchers)
    proc._finalizer.join(timeout=5)
    assert not proc._finalizer.is_alive()       # it left on run()'s sentinel
    assert proc.requests_processed == 10


def test_stop_without_start_delivers_the_deferred_batch(monkeypatch):
    monkeypatch.setenv("FINALIZE_ASYNC", "0")
    q = _queue()
    proc = port_bp.BatchProcessor(q, StubEngine())
    rid = q.add_request("held", 1)
    batch = q.get_batch()
    proc._generate_and_store(batch, ["P:held"])
    assert q.get_result(rid, timeout=0) is None and proc._pending is not None
    proc.stop()
    assert q.get_result(rid, timeout=0) == {"result": "ans:P:held"}


# ---------------------------------------------------------------------------
# the tiny engine through the pipeline
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(0)
    docs = [" ".join(f"w{rng.integers(0, 300)}" for _ in range(rng.integers(14, 24)))
            for _ in range(40)]
    return docs, rng.standard_normal((40, 64)).astype(np.float32)


def _serve(corpus, queries, budgets, **proc_kw):
    docs, emb = corpus
    s = tiny_settings(prefix_cache=True, prefix_pool_len=128, packed_prefill=True)
    engine = port_engine.RagEngine(s, docs, emb, device="cpu")
    q = port_rq.make_queue(s)
    rids = [q.add_request(text, 2, b) for text, b in zip(queries, budgets)]
    proc = port_bp.BatchProcessor(q, engine, polling_interval=0.01, **proc_kw)
    proc.start()
    try:
        res = _results(q, rids, timeout=240)
    finally:
        proc.stop(drain_timeout=5.0)
    return res, proc, engine


@pytest.mark.parametrize("workers,fin_async,stage", [("1", "1", "0"), ("2", "1", "0"),
                                                     ("2", "0", "1")])
def test_pipelined_answers_equal_the_serial_mode(corpus, monkeypatch, workers,
                                                 fin_async, stage):
    """13 greedy requests (batches of 4, regrouped, some on the prefix route,
    mixed budgets) through the pipeline: each answer equals the serial
    mode's, at 1 and 2 stage-1 workers, with the async and the deferred
    finalize, staged on either thread."""
    queries = [f"what is w{i} w{i + 1}" + " and more" * (i % 4) for i in range(13)]
    budgets = [None, 2, None, 5, None, None, 1, None, 3, None, None, 6, None]
    serial, _, _ = _serve(corpus, queries, budgets, prefetch=False)
    monkeypatch.setenv("PREFETCH_WORKERS", workers)
    monkeypatch.setenv("FINALIZE_ASYNC", fin_async)
    monkeypatch.setenv("STAGE_PROMPTS", stage)
    res, proc, engine = _serve(corpus, queries, budgets)
    assert all(isinstance(r, dict) and isinstance(r.get("result"), str) for r in serial)
    assert res == serial
    assert proc.requests_processed == 13
    assert {"embed_retrieve", "generate", "finalize"} <= set(engine.timer.summary())


# ---------------------------------------------------------------------------
# /stats and the roles
# ---------------------------------------------------------------------------

def _get(url):
    with urllib.request.urlopen(url, timeout=30) as r:
        return json.loads(r.read())


@pytest.mark.parametrize("with_engine", [True, False], ids=["role_all", "role_api"])
def test_stats_has_every_key_of_the_jax_service(corpus, with_engine):
    """The two services' /stats over like engines and processors: the same
    top-level keys (the JAX service's `native_front` aside, which needs its
    C++ front), so a client of one reads the other."""
    pytest.importorskip("aiohttp")
    from rag_serving_system_tpu.api import endpoints as jax_api
    from rag_serving_system_torch.api import endpoints as port_api

    docs, emb = corpus
    over = dict(prefix_cache=True, prefix_pool_len=128)
    if with_engine:
        je = jax_engine.RagEngine(jax_settings(**over), docs, emb)
        te = port_engine.RagEngine(tiny_settings(**over), docs, emb, device="cpu")
        jq, tq = _queue(jax_rq), _queue()
        japp = jax_api.create_api(jq, jax_bp.BatchProcessor(jq, je), je)
        tapp = port_api.create_api(tq, port_bp.BatchProcessor(tq, te), te)
    else:
        japp, tapp = jax_api.create_api(_queue(jax_rq)), port_api.create_api(_queue())
    jsrv, tsrv = jax_api.ServerThread(japp).start(), port_api.ServerThread(tapp).start()
    try:
        ref, ours = _get(jsrv.url + "/stats"), _get(tsrv.url + "/stats")
    finally:
        jsrv.stop()
        tsrv.stop()
    assert set(ours) == set(ref) - {"native_front"}
    if with_engine:
        assert {"ready_backlog", "finalize_backlog", "prefix_cache", "query_cache"} <= set(ours)
        assert ours["ready_backlog"] == ours["finalize_backlog"] == 0
    else:
        assert set(ours) == {"queue_size", "queue_wait_s"}


def _corpus_files(tmp_path, corpus):
    docs, emb = corpus
    (tmp_path / "docs.json").write_text(json.dumps(docs))
    np.save(tmp_path / "emb.npy", emb)
    return dict(document_text_file=str(tmp_path / "docs.json"),
                document_embeddings_file=str(tmp_path / "emb.npy"))


def test_role_split_api_and_engine_over_one_queue(corpus, tmp_path, monkeypatch):
    """ROLE=api serves HTTP with no engine in its process; ROLE=engine
    consumes the queue with no HTTP surface. Both wired to one in-memory
    queue (a stand-in for Redis): a request posted to the one is answered by
    the other."""
    pytest.importorskip("aiohttp")
    from rag_serving_system_torch.api.endpoints import ServerThread

    shared = _queue(cap=2, max_wait_time=0.1)
    monkeypatch.setattr(port_rq, "make_queue", lambda settings: shared)
    monkeypatch.setenv("TORCH_DEVICE", "cpu")
    s = tiny_settings(redis_url="redis://stub:6379", **_corpus_files(tmp_path, corpus))
    app, proc, eng, _ = port_main.build_app(settings=s, role="api")
    assert app is not None and proc is None and eng is None
    app2, proc2, eng2, _ = port_main.build_app(settings=s, warmup=False, role="engine")
    assert app2 is None and proc2.is_alive() and eng2 is not None
    srv = ServerThread(app).start()
    try:
        body = json.dumps({"query": "what is w3?", "k": 2}).encode()
        req = urllib.request.Request(srv.url + "/rag", data=body, method="POST",
                                     headers={"content-type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as r:
            rid = json.loads(r.read())["request_id"]
        res = _get(srv.url + f"/rag/result/{rid}?timeout=25")
        deadline = time.time() + 120
        while res["status"] != "complete" and time.time() < deadline:
            res = _get(srv.url + f"/rag/result/{rid}?timeout=25")
        assert res["status"] == "complete" and isinstance(res["result"]["result"], str)
        assert set(_get(srv.url + "/stats")) == {"queue_size", "queue_wait_s"}
    finally:
        srv.stop()
        proc2.stop(drain_timeout=2.0)


_FRONT_WITH_REDIS = {"NATIVE_FRONT_PORT": "9001", "REDIS_URL": "redis://stub:6379"}
_FRONT_REFUSED = ("NATIVE_FRONT_PORT requires the in-memory queue (single-replica "
                  "role=all); unset REDIS_URL or the front")


@pytest.mark.parametrize("role,env,match", [
    ("api", {}, "ROLE=api requires REDIS_URL"),
    ("engine", {}, "ROLE=engine requires REDIS_URL"),
    ("worker", {}, "ROLE=worker"),
    ("all", _FRONT_WITH_REDIS, re.escape(_FRONT_REFUSED)),
    ("engine", _FRONT_WITH_REDIS, re.escape(_FRONT_REFUSED)),
])
def test_build_app_refusals(monkeypatch, role, env, match):
    """api and engine without REDIS_URL exit as the root `main.py` does, an
    unknown role is named, and the native front beside a shared Redis queue
    is refused with the root `main.py`'s message, before any model is
    built."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    s = tiny_settings()
    assert s.redis_url == env.get("REDIS_URL")
    with pytest.raises(SystemExit, match=match):
        port_main.build_app(settings=s, role=role)


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def test_native_front_serves_beside_aiohttp(corpus, tmp_path, monkeypatch):
    """NATIVE_FRONT_PORT: `build_app` starts the port's C++ front over the
    in-memory queue, its in-flight cap from MAX_QUEUE_SIZE; the processor
    stores the front's results through FrontQueue, and aiohttp's /stats and
    /metrics carry the front's counters."""
    pytest.importorskip("aiohttp")
    from rag_serving_system_torch.api.endpoints import ServerThread
    from rag_serving_system_torch.api.native_front import FrontQueue

    port = _free_port()
    monkeypatch.setenv("NATIVE_FRONT_PORT", str(port))
    monkeypatch.setenv("MAX_QUEUE_SIZE", "50")
    monkeypatch.setenv("TORCH_DEVICE", "cpu")
    s = tiny_settings(redis_url=None, **_corpus_files(tmp_path, corpus))
    app, proc, eng, _ = port_main.build_app(settings=s, warmup=False, role="all")
    front = proc.request_queue._front
    srv = ServerThread(app).start()
    try:
        assert isinstance(proc.request_queue, FrontQueue) and front.port == port
        assert front._max_inflight == 50
        body = json.dumps({"query": "what is w3?", "k": 2}).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{port}/rag?wait=60", data=body,
                                     method="POST",
                                     headers={"content-type": "application/json"})
        with urllib.request.urlopen(req, timeout=90) as r:
            out = json.loads(r.read())
        assert out["status"] == "complete" and out["request_id"].startswith(front.id_prefix)
        assert isinstance(out["result"]["result"], str)
        stats = _get(srv.url + "/stats")["native_front"]
        assert stats["accepted"] == stats["completed"] == 1 and stats["port"] == port
        with urllib.request.urlopen(srv.url + "/metrics", timeout=30) as r:
            assert 'rag_native_front{counter="completed"} 1.0' in r.read().decode()
    finally:
        srv.stop()
        proc.stop(drain_timeout=2.0)
        front.stop()


def test_native_front_that_does_not_build_ends_the_process(monkeypatch):
    """No compiler for the front: the process exits with the reason (the
    root `main.py` would serve aiohttp only, behind a warning)."""
    from rag_serving_system_torch import native

    monkeypatch.setattr(native, "_libs", {})
    monkeypatch.setenv("CXX", "/nonexistent/c++")
    with pytest.raises(SystemExit, match="native front did not start.*nonexistent"):
        port_main._native_front(_queue(), _free_port())


def test_main_as_engine_blocks_until_sigterm_then_drains(monkeypatch):
    stopped = {}

    class Proc:
        def stop(self, drain_timeout=0.0):
            stopped["drain"] = drain_timeout

    seen = {}

    def fake_build_app(settings=None, warmup=True, role="all"):
        seen["role"] = role
        return None, Proc(), object(), None

    monkeypatch.setattr(port_main, "build_app", fake_build_app)
    monkeypatch.setenv("ROLE", "engine")
    monkeypatch.setenv("DRAIN_TIMEOUT", "7")
    old = {sig: signal.getsignal(sig) for sig in (signal.SIGTERM, signal.SIGINT)}
    t = threading.Timer(0.3, lambda: os.kill(os.getpid(), signal.SIGTERM))
    t.start()
    t0 = time.time()
    try:
        port_main.main()
    finally:
        t.cancel()
        for sig, h in old.items():
            signal.signal(sig, h)
    assert seen == {"role": "engine"} and stopped == {"drain": 7.0}
    assert 0.2 < time.time() - t0 < 10


def test_many_workers_under_a_short_switch_interval_lose_no_request(monkeypatch):
    """A stress run: 4 stage-1 workers (more than this pipeline needs), the
    async finalize worker, 240 requests in batches of 4 with mixed budgets,
    the interpreter switching threads every 10 microseconds. Every request
    gets its own answer exactly once, the counters add up, and nothing is
    left in flight."""
    import sys

    monkeypatch.setenv("PREFETCH_WORKERS", "4")
    monkeypatch.setenv("READY_DEPTH", "2")
    q = _queue(cap=4, max_wait_time=0.01)
    engine = StubEngine()
    proc = port_bp.BatchProcessor(q, engine, polling_interval=0.005)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        proc.start()
        rids = [q.add_request(f"r{i} " + "x " * (i % 7), 1, 1 + i % 5) for i in range(240)]
        res = _results(q, rids, timeout=60)
        proc.stop(drain_timeout=10.0)
        proc.join(timeout=10)
    finally:
        sys.setswitchinterval(old)
        proc.stop()
    assert res == [{"result": f"ans:P:r{i} " + "x " * (i % 7)} for i in range(240)]
    served = [p for g, _ in engine.groups for p in g]
    assert len(served) == len(set(served)) == 240
    assert not proc.is_alive() and proc.requests_processed == 240
    assert proc._stage1_count == 0 and proc.ready_backlog == proc.finalize_backlog == 0
