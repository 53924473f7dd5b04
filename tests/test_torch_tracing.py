"""PyTorch port: the stage timer's spans (`utils/timing.py`) and where the
port records them.

The span log is bounded, empty without a profiler and filled under one; its
stamps share `torch.profiler`'s clock; `add` counts steps. On the tiny
engine (CPU, f32, greedy) the `decode` count is the steps the decode loops
ran, and a batch's `stage_prompts`, `prefix_resolve`, `prefill` and
`decode` fit inside its `generate`. Through the processor every dequeued
request gets one `queue_wait`, and through HTTP every POST /rag one `http`.
`idle_by_span` puts synthetic idle gaps down to the right spans, and
`clock_ok` flags a trace whose device ops are stamped before their own
launch calls, and `host_shifts` finds skewed device stamps' places on the
host's clock by the launch calls, where `idle_by_span` moves the gaps.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_tracing.py -q
"""

import json
import threading
import time
import urllib.request
from unittest import mock

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile, record_function  # noqa: E402

from rag_serving_system_torch.config import Settings  # noqa: E402
from rag_serving_system_torch.core import batch_processor as port_bp  # noqa: E402
from rag_serving_system_torch.core import request_queue as port_rq  # noqa: E402
from rag_serving_system_torch.core.engine import RagEngine  # noqa: E402
from rag_serving_system_torch.models import qwen2 as tq  # noqa: E402
from rag_serving_system_torch.models.weights import init_decoder_params  # noqa: E402
from rag_serving_system_torch.utils import timing  # noqa: E402
from rag_serving_system_torch.utils.timing import (  # noqa: E402
    GENERATE_SELF, NO_BATCH, StageTimer, device_trace, idle_by_span)

QUERIES = ["what is w1 w2", "tell me w5", "w7 w8 w9 w10", "another question w3"]


def _cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


# ---------------------------------------------------------------------------
# the recorder
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("traced", [False, True], ids=["no_profiler", "profiler"])
def test_span_log_is_bounded_and_filled_only_under_a_profiler(traced):
    with mock.patch.object(timing, "SPAN_LOG_SIZE", 4):
        timer = StageTimer()
    ctx = _cpu_profile() if traced else mock.MagicMock()
    with ctx:
        assert timing.profiler_active() == traced
        for i in range(10):
            with timer.stage("outer"):
                timer.add("inner", 0.0, start_ns=time.time_ns(), id=i)
    assert timer.counts["outer"] == timer.counts["inner"] == 10
    if not traced:
        assert len(timer.spans) == 0
        return
    assert len(timer.spans) == 4                     # the newest four
    assert [s[0] for s in timer.spans] == ["inner", "outer"] * 2
    inner = timer.spans[-2]
    assert inner[4] == 9 and inner[5] == "outer"     # id; the open span is its parent
    assert inner[1] == threading.current_thread().name
    assert timer.spans[-1][5] is None and timer.spans[-1][2] <= inner[2]


def test_add_counts_steps_and_logs_its_interval():
    timer = StageTimer()
    with _cpu_profile():
        timer.add("decode", 0.5, n=9, start_ns=1_000)
        timer.add("decode", 0.25, n=3, start_ns=2_000)
        timer.add("http", 0.1, n=0, start_ns=5_000)
    with pytest.raises(TypeError):
        timer.add("decode", 0.25)                    # a span is stamped by its caller
    assert timer.counts["decode"] == 12 and timer.totals["decode"] == pytest.approx(0.75)
    s = timer.summary()
    assert s["decode"]["mean_s"] == pytest.approx(0.75 / 12)
    assert s["http"]["count"] == 0 and set(s["http"]) == {"total_s", "count", "mean_s"}
    first, second, third = timer.spans
    assert (first[2], first[3]) == (1_000, 1_000 + 500_000_000)
    assert (second[2], second[3]) == (2_000, 2_000 + 250_000_000)
    assert (third[2], third[3]) == (5_000, 5_000 + 100_000_000)


def test_span_stamps_share_the_profilers_clock():
    """A span around a `record_function` block holds the profiler's event,
    and starts within 1 ms of it (the best of five: scheduling only delays)."""
    timer = StageTimer()
    with _cpu_profile() as prof:
        with record_function("warm"):
            torch.ones(4).add_(1)
        for i in range(5):
            with timer.stage("span"):
                with record_function(f"rf{i}"):
                    torch.ones(64).add_(1)
    events = {e.name(): e for e in prof.profiler.kineto_results.events()}
    offsets = []
    for i, (name, _, t0, t1, _, _) in enumerate(timer.spans):
        ev = events[f"rf{i}"]
        assert t0 <= ev.start_ns() and ev.start_ns() + ev.duration_ns() <= t1
        offsets.append(ev.start_ns() - t0)
    assert min(offsets) < 1_000_000


def test_batch_numbers_tag_the_spans_and_map_to_requests():
    timer = StageTimer()
    with _cpu_profile():
        n = timer.number(["a", "b"])
        with timer.batch(n):
            with timer.stage("generate"):
                timer.add("prefill", 0.001, start_ns=time.time_ns())

        def finalize():                              # the number, on another thread
            with timer.batch(n), timer.stage("finalize"):
                pass

        t = threading.Thread(target=finalize, name="finalize")
        t.start()
        t.join()
        m = timer.number(["c"])
    assert m == n + 1
    assert list(timer.batch_log) == [(n, ("a", "b")), (m, ("c",))]
    by_name = {s[0]: s for s in timer.spans}
    assert by_name["prefill"][4] == by_name["generate"][4] == by_name["finalize"][4] == n
    assert by_name["prefill"][5] == "generate" and by_name["finalize"][5] is None
    assert by_name["finalize"][1] == "finalize"


# ---------------------------------------------------------------------------
# the engine's spans
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(0)
    docs = [" ".join(f"w{rng.integers(0, 300)}" for _ in range(rng.integers(14, 24)))
            for _ in range(40)]
    return docs, rng.standard_normal((40, 64)).astype(np.float32)


def _engine(corpus, **over):
    base = dict(model_preset="tiny", dtype="float32", do_sample=False, prefix_cache=False,
                batch_buckets=[1, 4], max_batch_size=4, encode_len_buckets=[16, 32],
                prompt_len_buckets=[32, 128], packed_t_step=256, max_new_tokens=6, max_k=4,
                max_wait_time=0.05, polling_interval=0.01, decode_mode="fixed",
                quant_weights="none", quant_act="none", retrieval_corpus_dtype="float32",
                retriever="exact", spec_gamma=0, mesh_shape="", weights_dir=None,
                embed_model_name="e5", llm_model_name="qwen", prefix_pool_len=128)
    base.update(over)
    docs, emb = corpus
    engine = RagEngine(Settings(**base), docs, emb, device="cpu")
    # varied greedy answers, so that rows stop at different steps
    fp = init_decoder_params(engine.dec_cfg, seed=1, dtype=torch.float32, device="cpu")
    for key in ("qkv_w", "o_w", "gu_w", "down_w"):
        fp["layers"][key] *= 8.0
    fp["embed"] *= 8.0
    engine.dec_params = fp
    return engine


@pytest.mark.parametrize("gamma", [0, 3], ids=["one_token", "speculative"])
@pytest.mark.parametrize("prefix", [False, True], ids=["packed", "prefix"])
def test_decode_count_is_the_steps_the_loop_ran(corpus, gamma, prefix):
    engine = _engine(corpus, spec_gamma=gamma, prefix_cache=prefix)
    ran = []
    loop = tq._spec_decode_loop if gamma else tq._decode_loop

    def counted(*a, **kw):
        out = loop(*a, **kw)
        ran.append(out[1])
        return out

    with mock.patch.object(tq, loop.__name__, counted):
        for budgets in ([None] * 4, [2, 6, 1, 4]):
            engine.process(QUERIES, [2] * 4, budgets)
    assert len(ran) == 2 and sum(ran) > 0
    assert engine.timer.counts["decode"] == sum(ran)
    assert engine.timer.counts["prefill"] == engine.timer.counts["generate"] == 2


@pytest.mark.parametrize("prefix", [False, True], ids=["packed", "prefix"])
def test_children_fit_inside_generate(corpus, prefix):
    """One batch: its children are sequential on the stage-2 thread, so
    their spans add up to no more than `generate`, and each names it."""
    engine = _engine(corpus, prefix_cache=prefix)
    prompts = engine.prepare(QUERIES, [2] * 4)
    engine.timer.reset()
    with _cpu_profile():
        n = engine.timer.number(["r0", "r1", "r2", "r3"])
        with engine.timer.batch(n), engine.timer.stage("generate"):
            engine.finalize_tokens(engine.generate_tokens(prompts))
    t = engine.timer.totals
    children = ["stage_prompts", "prefill", "decode"] + (["prefix_resolve"] if prefix else [])
    assert set(children) <= set(t)
    assert sum(t[c] for c in children) <= t["generate"]
    spans = {s[0]: s for s in engine.timer.spans}
    gen = spans["generate"]
    for c in children:
        name, thread, t0, t1, sid, parent = spans[c]
        assert parent == "generate" and sid == n and thread == gen[1]
        assert gen[2] <= t0 <= t1 <= gen[3]
    # prefill ends where decode begins: at the decode loop's first host read
    assert spans["prefill"][3] == spans["decode"][2]


# ---------------------------------------------------------------------------
# the processor and HTTP
# ---------------------------------------------------------------------------

class _StubEngine:
    """prompt = P:query, answer = ans:prompt, with a stage timer."""

    class settings:
        max_new_tokens = 10

    def __init__(self):
        self.timer = StageTimer()

    def prepare(self, queries, ks, budgets=None):
        with self.timer.stage("embed_retrieve"):
            return [f"P:{q}" for q in queries]

    def generate_tokens(self, prompts, staged=None):
        return list(prompts)

    def finalize_tokens(self, handle):
        return [f"ans:{p}" for p in handle]

    def process(self, queries, ks, budgets=None):
        return [{"result": f"serial:{q}"} for q in queries]

    def query_cache_stats(self):
        return None

    prefix_cache = None


@pytest.mark.parametrize("prefetch", [True, False], ids=["pipeline", "serial"])
def test_queue_wait_once_per_dequeued_request(prefetch):
    engine = _StubEngine()
    q = port_rq.RequestQueue(max_batch_size=4, max_wait_time=0.05, polling_interval=0.01)
    rids = [q.add_request(f"q{i}", 1) for i in range(10)]
    # an item without a timestamp is dequeued but not timed
    q.queue.put({"id": "no-ts", "query": "q", "k": 1})
    proc = port_bp.BatchProcessor(q, engine, polling_interval=0.01, prefetch=prefetch)
    with _cpu_profile():
        t_start = time.time_ns()
        proc.start()
        try:
            got = [q.get_result(r, timeout=20) for r in rids + ["no-ts"]]
        finally:
            proc.stop(drain_timeout=5.0)
    assert all(isinstance(r, dict) for r in got)
    assert engine.timer.counts["queue_wait"] == 10
    waits = [s for s in engine.timer.spans if s[0] == "queue_wait"]
    assert sorted(s[4] for s in waits) == sorted(rids)
    assert all(s[2] < t_start <= s[3] for s in waits)   # enqueued before the start
    assert all(s[1].startswith("stage-1" if prefetch else "stage-2") for s in waits)
    # a batch's number, minted once, is carried from stage 1 to finalize
    logged = dict(engine.timer.batch_log)
    assert len(logged) == len(engine.timer.batch_log)
    by_stage = {name: [sid for n, _, _, _, sid, _ in engine.timer.spans if n == name]
                for name in ("embed_retrieve", "generate", "finalize")}
    if prefetch:
        assert sorted(by_stage["generate"]) == sorted(by_stage["finalize"])
        assert set(by_stage["generate"]) <= set(logged)
        assert set(by_stage["embed_retrieve"]) <= set(logged)
        # every group generated holds requests its stage-1 batch prepared
        assert sorted(r for n in by_stage["generate"] for r in logged[n]) == sorted(
            rids + ["no-ts"])


def _post(url, wait):
    body = json.dumps({"query": "what is w3?", "k": 2}).encode()
    req = urllib.request.Request(f"{url}/rag?wait={wait}", data=body, method="POST",
                                 headers={"content-type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


@pytest.mark.parametrize("wait", [10, 0], ids=["wait", "no_wait"])
def test_post_rag_records_one_http_span(wait):
    pytest.importorskip("aiohttp")
    from rag_serving_system_torch.api.endpoints import ServerThread, create_api

    engine = _StubEngine()
    q = port_rq.RequestQueue(max_batch_size=4, max_wait_time=0.05, polling_interval=0.01)
    proc = port_bp.BatchProcessor(q, engine, polling_interval=0.01)
    srv = ServerThread(create_api(q, proc, engine)).start()
    proc.start()
    try:
        with _cpu_profile():
            t0 = time.time_ns()
            res = _post(srv.url, wait)
            t1 = time.time_ns()
        stats = json.loads(urllib.request.urlopen(srv.url + "/stats", timeout=30).read())
    finally:
        srv.stop()
        proc.stop(drain_timeout=5.0)
    assert res["status"] == ("complete" if wait else "processing")
    assert engine.timer.counts["http"] == 1
    pieces = [s for s in engine.timer.spans if s[0] == "http"]
    assert len(pieces) == 2 and {s[4] for s in pieces} == {res["request_id"]}
    assert all(t0 <= s[2] <= s[3] <= t1 and s[1] == "http" for s in pieces)
    handler_s = engine.timer.totals["http"]
    assert 0 < handler_s < (t1 - t0) * 1e-9
    assert stats["stages"]["http"]["count"] == 1


def test_stats_lists_the_stages(corpus):
    pytest.importorskip("aiohttp")
    from rag_serving_system_torch.api.endpoints import ServerThread, create_api

    engine = _engine(corpus, prefix_cache=True)
    engine.process(QUERIES, [2] * 4)
    q = port_rq.RequestQueue(max_batch_size=4)
    srv = ServerThread(create_api(q, port_bp.BatchProcessor(q, engine), engine)).start()
    try:
        stats = json.loads(urllib.request.urlopen(srv.url + "/stats", timeout=30).read())
        metrics = urllib.request.urlopen(srv.url + "/metrics", timeout=30).read().decode()
    finally:
        srv.stop()
    stages = stats["stages"]
    assert {"embed_retrieve", "generate", "stage_prompts", "prefix_resolve", "prefill",
            "decode"} <= set(stages)
    assert all(set(v) == {"total_s", "count", "mean_s"} for v in stages.values())
    assert stages["decode"]["count"] >= stages["generate"]["count"] == 1
    assert 'rag_stage_seconds{stage="decode"}' in metrics


# ---------------------------------------------------------------------------
# idle gaps put down to spans
# ---------------------------------------------------------------------------

US = 1_000


def _span(name, t0_us, t1_us, thread="stage-2", sid=1, parent=None):
    return (name, thread, t0_us * US, t1_us * US, sid, parent)


def test_idle_by_span_on_synthetic_intervals():
    spans = [
        _span("generate", 1000, 2000),
        _span("stage_prompts", 1000, 1100, parent="generate"),
        _span("prefill", 1150, 1400, parent="generate"),
        _span("decode", 1400, 1900, parent="generate"),
        _span("embed_retrieve", 500, 800, thread="stage-1-0"),
        _span("queue_wait", 100, 700, thread="stage-1-0", sid="r1"),
        _span("queue_wait", 200, 600, thread="stage-1-0", sid="r2"),
    ]
    ops = [(0, 200 * US),                   # busy 0-200
           (400 * US, 100 * US),            # gap 200-400: no batch ready
           (1050 * US, 10 * US),            # gap 500-1050: no batch, then stage_prompts
           (1065 * US, 30 * US),            # a 5 us gap: launch spacing, ignored
           (1500 * US, 50 * US),            # gap 1095-1500: stage_prompts, self, prefill, decode
           (1950 * US, 10 * US),            # gap 1550-1950: decode, then generate (self)
           (2100 * US, 10 * US)]            # gap 1960-2100: self, then no batch ready
    got = idle_by_span(ops, spans, [0] * len(ops))
    assert got["gaps"] == 5
    assert got["idle_s"] == pytest.approx((200 + 550 + 405 + 400 + 140) * 1e-6)
    want = {NO_BATCH: 200 + 500 + 100, "stage_prompts": 50 + 5, GENERATE_SELF: 50 + 50 + 40,
            "prefill": 250, "decode": 100 + 350}
    assert got["by_span"] == pytest.approx({k: v * 1e-6 for k, v in want.items()})
    assert sum(got["by_span"].values()) == pytest.approx(got["idle_s"])
    # beside "no batch ready": queue waits (a union: 200-400 and 500-700)
    # and stage 1's embed_retrieve (500-800)
    assert got["beside"][NO_BATCH] == pytest.approx({"queue_wait": 400e-6,
                                                     "embed_retrieve": 300e-6})
    assert "queue_wait" not in got["beside"].get("decode", {})
    # on a device clock 5 ms ahead of the host's, moved back by the shifts
    ahead = [(s + 5_000_000, d) for s, d in ops]
    assert idle_by_span(ahead, spans, shifts=[5_000_000] * len(ops)) == got


def test_idle_by_span_without_a_batch_or_a_gap():
    ops = [(0, 100 * US), (300 * US, 100 * US)]
    assert idle_by_span(ops, [], [0, 0])["by_span"] == pytest.approx({NO_BATCH: 200e-6})
    assert idle_by_span([(0, 100 * US)], [_span("generate", 0, 50)], [0])["gaps"] == 0


def test_device_trace_writes_the_spans_as_host_tracks(tmp_path):
    timer = StageTimer()
    with device_trace(str(tmp_path), device="cpu", spans=timer) as prof:
        with timer.batch(timer.number(["r0"])), timer.stage("generate"):
            timer.add("prefill", 0.0005, start_ns=time.time_ns())
            torch.ones(8).add_(1)
    assert prof.clock_ok is True                   # no device op on the CPU
    assert prof.idle_by_span["gaps"] == 0
    (path,) = list(tmp_path.glob("trace_*.json"))
    trace = json.loads(path.read_text())
    tracks = [e for e in trace["traceEvents"] if e.get("cat") == "span"]
    assert sorted(e["name"] for e in tracks) == ["generate", "prefill"]
    gen = next(e for e in tracks if e["name"] == "generate")
    assert gen["args"]["requests"] == ["r0"] and gen["dur"] > 0
    ops = [e for e in trace["traceEvents"] if e.get("name") == "aten::ones"]
    assert ops and gen["ts"] <= ops[0]["ts"] <= gen["ts"] + gen["dur"]


@pytest.mark.parametrize("ops, want", [
    ([(1_010, 5, 1_000), (2_030, 5, 2_000)], True),
    ([(1_010, 5, 1_000), (1_990, 5, 2_000)], False),          # stamped before its call
    ([(1_010, 5, 1_000), (2_030, 5, None)], True),            # one call not traced
    ([(1_010, 5, None)], None),                               # no call in the trace
    ([], True),                                               # no device op
], ids=["after", "before_its_launch", "partly_matched", "unmatched", "no_ops"])
def test_clock_ok_flags_ops_stamped_before_their_launch_calls(ops, want):
    assert timing.clock_ok(ops) is want


def test_host_shifts_place_ops_by_their_launch_calls():
    """A device clock 0.78 ms off that runs 12% fast for 4 ms, then jumps
    back, with ops launched onto an idle device (5 us latency), queues of
    ten ops launched at once and a launch call the trace lost: most ops land
    exactly on their host times, and none further off than a queue's ramp."""
    true, launch, dur = [], [], []
    t = 0
    for i in range(400):
        if i % 40 == 20:                       # ten ops launched together: a queue
            for k in range(10):
                launch.append(t)
                true.append(t + 5_000 + k * 20_000)
                dur.append(20_000)
            t += 10 * 20_000 + 50_000
        else:
            launch.append(t)
            true.append(t + 5_000)
            dur.append(4_000)
            t += 37_000

    def device(x):
        ramp = min(max(x - 2_000_000, 0), 4_000_000) * 0.12 if x < 6_000_000 else 0
        return round(x + 777_000 + ramp)

    # a queued op's device duration spans to the next one's device start
    ops = [(device(x), device(x + n) - device(x), c) for x, n, c in zip(true, dur, launch)]
    ops[7] = (ops[7][0], ops[7][1], None)
    assert timing.clock_ok(ops) is True       # late stamps pass the check
    placed = [(s - sh, d) for (s, d, _), sh in zip(ops, timing.host_shifts(ops))]
    # at its launch call where the device was idle (5 us before its true
    # start); off by no more than the ramp over a queue and the anchors
    # of a window
    err = sorted(abs(s - (x - 5_000)) for (s, _), x in zip(placed, true))
    ramp = 0.12 * (10 * 20_000 + 2 * timing.ALIGN_WINDOW * 37_000)
    assert err[len(err) // 2] == 0 and err[-1] <= ramp
    early = [(s - 3_000_000, d, c) for s, d, c in ops]      # 3 ms early: flagged,
    assert timing.clock_ok(early) is False                   # and placed alike
    assert [(s - sh, d) for (s, d, _), sh in zip(early, timing.host_shifts(early))] == placed
    assert timing.host_shifts([]) == [] and timing.host_shifts([(5, 1, None)]) is None


def test_device_trace_places_the_gaps_by_the_launch_calls(tmp_path):
    """A trace whose device stamps run 5 ms early: flagged, and its idle
    gap still put down to the span it lies in on the host's clock."""
    timer = StageTimer()
    t0 = time.time_ns()
    dec = t0 + 1_000_000                       # two launches inside the decode span
    ops = [(dec - 5_000_000, 1_000, dec), (dec + 400_000 - 5_000_000, 1_000, dec + 400_000)]
    window = [("generate", "stage-2", t0 - 1, t0 + 3_000_000, 1, None),
              ("decode", "stage-2", t0, t0 + 2_000_000, 1, "generate")]
    with mock.patch.object(timing, "read_trace", return_value=ops), \
            mock.patch.object(timer, "window", return_value=window):
        with device_trace(str(tmp_path), device="cpu", spans=timer) as prof:
            pass
    assert prof.clock_ok is False
    assert prof.idle_by_span["by_span"] == pytest.approx({"decode": 399_000e-9})


def test_device_trace_without_launch_calls_puts_no_gap_down(tmp_path):
    timer = StageTimer()
    ops = [(0, 1_000, None), (50_000, 1_000, None)]
    with mock.patch.object(timing, "read_trace", return_value=ops):
        with device_trace(str(tmp_path), device="cpu", spans=timer) as prof:
            with timer.batch(timer.number(["r0"])), timer.stage("generate"):
                pass
    assert prof.clock_ok is None and prof.idle_by_span is None
    (path,) = list(tmp_path.glob("trace_*.json"))
    tracks = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("cat") == "span"]
    assert [e["name"] for e in tracks] == ["generate"]       # the host tracks still
