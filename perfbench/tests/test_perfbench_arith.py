"""Roofline, MFU and percentile arithmetic on known shapes."""

from __future__ import annotations

import math

import pytest

from perfbench import flops, readers
from perfbench.trace import summarize

QWEN = {"hidden_size": 1536, "intermediate_size": 8960, "num_hidden_layers": 28,
        "num_attention_heads": 12, "num_key_value_heads": 2, "vocab_size": 151936}
E5 = {"hidden_size": 1024, "intermediate_size": 4096, "num_hidden_layers": 24}


def test_topk_bound_is_the_corpus_read():
    # 1,048,576 x 1024 f32: 4.29 GB at 3.35 TB/s, as chip_smoke.py's bound
    s = flops.topk_least_s(1 << 20, 1024, 32, 16, "float32")
    assert s == pytest.approx((4 * 2**30 + 32 * 1024 * 4 + 32 * 16 * 8) / 3.35e12)
    assert s == pytest.approx(1.282e-3, rel=1e-3)
    # int8 adds a f32 scale a row; 0.322 ms in PERF.md's table
    assert flops.topk_least_s(1 << 20, 1024, 32, 16, "int8") == pytest.approx(0.3218e-3, rel=2e-3)


def test_packed_attention_bound():
    # the B3 case timed on the card: T = 8192, 6,373 real tokens, Hq 12, Hk 2, D 128
    lens = [200] * 31 + [173]
    s = flops.packed_attn_least_s(lens, 8192, 12, 2, 128)
    nbytes = 2 * (6373 * 16 * 128 + 8192 * 12 * 128)
    assert s == pytest.approx(nbytes / 3.35e12)
    assert s == pytest.approx(0.0153e-3, rel=0.02)


def test_decoder_flops():
    per_tok = 2 * (1536 * 2048 + 1536 * 1536 + 1536 * 17920 + 8960 * 1536)
    assert per_tok * 28 == pytest.approx(2 * 1.31e9, rel=0.01)
    one = flops.decoder_flops(QWEN, 0, 1, 0)
    assert one == pytest.approx(28 * (per_tok + 4 * 12 * 128 * 1))
    # a prompt of 350 and 10 generated: ~0.93 TFLOP, the head 10 times
    f = flops.decoder_flops(QWEN, 0, 359, 10)
    keys = 359 * 360 / 2
    assert f == pytest.approx(28 * (359 * per_tok + 4 * 12 * 128 * keys) + 2 * 1536 * 151936 * 10)
    assert 0.9e12 < f < 1.0e12
    # split at a cached prefix: the parts add up
    assert flops.decoder_flops(QWEN, 0, 100, 0) + flops.decoder_flops(QWEN, 100, 359, 10) == \
        pytest.approx(f)


def test_encoder_flops():
    n = 20
    assert flops.encoder_flops(E5, n) == pytest.approx(
        24 * (2 * n * (4 * 1024 ** 2 + 2 * 1024 * 4096) + 4 * n * n * 1024))


def test_percentile():
    assert readers.percentile([3, 1, 2], 0.5) == 2
    assert readers.percentile(list(range(101)), 0.95) == pytest.approx(95)
    assert readers.percentile([0, 10], 0.95) == pytest.approx(9.5)


def test_trace_summary_busy_and_gaps():
    ms = 1_000_000
    evs = [(0, 2 * ms, "a"), (1 * ms, 2 * ms, "b"), (5 * ms, 1 * ms, "a"), (9 * ms, 1 * ms, "c")]
    tr = summarize(evs, 0.010)
    assert tr.busy_s == pytest.approx(0.005)
    assert tr.by_name["a"] == (pytest.approx(0.003), 2)
    assert [g[1] for g in tr.gaps] == [pytest.approx(0.003), pytest.approx(0.002)]
    assert tr.gaps[0][0].endswith("c")
    assert tr.time_of("a|b") == (pytest.approx(0.005), 3)
    assert 100 * (1 - tr.busy_s / tr.window_s) == pytest.approx(50.0)


def test_model_flops_share_on_known_requests():
    class Run:
        pass
    r = Run()
    r.trace = type("T", (), {"window_s": 2.0, "t0": 0.0, "t1": 2.0})()
    r.t0, r.t1 = 0.0, 2.0
    r.config = {"encoder": dict(E5, vocab_size=250002, pad_token_id=1),
                "decoder": QWEN,
                "tokenizer": {"bos_id": 0, "encoder_eos_id": 2, "decoder_eos_id": 151645,
                              "decoder_pad_id": 151643}}
    r.docs = ["alpha beta gamma", "delta epsilon"]
    r.retrieved = {"q one": [0, 1]}
    r.facts = {"k": 2, "pool_len": 640}
    r.snap0 = r.snap1 = {"prefix": None}
    r.diag = {}
    rec = {"query": "q one", "status": "ok", "done": 1.0, "send": 0.5, "answer": "<11> <12>"}
    r.records = [rec]
    r.answered_in = lambda a, b: [x for x in r.records if a <= x["done"] < b]
    got = readers.model_flops_pct(r)
    from perfbench import reference as ref
    n_enc = len(ref.HashTokenizer(250002, 0, 2, 1).encode("query: q one"))
    n_prompt = len(ref.HashTokenizer(151936, 0, 151645, 151643).encode(
        ref.prompt_text("q one", r.docs)))
    want = flops.encoder_flops(E5, n_enc) + flops.decoder_flops(QWEN, 0, n_prompt + 1, 2)
    assert got == pytest.approx(100 * want / 2.0 / 989e12)
    assert math.isfinite(got)


def test_trace_that_lost_launches_is_named():
    from perfbench import run

    ms = 1_000_000
    names = ["void topk_partial_kernel<float>(...)", "void flash_wg_kernel<128, true>(...)",
             "void at::native::silu_kernel(...)"]
    evs = [(i * ms, ms // 2, names[i % 3]) for i in range(30)]
    tr = summarize(evs, 0.030)
    cfg = {"decoder": {"num_hidden_layers": 4}}

    def snap(topk, flash, gen):
        return {"launches": {"topk": topk, "flash": flash}, "stages": {"generate": (0.0, gen)}}
    # the program launched what the trace holds: 10 of each, 3 batches
    want = run.launch_counts(cfg, snap(5, 0, 1), snap(15, 10, 4))
    assert want["silu"] == 4 * 2 and not tr.lost(want)
    # a thread's kernels missing from the trace
    want = run.launch_counts(cfg, snap(0, 0, 0), snap(12, 10, 2))
    assert tr.lost(want) == [(run.TRACED_KERNELS["topk"], 10, 12)]
    want = run.launch_counts(cfg, snap(0, 0, 0), snap(0, 0, 5))
    assert tr.lost(want) == [("silu", 10, 16)]


def test_trace_is_taken_again_when_it_lost_launches(monkeypatch):
    from perfbench import run, trace

    ms = 1_000_000
    whole = [(i * ms, ms // 2, n) for i, n in enumerate(["topk_partial_kernel<float>"] * 3
                                                      + ["silu_kernel"] * 8)]
    reads = iter([whole[3:], whole, whole[:3], whole[:3]])   # lost stage 1, then whole

    class FakeTracer:
        def start(self):
            pass

        def stop(self):
            pass

        def read(self):
            return trace.summarize(list(next(reads)), 0.01)

    class FakeSystem:
        n = 0

        def snapshot(self):
            self.n += 3
            return {"launches": {"topk": self.n, "flash": 0},
                    "stages": {"generate": (0.0, self.n)}}

    monkeypatch.setattr(trace, "Tracer", FakeTracer)
    monkeypatch.setattr(run, "TRACE_SECONDS", 0.0)
    cfg = {"decoder": {"num_hidden_layers": 4}}
    diag = {}
    tr, _, _ = run.trace_segment(FakeSystem(), cfg, diag)
    assert tr.n_ops == 11 and len(diag["trace_tries"]) == 2
    assert diag["trace_tries"][0]["lost"] == [(run.TRACED_KERNELS["topk"], 0, 3)]
    with pytest.raises(RuntimeError, match="lost launches"):
        run.trace_segment(FakeSystem(), cfg, {})
