"""The open-loop schedule, the closed loop's warm-up and window, and latency
measured from when a request was due."""

from __future__ import annotations

import asyncio
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
from aiohttp import web

from conftest import ROOT
from perfbench import generator

HOT = {"arrivals": "poisson", "popularity": {"kind": "zipf", "s": 1.0}, "k": 2, "rate_rps": 50,
       "warmup": {"clients": 4, "closed_requests": 10, "open_seconds": 2}}
COLD = {"arrivals": "closed", "clients": 8, "popularity": {"kind": "cycle"}, "unique_tail": True,
        "k": 2, "warmup": {"closed_requests": 20}}


def _queries(reqs):
    return [r["query"] for r in reqs]


def test_open_schedule_same_work_every_seed():
    a = generator.Plan(HOT, 1, 20.0)
    b = generator.Plan(HOT, 2**31 + 12345, 20.0)
    for p in (a, b):
        due = np.asarray(p.open_due)
        assert len(due) == 50 * 2 + 50 * 20
        assert (np.diff(due) > 0).all() and due[0] >= 0
        win = due[due >= 2.0]
        assert len(win) == 1000 and win[-1] < 22.0
    assert a.open_due != b.open_due
    # the window's questions: one multiset, another order
    qa, qb = _queries(a.open_reqs)[100:], _queries(b.open_reqs)[100:]
    assert sorted(qa) == sorted(qb) and qa != qb
    # Zipf(1.0): the head carries most requests
    counts = np.bincount([generator.questions().index(q) for q in qa], minlength=1000)
    assert counts[:117].sum() / 1000 == pytest.approx(0.71, abs=0.05)


def test_closed_same_work_every_seed():
    # the first 1,000 requests ask every question once, each with the tail
    # and budget of its first asking, whatever the seed
    mix = dict(COLD, new_tokens=[10, 128])
    runs = []
    for seed in (3, 2**31 + 99):
        p = generator.Plan(mix, seed, 10.0)
        it = p.closed_reqs()
        runs.append(p.warmup_closed + [next(it) for _ in range(1000 - len(p.warmup_closed))])
    key = [sorted((r["query"], r["max_new_tokens"]) for r in reqs) for reqs in runs]
    assert key[0] == key[1]
    assert _queries(runs[0]) != _queries(runs[1])


def test_budgets_span_their_range():
    p = generator.Plan(dict(COLD, new_tokens=[10, 128]), 8, 10.0)
    it = p.closed_reqs()
    budgets = [next(it)["max_new_tokens"] for _ in range(3000)]
    assert min(budgets) == 10 and max(budgets) == 128
    assert abs(np.mean(budgets) - 69) < 3
    assert "max_new_tokens" not in generator.Plan(COLD, 8, 10.0).warmup_closed[0]


def test_bursts_double_the_rate_in_their_segments():
    mix = dict(HOT, rate_cycle=[[8, 1.0], [2, 2.0]], warmup={"open_seconds": 0})
    p = generator.Plan(mix, 11, 20.0)
    due = np.asarray(p.open_due)
    # 50/s for 8 s, 100/s for 2 s, twice
    assert len(due) == 2 * (400 + 200)
    burst = ((due % 10.0) >= 8.0).sum()
    assert burst == pytest.approx(400, rel=0.1)
    assert (np.diff(due) >= 0).all() and due[-1] < 20.0
    with pytest.raises(ValueError):
        generator.Plan(dict(mix, rate_cycle=[[0, 1.0]]), 11, 20.0)


def test_same_seed_same_plan():
    a, b = generator.Plan(HOT, 77, 10.0), generator.Plan(HOT, 77, 10.0)
    assert a.open_due == b.open_due and a.open_reqs == b.open_reqs
    c, d = generator.Plan(COLD, 77, 10.0), generator.Plan(COLD, 77, 10.0)
    ic, id_ = c.closed_reqs(), d.closed_reqs()
    assert c.warmup_closed == d.warmup_closed
    assert [next(ic) for _ in range(50)] == [next(id_) for _ in range(50)]


def test_closed_texts_unique_and_cycle():
    p = generator.Plan(COLD, 5, 10.0)
    it = p.closed_reqs()
    texts = [r["query"] for r in p.warmup_closed + [next(it) for _ in range(2500)]]
    assert len(set(texts)) == len(texts)
    bare = [t.rsplit(" (ref ", 1)[0] for t in texts[:1000]]
    assert sorted(bare) == sorted(generator.questions())


class SlowServer:
    """A stub of POST /rag that answers one request at a time, each after
    `delay` seconds: a queue builds up under an open loop."""

    def __init__(self, delay: float):
        self.delay = delay
        self.bodies: list = []
        self.loop = asyncio.new_event_loop()
        self.port = None
        self.ready = threading.Event()
        threading.Thread(target=self._run, daemon=True).start()
        self.ready.wait(10)

    def _run(self):
        asyncio.set_event_loop(self.loop)
        lock = asyncio.Lock()

        async def rag(request):
            self.bodies.append(await request.json())
            async with lock:
                await asyncio.sleep(self.delay)
            return web.json_response({"request_id": "x", "status": "complete",
                                      "result": {"result": "<11> <12>"}})
        app = web.Application()
        app.router.add_post("/rag", rag)
        runner = web.AppRunner(app)
        self.loop.run_until_complete(runner.setup())
        site = web.TCPSite(runner, "127.0.0.1", 0)
        self.loop.run_until_complete(site.start())
        self.port = runner.addresses[0][1]
        self.ready.set()
        self.loop.run_forever()


def _loadgen(tmp_path, mix, seconds, server=None):
    server = server or SlowServer(0.05)
    mix_path, out = tmp_path / "mix.json", tmp_path / "out.jsonl"
    mix_path.write_text(json.dumps(mix))
    t = time.time()
    p = subprocess.run([sys.executable, os.path.join(ROOT, "perfbench", "loadgen.py"), "--url",
                        f"http://127.0.0.1:{server.port}", "--mix", str(mix_path), "--seed", "3",
                        "--seconds", str(seconds), "--out", str(out)],
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    lines = p.stdout.split()
    assert lines[0] == "T0" and lines[-1] == "DONE"
    t0 = float(lines[1])
    assert t < t0 < time.time()
    return t0, [json.loads(x) for x in out.read_text().splitlines()]


def test_open_loop_latency_counts_from_due(tmp_path):
    # 40 requests/s against a server that answers 20/s: the queue grows
    mix = dict(HOT, rate_rps=40, warmup={"clients": 2, "closed_requests": 4, "open_seconds": 0.5})
    t0, recs = _loadgen(tmp_path, mix, 2.0)
    win = [r for r in recs if r["phase"] == "window"]
    assert len(win) == 80
    assert all(t0 <= r["due"] < t0 + 2.0 for r in win)
    assert all(r["send"] >= r["due"] - 1e-3 and r["done"] > r["send"] for r in win)
    lat = sorted(r["done"] - r["due"] for r in sorted(win, key=lambda r: r["due"])[-10:])
    # the last requests waited behind the backlog: far longer than one answer
    assert lat[0] > 1.0
    assert sum(r["phase"] == "warmup" for r in recs) >= 4


def test_closed_loop_window_opens_after_warmup(tmp_path):
    mix = dict(COLD, clients=4, warmup={"closed_requests": 8})
    t0, recs = _loadgen(tmp_path, mix, 1.0)
    warm = [r for r in recs if r["phase"] == "warmup"]
    win = [r for r in recs if r["phase"] == "window"]
    assert len(warm) >= 8 and win
    assert all(r["send"] >= t0 and r["send"] < t0 + 1.0 for r in win)
    assert all(0 <= r["send"] - r["due"] < 0.05 for r in win)
    assert all(r["status"] == "ok" and r["answer"] == "<11> <12>" for r in recs)


def test_budgets_are_sent_and_recorded(tmp_path):
    server = SlowServer(0.01)
    mix = dict(COLD, clients=2, new_tokens=[3, 7], warmup={"closed_requests": 4})
    _, recs = _loadgen(tmp_path, mix, 0.5, server)
    assert all(3 <= b["max_new_tokens"] <= 7 and b["k"] == 2 for b in server.bodies)
    sent = {b["query"]: b["max_new_tokens"] for b in server.bodies}
    assert all(r["max_new_tokens"] == sent[r["query"]] for r in recs)
