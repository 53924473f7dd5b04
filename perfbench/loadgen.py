"""The load generator, run as its own process so that its interpreter lock is
not the server's:

    python perfbench/loadgen.py --url http://127.0.0.1:PORT --mix FILE \
        --seed N --seconds S --grace G --out FILE

It sends `POST /rag?wait=30` (polling `GET /rag/result/<id>` if the answer
takes longer) on the plan of `perfbench/generator.py`: first the closed-loop
warm-up, then the mix's own loop. It prints `T0 <time>` on standard output
when the timed window opens (a wall-clock time, which may lie in the near
future), writes one JSON line a request to `--out` (its phase, query,
budget, due, send and answer times, status and answer), then prints `DONE`.
A window request's latency counts from when it was due, not from when it
was sent; how late the generator sent them goes to standard error. A
request of the window is waited for until `--grace` seconds after the
window closes; one that has no answer by then is recorded as `timeout`.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import aiohttp  # noqa: E402

from perfbench.generator import Plan  # noqa: E402

WARMUP_TIMEOUT_S = 120.0


async def _ask(session, url: str, body: dict, deadline: float) -> tuple:
    """(status, answer text or None) of one request."""
    try:
        async with session.post(f"{url}/rag?wait=30", json=body) as r:
            if r.status != 200:
                return f"http_{r.status}", None
            body = await r.json()
        while body.get("status") != "complete":
            left = deadline - time.time()
            if left <= 0:
                return "timeout", None
            async with session.get(f"{url}/rag/result/{body['request_id']}",
                                   params={"timeout": str(min(30.0, left))}) as r:
                if r.status != 200:
                    return f"http_{r.status}", None
                body = dict(await r.json(), request_id=body["request_id"])
        res = body.get("result") or {}
        if "result" not in res:
            return "failed", json.dumps(res)[:200]
        return "ok", res["result"]
    except (aiohttp.ClientError, asyncio.TimeoutError, ValueError) as e:
        return "error", repr(e)[:200]


class Run:
    def __init__(self, args):
        self.url = args.url
        self.seconds = float(args.seconds)
        self.grace = float(args.grace)
        with open(args.mix, encoding="utf-8") as f:
            self.plan = Plan(json.load(f), args.seed, args.seconds)
        self.records: list = []
        self.warm_done = 0
        self.t0 = None
        self.t1 = None

    def announce(self, t0: float) -> None:
        self.t0, self.t1 = t0, t0 + self.seconds
        print(f"T0 {t0!r}", flush=True)

    async def one(self, session, body: dict, due: float, phase: str) -> None:
        send = time.time()
        deadline = (self.t1 + self.grace) if phase == "window" else send + WARMUP_TIMEOUT_S
        try:
            status, text = await asyncio.wait_for(
                _ask(session, self.url, body, deadline), timeout=max(1.0, deadline - send))
        except asyncio.TimeoutError:
            status, text = "timeout", None
        done = time.time()
        self.records.append({"phase": phase, "query": body["query"],
                             "max_new_tokens": body.get("max_new_tokens"), "due": due,
                             "send": send, "done": done, "status": status, "answer": text})
        if phase != "window":
            self.warm_done += 1

    async def closed(self, session, reqs, clients: int, warm: int,
                     window: bool = True) -> None:
        """`clients` callers over `reqs`; with `window`, the window opens
        when `warm` answers have come back (at once when `warm` is 0) and no
        caller sends once it has closed; without, every request is warm-up."""
        it = iter(reqs)
        if window and warm == 0:
            self.announce(time.time())

        async def caller():
            while True:
                now = time.time()
                if self.t1 is not None and now >= self.t1:
                    return
                try:
                    q = next(it)
                except StopIteration:
                    return
                phase = "window" if self.t0 is not None and now >= self.t0 else "warmup"
                await self.one(session, q, now, phase)
                if window and self.t0 is None and self.warm_done >= warm:
                    self.announce(time.time())

        await asyncio.gather(*(caller() for _ in range(clients)))

    async def open(self, session) -> None:
        p = self.plan
        s0 = time.time() + 0.2
        self.announce(s0 + p.open_warm_s)
        tasks = []
        for off, q in zip(p.open_due, p.open_reqs):
            due = s0 + off
            wait = due - time.time()
            if wait > 0:
                await asyncio.sleep(wait)
            phase = "window" if due >= self.t0 else "warmup"
            tasks.append(asyncio.ensure_future(self.one(session, q, due, phase)))
        await asyncio.gather(*tasks)

    async def main(self) -> None:
        conn = aiohttp.TCPConnector(limit=0, force_close=False)
        async with aiohttp.ClientSession(connector=conn,
                                         timeout=aiohttp.ClientTimeout(total=None)) as s:
            p = self.plan
            if p.mix["arrivals"] == "poisson":
                if p.warmup_closed:
                    await self.closed(s, p.warmup_closed, p.warm_clients,
                                      warm=len(p.warmup_closed), window=False)
                await self.open(s)
            else:
                reqs = _chain(p.warmup_closed, p.closed_reqs())
                await self.closed(s, reqs, int(p.mix["clients"]),
                                  warm=len(p.warmup_closed))


def _chain(first: list, rest):
    yield from first
    yield from rest


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--url", required=True)
    ap.add_argument("--mix", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--grace", type=float, default=60.0)
    ap.add_argument("--out", required=True)
    args = ap.parse_args()
    run = Run(args)
    asyncio.run(run.main())
    late = sorted(r["send"] - r["due"] for r in run.records if r["phase"] == "window")
    if late:
        print(f"loadgen: {len(late)} window requests; sent late by median "
              f"{late[len(late) // 2]:.6f} s, p99 {late[int(0.99 * (len(late) - 1))]:.6f} s, "
              f"max {late[-1]:.6f} s", file=sys.stderr, flush=True)
    with open(args.out, "w", encoding="utf-8") as f:
        for r in run.records:
            f.write(json.dumps(r) + "\n")
    print("DONE", flush=True)


if __name__ == "__main__":
    main()
