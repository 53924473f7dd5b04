"""Traffic from a mix's parameters and a seed: the one generator every mix
file (`perfbench/traffic/<mix>.json`) is read by. A new traffic shape is a
new file of these parameters:

- `arrivals`: `"poisson"` (open loop: each request due at its own time, at
  `rate_rps` a second on average) or `"closed"` (`clients` callers, each
  sending its next request when the last one is answered);
- `rate_cycle` (Poisson only, optional): `[[seconds, factor], ...]`, the
  rate as `factor` times `rate_rps` through each segment, the segments
  repeating from the schedule's start (bursts: `[[8, 1], [2, 2]]`);
- `popularity`: which of squad_real's 1,000 questions each request asks:
  `{"kind": "zipf", "s": ...}` (question r at rank r) or `{"kind": "cycle"}`
  (every question once in the seed's order, again and again);
- `unique_tail`: append a tag no other request of the run carries;
- `new_tokens` (optional): `[lo, hi]`, each request's own generation budget
  (`max_new_tokens` of `POST /rag`), from lo to hi; without it the
  service's `MAX_NEW_TOKENS` holds;
- `k`: the passages a request asks for;
- `warmup`: `closed_requests` sent by `clients` callers first, then for a
  Poisson mix `open_seconds` of its own arrivals before the window.

Every seed gets the same work in another order: the gaps between arrivals
and the popularity ranks are one fixed multiset (drawn from a fixed
stream), which the run's seed permutes, and a request's tail and budget
follow from its question and how often the run has asked it, not from the
seed. So the count of requests in the window, the questions and the work
each one is do not move with the seed; only their order does.

The open-loop schedule is a copy of `benchmarks/load_generator.py`'s
Poisson trace (exponential gaps at 1/rate), with the count fixed.
"""

from __future__ import annotations

import json
import os

import numpy as np

from perfbench.spec import BENCH_DIR

FIXED_STREAM = 20240601    # the multisets every seed shares


def questions(bench_dir: str = BENCH_DIR) -> list:
    with open(os.path.join(bench_dir, "data", "squad_real_queries.json"), encoding="utf-8") as f:
        return json.load(f)


def contexts(bench_dir: str = BENCH_DIR) -> list:
    with open(os.path.join(bench_dir, "data", "squad_real_contexts.json"), encoding="utf-8") as f:
        return json.load(f)


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one use of a seed (any whole number)."""
    words = [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF,
             *(ord(c) for c in tag)]
    return int(np.random.SeedSequence(words).generate_state(2, np.uint64)[0] >> np.uint64(1))


def zipf_ranks(n: int, n_items: int, s: float, rng: np.random.Generator) -> np.ndarray:
    """n ranks in [0, n_items) with P(r) proportional to 1 / (r + 1)^s."""
    p = 1.0 / np.arange(1, n_items + 1, dtype=np.float64) ** s
    return rng.choice(n_items, size=n, p=p / p.sum())


def rate_breaks(seconds: float, cycle: list | None) -> tuple:
    """(times, cumulative expected arrivals over the mean-rate-1 schedule) at
    the segment edges of `cycle` over [0, seconds]: piecewise linear."""
    if not cycle:
        return np.array([0.0, seconds]), np.array([0.0, seconds])
    if any(float(length) <= 0 or float(factor) < 0 for length, factor in cycle):
        raise ValueError(f"rate_cycle {cycle!r}: segments last > 0 s at a factor >= 0")
    times, acc, t = [0.0], [0.0], 0.0
    while t < seconds:
        for length, factor in cycle:
            step = min(float(length), seconds - t)
            t += step
            times.append(t)
            acc.append(acc[-1] + step * float(factor))
            if t >= seconds:
                break
    return np.array(times), np.array(acc)


def expected_count(rate: float, seconds: float, cycle: list | None = None) -> int:
    """The requests a Poisson mix sends in `seconds`: its rate's integral."""
    return int(round(rate * rate_breaks(seconds, cycle)[1][-1]))


def poisson_offsets(n: int, seconds: float, seed: int, cycle: list | None = None) -> np.ndarray:
    """n due times in [0, seconds): one fixed multiset of exponential gaps,
    in the seed's order, spread over the window by the cycle's rate (the
    time change of an inhomogeneous Poisson process)."""
    gaps = np.random.default_rng(FIXED_STREAM).exponential(1.0, size=n + 1)
    gaps = np.random.default_rng(sub_seed(seed, "gaps")).permutation(gaps)
    times, acc = rate_breaks(seconds, cycle)
    u = np.cumsum(gaps)[:n] / gaps.sum() * acc[-1]
    return np.interp(u, acc, times)


class Plan:
    """The requests of one run, by phase; each request is the JSON body of
    a `POST /rag` (`query`, `k`, and `max_new_tokens` where the mix sets
    budgets).

    `warmup_closed`: the closed-loop warm-up's requests (`warmup.closed_requests`
    by `warmup.clients` callers, before either loop's timed part);
    `open_due` / `open_reqs`: for a Poisson mix, the due offsets (seconds
    from the open schedule's start) and requests, the warm-up's
    `warmup.open_seconds` first, then the window's; `closed_reqs()`: for a
    closed mix, an endless stream of requests after the warm-up."""

    def __init__(self, mix: dict, seed: int, seconds: float, bench_dir: str = BENCH_DIR):
        self.mix = mix
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.qs = questions(bench_dir)
        self.k = int(mix.get("k", 2))
        w = mix.get("warmup", {})
        self.warm_clients = int(w.get("clients", mix.get("clients", 64)))
        self._asked = np.zeros(len(self.qs), dtype=np.int64)
        self._cycle_at = 0
        n_warm = int(w.get("closed_requests", 0))
        self.warmup_closed = [self._request(i) for i in self._picks(n_warm, "warm")]
        self.open_warm_s = 0.0
        self.open_due: list = []
        self.open_reqs: list = []
        if mix["arrivals"] == "poisson":
            rate, cycle = float(mix["rate_rps"]), mix.get("rate_cycle")
            self.open_warm_s = float(w.get("open_seconds", 0.0))
            n_ow = expected_count(rate, self.open_warm_s, cycle)
            n_win = expected_count(rate, self.seconds, cycle)
            due = list(poisson_offsets(n_ow, self.open_warm_s, sub_seed(seed, "ow"), cycle))
            due += [self.open_warm_s + t
                    for t in poisson_offsets(n_win, self.seconds, seed, cycle)]
            picks = self._picks(n_ow, "ow") + self._picks(n_win, "window")
            self.open_due = due
            self.open_reqs = [self._request(i) for i in picks]
        elif mix["arrivals"] != "closed":
            raise ValueError(f"unknown arrivals {mix['arrivals']!r}")

    def _picks(self, n: int, phase: str) -> list:
        pop = self.mix.get("popularity", {"kind": "cycle"})
        n_items = len(self.qs)
        if n == 0:
            return []
        if pop["kind"] == "zipf":
            fixed = np.random.default_rng(FIXED_STREAM + len(phase))
            # rank r is question r: one fixed popularity order for every seed
            ranks = zipf_ranks(n, n_items, float(pop.get("s", 1.0)), fixed)
            return [int(r) for r in np.random.default_rng(
                sub_seed(self.seed, "zipf" + phase)).permutation(ranks)]
        if pop["kind"] == "cycle":
            order = np.random.default_rng(sub_seed(self.seed, "cycle")).permutation(n_items)
            start, self._cycle_at = self._cycle_at, self._cycle_at + n
            return [int(order[(start + i) % n_items]) for i in range(n)]
        raise ValueError(f"unknown popularity {pop['kind']!r}")

    def _request(self, qi: int) -> dict:
        """The body of the run's next request of question `qi`: its tail and
        budget are those of that question's nth asking, for every seed."""
        nth = int(self._asked[qi])
        self._asked[qi] += 1
        q = self.qs[qi]
        fixed = sub_seed(FIXED_STREAM, f"{qi}.{nth}")
        if self.mix.get("unique_tail"):
            q = f"{q} (ref {fixed & 0xFFFFFFFFFF:010x})"
        body = {"query": q, "k": self.k}
        if "new_tokens" in self.mix:
            lo, hi = (int(x) for x in self.mix["new_tokens"])
            body["max_new_tokens"] = lo + (fixed >> 40) % (hi - lo + 1)
        return body

    def closed_reqs(self):
        """The closed loop's requests after the warm-up, without end."""
        while True:
            for qi in self._picks(len(self.qs), "closed"):
                yield self._request(qi)
