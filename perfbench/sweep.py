"""The knee sweep of an open-loop cell, run once when the cell is defined:

    python3 perfbench/sweep.py --workload bf16.hot-zipf --seed N \
        --rates 40,60,80,100 --seconds 20

Builds the service once, warms it with the cell's warm-up, then offers each
rate in turn (a few seconds of that rate's arrivals first, then the timed
part) and prints, a line each: the offered and answered rates, the latency
percentiles from due time, how late the generator ran, and the queue left
at the end. The knee is the highest rate whose answered rate keeps up with
the offered one (no growing backlog) and whose p99 stays within 10 s (the
reference service's load gate); the cell's `rate_rps` is 0.8 times it.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from perfbench import readers, spec  # noqa: E402
from perfbench.run import RUN_DIR, cache_env  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    cache_env()
    from perfbench.system import System

    cell = spec.cell(args.workload)
    os.makedirs(RUN_DIR, exist_ok=True)
    sysm = System(cell.config, args.device, cell.decoder)
    url = sysm.start()
    for n, rate in enumerate(float(r) for r in args.rates.split(",")):
        mix = dict(cell.mix, rate_rps=rate)
        w = dict(mix.get("warmup", {}))
        if n:
            w["closed_requests"] = 0
        w["open_seconds"] = max(3.0, float(w.get("open_seconds", 3.0)))
        mix["warmup"] = w
        mix_path = os.path.join(RUN_DIR, "sweep.mix.json")
        out = os.path.join(RUN_DIR, "sweep.requests.jsonl")
        with open(mix_path, "w") as f:
            json.dump(mix, f)
        subprocess.run([sys.executable, os.path.join(spec.BENCH_DIR, "loadgen.py"), "--url", url,
                        "--mix", mix_path, "--seed", str(args.seed + n), "--seconds",
                        str(args.seconds), "--out", out], check=True, stdout=subprocess.DEVNULL)
        with open(out) as f:
            recs = [json.loads(x) for x in f]
        win = [r for r in recs if r["phase"] == "window"]
        t0 = min(r["due"] for r in win)
        lat = [r["done"] - r["due"] for r in win]
        late = [r["send"] - r["due"] for r in win]
        third = sorted(win, key=lambda r: r["due"])
        head, tail = third[:len(third) // 3], third[-(len(third) // 3):]
        ok_in = sum(1 for r in recs if r["status"] == "ok" and t0 <= r["done"] < t0 + args.seconds)
        print(json.dumps({
            "rate_offered": len(win) / args.seconds, "rate_answered": ok_in / args.seconds,
            "failed": sum(r["status"] != "ok" for r in win),
            "p50_s": readers.percentile(lat, 0.5), "p95_s": readers.percentile(lat, 0.95),
            "p99_s": readers.percentile(lat, 0.99), "late_max_s": max(late),
            "p50_first_third_s": readers.percentile([r["done"] - r["due"] for r in head], 0.5),
            "p50_last_third_s": readers.percentile([r["done"] - r["due"] for r in tail], 0.5)}),
              flush=True)
        time.sleep(2.0)
    sysm.stop()


if __name__ == "__main__":
    main()
