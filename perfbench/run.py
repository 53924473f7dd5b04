"""The benchmark of the PyTorch and CUDA port (`rag_serving_system_torch`):

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One run builds the service in this process (`perfbench/system.py`), warms it
up with the cell's own traffic, and has the load generator
(`perfbench/loadgen.py`, its own process) drive `POST /rag?wait=30` for
`--seconds`. With `--trace 0` it reports the cell's end-to-end metrics, with
`--trace 1` its per-layer metrics: the spans and counters of the window, and
a device trace of `TRACE_SECONDS` of the same load right after it (one that
holds every launch the program counted in it). Then
the program is freed and the reference checks a sample of the answers
(`perfbench/judge.py`). The last line of standard output is the result, as
JSON; the numbers compared, each beside its limit, are the last lines of
standard error and the last key of the result.

`--control 1` serves with the configuration's lower-precision control and
reports its readings of the compared numbers (the readings the limits are
set from; the benchmark's own runs never take it).

It exits non-zero, printing no result, without as many CUDA cards as the
cell asks for, and when a module of JAX or of the JAX package is loaded once
the window has closed.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import logging  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "rag_serving_system_tpu")
RUN_DIR = os.path.join(ROOT, "build", "perfbench")
CHECK_REQUESTS = 40
GRACE_S = 60.0           # a window request is waited for this long past the close
WARMUP_TIMEOUT_S = 300.0
TRACE_SECONDS = 10.0
TRACE_TRIES = 2
# the program's launch counters, and the kernel names each counts
TRACED_KERNELS = {"topk": r"topk(_int8)?_partial_kernel|score_rows(_int8)?_kernel",
                  "flash": r"flash_(wg_)?kernel"}

logger = logging.getLogger("perfbench")


def cache_env() -> None:
    """Build and kernel caches at fixed paths inside the checkout; keep
    libraries from loading JAX."""
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(RUN_DIR, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(RUN_DIR, "triton"))
    os.environ["USE_FLAX"] = "0"
    # the profiler keeps CUPTI set up between its sessions, rather than tear
    # it down after the set-up's first one and set it up again for the
    # trace (torch.profiler does the same where CUDA graphs run)
    os.environ["TEARDOWN_CUPTI"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ.pop("JAX_PLATFORMS", None)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _finite(v: float) -> float:
    """A number JSON can carry: an unbounded reading as 1e300."""
    return v if math.isfinite(v) else 1e300


class RunData:
    """What a metric reader reads: the window, the counters at its edges,
    the load generator's records, the spans, the trace and the cell."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def window_records(self) -> list:
        return [r for r in self.records if r["phase"] == "window"]

    def answered_in(self, t0: float, t1: float) -> list:
        return [r for r in self.records if r["status"] == "ok" and t0 <= r["done"] < t1]


def _read_lines(proc, lines: list, ev: threading.Event) -> None:
    for line in proc.stdout:
        lines.append(line.strip())
        ev.set()
    ev.set()


def launch_counts(cfg: dict, snap_a: dict, snap_b: dict, decoder=None) -> dict:
    """{kernel-name pattern: launches at least} that the program made between
    two snapshots: its own counts of B1/B4 and B2/B3 launches, and one
    decoder pass (the `pass_launches` of `decoder`, the module of the
    configuration's decoder architecture: a SiLU a layer for Qwen2) for each
    generated batch but the first, which may have begun before the earlier
    snapshot."""
    from perfbench import spec

    decoder = decoder or spec.decoder_of(cfg["decoder"])
    la, lb = snap_a["launches"], snap_b["launches"]
    want = {pattern: lb[key] - la[key] for key, pattern in TRACED_KERNELS.items()}
    gen_a = snap_a["stages"].get("generate", (0.0, 0))[1]
    gen_b = snap_b["stages"].get("generate", (0.0, 0))[1]
    for pattern, n in decoder.pass_launches(cfg["decoder"]).items():
        want[pattern] = want.get(pattern, 0) + n * max(0, gen_b - gen_a - 1)
    return want


def trace_segment(sysm, cfg: dict, diag: dict, decoder=None):
    """A device trace of TRACE_SECONDS of the running load that holds every
    launch the program counted in it, on the first of TRACE_TRIES tries.
    Raises where none does: a trace that lost a thread's kernels would read
    as an idle card."""
    from perfbench.trace import Tracer

    tries = []
    for _ in range(TRACE_TRIES):
        tracer = Tracer()
        tracer.start()
        snap_a = sysm.snapshot()
        time.sleep(TRACE_SECONDS)
        snap_b = sysm.snapshot()
        tracer.stop()
        tr = tracer.read()
        lost = tr.lost(launch_counts(cfg, snap_a, snap_b, decoder))
        tries.append({"busy_s": tr.busy_s, "ops": tr.n_ops, "lost": lost})
        if not lost:
            diag["trace_tries"] = tries
            return tr, snap_a, snap_b
    raise RuntimeError(f"every device trace lost launches the program made: {tries}")


def run_cell(cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             control: bool = False, fault=None) -> dict:
    """One run of `cell` (a `spec.Cell`). `fault(system)`, for the tests,
    breaks the timed path after set-up."""
    import torch

    from perfbench import generator, spec
    from perfbench.judge import Judge
    from perfbench.system import System

    os.makedirs(RUN_DIR, exist_ok=True)
    cfg, mix = cell.config, cell.mix
    sysm = System(cfg, device, cell.decoder, control=control)
    trace = trace and sysm.device.type == "cuda"
    if trace:
        from perfbench.trace import Tracer
        Tracer.prime()
    if fault is not None:
        fault(sysm)
    url = sysm.start()
    mix_path = os.path.join(RUN_DIR, f"mix.{cell.name}.json")
    out_path = os.path.join(RUN_DIR, f"requests.{cell.name}.jsonl")
    with open(mix_path, "w", encoding="utf-8") as f:
        json.dump(mix, f)
    # a traced run keeps the load on past the window for its trace
    load_s = seconds + (TRACE_SECONDS * TRACE_TRIES if trace else 0.0)
    gen = subprocess.Popen(
        [sys.executable, os.path.join(spec.BENCH_DIR, "loadgen.py"), "--url", url,
         "--mix", mix_path, "--seed", str(seed), "--seconds", str(load_s),
         "--grace", str(GRACE_S), "--out", out_path],
        stdout=subprocess.PIPE, text=True, cwd=ROOT)
    lines: list = []
    ev = threading.Event()
    reader = threading.Thread(target=_read_lines, args=(gen, lines, ev), daemon=True)
    reader.start()
    tr = None
    diag: dict = {}
    try:
        deadline = time.time() + WARMUP_TIMEOUT_S
        while not any(x.startswith("T0 ") for x in lines):
            if gen.poll() is not None or time.time() > deadline:
                raise RuntimeError(f"the load generator gave no window (exit {gen.poll()})")
            ev.wait(0.5)
            ev.clear()
        t0 = float(next(x for x in lines if x.startswith("T0 ")).split()[1])
        t1 = t0 + seconds
        time.sleep(max(0.0, t0 - time.time()))
        if sysm.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        snap0 = sysm.snapshot()
        time.sleep(max(0.0, t1 - time.time()))
        snap1 = sysm.snapshot()
        if trace:
            # after the window, so that the profiler slows no span or
            # counter the metrics read
            tr, _, _ = trace_segment(sysm, cfg, diag, cell.decoder)
        gen.wait(timeout=load_s + GRACE_S + 180)
    except BaseException:
        sysm.stop()
        raise
    finally:
        if gen.poll() is None:
            gen.kill()
            gen.wait()
    reader.join(timeout=5)
    mem_peak = torch.cuda.max_memory_allocated() if sysm.device.type == "cuda" else 0
    sysm.stop()
    with open(out_path, encoding="utf-8") as f:
        records = [json.loads(x) for x in f]
    win = [r for r in records if r["phase"] == "window"]
    facts = dict(sysm.facts(), k=int(mix.get("k", 2)))
    retrieved = sysm.retrieved({r["query"] for r in records})
    embed_calls, packed_calls, away = sysm.embed_calls, sysm.packed_calls, sysm.away
    sysm.free()
    del sysm

    # the check
    docs = generator.contexts()
    limits = cfg["limits"]
    judge = Judge(cfg, facts, seed, device, cell.decoder, away=away)
    sample = judge.sample(records, retrieved, docs, CHECK_REQUESTS)
    numbers = judge.check(sample, retrieved, embed_calls, docs, control=control)
    failed = sum(r["status"] != "ok" for r in win)
    compared = {name: {"value": _finite(v), "limit": limits[name]}
                for name, v in numbers.items() if name in limits}
    compared["failed_requests"] = {"value": failed, "limit": 0}
    compared["checked_requests"] = {"value": len(sample), "limit": 1}
    correct = (failed == 0 and len(sample) >= 1
               and all(c["value"] <= c["limit"] for n, c in compared.items()
                       if n not in ("checked_requests",)))

    run = RunData(cell=cell, config=cfg, mix=mix, seed=seed, seconds=seconds, t0=t0, t1=t1,
                  setup_s=t0 - T_START, records=records, snap0=snap0, snap1=snap1,
                  trace=tr, embed_calls=embed_calls, packed_calls=packed_calls,
                  facts=facts, retrieved=retrieved, docs=docs, diag=diag)
    names = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for name in names:
        mod = spec.metric(name)
        v = mod.read(run)
        if v is not None:
            metrics[name] = {"value": v, "unit": mod.UNIT}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else device,
           "count": cell.chips, "memory_peak_bytes": int(mem_peak)}
    result = {"correct": bool(correct), "attempted": len(win), "failed": failed,
              "metrics": metrics, "device": dev}
    if tr is not None:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        result["breakdown"] = {"device_ops": tr.top_ops(10), "idle_gaps": tr.gaps[:10]}
    run.diag["check"] = judge.summary()
    print("diag " + json.dumps(run.diag), file=sys.stderr)
    result["compared"] = compared
    return result


def _print_side_lines(result: dict) -> None:
    """The compared numbers, each beside its limit, last on standard error."""
    for name, c in result["compared"].items():
        print(f"compared {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.WARNING, stream=sys.stderr,
                        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    cache_env()
    from perfbench import spec

    cell = spec.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"perfbench: {args.workload} needs {cell.chips} CUDA card(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}, "
              f"device_count = {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      control=bool(args.control))
    bad = forbidden_modules()
    if bad:
        print(f"perfbench: loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 4
    _print_side_lines(result)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
