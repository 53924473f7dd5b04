"""Retrieval roofline decomposition on one CUDA device.

    python -m rag_serving_system_torch.profile_topk
    TOPK_PARTS=10m python -m rag_serving_system_torch.profile_topk

Port of `scripts/profile_topk.py`. It splits the top-k kernels' time into
its two halves, each run alone over the same corpus rows:

  stream - kernel P1: the corpus streamed once, a column max, nothing else
  dot    - kernel P2: the top-k kernel's score arithmetic without the
           selection (for f32 also at highest=False: one bf16 pass)
  full   - the top-k kernel itself: B1 (f32, bf16 corpus), B4 (int8)

for f32, bf16 and int8 corpora of TOPK_N rows (default 1,048,576) x 1024,
B = 32 seeded queries, k = 16. Times are CUDA events over repeated
launches; GB/s counts the corpus bytes each launch reads. Prints the card's
nvidia-smi name and power limit, then one JSON line per (corpus, variant).
TOPK_PARTS picks sections (default "fp,int8"; "10m" adds the 10,000,000-row
int8 corpus in 4,194,304-row chunks, 10.2 GB on the card; "trace" adds
torch.profiler's device time of each CUDA kernel behind B4 at k = 16 and
select_topk at k = 1024). Needs a CUDA device and nvcc; there is no CPU
mode.
"""

from __future__ import annotations

import json
import os
import subprocess

import torch

from rag_serving_system_torch.device import resolve_device
from rag_serving_system_torch.ops.probes import dot_probe, stream_probe
from rag_serving_system_torch.ops.topk import (
    _quantize_queries_int8,
    cosine_topk,
    cosine_topk_int8,
    cosine_topk_int8_chunked,
    l2_normalize,
    quantize_corpus_int8,
)

D, B, K = 1024, 32, 16
BLOCK_N = 2048  # rows per P1 block; P2 probes N // BLOCK_N * BLOCK_N rows


def nvidia_smi() -> str:
    """The card's `name, power.limit` as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def timed_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() over reps launches, after two warm-up calls."""
    fn()
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def int8_chunks(n: int, chunk: int, dev, seed: int = 1):
    """A synthetic int8 corpus of n rows x 1024 in `chunk`-row chunks, made
    on the device: [(values (C, D) int8, scales (1, C) f32), ...]. The scan's
    time does not depend on the values."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return [(torch.randint(-127, 128, (min(chunk, n - lo), D), generator=g,
                           device=dev, dtype=torch.int8),
             torch.full((1, min(chunk, n - lo)), 1 / 127.0, device=dev))
            for lo in range(0, n, chunk)]


def device_us(fn, reps: int = 10) -> dict:
    """torch.profiler's device time of each CUDA kernel fn() launches, in
    microseconds a call (mean of reps calls, after one warm-up)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.device_time_total / reps for e in prof.key_averages()
            if e.device_time_total > 0}


def trace_kernels(base, queries, emit) -> None:
    """Where B4's and the select's time goes: each CUDA kernel's device time
    for B4 at k = 16 over the int8 corpus of `base`, and for select_topk at
    k = 1024 over (32, N) scores on a 0.001 grid, in a 1e-3 band (a crowded
    bin) and all equal."""
    from rag_serving_system_torch.ops.topk import select_topk

    cq, cs, cm = quantize_corpus_int8(base)
    emit(json.dumps({"trace": "B4", "k": K, "us": device_us(
        lambda: cosine_topk_int8(cq, cs, queries, K, corpus_mean=cm))}))
    del cq, cs, cm
    g = torch.Generator(device=base.device).manual_seed(8)
    shape = (B, base.shape[0])
    for name, scores in (
            ("grid", torch.round(torch.randn(shape, generator=g, device=base.device) * 1000)
             / 1000),
            ("crowded", 0.8 + torch.round((torch.rand(shape, generator=g, device=base.device)
                                           - 0.5) * 1e4) * 1e-7),
            ("equal", torch.full(shape, 0.8, device=base.device))):
        emit(json.dumps({"trace": "select_topk", "scores": name, "k": 1024,
                         "us": device_us(lambda s=scores: select_topk(s, 1024))}))


def roofline(n: int = 1 << 20, parts=("fp", "int8"), emit=print) -> None:
    """Time each (corpus, variant) and emit one JSON line each."""
    dev = resolve_device("cuda")

    def record(corpus, variant, fn, nbytes, **extra):
        ms = timed_ms(fn, 20)
        emit(json.dumps({"corpus": corpus, "variant": variant, "n": n, **extra,
                         "ms": ms, "gbps": nbytes / ms / 1e6}))

    g = torch.Generator(device=dev).manual_seed(0)
    base = l2_normalize(torch.randn((n, D), generator=g, device=dev))
    queries = torch.randn((B, D), generator=g, device=dev)
    if "fp" in parts:
        for dt, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            corpus = base.to(dt)
            nbytes = n * D * corpus.element_size()
            record(name, "stream", lambda: stream_probe(corpus, BLOCK_N), nbytes)
            for highest in ((False, True) if name == "f32" else (False,)):
                record(name, "dot", lambda h=highest: dot_probe(corpus, queries, BLOCK_N, h),
                       nbytes, highest=highest)
            record(name, "full", lambda: cosine_topk(corpus, queries, K), nbytes)
            del corpus
    if "int8" in parts:
        cq, cs, cm = quantize_corpus_int8(base)
        qi, _ = _quantize_queries_int8(l2_normalize(queries))
        record("int8", "stream", lambda: stream_probe(cq, BLOCK_N), n * D)
        record("int8", "dot", lambda: dot_probe(cq, qi, BLOCK_N), n * D)
        record("int8", "full", lambda: cosine_topk_int8(cq, cs, queries, K, corpus_mean=cm),
               n * D + 4 * n)
        del cq, cs, cm
    if "trace" in parts:
        trace_kernels(base, queries, emit)
    del base
    torch.cuda.empty_cache()
    if "10m" in parts:
        n10, chunk = 10_000_000, 4_194_304
        chunks = int8_chunks(n10, chunk, dev)
        ms = timed_ms(lambda: cosine_topk_int8_chunked(chunks, queries, K), 4)
        emit(json.dumps({"corpus": "int8", "variant": "chunked", "n": n10,
                         "chunks": len(chunks), "ms": ms,
                         "gbps": (n10 * D + 4 * n10) / ms / 1e6}))
        del chunks
        torch.cuda.empty_cache()


def main() -> None:
    n = int(os.environ.get("TOPK_N", str(1 << 20)))
    parts = os.environ.get("TOPK_PARTS", "fp,int8").split(",")
    print(nvidia_smi(), flush=True)
    roofline(n, parts, emit=lambda line: print(line, flush=True))


if __name__ == "__main__":
    main()
