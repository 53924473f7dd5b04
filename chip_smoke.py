#!/usr/bin/env python3
"""Drive the PyTorch port's main RAG path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each (with its seconds); any failure exits non-zero:

1. device     - the card (torch and nvidia-smi).
2. build      - nvcc builds the kernels in rag_serving_system_torch/csrc/.
3. kernels    - each kernel against its plain PyTorch version at main-path
                shapes, with CUDA-event times of both, the least time the
                card could take (bound_ms, from the run's shapes and data),
                and where one exists the time of one PyTorch call computing
                the same function (library_ms): B1 at 1M rows (f32 and bf16
                corpus, k = 16, 64, 256, 1024) and 1000 rows, B2 and B3 in
                bf16 and f32 (B2 also at a mesh position's 6 query heads and
                1 KV head; B3 with n_real = T and with the stream's real
                count, the served contract, its rows past n_real exactly 0),
                B2 again under RIGHT padding at (32, 512) and
                (8, 768) (the prefix-KV compute's shapes), B2 and B3 at the
                narrow head sizes 16 and 32 (the tiny preset's), B1 and B4 at
                depths 50 and 100 (padded by the wrappers), B4 at 1M rows
                (k = 16, 64, 256, 1024) and chunked over 10M rows (10.24 GB of int8 on the card),
                select_topk alone (normal, crowded and all-equal scores,
                beside torch.topk), P1 and P2 at 1M rows. Then B4's CTAs an
                SM and registers, and the crossover: each top-k wrapper's
                warp lists against its score kernel plus select_topk at
                k = 16 and 32, at 1M and 1000 rows (LIST_K's evidence).
4. roofline   - profile_topk's 1M-row rows: P1 (stream), P2 (dot) and the
                top-k kernel (full) for f32, bf16 and int8 corpora.
5. serve      - the port's engine at full width (e5-large + Qwen2.5-1.5B,
                random weights from a seed, bf16) with EVERY setting at its
                default (PREFIX_CACHE=1, the pool sized from the corpus)
                behind the queue and batch processor: (a) one lone request
                (a miss: the prefix K/V through B2), (b) 64 at once (misses
                de-duplicated a batch), (c) the same 64 again (hits: no B2,
                and the query cache skips retrieval). Then the stage split
                of a batch of 32, all miss (the cache emptied before each
                run) and all hit: prepare, prefix_resolve, prefill, decode
                (CUDA-synced host clock, mean of 3, query cache off); one
                more batch of 32 (all hit) under `device_trace`: the
                device-busy share, the kernel count, the top kernels and the
                share of launches in decode; and the peak device memory.
6. serve_cold - the same engine with PREFIX_CACHE=0: one lone request
                (padded prefill, B2), then 64 at once (packed prefill, B3,
                each call given the stream's real count n_real < T), and
                the stage split of a lone request and a batch of 32.
7. parity     - a full-width f32 greedy engine at PREFIX_CACHE=1 answers a
                lone request and a batch of 8 identically through the
                kernels and through their plain versions, on the prefix
                route (from an emptied cache) and on the cold route (the
                cache switched off); a miss and the hit after it answer
                identically; prefix route against cold route: first-token
                logits within 1e-3, the tokens printed beside each other.
                Then, with the decoder's matrices scaled by 4 so that answers
                depend on the context: the decode pool (4 slots under batches
                of 8: waves and slot reuse) answers exactly as the fixed path
                over the prefix cache, padded and packed; `torch._int_mm`
                gives the plain version's int32 sums exactly at the decoder's
                four matmul shapes (timed beside the bf16 product and the
                decode-shaped int8-weight product); int8 and W8A8 logits
                against the unquantized ones.
8. serve_int8 - RETRIEVAL_CORPUS_DTYPE=int8 over 1,048,576 rows in 4 chunks
                of 262,144 (squad_real rows and seeded noisy copies): a lone
                request, then 32 at once; the retrieved ids equal the plain
                version's.
9. serve_ivf  - RETRIEVER=ivf over a seeded clustered corpus (65,536 rows,
                256 centres) through its startup recall gate; 32 requests.
10. serve_wide_k - MAX_K=1000 over squad_real (k = N, past the warp lists'
                256: the score kernel and select_topk): a lone request, then
                7; the batch's retrieval against the plain version's.
11. serve_quant - QUANT_WEIGHTS=int8, QUANT_ACT=int8, all else at its default
                (the JAX package's production settings): a lone request, 64
                at once, the same 64 again; the weight bytes before and after
                quantizing; the stage split of 32 (miss and hit) beside the
                bf16 one of phase 5.
12. serve_continuous - DECODE_MODE=continuous: the same three steps through
                the processor and the decode pool, the pool's stats; then
                PREFIX_CACHE=0, 32 at once (the packed pool prefill, B3,
                with n_real < T).
13. serve_tiny - MODEL_PRESET=tiny on the card (head size 16, and the same
                preset widened to head size 32), f32, greedy: through the
                kernels exactly as through their plain versions, on the
                prefix, padded and packed routes; the pool exactly as the
                fixed path; int8 + W8A8 through `torch._int_mm` exactly as
                through the plain int32 sums.
14. serve_spec - DO_SAMPLE=0 SPEC_DECODE=3 at full width in bf16: a lone
                request, 64 at once (misses), the same 64 (hits), then
                PREFIX_CACHE=0 and 32 at once (packed); the same requests at
                SPEC_DECODE=0 beside them: seconds, loop iterations, decode
                tokens a row an iteration. One `decode_step` against one
                `decode_step_spec` at S = 2, 4, 8 (batch 32; CUDA events and
                the synced host clock), and whole decode loops of 10 and 32
                tokens: sequential, and speculative under right and wrong
                drafts (the acceptance → time curve).
15. serve_checkpoint - the seeded full-width models written as HF snapshots
                (safetensors in BF16 and config.json) into a temporary
                directory, and an engine started with WEIGHTS_DIR on it: the
                derived configs equal the presets, every leaf is bit-equal, 33
                requests are served, and a greedy batch of 32 is answered as by
                the random-init engine. Bytes, write and load seconds.
16. serve_pipeline - the full processor: 129 requests in f32 greedy (decoder
                scaled by 4) through PREFETCH_WORKERS 1 and 2 with
                FINALIZE_ASYNC 1 and 0 against the serial `prefetch=False`
                mode's answers; the same modes in bf16 at the defaults, in
                seconds; 64 requests at 1, 2, 2, 1 workers (misses and hits);
                ROLE=api and ROLE=engine over one in-memory queue, a request
                through HTTP (or through the queue without aiohttp).
17. serve_mesh - the engine over a "2,2" mesh (2 data groups x 2 model
                positions) placed on the one card, at full width, bf16, every
                default: the lone miss, 64 misses, the same 64 as hits, then 8
                cold requests (padded prefill), through the processor. B1 once
                per shard per retrieval (4 shards of squad_real), B2 on every
                model position (6 query heads, 1 KV head) in the prefix
                compute and the padded prefill, each prefix pool part holding
                half the KV heads; the seconds, peak memory and each
                position's weight bytes. B2 and B1 at those shapes against
                their plain versions; f32 greedy answers of the mesh engine
                equal to the one-device engine's (a lone request and 8, miss
                and hit routes; decoder scaled by 4); the sharded top-k at
                1,048,576 x 1024 (f32, bf16; B = 32; k = 16, 1024): ids equal
                to unsharded B1's, each shard's B1 against its plain version,
                the times beside unsharded B1 (four positions on ONE card: not
                a multi-card measurement).
18. train     - the contrastive trainer at full width (e5-large, f32
                parameters from a seed, squad_real's 1,000 pairs, batches of
                16 at 64 tokens): one f32 step at 2 layers on the card against
                the CPU (loss, every gradient, the parameters after AdamW); 8
                steps on a fixed batch at 24 layers in bf16 (the loss falls at
                lr 5e-4, else at the first of 1e-4, 2e-5 where it does);
                one epoch through `train_encoder` (62 steps, lr 1e-5: seconds,
                step ms, pairs/s, peak memory, losses); recall@1 and @5 of the
                1,000 queries over the distinct facts through B1 (its ids
                equal to its plain version's) before and after the epoch; a
                checkpoint round trip of the trained tree (bytes, seconds,
                every leaf bit-equal); one step under `device_trace` (busy
                share, kernel count, the top five kernels).

19. multihost - the sharded top-k over a (2, 2) mesh that spans two
                processes (`chip_smoke.py --multihost-worker`, gloo over TCP;
                both on cuda:0 of one card, a card each where there are
                more), 1,048,576 x 1024 f32 from a seed, each process holding
                its half on its card, B = 32, k = 16 and 1024: both ranks' ids
                and scores equal unsharded B1's on the whole corpus; each
                rank's launches; the ms of the two-process call beside
                unsharded B1 and the one-process call over four shards.
20. serve_native_front - `main.build_app(role="all")` at full width with
                every default and NATIVE_FRONT_PORT set: 129 squad_real
                queries (half a sync POST ?wait=, half an async POST and
                polls) at 32 in flight from a client process, through the
                C++ front and through aiohttp in turns (front, aiohttp,
                aiohttp, front; caches emptied before each): req/s, p50 and
                p99 of each; every answer a 200 with a result, /stats
                `native_front` counting the front's requests, B1 and B2
                launched, both hash tokenizers through their C library.
21. serve_replicas - the port's miniredis, one ROLE=api and two ROLE=engine
                processes of `python -m rag_serving_system_torch.main` (full
                width, every default; both engines on one card where there is
                one): two rounds of 64 requests through the api's HTTP,
                then one engine stopped and two rounds of 64 others through
                the other; seconds of each, requests each engine batched.

The parity phase (7) also holds speculative decode (gamma 1 and 3, row
budgets, an EOS bias) to sequential greedy on the prefix, packed and padded
routes, and `_spec_decode_loop` under `draft_source` to its iteration counts.

`python3 chip_smoke.py --stage-split` runs phases 1, 2 and the stage splits
alone (5 reps each: cold lone and batch of 32, then all miss and all hit),
for an A/B of two checkouts on one card. `python3 chip_smoke.py --crossover`
runs phases 1, 2 and the kernels phase's crossover alone, on two seeded
corpora. `python3 chip_smoke.py --phases serve_spec,serve_pipeline` runs phases
1, 2 and the named ones (of serve, parity, serve_spec, serve_checkpoint,
serve_pipeline, serve_mesh, serve_mesh_cards, train, multihost,
serve_native_front, serve_replicas, attention) alone; `attention` is the
kernels phase's B2 and B3 checks (copied into an older checkout, it times
that checkout's kernels: an A/B in one call).
`python3 chip_smoke.py --phases serve_mesh_cards` on a machine of several
cards serves over meshes of them (one card, "N,1", "N/2,2"): the script's
only multi-card measurement; the default run needs one card and leaves it
out.

Each path phase (roofline, serve, serve_cold, serve_int8, serve_ivf,
serve_wide_k, serve_quant, serve_continuous, serve_tiny, serve_spec,
serve_checkpoint, serve_pipeline, serve_mesh, train, serve_native_front)
sets every launch count to 0 just before it and reads the counts just
after, as each multihost worker does before its first call; each kernel of
the path must have launched, and every request must come back as
{"result": str}. A phase whose child process fails or does not finish in
time fails the run. Then the nvidia-smi name and power limit, the kernels'
summary line, and the last line {"ok": true, "device": {...}}.
Needs a CUDA device; exits 1 without one, and when run outside a checkout
of the repository.
"""

from __future__ import annotations

import functools
import inspect
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(ROOT, "data")

# wrapper: (source, TPU kernel it replaces, the path phase that launches it)
KERNELS = {
    "cosine_topk": ("rag_serving_system_torch/csrc/topk.cu",
                    "rag_serving_system_tpu/ops/topk.py:93", "serve"),
    "flash_attention": ("rag_serving_system_torch/csrc/flash_attention.cu",
                        "rag_serving_system_tpu/ops/attention.py:42", "serve"),
    # B3 runs on the bypass route only: the cold phase drives it
    "flash_attention_packed": ("rag_serving_system_torch/csrc/flash_attention.cu",
                               "rag_serving_system_tpu/ops/attention.py:100", "serve_cold"),
    "cosine_topk_int8": ("rag_serving_system_torch/csrc/topk_int8.cu",
                         "rag_serving_system_tpu/ops/topk.py:189", "serve_int8"),
    "stream_probe": ("rag_serving_system_torch/csrc/probes.cu",
                     "scripts/profile_topk.py:36", "roofline"),
    "dot_probe": ("rag_serving_system_torch/csrc/probes.cu",
                  "scripts/profile_topk.py:51", "roofline"),
    # B1's selection beyond its warp lists (the TPU kernel's k rounds of max)
    "select_topk": ("rag_serving_system_torch/csrc/select.cu",
                    "rag_serving_system_tpu/ops/topk.py:93", "serve_wide_k"),
    # B2 / B3 at the narrow head sizes: the scalar body, driven by the tiny
    # preset (head size 16) and by the same preset widened to 32
    "flash_attention[D=16]": ("rag_serving_system_torch/csrc/flash_attention.cu",
                              "rag_serving_system_tpu/ops/attention.py:42", "serve_tiny"),
    "flash_attention_packed[D=16]": ("rag_serving_system_torch/csrc/flash_attention.cu",
                                     "rag_serving_system_tpu/ops/attention.py:100",
                                     "serve_tiny"),
    "flash_attention[D=32]": ("rag_serving_system_torch/csrc/flash_attention.cu",
                              "rag_serving_system_tpu/ops/attention.py:42", "serve_tiny_d32"),
    "flash_attention_packed[D=32]": ("rag_serving_system_torch/csrc/flash_attention.cu",
                                     "rag_serving_system_tpu/ops/attention.py:100",
                                     "serve_tiny_d32"),
}
# the card's published peaks (H100 SXM, dense, at 700 W): HBM bytes/s and
# operations/s by type
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"f32": 67e12, "bf16": 989e12, "int8": 1979e12}
SERVE_ENV = {"MODEL_PRESET": "full", "TORCH_DEVICE": "cuda"}   # both their defaults
_BASE_ENV = dict(os.environ)


class SmokeFailure(Exception):
    pass


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() over reps launches, after two warm-up calls."""
    from rag_serving_system_torch.profile_topk import timed_ms

    return timed_ms(fn, reps)


def wrappers() -> dict:
    """Every kernel wrapper, by name; each carries its launch count."""
    from rag_serving_system_torch.ops import attention, probes, topk

    return {"cosine_topk": topk.cosine_topk,
            "flash_attention": attention.flash_attention,
            "flash_attention_packed": attention.flash_attention_packed,
            "cosine_topk_int8": topk.cosine_topk_int8,
            "stream_probe": probes.stream_probe,
            "dot_probe": probes.dot_probe,
            "select_topk": topk.select_topk}


def reset_launches() -> None:
    for w in wrappers().values():
        w.launches = 0


def read_launches() -> dict:
    return {name: w.launches for name, w in wrappers().items()}


def wrapper_of(name: str) -> str:
    """The wrapper behind a KERNELS entry: `flash_attention[D=16]` is
    `flash_attention` at head size 16."""
    return name.split("[")[0]


# kernels a phase must launch besides those whose path it is in KERNELS
ALSO_REQUIRED = {"serve_mesh": ("cosine_topk", "flash_attention")}


def require_launched(phase: str, launches: dict) -> None:
    names = [name for name, (_, _, path) in KERNELS.items() if path == phase]
    for name in names + list(ALSO_REQUIRED.get(phase, ())):
        require(launches[wrapper_of(name)] > 0, f"kernel {name} never launched in {phase}")


def bound(nbytes: float, ops: float, kind: str) -> dict:
    """bound_ms: the larger of the bytes over the HBM rate and the operations
    over the peak rate of their type; bound_by names the larger."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = ops / PEAK_OPS_S[kind] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": ops}


def set_env(**over) -> None:
    """The environment as the script found it, the serving defaults, and
    `over`: each engine phase reads its settings from a clean slate."""
    os.environ.clear()
    os.environ.update(_BASE_ENV)
    os.environ.update(SERVE_ENV)
    os.environ.update(over)


def phase_device():
    import torch
    from rag_serving_system_torch.profile_topk import nvidia_smi

    line = nvidia_smi()
    emit("device", torch=torch.__version__, cuda=torch.version.cuda,
         name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         nvidia_smi=line)
    return line


def phase_build():
    from rag_serving_system_torch.ops import _build

    t0 = time.perf_counter()
    _build.library()
    emit("build", seconds=time.perf_counter() - t0, nvcc_seconds=_build.build_seconds)


def _check_topk(corpus, queries, k, reps=20):
    import torch
    from rag_serving_system_torch.ops import topk

    s_k, i_k = topk.cosine_topk(corpus, queries, k)
    s_p, i_p = topk.cosine_topk_reference(corpus, queries, k + 1)
    torch.cuda.synchronize()
    err = (s_k - s_p[:, :k]).abs().max().item()
    require(err <= 1e-5, f"cosine_topk scores differ by {err} > 1e-5")
    # an index may differ only where the plain scores of two neighbouring
    # ranks are within 1e-6 of each other (a near-tie)
    gaps = (s_p[:, :-1] - s_p[:, 1:]).abs()
    near = torch.zeros_like(i_k, dtype=torch.bool)
    near |= gaps[:, :k] < 1e-6
    near[:, 1:] |= gaps[:, :k - 1] < 1e-6
    bad = (i_k != i_p[:, :k]) & ~near
    require(not bad.any().item(), f"cosine_topk indices differ at "
            f"{bad.nonzero().tolist()[:8]} (no near-tie there)")
    n_swapped = int((i_k != i_p[:, :k]).sum().item())
    ms = cuda_ms(lambda: topk.cosine_topk(corpus, queries, k), reps)
    plain_ms = cuda_ms(lambda: topk.cosine_topk_reference(corpus, queries, k), 3)
    n, d = corpus.shape
    b = queries.shape[0]
    # IEEE f32 FMAs for an f32 corpus; bf16 products are exact, so a bf16
    # corpus could use the bf16 tensor-core rate
    kind = "f32" if corpus.dtype == torch.float32 else "bf16"
    return {"n": n, "b": b, "k": k, "corpus": str(corpus.dtype),
            "path": "warp lists" if k <= topk.LIST_K[corpus.dtype] else "scores + select_topk",
            "max_abs_err": err, "near_tie_swaps": n_swapped, "ms": ms, "plain_ms": plain_ms,
            **bound(n * d * corpus.element_size() + b * d * 4 + b * k * 8, 2 * b * n * d, kind),
            "library_ms": None}


def _check_select(dev, seed):
    """select_topk alone at its k = 1024 shape, (32, 1,048,576) f32 scores:
    normal scores on a 0.001 grid (many exact ties; the main record), a
    crowded bin (every score in a 1e-3 band around 0.8, on a 1e-7 grid) and
    every score equal: the plain version's ids and scores exactly.
    library_ms: one torch.topk call (which does not promise the tie
    order)."""
    import torch
    from rag_serving_system_torch.ops import topk

    b, n, k = 32, 1 << 20, 1024
    g = torch.Generator(device=dev).manual_seed(seed)
    shapes = {
        "grid": lambda: torch.round(torch.randn((b, n), generator=g, device=dev) * 1000) / 1000,
        "crowded": lambda: 0.8 + torch.round(
            (torch.rand((b, n), generator=g, device=dev) - 0.5) * 1e4) * 1e-7,
        "equal": lambda: torch.full((b, n), 0.8, device=dev),
    }
    records = []
    for name, make in shapes.items():
        scores = make()
        s_k, i_k = topk.select_topk(scores, k)
        s_p, i_p = topk.select_topk_plain(scores, k)
        torch.cuda.synchronize()
        require(torch.equal(i_k, i_p) and torch.equal(s_k, s_p),
                f"select_topk differs from its plain version on {name} scores")
        records.append({"scores": name, "b": b, "l": n, "k": k,
                        "max_abs_err": (s_k - s_p).abs().max().item(),
                        "ms": cuda_ms(lambda: topk.select_topk(scores, k), 20),
                        "plain_ms": cuda_ms(lambda: topk.select_topk_plain(scores, k), 3),
                        "library_ms": cuda_ms(lambda: torch.topk(scores, k, dim=1), 20),
                        "library": "torch.topk", **bound(b * n * 4 + b * k * 8, 0, "f32")})
        del scores
    return records


# the lists hold k <= 32 (topk.LIST_MAX); wider lists lost to the select
# from k = 64 on and were removed (PERF.md keeps that measurement)
CROSSOVER_K = (16, 32)


def _crossover(dev, seed) -> None:
    """Both paths of each top-k wrapper at CROSSOVER_K, at 1M rows and the
    served 1000 rows, B = 32: the warp lists (LIST_K set to LIST_MAX) and the
    score kernel plus select_topk (LIST_K set to 0), CUDA-event ms of 10
    calls after two warm-ups, taken lists, select, select, lists and
    averaged a path (at 1000 rows a call is host-bound: the events time the
    wrapper's host work too). Then, for each corpus dtype and row count, the
    largest k up to which the lists win at every k measured, beside the
    wrapper's LIST_K."""
    from unittest import mock

    import torch
    from rag_serving_system_torch.ops import topk

    for n in (1 << 20, 1000):
        g = torch.Generator(device=dev).manual_seed(seed)
        base = topk.l2_normalize(torch.randn((n, 1024), generator=g, device=dev))
        queries = torch.randn((32, 1024), generator=g, device=dev)
        for dtype in (torch.float32, torch.bfloat16, torch.int8):
            if dtype == torch.int8:
                cq, cs, cm = topk.quantize_corpus_int8(base)
                fn = functools.partial(topk.cosine_topk_int8, cq, cs, queries, corpus_mean=cm)
                del cq, cs, cm
            else:
                fn = functools.partial(topk.cosine_topk, base.to(dtype), queries)
            lists_win_to, lost = 0, False   # the lists win at every k up to lists_win_to
            for k in CROSSOVER_K:
                ms = {"lists": 0.0, "select": 0.0}
                for path, limit in (("lists", topk.LIST_MAX), ("select", 0), ("select", 0),
                                    ("lists", topk.LIST_MAX)):
                    with mock.patch.dict(topk.LIST_K, {dtype: limit}):
                        ms[path] += cuda_ms(lambda: fn(k), 10) / 2
                emit("crossover", dtype=str(dtype), n=n, k=k, lists_ms=ms["lists"],
                     select_ms=ms["select"])
                lost = lost or ms["lists"] >= ms["select"]
                if not lost:
                    lists_win_to = k
            emit("crossover_summary", dtype=str(dtype), n=n, lists_win_up_to=lists_win_to,
                 list_k=topk.LIST_K[dtype])
            del fn
        del base
        torch.cuda.empty_cache()


def _int8_tile_record(dev) -> dict:
    """What the occupancy calculator says of B4's kernel, its score kernel
    and P2's int8 kernel at D = 1024: CTAs an SM, registers and stack bytes
    a thread, dynamic shared memory."""
    from rag_serving_system_torch.ops import topk

    return {kernel: topk.int8_tile_info(kernel, 1024, dev.index)._asdict()
            for kernel in ("topk", "scores", "dot")}


def _seeded_qkv(dev, shape_q, shape_kv, dtype, seed):
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(s, generator=g, device=dev).to(dtype)
            for s in (shape_q, shape_kv, shape_kv)]


def _timed_call(call):
    """(CUDA-event ms of call over 10 launches, None) or (None, the error)."""
    try:
        return cuda_ms(call, 10), None
    except Exception as e:  # a library call this PyTorch does not take
        return None, f"{type(e).__name__}: {e}"[:300]


def _sdpa_ms(q, k, v, valid):
    """One F.scaled_dot_product_attention call on (B, H, S, D) copies of
    q/k/v with a bool (B, 1, S, S) mask and enable_gqa: library_ms."""
    import torch.nn.functional as F

    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    return _timed_call(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=valid,
                                                              enable_gqa=True))


def _kernel_device_ms(call, reps: int = 10):
    """Mean device time a call spends in the flash kernels it launches
    (torch.profiler's CUDA events of kernels named flash*, over reps calls
    after a warm-up), apart from its other kernels and the host; None where
    the profiler sees no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            call()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA and "flash" in e.name
             and not getattr(e, "is_user_annotation", False))
    return us / reps / 1e3 if us > 0 else None


def _attention_record(out, ref, real, tol, name) -> dict:
    diff = (out.float() - ref.float())[real].abs()
    err = diff.max().item()
    require(err <= tol, f"{name} differs by {err} > {tol}")
    return {"max_abs_err": err, "mean_abs_err": diff.mean().item(), "tol": tol}


def _check_flash(dev, dtype, tol, seed, b=32, s=512, padding="left", heads=(12, 2, 128)):
    """B2 on a seeded (b, s) batch against its plain version. Left padding
    (prompts; the last row has every key masked and must come out 0) or
    right padding (`compute_prefix_kv`'s prefixes: every row has a real
    token, of two rows or more one is full and one holds a single token; a
    pad query i >= n sees the keys j < n, so every position is compared).
    The byte bound counts K and V at the real keys only: no query needs a
    masked key, and the kernel skips the tiles that hold none."""
    import numpy as np
    import torch
    from rag_serving_system_torch.ops import attention as att

    hq, hk, d = heads
    q, k, v = _seeded_qkv(dev, (b, s, hq, d), (b, s, hk, d), dtype, seed)
    rng = np.random.default_rng(seed)
    if padding == "left":
        pads = rng.integers(0, s, size=b)
        pads[-1] = s                      # one row with every key masked
        keys = np.arange(s)[None, :] >= pads[:, None]
        real_len = (s - pads).astype(np.int64)
        pairs = int((real_len * (real_len + 1) // 2).sum())   # visible (query, key) pairs
    else:
        real_len = rng.integers(1, s + 1, size=b).astype(np.int64)
        if b > 1:
            real_len[0], real_len[-1] = s, 1
        keys = np.arange(s)[None, :] < real_len[:, None]
        # query i sees min(i + 1, n) keys
        pairs = int((real_len * (real_len + 1) // 2 + (s - real_len) * real_len).sum())
    mask = torch.as_tensor(keys.astype(np.int32), device=dev)
    ref = att.flash_attention_plain(q, k, v, mask)
    real = mask.bool() if padding == "left" else torch.ones_like(mask, dtype=torch.bool)

    out = att.flash_attention(q, k, v, mask)
    require(not out[~real].any().item(), "flash_attention: fully masked rows are not 0")
    rec = _attention_record(out, ref, real, tol, f"flash_attention {dtype} {padding}-padded")
    ms = cuda_ms(lambda: att.flash_attention(q, k, v, mask), 10)
    device_ms = _kernel_device_ms(lambda: att.flash_attention(q, k, v, mask))
    plain_ms = cuda_ms(lambda: att.flash_attention_plain(q, k, v, mask), 3)
    valid = mask.bool()[:, None, None, :] & torch.tril(torch.ones((s, s), dtype=torch.bool,
                                                                  device=dev))
    library_ms, library_error = _sdpa_ms(q, k, v, valid)
    nbytes = ((b * s * 2 * hq + int(real_len.sum()) * 2 * hk) * d * q.element_size()
              + b * s * 4)
    return {"shape": [b, s, hq, hk, d], "dtype": str(dtype), "padding": padding,
            "real_keys": int(real_len.sum()), **rec,
            "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "library": "F.scaled_dot_product_attention(bool mask, enable_gqa=True)",
            "library_error": library_error,
            **bound(nbytes, 4 * d * hq * pairs, "bf16" if dtype == torch.bfloat16 else "f32")}


def _check_ragged_depths(dev, seed):
    """B1 (f32 and bf16 corpus) and B4 at D = 50 and 100, which the wrappers
    pad with zero columns to a multiple of 16: against the plain versions on
    the unpadded tensors (B4: ids identical, scores within 1e-6, the mean
    term being an f32 sum over D terms in one run and the padded D in the
    other)."""
    import torch
    from rag_serving_system_torch.ops import topk

    n, b, k = 100_000, 32, 16
    records = []
    for d in (50, 100):
        g = torch.Generator(device=dev).manual_seed(seed + d)
        base = topk.l2_normalize(torch.randn((n, d), generator=g, device=dev))
        queries = torch.randn((b, d), generator=g, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            r = _check_topk(base.to(dtype), queries, k, reps=5)
            records.append({"name": "cosine_topk", "d": d, **r})
        cq, cs, cm = topk.quantize_corpus_int8(base)
        s_k, i_k = topk.cosine_topk_int8(cq, cs, queries, k, corpus_mean=cm)
        s_p, i_p = topk.cosine_topk_int8_reference(cq, cs, queries, k, corpus_mean=cm)
        torch.cuda.synchronize()
        err = (s_k - s_p).abs().max().item()
        require(torch.equal(i_k, i_p), f"cosine_topk_int8 indices differ at D={d}")
        require(err <= 1e-6, f"cosine_topk_int8 scores differ by {err} at D={d}")
        records.append({"name": "cosine_topk_int8", "d": d, "n": n, "b": b, "k": k,
                        "max_abs_err": err,
                        "ms": cuda_ms(lambda: topk.cosine_topk_int8(
                            cq, cs, queries, k, corpus_mean=cm), 5),
                        "plain_ms": cuda_ms(lambda: topk.cosine_topk_int8_reference(
                            cq, cs, queries, k, corpus_mean=cm), 2),
                        "library_ms": None, **_int8_bound(n, d, b, k)})
    return records


def packed_lengths(seed: int, n_seg: int = 32, t: int = 8192) -> list:
    """n_seg seeded segment lengths in [64, 512] that leave a pad tail in t
    (skewed toward short rows, as retrieved prompts are)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    while True:
        lens = (64 + np.floor(448 * rng.random(n_seg) ** 2)).astype(int)
        if lens.sum() < t:
            return lens.tolist()


def _varlen_ms(q, k, v, lens: list):
    """(library, ms, error) of one varlen_attn call over the segments of
    `lens`, back to back from token 0 of the (1, T, H, D) q/k/v; (..., None,
    error) where this PyTorch lacks it or its causal option."""
    import numpy as np
    import torch

    library = "torch.nn.attention.varlen.varlen_attn"
    try:
        from torch.nn.attention.varlen import varlen_attn
    except ImportError as e:
        return library, None, f"ImportError: {e}"
    n = sum(lens)
    cu = torch.tensor(np.concatenate([[0], np.cumsum(lens)]), dtype=torch.int32,
                      device=q.device)
    mx = max(lens)
    sig = inspect.signature(varlen_attn)
    causal = ({"is_causal": True} if "is_causal" in sig.parameters
              else {"window_size": (-1, 0)} if "window_size" in sig.parameters else None)
    if causal is None:
        return library, None, f"varlen_attn{sig} takes no causal mask"
    qs, ks, vs = q[0, :n], k[0, :n], v[0, :n]
    ms, err = _timed_call(lambda: varlen_attn(qs, ks, vs, cu, cu, mx, mx, **causal))
    return library, ms, err and f"varlen_attn{sig}: {err}"


def _check_flash_packed(dev, dtype, tol, seed, t=8192, heads=(12, 2, 128), n_seg=32,
                        lens=None):
    """B3 on a seeded (1, t) stream of segments and a pad tail, against its
    plain version at the real tokens, under both contracts: n_real = T (every
    row computed, the pad tail as a segment of its own) and the served one,
    n_real = the real tokens (rows past it exactly 0). The record's ms,
    plain_ms, library_ms and bound are the served contract's: the library
    call runs varlen_attn over the real segments only (the same work), the
    bound counts q, k, v and o of the real tokens plus the zero rows written;
    the *_all_rows fields are the n_real = T contract's, its library call
    over every segment, the pad tail's included. A checkout whose wrapper
    takes no n_real gets the n_real = T contract's record alone."""
    import numpy as np
    import torch
    from rag_serving_system_torch.ops import attention as att

    hq, hk, d = heads
    lens = lens or packed_lengths(seed, n_seg, t)
    n_real = sum(lens)
    seg_np = np.full(t, len(lens), np.int32)   # pad tail: id = number of rows
    seg_np[:n_real] = np.repeat(np.arange(len(lens)), lens)
    seg = torch.as_tensor(seg_np[None], device=dev)
    q, k, v = _seeded_qkv(dev, (1, t, hq, d), (1, t, hk, d), dtype, seed)
    ref = att.flash_attention_packed_plain(q, k, v, seg)
    real = torch.zeros((1, t), dtype=torch.bool, device=dev)
    real[0, :n_real] = True
    kind = "bf16" if dtype == torch.bfloat16 else "f32"
    es = q.element_size()
    pairs = sum(x * x + x for x in lens) // 2

    rec = _attention_record(att.flash_attention_packed(q, k, v, seg), ref, real, tol,
                            f"flash_attention_packed {dtype}")
    ms = cuda_ms(lambda: att.flash_attention_packed(q, k, v, seg), 10)
    device_ms = _kernel_device_ms(lambda: att.flash_attention_packed(q, k, v, seg))
    plain_ms = cuda_ms(lambda: att.flash_attention_packed_plain(q, k, v, seg), 3)
    all_lens = lens + ([t - n_real] if t > n_real else [])
    library, library_ms, library_error = _varlen_ms(q, k, v, all_lens)
    if library_ms is None:   # one SDPA call with the block-diagonal causal mask
        sg = seg[0]
        valid = ((sg[:, None] == sg[None, :])
                 & torch.tril(torch.ones((t, t), dtype=torch.bool, device=dev)))[None, None]
        library = "F.scaled_dot_product_attention(block-diagonal bool mask, enable_gqa=True)"
        library_ms, err2 = _sdpa_ms(q, k, v, valid)
        library_error = f"{library_error}; {err2}" if err2 else library_error
    whole = {"ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
             "library_ms": library_ms, "library": library,
             "library_error": library_error,
             **bound(t * (2 * hq + 2 * hk) * d * es + t * 4, 4 * d * hq * pairs, kind)}
    out = {"t": t, "segments": len(lens), "real_tokens": n_real,
           "sum_len_sq": int(sum(x * x for x in lens)), "dtype": str(dtype), "heads": [hq, hk, d]}
    if "n_real" not in inspect.signature(att.flash_attention_packed).parameters:
        return {**out, "contract": "n_real = T", **rec, **whole}

    served = att.flash_attention_packed(q, k, v, seg, n_real=n_real)
    require(not served[:, n_real:].any().item(),
            f"flash_attention_packed {dtype}: rows past n_real are not 0")
    srec = _attention_record(served, ref, real, tol, f"flash_attention_packed {dtype} n_real")
    s_ms = cuda_ms(lambda: att.flash_attention_packed(q, k, v, seg, n_real=n_real), 10)
    s_device = _kernel_device_ms(lambda: att.flash_attention_packed(q, k, v, seg, n_real=n_real))
    s_plain = cuda_ms(lambda: att.flash_attention_packed_plain(q, k, v, seg, n_real=n_real), 3)
    s_library, s_library_ms, s_error = _varlen_ms(q, k, v, lens)
    nbytes = n_real * (2 * hq + 2 * hk) * d * es + (t - n_real) * hq * d * es + n_real * 4
    return {**out, "contract": "n_real", **srec, "ms": s_ms, "device_ms": s_device,
            "plain_ms": s_plain,
            "library_ms": s_library_ms, "library": f"{s_library} (real segments)",
            "library_error": s_error, **bound(nbytes, 4 * d * hq * pairs, kind),
            **{f"{key}_all_rows": val for key, val in rec.items()},
            **{f"{key}_all_rows": val for key, val in whole.items()
               if key not in ("library", "library_ms", "library_error")},
            "library_all_segments_ms": library_ms, "library_all_segments": library,
            "library_all_segments_error": library_error}


def _int8_bound(n, d, b, k) -> dict:
    return bound(n * d + 4 * n + b * d + b * k * 8, 2 * b * n * d, "int8")


def _check_topk_int8(dev, seed):
    """B4 at 1M rows (k = 16 on the warp lists; 64, 256 and 1024 through
    the score kernel and select_topk), then chunked over 10M: indices
    identical and scores bit-identical to the plain version (the int32 dot is
    exact in both, and each score is one correctly rounded product), ties
    included."""
    from unittest import mock

    import torch
    from rag_serving_system_torch.ops import topk
    from rag_serving_system_torch.profile_topk import int8_chunks

    n, d, b, k = 1 << 20, 1024, 32, 16
    g = torch.Generator(device=dev).manual_seed(seed)
    corpus = torch.randint(-127, 128, (n, d), generator=g, device=dev, dtype=torch.int8)
    scales = torch.rand((1, n), generator=g, device=dev) / 127 + 1e-4
    mean = torch.randn((1, d), generator=g, device=dev) * 0.03
    queries = torch.randn((b, d), generator=g, device=dev)
    s_k, i_k = topk.cosine_topk_int8(corpus, scales, queries, k, corpus_mean=mean)
    s_p, i_p = topk.cosine_topk_int8_reference(corpus, scales, queries, k,
                                               corpus_mean=mean)
    torch.cuda.synchronize()
    require(torch.equal(i_k, i_p), "cosine_topk_int8 indices differ at 1M rows")
    require(torch.equal(s_k, s_p), "cosine_topk_int8 scores are not bit-identical")
    ms = cuda_ms(lambda: topk.cosine_topk_int8(corpus, scales, queries, k,
                                               corpus_mean=mean), 20)
    plain_ms = cuda_ms(lambda: topk.cosine_topk_int8_reference(
        corpus, scales, queries, k, corpus_mean=mean), 3)
    one = {"n": n, "b": b, "k": k, "max_abs_err": (s_k - s_p).abs().max().item(),
           "ms": ms, "plain_ms": plain_ms, "library_ms": None, **_int8_bound(n, d, b, k)}
    wide = []
    for kw in (64, 256, 1024):
        s_k, i_k = topk.cosine_topk_int8(corpus, scales, queries, kw, corpus_mean=mean)
        s_p, i_p = topk.cosine_topk_int8_reference(corpus, scales, queries, kw,
                                                   corpus_mean=mean)
        torch.cuda.synchronize()
        require(torch.equal(i_k, i_p), f"cosine_topk_int8 indices differ at k={kw}")
        require(torch.equal(s_k, s_p), f"cosine_topk_int8 scores at k={kw} are not "
                "bit-identical")
        wide.append({"n": n, "b": b, "k": kw, "max_abs_err": (s_k - s_p).abs().max().item(),
                     "path": ("warp lists" if kw <= topk.LIST_K[torch.int8]
                              else "scores + select_topk"),
                     "ms": cuda_ms(lambda: topk.cosine_topk_int8(
                         corpus, scales, queries, kw, corpus_mean=mean), 5),
                     "plain_ms": cuda_ms(lambda: topk.cosine_topk_int8_reference(
                         corpus, scales, queries, kw, corpus_mean=mean), 2),
                     "library_ms": None, **_int8_bound(n, d, b, kw)})
    del corpus, scales
    torch.cuda.empty_cache()

    n10, chunk = 10_000_000, 4_194_304
    chunks = int8_chunks(n10, chunk, dev, seed=seed + 1)
    s_k, i_k = topk.cosine_topk_int8_chunked(chunks, queries, k)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with mock.patch.object(topk, "cosine_topk_int8", topk.cosine_topk_int8_reference):
        start.record()
        s_p, i_p = topk.cosine_topk_int8_chunked(chunks, queries, k)
        end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)  # one run: the plain scan takes seconds
    require(torch.equal(i_k, i_p), "cosine_topk_int8_chunked indices differ at 10M rows")
    require(torch.equal(s_k, s_p), "cosine_topk_int8_chunked scores are not bit-identical")
    ten = {"n": n10, "chunks": len(chunks), "b": b, "k": k,
           "corpus_gb": sum(c.numel() for c, _ in chunks) / 1e9,
           "max_abs_err": (s_k - s_p).abs().max().item(),
           "ms": cuda_ms(lambda: topk.cosine_topk_int8_chunked(chunks, queries, k), 4),
           "plain_ms": plain_ms, "library_ms": None, **_int8_bound(n10, d, b, k)}
    del chunks
    torch.cuda.empty_cache()
    return one, wide, ten


def _check_probes(dev, seed):
    """P1 and P2 at 1M rows against their plain versions. They differ only
    in summation order, which moves an f32 sum of m terms by at most about
    m * 2^-24 * (the sum of the terms' absolute values): that bound, not the
    result, which cancels, sets each tolerance. P1 sums 512 block maxima in
    a fixed order (and the plain version in another): m = 2 * 512. P2's sums
    are random-sign dot products, whose order errors stay far below the
    worst case: m = 32 is a wide margin, still tight enough to catch one
    dropped or doubled row."""
    import torch
    from rag_serving_system_torch.ops import probes, topk

    n, d, b, block_n = 1 << 20, 1024, 32, 2048
    g = torch.Generator(device=dev).manual_seed(seed)
    base = topk.l2_normalize(torch.randn((n, d), generator=g, device=dev))
    queries = torch.randn((b, d), generator=g, device=dev)
    q8 = torch.randint(-127, 128, (b, d), generator=g, device=dev, dtype=torch.int8)
    c8 = torch.randint(-127, 128, (n, d), generator=g, device=dev, dtype=torch.int8)
    records = []
    for name, corpus, q in (("f32", base, queries), ("bf16", base.to(torch.bfloat16), queries),
                            ("int8", c8, q8)):
        out = probes.stream_probe(corpus, block_n)
        ref = probes.stream_probe_plain(corpus, block_n)
        tol = 2 * (n // block_n) * 2.0 ** -24 * probes.abs_terms(corpus, None, block_n)
        err = (out - ref).abs()
        require(bool((err <= tol).all()), f"stream_probe {name} differs beyond "
                f"its summation-order bound: {err.max().item()}")
        itemsize = corpus.element_size()
        records.append({"name": "stream_probe", "corpus": name, "n": n, "block_n": block_n,
                        "max_abs_err": err.max().item(), "tol": tol.min().item(),
                        "ms": cuda_ms(lambda: probes.stream_probe(corpus, block_n), 20),
                        "plain_ms": cuda_ms(lambda: probes.stream_probe_plain(corpus, block_n), 3),
                        "library_ms": None,
                        **bound(n * d * itemsize + (n // block_n) * d * 4, 0, "f32")})
        for highest in ((True, False) if name == "f32" else (True,)):
            out = probes.dot_probe(corpus, q, block_n, highest)
            ref = probes.dot_probe_plain(corpus, q, block_n, highest)
            tol = 32 * 2.0 ** -24 * probes.abs_terms(corpus, q, block_n, highest)
            err = (out - ref).abs()
            require(bool((err <= tol).all()), f"dot_probe {name} highest={highest} "
                    f"differs beyond its summation-order bound: {err.max().item()}")
            kind = ("int8" if name == "int8" else "f32" if name == "f32" and highest
                    else "bf16")
            records.append({
                "name": "dot_probe", "corpus": name, "highest": highest, "n": n, "b": b,
                "max_abs_err": err.max().item(), "tol": tol.min().item(),
                "ms": cuda_ms(lambda: probes.dot_probe(corpus, q, block_n, highest), 20),
                "plain_ms": cuda_ms(lambda: probes.dot_probe_plain(corpus, q, block_n,
                                                                   highest), 3),
                "library_ms": None,
                **bound(n * d * itemsize + b * d * q.element_size() + b * 128 * 4,
                        2 * b * n * d, kind)})
    del base, c8
    torch.cuda.empty_cache()
    return records


def check_attention(dev) -> dict:
    """B2 and B3 against their plain versions at the kernels phase's shapes
    (bf16 and f32); returns the main-path record of each name."""
    import torch

    out = {}
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 2e-4)):
        r = _check_flash(dev, dtype, tol, seed=1)
        emit("kernel", name="flash_attention", **r)
        out.setdefault("flash_attention", r)
        # a mesh position's heads (serve_mesh: 6 query heads, 1 KV head)
        emit("kernel", name="flash_attention",
             **_check_flash(dev, dtype, tol, seed=17, heads=(6, 1, 128)))
        r = _check_flash_packed(dev, dtype, tol, seed=2)
        emit("kernel", name="flash_attention_packed", **r)
        out.setdefault("flash_attention_packed", r)
        for b, s in ((32, 512), (8, 768)):   # compute_prefix_kv's: (misses, pool_len)
            emit("kernel", name="flash_attention",
                 **_check_flash(dev, dtype, tol, seed=11, b=b, s=s, padding="right"))
    # the narrow heads, at the shapes the tiny preset's serve gives them (4
    # query and 2 key heads): B2 on a left-padded (4, 128) prompt batch and
    # on right-padded (4, 48) prefixes, B3 on a (1, 256) stream of 4 rows;
    # f32 (the summary's record: serve_tiny runs in f32) and bf16
    for d in (16, 32):
        for dtype, tol in ((torch.float32, 2e-4), (torch.bfloat16, 2e-2)):
            r = _check_flash(dev, dtype, tol, seed=14, b=4, s=128, heads=(4, 2, d))
            emit("kernel", name=f"flash_attention[D={d}]", **r)
            out.setdefault(f"flash_attention[D={d}]", r)
            emit("kernel", name=f"flash_attention[D={d}]",
                 **_check_flash(dev, dtype, tol, seed=15, b=4, s=48, padding="right",
                                heads=(4, 2, d)))
            r = _check_flash_packed(dev, dtype, tol, seed=16, t=256, heads=(4, 2, d),
                                    lens=[61, 48, 57, 52])
            emit("kernel", name=f"flash_attention_packed[D={d}]", **r)
            out.setdefault(f"flash_attention_packed[D={d}]", r)
    torch.cuda.empty_cache()
    return out


def phase_kernels(dev) -> dict:
    """Each kernel against its plain version. Returns the main-path record of
    each (f32 retrieval at 1M docs; bf16 attention; int8 retrieval at 1M
    docs; the probes on the f32 corpus)."""
    import torch

    from rag_serving_system_torch.ops.topk import l2_normalize

    out = {}
    for n in (1_000_000, 1000):  # the exact regime's scale; the served corpus
        g = torch.Generator(device=dev).manual_seed(0)
        corpus = l2_normalize(torch.randn((n, 1024), generator=g, device=dev))
        queries = torch.randn((32, 1024), generator=g, device=dev)
        for dtype in ((torch.float32, torch.bfloat16) if n > 1000 else (torch.float32,)):
            c = corpus.to(dtype)
            for k in ((16, 64, 256, 1024) if n > 1000 else (16,)):
                r = _check_topk(c, queries, k, reps=20 if k == 16 else 5)
                emit("kernel", name="cosine_topk", **r)
                out.setdefault("cosine_topk", r)
            del c
        del corpus
        torch.cuda.empty_cache()
    out.update(check_attention(dev))
    for r in _check_ragged_depths(dev, seed=12):
        emit("kernel", **r)
    one, wide, ten = _check_topk_int8(dev, seed=3)
    for r in (one, *wide):
        emit("kernel", name="cosine_topk_int8", **r)
    emit("kernel", name="cosine_topk_int8_chunked", **ten)
    out["cosine_topk_int8"] = one
    for r in _check_probes(dev, seed=5):
        emit("kernel", **r)
        out.setdefault(r["name"], r)
    for r in _check_select(dev, seed=8):
        emit("kernel", name="select_topk", **r)
        out.setdefault("select_topk", r)
    emit("int8_tile", **_int8_tile_record(dev))
    _crossover(dev, seed=9)
    return out


def phase_roofline() -> None:
    """profile_topk's 1M-row decomposition: the path that runs P1 and P2."""
    from rag_serving_system_torch.profile_topk import roofline

    reset_launches()
    roofline(1 << 20, ("fp", "int8"), emit=lambda line: emit("roofline", **json.loads(line)))
    launches = read_launches()
    require_launched("roofline", launches)
    return launches


def _answered(request_queue, queries: list) -> tuple:
    """Add `queries` at once and wait for all; (results, wall seconds). Every
    result must be {"result": str}."""
    t0 = time.perf_counter()
    ids = [request_queue.add_request(q, 2) for q in queries]
    results = [request_queue.get_result(i, timeout=300) for i in ids]
    seconds = time.perf_counter() - t0
    bad = [r for r in results if not (isinstance(r, dict) and isinstance(r.get("result"), str))]
    require(not bad, f"{len(bad)} of {len(results)} requests did not come back as "
            f"{{'result': str}}: {bad[:3]}")
    return results, seconds


def _drive(processor, request_queue, queries: list, n_batch: int) -> dict:
    """One lone request, then n_batch at once, through the running
    processor; returns the results and their wall times."""
    processor.start()
    try:
        results, t_lone = _answered(request_queue, queries[:1])
        more, t_batch = _answered(request_queue, queries[1:1 + n_batch])
    finally:
        processor.stop(drain_timeout=10.0)
        processor.join(timeout=30)
    results += more
    require(len(results) == n_batch + 1, f"{len(results)} results for {n_batch + 1} requests")
    return {"lone_request_s": t_lone, f"batch_of_{n_batch}_s": t_batch,
            "requests": len(results), "answered": len(results),
            "sample_answer": results[0]}


def _serve_env(**over) -> None:
    set_env(DOCUMENT_TEXT_FILE=os.path.join(DATA, "squad_real_contexts.json"),
            DOCUMENT_EMBEDDINGS_FILE=os.path.join(DATA, "squad_real_embeddings.npy"), **over)


def _three_steps(processor, request_queue, cache, queries: list) -> tuple:
    """A lone request, 64 at once, the same 64 again, through the running
    processor: (steps, summed launches, peaks). Each step carries its
    seconds, its launch counts, the prefix cache's hits, misses and bypasses,
    the device memory held before it and its own peak; `peaks` has the peak
    up to the first step (construction) and over the steps. The peak
    counter is reset before each step."""
    import torch

    steps, total = {}, {}
    peaks = {"construction_gb": torch.cuda.max_memory_allocated() / 1e9}
    for step, qs in (("a_lone_miss", queries[:1]), ("b_64_misses", queries[1:65]),
                     ("c_64_hits", queries[1:65])):
        before = cache.stats()
        held_gb = torch.cuda.memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        _, seconds = _answered(request_queue, qs)
        launches = read_launches()
        after = cache.stats()
        steps[step] = {"requests": len(qs), "seconds": seconds, "launches": launches,
                       "held_before_gb": held_gb,
                       "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                       **{k: after[k] - before[k] for k in ("hits", "misses", "bypassed")},
                       "entries": after["entries"]}
        for name, n in launches.items():
            total[name] = total.get(name, 0) + n
    peaks["serving_gb"] = max(st["peak_memory_gb"] for st in steps.values())
    return steps, total, peaks


def _require_prefix_steps(steps: dict, layers: int, cache, phase: str) -> None:
    """The three steps took the miss, miss and hit routes: B2 ran `layers`
    times a miss batch and never for the hits, which skipped retrieval too."""
    a, b, c = steps["a_lone_miss"], steps["b_64_misses"], steps["c_64_hits"]
    require((a["misses"], a["hits"], a["entries"]) == (1, 0, 1)
            and a["launches"]["flash_attention"] == layers,
            f"{phase}: the lone request was not one miss computed in {layers} B2 "
            f"launches: {a}")
    require(b["hits"] + b["misses"] == 64 and b["bypassed"] == 0 and b["misses"] > 0
            and b["launches"]["flash_attention"] > 0
            and b["launches"]["flash_attention"] % layers == 0,
            f"{phase}: the 64 requests did not take the miss route through B2: {b}")
    require(b["entries"] <= cache.capacity and b["entries"] <= 1 + b["misses"],
            f"{phase}: entries after the misses: {b}")
    # the same 64: every row whose entry is cached hits (all, while the
    # entries fit the pool), and B2 runs only for rows that missed
    require(c["hits"] == 64 - c["misses"] and c["entries"] == b["entries"]
            and (c["misses"] == 0) == (c["launches"]["flash_attention"] == 0)
            and c["launches"]["flash_attention"] % layers == 0,
            f"{phase}: the repeated 64 requests did not hit: {c}")
    require(c["misses"] == 0, f"{phase}: {c['misses']} repeated requests missed although "
            f"{b['entries']} entries fit {cache.capacity} slots")
    require(c["launches"]["cosine_topk"] == 0,
            f"{phase}: the repeated requests retrieved again although the query cache is on")


def phase_serve(queries: list) -> tuple:
    """The full-width engine at its default settings (the prefix-KV cache
    on) behind the queue and the batch processor: a lone request, 64 at
    once, the same 64 again. Returns each kernel's launch count over the
    three steps, and the stage-split rows. B2 is then held against its plain
    version at the very (misses, pool_len) shapes `compute_prefix_kv` gave
    it here."""
    from unittest import mock

    import torch
    from rag_serving_system_torch.core import engine as engine_mod
    from rag_serving_system_torch.main import build_processor

    _serve_env()
    require("PREFIX_CACHE" not in os.environ, "the serve phase must run at the default "
            "PREFIX_CACHE")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    processor, engine, request_queue, settings = build_processor()
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    cache = engine.prefix_cache
    require(settings.prefix_cache and cache is not None, "the prefix cache is not on")
    layers = engine.dec_cfg.num_layers
    miss_shapes = []

    def shape_recorded(fn):
        def call(params, cfg, input_ids, *a, **kw):
            miss_shapes.append(tuple(input_ids.shape))
            return fn(params, cfg, input_ids, *a, **kw)
        return call

    recorder = mock.patch.object(engine_mod, "compute_prefix_kv",
                                 shape_recorded(engine_mod.compute_prefix_kv))
    recorder.start()
    processor.start()
    try:
        steps, total, peaks = _three_steps(processor, request_queue, cache, queries)
    finally:
        processor.stop(drain_timeout=10.0)
        processor.join(timeout=30)
        recorder.stop()
    emit("serve", init_s=t_init, prefix_cache=True, pool_len=cache.pool_len,
         entry_mb=cache.entry_bytes / 2 ** 20, steps=steps, launches=total,
         batches=processor.batches_processed, stages=engine.timer.summary(),
         compute_prefix_kv_shapes=miss_shapes,
         prefix_stats=cache.stats(), query_cache=engine.query_cache_stats(),
         peak_memory_gb=max(peaks.values()), peaks=peaks)
    require_launched("serve", total)
    _require_prefix_steps(steps, layers, cache, "serve")
    # B2 at the shapes this run's misses gave it (the fewest and the most
    # distinct misses of a batch, at the pool length the corpus set), in the
    # served bf16 and in f32
    require(miss_shapes and all(pl == cache.pool_len for _, pl in miss_shapes),
            f"compute_prefix_kv saw shapes {miss_shapes} at pool_len {cache.pool_len}")
    for m in sorted({min(m for m, _ in miss_shapes), max(m for m, _ in miss_shapes)}):
        for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 2e-4)):
            emit("kernel", name="flash_attention", served_shape=True,
                 **_check_flash(engine.device, dtype, tol, seed=13, b=m, s=cache.pool_len,
                                padding="right"))
    splits = {}
    for label, before_rep in (("miss", cache.clear), ("hit", None)):
        splits[label] = _stage_split(engine, queries[1:33], label=label,
                                     before_rep=before_rep)
        emit("stage_split", **splits[label])
    emit("serve_trace", route="hit", **_traced_serve_batch(engine, queries[1:33]))
    stats = cache.stats()
    emit("serve_memory",
         peak_memory_gb=max(*peaks.values(), torch.cuda.max_memory_allocated() / 1e9),
         pool_rows=stats["pool_reserved_bytes"] // cache.entry_bytes,
         pool_gb=stats["pool_reserved_bytes"] / 1e9, prefix_stats=stats)
    del processor, engine, cache
    torch.cuda.empty_cache()
    return total, splits


def b3_recorder():
    """(a patch of qwen2's B3 that records each call's (n_real, T), the list
    it fills): the packed steps must pass the stream's real count, below T
    where the stream ends in a pad tail."""
    from unittest import mock

    from rag_serving_system_torch.models import qwen2

    calls, b3 = [], qwen2.flash_attention_packed

    def call(q, k, v, seg, n_real=None):
        calls.append((n_real, q.shape[1]))
        return b3(q, k, v, seg, n_real)
    return mock.patch.object(qwen2, "flash_attention_packed", call), calls


def require_b3_rows(phase: str, calls: list) -> list:
    """Each B3 call of a packed step got n_real <= T, some below T; returns
    the distinct (n_real, T) pairs."""
    pairs = sorted(set(calls))
    require(calls and all(n is not None and 0 < n <= t for n, t in calls)
            and any(n < t for n, t in calls),
            f"{phase}: B3 called with (n_real, T) {pairs}")
    return [list(x) for x in pairs]


def phase_serve_cold(queries: list) -> dict:
    """The full-width engine with PREFIX_CACHE=0 behind the queue and the
    batch processor: a lone request (padded prefill), 64 at once (packed).
    Returns each kernel's launch count over the served requests."""
    import torch
    from rag_serving_system_torch.main import build_processor

    _serve_env(PREFIX_CACHE="0")
    t0 = time.perf_counter()
    processor, engine, request_queue, _ = build_processor()
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    require(engine.prefix_cache is None, "PREFIX_CACHE=0 left the prefix cache on")
    patch, b3_calls = b3_recorder()
    reset_launches()
    with patch:
        r = _drive(processor, request_queue, queries[:65], 64)
    launches = read_launches()
    emit("serve_cold", init_s=t_init, prefix_cache=False, **r, launches=launches,
         batches=processor.batches_processed, stages=engine.timer.summary(),
         b3_n_real_and_t=require_b3_rows("serve_cold", b3_calls))
    require_launched("serve_cold", launches)
    for name in ("cosine_topk", "flash_attention"):   # B3 is this phase's own
        require(launches[name] > 0, f"kernel {name} never launched in serve_cold")
    for n in (1, 32):
        emit("stage_split", **_stage_split(engine, queries[:n], label="cold"))
    del processor, engine
    torch.cuda.empty_cache()
    return launches


def phase_stage_split(queries: list) -> None:
    """Only the stage splits, 5 reps each: the A/B mode (`--stage-split`).
    The cold rows first (they also run from a checkout of the port that
    lacks the prefix cache), then all miss and all hit at the defaults."""
    from rag_serving_system_torch.main import build_processor

    _serve_env(PREFIX_CACHE="0")
    _, engine, _, _ = build_processor()
    engine.warmup()
    for n in (1, 32):
        emit("stage_split", **_stage_split(engine, queries[:n], label="cold", reps=5))
    del engine
    _serve_env()
    _, engine, _, _ = build_processor()
    engine.warmup()
    for label, before_rep in (("miss", engine.prefix_cache.clear), ("hit", None)):
        emit("stage_split", **_stage_split(engine, queries[1:33], label=label,
                                           before_rep=before_rep, reps=5))


def _stage_split(engine, queries: list, label: str, before_rep=None, reps: int = 3) -> dict:
    """One batch through the engine's stages on the CUDA-synced host clock,
    mean of reps after a warm-up, the query cache off (every batch encodes
    and retrieves): prepare (encode, retrieve, prompt build), prefix_resolve
    (lookups, `compute_prefix_kv` of the misses, insert, gather), prefill
    (the synchronised call of qwen2.prefill or prefill_packed), the B2/B3
    device time inside each of the two (CUDA events around each call),
    decode (generate minus prefill and prefix_resolve). `before_rep` runs
    before every rep (emptying the prefix cache makes each an all-miss
    batch; without it the reps after the warm-up all hit)."""
    from unittest import mock

    import torch
    from rag_serving_system_torch.models import qwen2

    engine._query_cache = None
    spans = {"prefill": [], "prefix_resolve": []}
    attn = {"prefill": [], "prefix_resolve": []}
    inside = ["prefill"]

    def synced(fn, name):
        def call(*a, **kw):
            torch.cuda.synchronize()
            inside[0] = name
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            spans[name].append(time.perf_counter() - t0)
            inside[0] = "prefill"
            return out
        return call

    def evented(fn):
        def call(*a, **kw):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = fn(*a, **kw)
            end.record()
            attn[inside[0]].append((start, end))
            return out
        return call

    ks = [2] * len(queries)
    if before_rep is not None:
        before_rep()
    staged = engine.stage_prompts(engine.prepare(queries, ks))
    rows = []
    with mock.patch.object(qwen2, "prefill", synced(qwen2.prefill, "prefill")), \
            mock.patch.object(qwen2, "prefill_packed",
                              synced(qwen2.prefill_packed, "prefill")), \
            mock.patch.object(engine, "_resolve_prefixes",
                              synced(engine._resolve_prefixes, "prefix_resolve")), \
            mock.patch.object(qwen2, "flash_attention", evented(qwen2.flash_attention)), \
            mock.patch.object(qwen2, "flash_attention_packed",
                              evented(qwen2.flash_attention_packed)):
        for rep in range(reps + 1):
            for lst in (*spans.values(), *attn.values()):
                lst.clear()
            if before_rep is not None:
                before_rep()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prompts = engine.prepare(queries, ks)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            engine.finalize_tokens(engine.generate_tokens(prompts))
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            if rep:   # the first is the warm-up
                ev = {k: sum(s.elapsed_time(e) for s, e in v) / 1e3 for k, v in attn.items()}
                rows.append((t1 - t0, sum(spans["prefix_resolve"]), ev["prefix_resolve"],
                             sum(spans["prefill"]), ev["prefill"],
                             t2 - t1 - sum(spans["prefill"]) - sum(spans["prefix_resolve"]),
                             t2 - t0, len(attn["prefill"]) + len(attn["prefix_resolve"])))
    mean = [sum(r[i] for r in rows) / len(rows) for i in range(8)]
    cache = engine.prefix_cache
    return {"batch": len(queries), "route": label, "layout": staged[0],
            "prompt_slots": int(staged[1].shape[-1]),
            "pool_len": cache.pool_len if cache else None,
            "distinct_prefixes": len(cache) if cache else None,
            "prepare_ms": mean[0] * 1e3, "prefix_resolve_ms": mean[1] * 1e3,
            "prefix_resolve_attention_ms": mean[2] * 1e3, "prefill_ms": mean[3] * 1e3,
            "prefill_attention_ms": mean[4] * 1e3, "attention_launches": int(mean[7]),
            "decode_ms": mean[5] * 1e3, "process_ms": mean[6] * 1e3, "reps": reps}


def _traced_answers(engine, queries: list) -> dict:
    """One batch through prepare and generate with the prefill's first-token
    logits recorded: retrieved ids, answers, token ids, (n, V) logits."""
    from unittest import mock

    from rag_serving_system_torch.models import qwen2

    seen = []

    def recorded(fn):
        def call(*a, **kw):
            out = fn(*a, **kw)
            seen.append(out[0])
            return out
        return call

    n = len(queries)
    ks = [2] * n
    with mock.patch.object(qwen2, "prefill", recorded(qwen2.prefill)), \
            mock.patch.object(qwen2, "prefill_packed", recorded(qwen2.prefill_packed)):
        ids = engine.embed_and_retrieve(queries, ks)
        handle = engine.generate_tokens(engine.prepare(queries, ks))
    require(len(seen) == 1, f"{len(seen)} prefill calls for one batch")
    return {"ids": ids, "answers": engine.finalize_tokens(handle),
            "tokens": handle[0][:n].cpu().tolist(), "logits": seen[0][:n].float()}


def phase_parity(queries: list) -> None:
    """End to end on a small input: a full-width f32 engine, greedy, at
    PREFIX_CACHE=1, a lone request and a batch of 8. On the prefix route
    (from an emptied cache) and on the cold route (the cache switched off:
    padded for the lone request, packed for the batch) it answers through
    the kernels exactly as with each kernel's plain version swapped in; the
    hit after a miss answers exactly as the miss; and the prefix route's
    first-token logits lie within 1e-3 of the cold route's."""
    from unittest import mock

    import torch
    from rag_serving_system_torch.core import engine as engine_mod
    from rag_serving_system_torch.main import build_processor
    from rag_serving_system_torch.models import qwen2
    from rag_serving_system_torch.ops import attention, topk

    # the pool is built here and used by the last part only: `process` and
    # `generate_tokens` take the fixed path whatever DECODE_MODE says
    _serve_env(COMPUTE_DTYPE="float32", DO_SAMPLE="0", QUERY_CACHE_SIZE="0",
               DECODE_MODE="continuous", DECODE_SLOTS="4")
    _, engine, _, _ = build_processor()
    cache = engine.prefix_cache
    require(cache is not None, "the parity engine runs without the prefix cache")
    require(not torch.backends.cuda.matmul.allow_tf32, "the parity phase needs TF32 off")
    cases = {"lone": queries[65:66], "batch_of_8": queries[66:74]}

    def plain_kernels():
        return (mock.patch.object(engine_mod, "cosine_topk", topk.cosine_topk_reference),
                mock.patch.object(qwen2, "flash_attention", attention.flash_attention_plain),
                mock.patch.object(qwen2, "flash_attention_packed",
                                  attention.flash_attention_packed_plain))

    def run(repeat: bool = False):
        """Each case from an emptied prefix cache (a miss). With `repeat`,
        each case again straight after (a hit on the entry that very miss
        wrote: an entry written by another batch's miss holds the same
        values from matmuls of another shape, equal only to rounding), and
        the B2 launches of the misses and of the hits."""
        out, again, b2 = {}, {}, [0, 0]
        for name, qs in cases.items():
            if engine.prefix_cache is not None:
                cache.clear()
            for step, into in ((0, out), (1, again))[:2 if repeat else 1]:
                reset_launches()
                into[name] = _traced_answers(engine, qs)
                b2[step] += read_launches()["flash_attention"]
        return (out, again, b2) if repeat else out

    def same(x, y, bitwise=False):
        """Retrieved ids, answers and token ids equal; with `bitwise` the
        first-token logits too (a hit reads the bits its miss wrote; a
        kernel and its plain version sum in different orders)."""
        return {name: all(x[name][key] == y[name][key] for key in ("ids", "answers", "tokens"))
                and (not bitwise or torch.equal(x[name]["logits"], y[name]["logits"]))
                for name in cases}

    miss, hit, b2 = run(repeat=True)
    require(b2[0] > 0 and b2[1] == 0, f"parity: B2 launched {b2[0]} times on the prefix "
            f"route's misses and {b2[1]} times on its hits")
    a, b, c = plain_kernels()
    with a, b, c:
        miss_plain = run()
    with mock.patch.object(engine, "prefix_cache", None):
        routes = {name: engine.stage_prompts(engine.prepare(qs, [2] * len(qs)))[0]
                  for name, qs in cases.items()}
        require(routes == {"lone": "padded", "batch_of_8": "packed"},
                f"parity inputs took cold routes {routes}")
        cold = run()
        a, b, c = plain_kernels()
        with a, b, c:
            cold_plain = run()
    checks = {"prefix_kernel_vs_plain": same(miss, miss_plain),
              "prefix_miss_vs_hit": same(miss, hit, bitwise=True),
              "cold_kernel_vs_plain": same(cold, cold_plain)}
    logit_err = {name: (miss[name]["logits"] - cold[name]["logits"]).abs().max().item()
                 for name in cases}
    emit("parity", dtype="float32", cold_routes=routes, identical=checks,
         prefix_vs_cold_first_token_logits_max_abs_err=logit_err,
         prefix_vs_cold_tokens_equal={n: miss[n]["tokens"] == cold[n]["tokens"] for n in cases},
         tokens_prefix=miss["lone"]["tokens"] + miss["batch_of_8"]["tokens"][:2],
         tokens_cold=cold["lone"]["tokens"] + cold["batch_of_8"]["tokens"][:2],
         answer=miss["lone"]["answers"][0], prefix_stats=cache.stats())
    for what, per_case in checks.items():
        require(all(per_case.values()), f"parity {what}: {per_case}")
    require(all(e <= 1e-3 for e in logit_err.values()),
            f"prefix route against cold route: first-token logits differ by {logit_err}")
    _parity_quant_logits(engine, cases["lone"])
    _parity_int_mm(engine.device)
    _parity_pool(engine, cases)
    _parity_spec(engine, cases)
    engine.decode_pool.stop()
    del engine, cache
    _release()


def _parity_quant_logits(engine, lone: list) -> None:
    """QUANT_WEIGHTS=int8 first-token logits of one cold prompt against the
    unquantized f32 ones, by the bound of the JAX package's quantization
    tests: correlation above 0.99. W8A8 against weight-only int8: cosine
    above 0.99 (those tests hold 0.999 at 2 layers; at the full 28 layers,
    112 products each with its own per-token rounding, 0.9967 was measured
    on an H100). The int8 tree is made from the f32 weights and dropped."""
    from unittest import mock

    import torch
    from rag_serving_system_torch.models import qwen2
    from rag_serving_system_torch.ops.quant import quantize_decoder_params

    with mock.patch.object(engine, "prefix_cache", None):
        staged = engine.stage_prompts(engine.prepare(lone, [2]))
    require(staged[0] == "padded", f"parity: the lone prompt staged {staged[0]}")
    ids, mask = staged[1], staged[2]
    with torch.inference_mode():
        base = qwen2.prefill(engine.dec_params, engine.dec_cfg, ids, mask, 0,
                             dtype=torch.float32)[0][0]
        q8 = quantize_decoder_params(engine.dec_params)
        l8 = qwen2.prefill(q8, engine.dec_cfg, ids, mask, 0, dtype=torch.float32)[0][0]
        la = qwen2.prefill(q8, engine.dec_cfg, ids, mask, 0, dtype=torch.float32,
                           act_quant=True)[0][0]
    corr = torch.corrcoef(torch.stack([base, l8]))[0, 1].item()
    cos = (torch.dot(l8, la) / (l8.norm() * la.norm())).item()
    emit("parity_quant", prompt_slots=int(ids.shape[1]), int8_vs_f32_logit_correlation=corr,
         w8a8_vs_int8_logit_cosine=cos, argmax_equal=[bool(base.argmax() == l8.argmax()),
                                                      bool(l8.argmax() == la.argmax())])
    require(corr > 0.99, f"parity: int8 logits correlate {corr} <= 0.99 with the f32 ones")
    require(cos > 0.99, f"parity: W8A8 logits at cosine {cos} <= 0.99 of int8's")
    del q8
    torch.cuda.empty_cache()


def _parity_int_mm(dev) -> None:
    """`layers.int_matmul` (`torch._int_mm`) against `int_matmul_plain` at
    the decoder's four matmul shapes with 8192 token rows (a packed batch)
    and 32 x 17 (a small one, past the 16-row limit): the int32 sums
    identical. Beside it the CUDA-event time of the int8 product (the
    wrapper, which transposes the stored weight a call; `torch._int_mm` alone
    on the row-major and on a column-major weight), of the whole W8A8 `dense`,
    of the bf16 product of the same shape, and at 32 rows (a decode step's) of
    `dense` on the int8 weight against `dense` on the bf16 weight: the
    quantized decode product converts the whole weight at each call."""
    import torch
    from rag_serving_system_torch.models import layers
    from rag_serving_system_torch.ops.quant import quantize_int8

    g = torch.Generator(device=dev).manual_seed(21)
    for name, k, n in (("qkv_w", 1536, 2048), ("o_w", 1536, 1536), ("gu_w", 1536, 17920),
                       ("down_w", 8960, 1536)):
        wq = torch.randint(-127, 128, (k, n), generator=g, device=dev, dtype=torch.int8)
        for m in (17, 8192):
            xq = torch.randint(-127, 128, (m, k), generator=g, device=dev, dtype=torch.int8)
            xq[0], wq[:, 0] = 127, -127
            got = layers.int_matmul(xq, wq)
            torch.cuda.synchronize()
            require(got.dtype == torch.int32 and torch.equal(got, layers.int_matmul_plain(xq, wq)),
                    f"parity: torch._int_mm differs from the plain sums at {(m, k, n)}")
            require(got[0, 0].item() == -127 * 127 * k, "parity: the extreme int32 sum is wrong")
        wq_t = wq.t().contiguous().t()      # the same values, column-major
        w = (torch.randn((k, n), generator=g, device=dev) * 0.02).to(torch.bfloat16)
        qw = quantize_int8(w)
        x = torch.randn((8192, k), generator=g, device=dev).to(torch.bfloat16)
        x32 = x[:32].contiguous()
        emit("quant_product", weight=name, shape=[k, n], int32_sums_identical=True,
             prefill_rows=8192,
             int_mm_ms=cuda_ms(lambda: layers.int_matmul(xq, wq), 10),
             int_mm_row_major_weight_ms=cuda_ms(lambda: torch._int_mm(xq, wq), 10),
             int_mm_column_major_weight_ms=cuda_ms(lambda: torch._int_mm(xq, wq_t), 10),
             w8a8_dense_ms=cuda_ms(lambda: layers.dense_w8a8(x, qw), 10),
             bf16_matmul_ms=cuda_ms(lambda: layers.dense(x, w), 10),
             decode_rows=32,
             decode_int8_weight_dense_ms=cuda_ms(lambda: layers.dense(x32, qw), 20),
             decode_bf16_weight_dense_ms=cuda_ms(lambda: layers.dense(x32, w), 20),
             weight_bytes_bf16=w.numel() * 2, weight_bytes_int8=qw.q.numel() + qw.scale.numel() * 4)
        del w, qw, x, wq, xq, wq_t
    torch.cuda.empty_cache()


def _parity_pool(engine, cases: dict) -> None:
    """The decode pool against the fixed path on the f32 greedy engine, the
    decoder's matrices scaled by 4: a batch of 8 over 4 slots (two waves,
    every slot reused) on the prefix route (the miss, then the hit) and cold
    packed, and the lone request cold padded: the same answers, token for
    token."""
    from unittest import mock

    _scale_decoder(engine, 4.0)
    cache, pool = engine.prefix_cache, engine.decode_pool
    batch, lone = cases["batch_of_8"], cases["lone"]
    require(pool.slots == 4 < len(batch), f"parity: the pool has {pool.slots} slots")
    want, got, layouts = {}, {}, {}
    cache.clear()
    for name in ("prefix_miss", "prefix_hit"):
        want[name] = [r["result"] for r in engine.process(batch, [2] * len(batch))]
    cache.clear()
    for name in ("prefix_miss", "prefix_hit"):
        got[name] = _pool_answers(engine, batch)
    with mock.patch.object(engine, "prefix_cache", None):
        for name, qs in (("cold_packed", batch), ("cold_padded", lone)):
            staged = engine.stage_prompts(engine.prepare(qs, [2] * len(qs)))
            layouts[name] = staged[0]
            want[name] = [r["result"] for r in engine.process(qs, [2] * len(qs))]
            got[name] = _pool_answers(engine, qs, staged=staged)
    equal = {name: got[name] == want[name] for name in want}
    stats = pool.stats()
    emit("parity_pool", dtype="float32", decoder_scale=4.0, slots=pool.slots, window=pool.window,
         layouts=layouts, pool_equals_fixed=equal, pool=stats,
         distinct_answers=len(set(want["cold_packed"])), answer_fixed=want["cold_packed"][0],
         answer_pool=got["cold_packed"][0])
    require(layouts == {"cold_packed": "packed", "cold_padded": "padded"},
            f"parity: the pool's cold cases staged {layouts}")
    require(all(equal.values()), f"parity: pool answers differ from the fixed path's: {equal}; "
            f"{got} / {want}")
    require(stats["inserted"] == stats["completed"] == 3 * len(batch) + 1,
            f"parity: the pool's counts: {stats}")


def noisy_copies(n: int, seed: int):
    """n corpus rows: rows 0-999 are data/squad_real_embeddings.npy, row i
    past them a seeded, noise-perturbed, renormalised copy of row i % 1000,
    with row i % 1000's text. Made on the card; returned on the host."""
    import numpy as np
    import torch
    from rag_serving_system_torch.ops.topk import l2_normalize

    with open(os.path.join(DATA, "squad_real_contexts.json"), encoding="utf-8") as f:
        contexts = json.load(f)
    real = torch.as_tensor(np.load(os.path.join(DATA, "squad_real_embeddings.npy")),
                           device="cuda").float()
    g = torch.Generator(device="cuda").manual_seed(seed)
    rows = real[torch.arange(n, device="cuda") % real.shape[0]]
    rows += 0.01 * torch.randn(rows.shape, generator=g, device="cuda")
    rows[:real.shape[0]] = real
    emb = l2_normalize(rows).cpu().numpy()
    del rows
    torch.cuda.empty_cache()
    return [contexts[i % len(contexts)] for i in range(n)], emb


def clustered(n: int, centres: int, seed: int):
    """n rows around `centres` seeded unit centres (noise of norm ~0.64 per
    row), renormalised; row i's text is squad_real_contexts[i % 1000]."""
    import torch
    from rag_serving_system_torch.ops.topk import l2_normalize

    with open(os.path.join(DATA, "squad_real_contexts.json"), encoding="utf-8") as f:
        contexts = json.load(f)
    g = torch.Generator(device="cuda").manual_seed(seed)
    c = l2_normalize(torch.randn((centres, 1024), generator=g, device="cuda"))
    assign = torch.randint(0, centres, (n,), generator=g, device="cuda")
    rows = c[assign] + 0.02 * torch.randn((n, 1024), generator=g, device="cuda")
    return [contexts[i % len(contexts)] for i in range(n)], l2_normalize(rows).cpu().numpy()


def phase_serve_int8(queries: list) -> dict:
    """RETRIEVAL_CORPUS_DTYPE=int8 at full width over 1,048,576 rows in 4
    chunks (B4 and the chunked merge), then the served queries' ids against
    the plain version's."""
    from unittest import mock

    import torch
    from rag_serving_system_torch.main import build_processor
    from rag_serving_system_torch.ops import topk

    t0 = time.perf_counter()
    docs, emb = noisy_copies(1 << 20, seed=6)
    t_corpus = time.perf_counter() - t0
    set_env(RETRIEVAL_CORPUS_DTYPE="int8", TOPK_CHUNK_ROWS="262144")
    t0 = time.perf_counter()
    processor, engine, request_queue, _ = build_processor(documents=docs, doc_embeddings=emb)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    del emb
    chunks = engine.corpus_chunks
    require(chunks is not None and len(chunks) == 4,
            f"the int8 corpus is not in 4 chunks: {None if chunks is None else len(chunks)}")
    reset_launches()
    r = _drive(processor, request_queue, queries, 32)
    launches = read_launches()
    require_launched("serve_int8", launches)
    batches = [queries[:1], queries[1:33]]
    got = [engine._retrieve_full(qs) for qs in batches]
    with mock.patch.object(topk, "cosine_topk_int8", topk.cosine_topk_int8_reference):
        plain = [engine._retrieve_full(qs) for qs in batches]
    emit("serve_int8", rows=engine.n_docs, chunks=len(chunks), corpus_s=t_corpus,
         init_s=t_init, **r, launches=launches, batches=processor.batches_processed,
         stages=engine.timer.summary(), ids_equal_plain=got == plain,
         sample_ids=got[0][0])
    require(got == plain, "int8 retrieval through B4 and through its plain version "
            "returned different ids")
    del processor, engine, chunks
    torch.cuda.empty_cache()
    return launches


def phase_serve_ivf(queries: list) -> dict:
    """RETRIEVER=ivf at full width over a clustered corpus, through the
    startup recall gate at its default 0.9."""
    import torch
    from rag_serving_system_torch.main import build_processor

    docs, emb = clustered(65536, 256, seed=7)
    set_env(RETRIEVER="ivf", IVF_CLUSTERS="256", IVF_NPROBE="8")
    t0 = time.perf_counter()
    processor, engine, request_queue, settings = build_processor(documents=docs,
                                                                 doc_embeddings=emb)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    reset_launches()
    r = _drive(processor, request_queue, queries, 31)
    launches = read_launches()
    emit("serve_ivf", rows=engine.n_docs, clusters=engine.ivf_index.centroids.shape[0],
         cap=engine.ivf_index.packed.shape[1], nprobe=engine.ivf_nprobe,
         startup_recall=engine.ivf_recall, recall_gate=settings.ivf_recall_gate,
         init_s=t_init, **r, launches=launches, stages=engine.timer.summary())
    require(settings.ivf_recall_gate == 0.9, "the IVF recall gate is not its default")
    require(launches["flash_attention"] + launches["flash_attention_packed"] > 0,
            "no prefill attention kernel launched while serving IVF")
    del processor, engine
    torch.cuda.empty_cache()
    return launches


def phase_serve_wide_k(queries: list) -> dict:
    """MAX_K=1000 over squad_real's 1000 rows: every batch retrieves k = N
    through the score kernel and select_topk; then the batch's retrieval
    against the plain version's."""
    import torch
    from rag_serving_system_torch.main import build_processor
    from rag_serving_system_torch.ops import topk

    set_env(DOCUMENT_TEXT_FILE=os.path.join(DATA, "squad_real_contexts.json"),
            DOCUMENT_EMBEDDINGS_FILE=os.path.join(DATA, "squad_real_embeddings.npy"),
            MAX_K="1000")
    processor, engine, request_queue, _ = build_processor()
    require(engine.max_k == 1000 > topk.LIST_K[torch.float32], f"max_k is {engine.max_k}")
    reset_launches()
    r = _drive(processor, request_queue, queries, 7)
    launches = read_launches()
    require_launched("serve_wide_k", launches)
    require(launches["cosine_topk"] > 0, "the score kernel never launched in serve_wide_k")
    # the served batch's retrieval against the plain version: scores within
    # 1e-5; ranks may swap only where neighbouring plain scores lie within
    # 1e-6 (f32 sums in two orders)
    q = engine._embed_queries(queries[1:8])
    s_k, i_k = engine._topk(q, engine.max_k)
    s_p, i_p = topk.cosine_topk_reference(engine.corpus, q, engine.max_k)
    torch.cuda.synchronize()
    err = (s_k - s_p).abs().max().item()
    gaps = (s_p[:, :-1] - s_p[:, 1:]).abs() < 1e-6
    near = torch.zeros_like(i_k, dtype=torch.bool)
    near[:, :-1] |= gaps
    near[:, 1:] |= gaps
    bad = (i_k != i_p) & ~near
    emit("serve_wide_k", rows=engine.n_docs, max_k=engine.max_k, **r, launches=launches,
         stages=engine.timer.summary(), max_abs_err=err,
         near_tie_swaps=int((i_k != i_p).sum().item()))
    require(err <= 1e-5, f"k = N retrieval scores differ by {err}")
    require(not bad.any().item(), "k = N retrieval ranks differ beyond near-ties")
    del processor, engine
    torch.cuda.empty_cache()
    return launches


SPLIT_KEYS = ("prepare_ms", "prefix_resolve_ms", "prefill_ms", "decode_ms", "process_ms")


def _release() -> None:
    """Free what a finished phase held on the card. An engine with a decode
    pool is a reference cycle (the pool keeps its engine), so `del` alone
    leaves its tensors to the next collection."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def phase_serve_quant(queries: list, bf16_splits: dict) -> dict:
    """QUANT_WEIGHTS=int8 and QUANT_ACT=int8 with every other setting at its
    default, at full width behind the queue and the batch processor: a lone
    request, 64 at once, the same 64 again. Then the stage split of a batch
    of 32 (all miss, all hit) beside the bf16 engine's of the serve phase,
    the decoder's weight bytes before and after quantizing, and the peak
    device memory. Returns the launch counts of the three steps."""
    from unittest import mock

    import torch
    from rag_serving_system_torch.main import build_processor
    from rag_serving_system_torch.models import layers
    from rag_serving_system_torch.ops.quant import QuantizedWeight

    _serve_env(QUANT_WEIGHTS="int8", QUANT_ACT="int8")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    processor, engine, request_queue, settings = build_processor()
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    cache = engine.prefix_cache
    p = engine.dec_params
    require(engine.act_quant and cache is not None
            and all(isinstance(p["layers"][k], QuantizedWeight)
                    for k in ("qkv_w", "o_w", "gu_w", "down_w"))
            and isinstance(p["embed"], QuantizedWeight) and p["embed"].q.dtype == torch.int8,
            "serve_quant: the decoder is not int8 with W8A8 prefill over the prefix cache")
    int_mm_rows = []
    real_int_matmul = layers.int_matmul

    def counted(xq, wq):
        int_mm_rows.append(xq.shape[0])
        return real_int_matmul(xq, wq)

    processor.start()
    try:
        with mock.patch.object(layers, "int_matmul", counted):
            steps, total, peaks = _three_steps(processor, request_queue, cache, queries)
    finally:
        processor.stop(drain_timeout=10.0)
        processor.join(timeout=30)
    emit("serve_quant", init_s=t_init, quant_weights=settings.quant_weights,
         quant_act=settings.quant_act, prefix_cache=True, pool_len=cache.pool_len,
         decoder_weight_bytes_before=engine.weight_bytes_init,
         decoder_weight_bytes_after=engine.weight_bytes,
         steps=steps, launches=total, peaks=peaks, int_mm_calls=len(int_mm_rows),
         int_mm_rows_min_max=[min(int_mm_rows, default=0), max(int_mm_rows, default=0)],
         batches=processor.batches_processed, stages=engine.timer.summary(),
         prefix_stats=cache.stats())
    for name in ("cosine_topk", "flash_attention"):
        require(total[name] > 0, f"kernel {name} never launched in serve_quant")
    _require_prefix_steps(steps, engine.dec_cfg.num_layers, cache, "serve_quant")
    # 4 products a layer in every prefill (the prefix compute and the suffix)
    require(int_mm_rows and len(int_mm_rows) % (4 * engine.dec_cfg.num_layers) == 0,
            f"serve_quant: {len(int_mm_rows)} torch._int_mm products, expected a multiple "
            f"of 4 a layer")
    require(engine.weight_bytes < 0.55 * engine.weight_bytes_init,
            f"serve_quant: weight bytes {engine.weight_bytes_init} -> {engine.weight_bytes}")
    for label, before_rep in (("miss", cache.clear), ("hit", None)):
        row = _stage_split(engine, queries[1:33], label=label, before_rep=before_rep)
        emit("stage_split", quant="int8+w8a8", **row)
        emit("stage_split_compare", route=label,
             **{k: {"bf16": bf16_splits[label][k], "int8_w8a8": row[k]} for k in SPLIT_KEYS})
    emit("serve_quant_memory", construction_peak_gb=peaks["construction_gb"],
         serving_peak_gb=max(peaks["serving_gb"], torch.cuda.max_memory_allocated() / 1e9))
    del processor, engine, cache, p
    _release()
    return total


def phase_serve_continuous(queries: list) -> tuple:
    """DECODE_MODE=continuous at full width: the three steps of the serve
    phase through the processor and the decode pool, every request
    delivered, the pool's stats; then the same with PREFIX_CACHE=0, 32 at
    once, which takes the packed pool prefill (B3). Returns the launch
    counts of the two parts."""
    import torch
    from rag_serving_system_torch.main import build_processor

    _serve_env(DECODE_MODE="continuous")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    processor, engine, request_queue, settings = build_processor()
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    pool, cache = engine.decode_pool, engine.prefix_cache
    require(pool is not None and cache is not None and settings.decode_mode == "continuous",
            "serve_continuous: no decode pool over the prefix cache")
    processor.start()
    try:
        steps, total, peaks = _three_steps(processor, request_queue, cache, queries)
    finally:
        processor.stop(drain_timeout=10.0)
        processor.join(timeout=30)
    stats = pool.stats()
    emit("serve_continuous", init_s=t_init, prefix_cache=True, pool_len=cache.pool_len,
         steps=steps, launches=total, pool=stats, batches=processor.batches_processed,
         requests_processed=processor.requests_processed, stages=engine.timer.summary(),
         pool_kv_gb=2 * pool.pool_k.numel() * pool.pool_k.element_size() / 1e9,
         peak_memory_gb=max(peaks.values()), peaks=peaks)
    for name in ("cosine_topk", "flash_attention"):
        require(total[name] > 0, f"kernel {name} never launched in serve_continuous")
    _require_prefix_steps(steps, engine.dec_cfg.num_layers, cache, "serve_continuous")
    require(stats["inserted"] == stats["completed"] == processor.requests_processed == 129
            and stats["free"] == stats["slots"] and stats["steps"] > 0
            and stats["pending_rows"] == stats["pending_submits"] == 0,
            f"serve_continuous: the pool did not deliver all 129 requests: {stats}")
    require(not pool._thread.is_alive(), "serve_continuous: the pool's thread outlived stop()")
    del processor, engine, pool, cache
    _release()

    _serve_env(DECODE_MODE="continuous", PREFIX_CACHE="0")
    torch.cuda.reset_peak_memory_stats()
    processor, engine, request_queue, _ = build_processor()
    pool = engine.decode_pool
    require(engine.prefix_cache is None and pool is not None,
            "serve_continuous: PREFIX_CACHE=0 left the prefix cache on, or no pool")
    patch, b3_calls = b3_recorder()
    reset_launches()
    processor.start()
    try:
        with patch:
            _, seconds = _answered(request_queue, queries[65:97])
    finally:
        processor.stop(drain_timeout=10.0)
        processor.join(timeout=30)
    packed = read_launches()
    stats = pool.stats()
    layout = engine.stage_prompts(engine.prepare(queries[65:97], [2] * 32))[0]
    require(layout == "packed", f"serve_continuous: 32 cold prompts staged {layout}")
    emit("serve_continuous_packed", prefix_cache=False, requests=32, seconds=seconds,
         launches=packed, pool=stats, peak_memory_gb=torch.cuda.max_memory_allocated() / 1e9,
         b3_n_real_and_t=require_b3_rows("serve_continuous", b3_calls))
    require(packed["flash_attention_packed"] > 0 and packed["cosine_topk"] > 0,
            f"serve_continuous: the packed pool prefill did not launch B3: {packed}")
    require(stats["inserted"] == stats["completed"] == 32,
            f"serve_continuous: the packed step's pool: {stats}")
    del processor, engine, pool
    _release()
    return total, packed


def _tiny_corpus(seed: int = 0):
    """40 seeded documents of 14-23 words and their seeded 64-dim embeddings."""
    import numpy as np

    rng = np.random.default_rng(seed)
    docs = [" ".join(f"w{rng.integers(0, 300)}" for _ in range(rng.integers(14, 24)))
            for _ in range(40)]
    return docs, rng.standard_normal((40, 64)).astype(np.float32)


TINY_QUERIES = ["what is w1 w2", "tell me w5", "w7 w8 w9 w10", "another question w3"]
TINY_ENV = dict(MODEL_PRESET="tiny", COMPUTE_DTYPE="float32", DO_SAMPLE="0",
                BATCH_BUCKETS="1,4", MAX_BATCH_SIZE="4", ENCODE_LEN_BUCKETS="16,32",
                PROMPT_LEN_BUCKETS="32,128", PACKED_T_STEP="256", MAX_NEW_TOKENS="6",
                MAX_K="4", PREFIX_POOL_LEN="48", QUERY_CACHE_SIZE="0",
                DECODE_MODE="continuous", DECODE_SLOTS="2")


def _pool_answers(engine, queries: list, staged=None) -> list:
    """The answers of one batch through the engine's decode pool (started if
    need be), in request order; every request must be delivered."""
    pool = engine.decode_pool
    if not pool._running:
        pool.start()
    got = {}
    rids = [f"r{i}" for i in range(len(queries))]
    prompts = engine.prepare(queries, [2] * len(queries))
    pool.submit(rids, prompts, lambda rid, res: got.__setitem__(rid, res), staged=staged)
    require(pool.wait_idle(300.0), "the decode pool did not go idle in 300 s")
    bad = [got.get(r) for r in rids if not isinstance((got.get(r) or {}).get("result"), str)]
    require(not bad, f"the decode pool did not deliver every request: {bad[:3]}")
    return [got[r]["result"] for r in rids]


def _scale_decoder(engine, factor: float) -> None:
    """Scale a decoder's matrices in place: a random init at std 0.02
    attends almost uniformly and repeats one token whatever the prompt, so a
    wrong mask or position would not show. Scaled, answers follow context."""
    for key in ("qkv_w", "o_w", "gu_w", "down_w"):
        engine.dec_params["layers"][key] *= factor
    engine.dec_params["embed"] *= factor


def phase_serve_tiny(head_dim: int) -> dict:
    """MODEL_PRESET=tiny on the card in f32, greedy, at the preset's head
    size 16 or widened to `head_dim` 32 (the scalar B2/B3 body either way),
    decoder matrices scaled by 8. The prefix route (a miss, then the hit),
    the padded and the packed cold routes: answers through the kernels equal
    those through each kernel's plain version; the decode pool (2 slots
    under batches of 4: waves and slot reuse) equals the fixed path on all
    three; int8 + W8A8 through `torch._int_mm` equals the plain int32 sums'
    answers. Returns the launch counts of the kernel runs."""
    import dataclasses
    from unittest import mock

    import torch
    from rag_serving_system_torch.core import engine as engine_mod
    from rag_serving_system_torch.main import build_processor
    from rag_serving_system_torch.models import layers, qwen2
    from rag_serving_system_torch.ops import attention, topk
    from rag_serving_system_torch.ops.quant import quantize_decoder_params

    set_env(**TINY_ENV)
    docs, emb = _tiny_corpus()
    cfg = dataclasses.replace(engine_mod.decoder_config_for("tiny"), head_dim=head_dim)
    with mock.patch.object(engine_mod, "decoder_config_for", lambda preset: cfg):
        _, engine, _, settings = build_processor(documents=docs, doc_embeddings=emb)
    require(settings.model_preset == "tiny" and engine.dec_cfg.head_dim == head_dim
            and engine.device.type == "cuda" and engine.dtype == torch.float32,
            "serve_tiny: not the tiny preset in f32 on the card")
    _scale_decoder(engine, 8.0)
    cache, pool = engine.prefix_cache, engine.decode_pool

    def plain_kernels():
        return (mock.patch.object(engine_mod, "cosine_topk", topk.cosine_topk_reference),
                mock.patch.object(qwen2, "flash_attention", attention.flash_attention_plain),
                mock.patch.object(qwen2, "flash_attention_packed",
                                  attention.flash_attention_packed_plain))

    def routes():
        """Fixed-path answers of a lone request and a batch of 4 on the
        prefix route (miss, then hit) and on the cold routes."""
        out = {}
        cache.clear()
        for name in ("prefix_miss", "prefix_hit"):
            out[name] = [engine.process(TINY_QUERIES[:1], [2]),
                         engine.process(TINY_QUERIES, [2] * 4)]
        with mock.patch.object(engine, "prefix_cache", None):
            out["cold"] = [engine.process(TINY_QUERIES[:1], [2]),
                           engine.process(TINY_QUERIES, [2] * 4)]
        return out

    with mock.patch.object(engine, "prefix_cache", None):
        layouts = [engine.stage_prompts(engine.prepare(qs, [2] * len(qs)))[0]
                   for qs in (TINY_QUERIES[:1], TINY_QUERIES)]
    require(layouts == ["padded", "packed"], f"serve_tiny: cold layouts {layouts}")
    reset_launches()
    kernel = routes()
    launches = read_launches()
    a, b, c = plain_kernels()
    with a, b, c:
        plain = routes()
    require(launches["flash_attention"] > 0 and launches["flash_attention_packed"] > 0
            and launches["cosine_topk"] > 0, f"serve_tiny: launches {launches}")
    require(kernel == plain, f"serve_tiny (D={head_dim}): answers through the kernels and "
            f"through their plain versions differ: {kernel} / {plain}")
    require(kernel["prefix_miss"] == kernel["prefix_hit"] == kernel["cold"],
            f"serve_tiny (D={head_dim}): the routes answer differently: {kernel}")
    answers = [r["result"] for r in kernel["cold"][1]]
    # (a row may stop at its first token: with these weights three of four do
    # at head size 32, and all four answer at 16)
    require(any(answers) and len(set(answers)) > 1,
            f"serve_tiny: answers do not vary with the prompt: {answers}")

    # the pool against the fixed path: over the prefix cache (miss, hit),
    # then cold, packed for the batch and padded for the lone request
    pool_equal = {}
    cache.clear()
    for name in ("prefix_miss", "prefix_hit"):
        pool_equal[name] = _pool_answers(engine, TINY_QUERIES) == answers
    with mock.patch.object(engine, "prefix_cache", None):
        for name, qs in (("packed", TINY_QUERIES), ("padded", TINY_QUERIES[:1])):
            staged = engine.stage_prompts(engine.prepare(qs, [2] * len(qs)))
            require(staged[0] == name, f"serve_tiny: pool case {name} staged {staged[0]}")
            pool_equal[name] = _pool_answers(engine, qs, staged=staged) == answers[:len(qs)]
    stats = pool.stats()
    require(all(pool_equal.values()), f"serve_tiny (D={head_dim}): pool answers differ "
            f"from the fixed path's: {pool_equal}")
    require(stats["slots"] == 2 and stats["completed"] == 13 and stats["inserted"] == 13,
            f"serve_tiny: pool stats {stats}")

    # int8 + W8A8: torch._int_mm against the plain int32 sums, end to end
    engine.dec_params = quantize_decoder_params(engine.dec_params)
    engine.act_quant = True
    cache.clear()
    calls = []
    real = layers.int_matmul

    def counted(xq, wq):
        calls.append(xq.shape[0])
        return real(xq, wq)

    with mock.patch.object(layers, "int_matmul", counted):
        quant = engine.process(TINY_QUERIES, [2] * 4)
    cache.clear()
    with mock.patch.object(layers, "int_matmul", layers.int_matmul_plain):
        quant_plain = engine.process(TINY_QUERIES, [2] * 4)
    require(calls and quant == quant_plain and any(r["result"] for r in quant),
            f"serve_tiny (D={head_dim}): W8A8 through torch._int_mm and through the plain "
            f"sums differ: {quant} / {quant_plain}")
    emit("serve_tiny", head_dim=head_dim, dtype="float32", launches=launches,
         kernel_vs_plain_identical=True, routes_identical=True, pool_equals_fixed=pool_equal,
         pool=stats, int_mm_calls=len(calls), w8a8_int_mm_vs_plain_identical=True,
         answers=answers[:2], quant_answers=[r["result"] for r in quant[:2]])
    pool.stop()
    del engine, cache, pool
    _release()
    return launches


# ---------------------------------------------------------------------------
# speculative decode
# ---------------------------------------------------------------------------

def _count_loops(engine) -> list:
    """Wrap `engine.generate_tokens` so that every batch is logged as (the
    decode loop's forwards after the prefill, its token handle). The log is
    read by `_loop_summary` after the timed step, never inside it."""
    log = []
    real = engine.generate_tokens

    def call(prompts=None, staged=None):
        before = engine.timer.counts["decode"]
        handle = real(prompts, staged=staged)
        log.append((engine.timer.counts["decode"] - before, handle))
        return handle

    engine.generate_tokens = call
    return log


def _loop_summary(engine, log: list) -> dict:
    """Batches, loop iterations and decode tokens (those after each row's
    first, which the prefill gives) of the logged batches, and then empty the
    log. `tokens_per_row_iteration` is what one row gets out of one forward:
    1 for the sequential loop while the row lives, up to gamma + 1 under
    speculative decode."""
    pad = engine.dec_cfg.pad_token_id
    iters = decode_tokens = row_iters = seq_steps = 0
    for n_iters, (toks, n) in log:
        lens = (toks[:n] != pad).sum(dim=1)
        iters += n_iters
        decode_tokens += int((lens - 1).clamp(min=0).sum())
        row_iters += n_iters * n
        seq_steps += max(int(lens.max()) - 1, 0)
    out = {"batches": len(log), "iterations": iters, "decode_tokens": decode_tokens,
           "tokens_per_row_iteration": decode_tokens / max(row_iters, 1),
           "iterations_of_a_sequential_loop": seq_steps}
    log.clear()
    return out


def _greedy_steps(queries: list, spec: int) -> tuple:
    """The serve phase's three steps (a lone miss, 64 misses, the same 64 as
    hits) and 32 cold requests (PREFIX_CACHE=0: packed) at DO_SAMPLE=0 and
    SPEC_DECODE=`spec`, each engine built from the environment behind the
    queue and the processor. Returns (steps, launches of the three steps,
    launches of the cold step)."""
    import torch
    from rag_serving_system_torch.main import build_processor

    _serve_env(DO_SAMPLE="0", SPEC_DECODE=str(spec))
    processor, engine, request_queue, settings = build_processor()
    require(engine.spec_gamma == spec and not settings.do_sample
            and engine.prefix_cache is not None,
            f"serve_spec: the engine runs gamma {engine.spec_gamma}, not greedy {spec}")
    log = _count_loops(engine)
    steps = {}
    engine.warmup()
    log.clear()
    processor.start()
    try:
        raw, total, _ = _three_steps(processor, request_queue, engine.prefix_cache, queries)
        for name, st in raw.items():
            steps[name] = {"seconds": st["seconds"], "requests": st["requests"],
                           "hits": st["hits"], "misses": st["misses"]}
    finally:
        processor.stop(drain_timeout=10.0)
        processor.join(timeout=30)
    # the log holds the three steps' batches in order: 1, then 2 + 2 or more
    # (a batch may split); attribute them by the requests they hold
    order = iter(log[:])
    for name, st in steps.items():
        part, held = [], 0
        while held < st["requests"]:
            item = next(order)
            part.append(item)
            held += item[1][1]
        st.update(_loop_summary(engine, part))
    log.clear()
    _require_prefix_steps(raw, engine.dec_cfg.num_layers, engine.prefix_cache, "serve_spec")
    step_ms = ((_spec_step_times(engine, queries[1:33]), _spec_loop_times(engine, queries[1:33]))
               if spec else None)
    del processor, engine
    _release()

    _serve_env(DO_SAMPLE="0", SPEC_DECODE=str(spec), PREFIX_CACHE="0")
    processor, engine, request_queue, _ = build_processor()
    require(engine.prefix_cache is None and engine.spec_gamma == spec,
            "serve_spec: the cold engine kept the prefix cache")
    log = _count_loops(engine)
    engine.warmup()
    log.clear()
    reset_launches()
    processor.start()
    try:
        _, seconds = _answered(request_queue, queries[65:97])
    finally:
        processor.stop(drain_timeout=10.0)
        processor.join(timeout=30)
    cold = read_launches()
    layout = engine.stage_prompts(engine.prepare(queries[65:97], [2] * 32))[0]
    require(layout == "packed", f"serve_spec: 32 cold prompts staged {layout}")
    steps["d_32_cold_packed"] = {"seconds": seconds, "requests": 32,
                                 **_loop_summary(engine, log)}
    del processor, engine
    _release()
    torch.cuda.empty_cache()
    return steps, total, cold, step_ms


def _spec_step_times(engine, queries: list, reps: int = 5, rounds: int = 5) -> dict:
    """One `decode_step` against one `decode_step_spec` over S = 2, 4 and 8
    positions a row, on the engine's weights and dtype at batch 32 over a
    cold padded prefill of real prompts: CUDA-event ms and CUDA-synced host
    ms, the median of `rounds` rounds of `reps` calls each, the calls taking
    turns. The cost of an iteration against a step is what an accepted draft
    has to pay for."""
    from unittest import mock

    import torch
    from rag_serving_system_torch.models import qwen2

    n = len(queries)
    with mock.patch.object(engine, "prefix_cache", None), \
            mock.patch.object(engine, "packed", False):
        staged = engine.stage_prompts(engine.prepare(queries, [2] * n))
    require(staged[0] == "padded", f"spec_step: staged {staged[0]}")
    ids, mask = staged[1], staged[2]
    b, p = ids.shape
    mnt = engine.settings.max_new_tokens
    dev = ids.device

    def timed_once(fn):
        """(CUDA-event ms, CUDA-synced host ms) of one call, mean of `reps`."""
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        t0 = time.perf_counter()
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps, (time.perf_counter() - t0) / reps * 1e3

    out = {"batch": b, "prompt_slots": p, "dtype": str(engine.dtype).split(".")[-1],
           "reps": reps, "rounds": rounds}
    with torch.inference_mode():
        _, cache = qwen2.prefill(engine.dec_params, engine.dec_cfg, ids, mask, mnt + 8,
                                 dtype=engine.dtype)
        tok = torch.full((b,), 100, dtype=torch.int32, device=dev)
        step0 = torch.ones((b,), dtype=torch.int32, device=dev)
        hist = torch.randint(0, 50, (b, p + mnt + 1), device=dev, dtype=torch.int32)
        cur = torch.full((b,), p + 3, dtype=torch.int32, device=dev)
        calls = {"decode_step": lambda: qwen2.decode_step(
            engine.dec_params, engine.dec_cfg, cache, tok, 1, p, mask, dtype=engine.dtype),
            "draft_ngram_gamma3": lambda: qwen2.draft_ngram(hist, cur, 3)}
        for s in (2, 4, 8):
            chunk = tok[:, None].expand(b, s).contiguous()
            calls[f"decode_step_spec_S{s}"] = lambda chunk=chunk: qwen2.decode_step_spec(
                engine.dec_params, engine.dec_cfg, cache, chunk, step0, p, mask,
                dtype=engine.dtype)
        # the host's speed drifts within a run: time the calls in turns and
        # keep each call's median round
        seen = {name: [] for name in calls}
        for rnd in range(rounds + 1):
            for name, fn in calls.items():
                pair = timed_once(fn)
                if rnd:                     # round 0 warms up
                    seen[name].append(pair)
        for name, pairs in seen.items():
            out[name] = {"device_ms": sorted(d for d, _ in pairs)[len(pairs) // 2],
                         "host_ms": sorted(h for _, h in pairs)[len(pairs) // 2],
                         "host_ms_min_max": [min(h for _, h in pairs),
                                             max(h for _, h in pairs)]}
        for s in (2, 4, 8):
            out[f"S{s}_over_step"] = (out[f"decode_step_spec_S{s}"]["host_ms"]
                                      / out["decode_step"]["host_ms"])
    del cache
    return out


def _spec_loop_times(engine, queries: list, mnts=(10, 32), reps: int = 3) -> dict:
    """The acceptance → time curve: whole decode loops over one cold padded
    prefill of 32 real prompts on the engine's weights and dtype, CUDA-synced
    host ms (median of `reps`, the loops taking turns) and iterations:
    the sequential loop; the speculative loop fed wrong drafts (gamma 3: one
    token an iteration, the dearest case); and fed right drafts at gamma 1,
    3 and 7 (the cheapest case). In bf16 a verify forward may pick another
    near-tie than the single step did, after which the sequential output no
    longer drafts the loop's own trajectory; the right drafts are therefore
    the loop's own output at that gamma. The iterations are printed."""
    from unittest import mock

    import torch
    from rag_serving_system_torch.models import qwen2

    n = len(queries)
    with mock.patch.object(engine, "prefix_cache", None), \
            mock.patch.object(engine, "packed", False):
        staged = engine.stage_prompts(engine.prepare(queries, [2] * n))
    ids, mask = staged[1], staged[2]
    b, p = ids.shape
    params, cfg, dtype = engine.dec_params, engine.dec_cfg, engine.dtype
    out = {"batch": b, "prompt_slots": p, "dtype": str(dtype).split(".")[-1], "reps": reps}
    with torch.inference_mode():
        for mnt in mnts:
            seq = qwen2.generate(params, cfg, ids, mask, max_new_tokens=mnt,
                                 do_sample=False, dtype=dtype)
            wrong = torch.full((b, mnt + 3), 7, dtype=torch.int32, device=ids.device)
            cases = {"sequential": (0, None), "wrong_gamma3": (3, wrong)}
            for gamma in (1, 3, 7):
                # the loop's own output at this gamma, reached from the
                # sequential one: a position's logits depend on the tokens
                # before it and on the forward's shape, not on where in a
                # chunk it stands, so these drafts are all accepted
                logits0, kv = qwen2.prefill(params, cfg, ids, mask, mnt + gamma, dtype=dtype)
                own, _ = qwen2._spec_decode_loop(
                    params, cfg, logits0, kv, mask, mnt, gamma, dtype, None, p, ids,
                    draft_source=torch.cat([seq, seq[:, :gamma]], dim=1))
                del kv
                cases[f"right_gamma{gamma}"] = (gamma, torch.cat([own, own[:, :gamma]], dim=1))
            seen = {name: [] for name in cases}
            for _ in range(reps + 1):
                for name, (gamma, src) in cases.items():
                    logits0, kv = qwen2.prefill(params, cfg, ids, mask, mnt + gamma, dtype=dtype)
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    if gamma:
                        _, iters = qwen2._spec_decode_loop(params, cfg, logits0, kv, mask, mnt,
                                                           gamma, dtype, None, p, ids,
                                                           draft_source=src)
                    else:
                        _, iters = qwen2._decode_loop(params, cfg, logits0, kv, mask, None,
                                                      mnt, 0.7, 20, 0.8, False, dtype, None, p)
                    torch.cuda.synchronize()
                    seen[name].append(((time.perf_counter() - t0) * 1e3, iters))
                    del kv
            out[f"max_new_tokens_{mnt}"] = {
                name: {"ms": sorted(t for t, _ in runs[1:])[len(runs[1:]) // 2],
                       "iterations": runs[-1][1]} for name, runs in seen.items()}
    return out


def phase_serve_spec(queries: list) -> tuple:
    """DO_SAMPLE=0 SPEC_DECODE=3 at full width in bf16 behind the queue and
    the processor: a lone request, 64 at once (misses), the same 64 (hits),
    then PREFIX_CACHE=0, 32 at once (packed); and the same requests at
    SPEC_DECODE=0 DO_SAMPLE=0 beside them: seconds, loop iterations and
    decode tokens a row an iteration. Random weights give the n-gram drafter
    little to find, so this shows the iteration's cost, not a gain. Returns
    the launch counts of the speculative run (three steps; cold step)."""
    spec, total, cold, step_ms = _greedy_steps(queries, 3)
    seq, _, _, _ = _greedy_steps(queries, 0)
    emit("serve_spec", gamma=3, dtype="bfloat16", do_sample=False, launches=total,
         launches_cold=cold,
         steps={name: {"spec": spec[name], "sequential": seq[name]} for name in spec})
    emit("spec_step", **step_ms[0])
    emit("spec_loop", **step_ms[1])
    for name in ("cosine_topk", "flash_attention"):
        require(total[name] > 0, f"kernel {name} never launched in serve_spec")
    require(cold["flash_attention_packed"] > 0 and cold["cosine_topk"] > 0,
            f"serve_spec: the cold packed step did not launch B3: {cold}")
    for name, st in spec.items():
        # a live row gets at least one token out of every iteration (one more
        # a batch is allowed for a stop id that equals the pad id)
        require(st["iterations"] <= st["iterations_of_a_sequential_loop"] + st["batches"],
                f"serve_spec: step {name} took {st['iterations']} iterations where a "
                f"sequential loop takes {st['iterations_of_a_sequential_loop']}")
        require(seq[name]["tokens_per_row_iteration"] <= 1.0 + 1e-9,
                f"serve_spec: the sequential loop's tokens an iteration: {seq[name]}")
    require(sum(st["iterations"] for st in spec.values()) > 0,
            f"serve_spec: no speculative iteration ran: {spec}")
    return total, cold


def _top2_gaps(engine, prompts: list) -> tuple:
    """One sequential greedy batch with the top-2 gap of every pick recorded:
    (tokens (n, mnt) on the host, gaps (n, mnt): the gap of the logits
    (EOS bias applied) that chose each token; inf where the loop had ended)."""
    from unittest import mock

    import torch
    from rag_serving_system_torch.models import qwen2

    seen = []
    real = qwen2.pick_token

    def recorded(logits, generator, do_sample, temperature=0.7, top_k=20, top_p=0.8,
                 eos_bias=0.0, eos_ids=()):
        top = torch.topk(qwen2.bias_eos(logits, eos_ids, eos_bias), 2, dim=-1).values
        seen.append(top[:, 0] - top[:, 1])
        return real(logits, generator, do_sample, temperature, top_k, top_p, eos_bias,
                    eos_ids)

    with mock.patch.object(engine, "spec_gamma", 0), \
            mock.patch.object(qwen2, "pick_token", recorded):
        toks, n = engine.generate_tokens(prompts)
    mnt = toks.shape[1]
    gaps = torch.full((n, mnt), float("inf"))
    for j, g in enumerate(seen):
        gaps[:, j] = g[:n].float().cpu()
    return toks[:n].cpu(), gaps


GAP_THRESHOLD = 1e-3    # logit units; below it a pick may flip between shapes


def _parity_spec(engine, cases: dict) -> None:
    """Speculative against sequential greedy on the f32 engine, the decoder's
    matrices scaled by 4 (so that picks have clear gaps): gamma 1 and 3, on
    the prefix route (a miss, then the hit), the cold packed route (batch of
    8) and the cold padded route (the lone request), with mixed row budgets
    and an EOS bias. A verify forward over gamma + 1 positions may reduce in
    another order than a single step, so tokens must be equal up to the
    first pick whose sequential top-2 gap is under GAP_THRESHOLD; the share
    of equal tokens and every row's first differing step are printed.

    Then `_spec_decode_loop` alone with `draft_source`: the sequential output
    (every draft right: the same tokens in ceil((mnt - 1) / (gamma + 1))
    iterations) and wrong drafts (one token an iteration)."""
    import math
    from unittest import mock

    import torch
    from rag_serving_system_torch.models import qwen2
    from rag_serving_system_torch.models.tokenizer import pad_and_stack

    cache = engine.prefix_cache
    mnt = engine.settings.max_new_tokens
    batch, lone = cases["batch_of_8"], cases["lone"]
    budgets = {8: [None, 3, 1, 7, None, 2, 5, None], 1: [None]}
    report, worst = {}, []

    def compare(name, qs, gamma):
        prompts = engine.prepare(qs, [2] * len(qs), budgets[len(qs)])
        layout = engine.stage_prompts(prompts)[0]
        if cache is not None and engine.prefix_cache is not None and "miss" in name:
            cache.clear()
        seq, gaps = _top2_gaps(engine, prompts)
        if cache is not None and engine.prefix_cache is not None and "miss" in name:
            cache.clear()
        before = engine.timer.counts["decode"]
        with mock.patch.object(engine, "spec_gamma", gamma):
            toks, n = engine.generate_tokens(prompts)
        spec = toks[:n].cpu()
        iters = engine.timer.counts["decode"] - before
        differ = (spec != seq)
        first = [int(row.nonzero()[0]) if row.any() else None for row in differ]
        excused = all(f is None or gaps[r, :f + 1].min() < GAP_THRESHOLD
                      for r, f in enumerate(first))
        report[f"{name}_gamma{gamma}"] = {
            "layout": layout, "rows": n, "iterations": iters,
            "equal_share": 1.0 - differ.float().mean().item(),
            "first_differing_step": first, "least_gap": gaps.min().item(),
            "ok": excused}
        if not excused:
            worst.append((name, gamma, first, spec.tolist(), seq.tolist()))

    with mock.patch.object(engine.settings, "eos_bias", 2.0):
        for gamma in (1, 3):
            compare("prefix_miss", batch, gamma)
            compare("prefix_hit", batch, gamma)
            with mock.patch.object(engine, "prefix_cache", None):
                compare("cold_packed", batch, gamma)
                compare("cold_padded", lone, gamma)
    layouts = {k: v["layout"] for k, v in report.items()}
    emit("parity_spec", dtype="float32", decoder_scale=4.0, eos_bias=2.0,
         budgets=budgets[8], gap_threshold=GAP_THRESHOLD, cases=report)
    require(all(("packed" if "cold_packed" in k else "padded") == v
                for k, v in layouts.items()), f"parity_spec: layouts {layouts}")
    require(not worst, f"parity_spec: speculative tokens differ from sequential greedy "
            f"where the sequential gap is above {GAP_THRESHOLD}: {worst[:2]}")

    # the loop alone over a padded prefill of the 8 prompts, drafts supplied
    with mock.patch.object(engine, "prefix_cache", None):
        prompts = engine.prepare(batch, [2] * len(batch))
    rows = engine._prompt_tokens_batch(prompts)
    plen = -(-max(len(r) for r in rows) // 64) * 64
    ids, mask = pad_and_stack(rows, plen, engine.dec_tok.pad_id, pad_side="left",
                              truncate_side="left")
    ids, mask = engine._put_batch(ids), engine._put_batch(mask)
    kw = dict(max_new_tokens=mnt, do_sample=False, dtype=engine.dtype)
    with torch.inference_mode():
        seq = qwen2.generate(engine.dec_params, engine.dec_cfg, ids, mask, **kw)
        ended = bool(qwen2.token_is_eos(seq, qwen2.eos_id_set(engine.dec_cfg)).any())
        wrong_id = next(v for v in range(100, engine.dec_cfg.vocab_size)
                        if not bool((seq == v).any()))
        drafts = {}
        for gamma in (1, 3):
            for kind in ("right", "wrong"):
                src = (torch.cat([seq, seq[:, :gamma]], dim=1) if kind == "right"
                       else torch.full((len(rows), mnt + gamma), wrong_id,
                                       dtype=torch.int32, device=ids.device))
                logits0, kv = qwen2.prefill(engine.dec_params, engine.dec_cfg, ids, mask,
                                            mnt + gamma, dtype=engine.dtype)
                out, iters = qwen2._spec_decode_loop(
                    engine.dec_params, engine.dec_cfg, logits0, kv, mask, mnt, gamma,
                    engine.dtype, None, plen, ids, draft_source=src)
                want = math.ceil((mnt - 1) / (gamma + 1)) if kind == "right" else mnt - 1
                drafts[f"{kind}_gamma{gamma}"] = {
                    "iterations": iters, "expected": want,
                    "tokens_equal": bool(torch.equal(out, seq))}
                del kv
    emit("parity_spec_drafts", max_new_tokens=mnt, rows=len(rows), prompt_slots=plen,
         a_row_ended_early=ended, cases=drafts)
    for name, d in drafts.items():
        require(d["tokens_equal"], f"parity_spec: draft_source {name}: tokens differ "
                f"from sequential greedy")
        require(d["iterations"] == d["expected"] or (ended and d["iterations"] <= d["expected"]),
                f"parity_spec: draft_source {name}: {d}")
    emit("spec_step", **_spec_step_times(engine, (batch * 4)[:32]))


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def decoder_to_hf(params: dict, cfg) -> dict:
    """The port's decoder tree in HF names and (out, in) layout: the inverse
    of `load_decoder_params`."""
    qd, kvd = cfg.num_heads * cfg.head_dim, cfg.num_kv_heads * cfg.head_dim
    ff = cfg.intermediate_size
    lay = params["layers"]
    out = {"model.embed_tokens.weight": params["embed"], "model.norm.weight": params["ln_f"]}
    if "lm_head" in params:
        out["lm_head.weight"] = params["lm_head"].t()
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}."
        qkv, gu = lay["qkv_w"][i], lay["gu_w"][i]
        out.update({
            p + "input_layernorm.weight": lay["ln1"][i],
            p + "post_attention_layernorm.weight": lay["ln2"][i],
            p + "self_attn.q_proj.weight": qkv[:, :qd].t(),
            p + "self_attn.k_proj.weight": qkv[:, qd:qd + kvd].t(),
            p + "self_attn.v_proj.weight": qkv[:, qd + kvd:].t(),
            p + "self_attn.o_proj.weight": lay["o_w"][i].t(),
            p + "mlp.gate_proj.weight": gu[:, :ff].t(),
            p + "mlp.up_proj.weight": gu[:, ff:].t(),
            p + "mlp.down_proj.weight": lay["down_w"][i].t()})
        if "qkv_b" in lay:
            b = lay["qkv_b"][i]
            out.update({p + "self_attn.q_proj.bias": b[:qd],
                        p + "self_attn.k_proj.bias": b[qd:qd + kvd],
                        p + "self_attn.v_proj.bias": b[qd + kvd:]})
    return out


def encoder_to_hf(params: dict, cfg) -> dict:
    """The port's encoder tree in XLM-RoBERTa's HF names: the inverse of
    `load_encoder_params`."""
    h = cfg.hidden_size
    emb, lay = params["embed"], params["layers"]
    out = {"embeddings.word_embeddings.weight": emb["word"],
           "embeddings.position_embeddings.weight": emb["pos"],
           "embeddings.token_type_embeddings.weight": emb["type"],
           "embeddings.LayerNorm.weight": emb["ln_scale"],
           "embeddings.LayerNorm.bias": emb["ln_bias"]}
    for i in range(cfg.num_layers):
        p = f"encoder.layer.{i}."
        w, b = lay["qkv_w"][i], lay["qkv_b"][i]
        for j, name in enumerate(("query", "key", "value")):
            out[p + f"attention.self.{name}.weight"] = w[:, j * h:(j + 1) * h].t()
            out[p + f"attention.self.{name}.bias"] = b[j * h:(j + 1) * h]
        out.update({
            p + "attention.output.dense.weight": lay["o_w"][i].t(),
            p + "attention.output.dense.bias": lay["o_b"][i],
            p + "attention.output.LayerNorm.weight": lay["attn_ln_scale"][i],
            p + "attention.output.LayerNorm.bias": lay["attn_ln_bias"][i],
            p + "intermediate.dense.weight": lay["ff_w1"][i].t(),
            p + "intermediate.dense.bias": lay["ff_b1"][i],
            p + "output.dense.weight": lay["ff_w2"][i].t(),
            p + "output.dense.bias": lay["ff_b2"][i],
            p + "output.LayerNorm.weight": lay["ff_ln_scale"][i],
            p + "output.LayerNorm.bias": lay["ff_ln_bias"][i]})
    return out


def decoder_hf_config(cfg) -> dict:
    """The config.json that `decoder_config_from_hf` reads back as `cfg`."""
    return {"model_type": "qwen2" if cfg.qkv_bias else "llama",
            "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
            "num_hidden_layers": cfg.num_layers, "num_attention_heads": cfg.num_heads,
            "num_key_value_heads": cfg.num_kv_heads, "head_dim": cfg.head_dim,
            "intermediate_size": cfg.intermediate_size, "rms_norm_eps": cfg.rms_norm_eps,
            "rope_theta": cfg.rope_theta, "tie_word_embeddings": cfg.tie_word_embeddings,
            "max_position_embeddings": cfg.max_position_embeddings,
            "eos_token_id": list(cfg.eos_token_ids), "pad_token_id": cfg.pad_token_id,
            "attention_bias": cfg.qkv_bias}


def encoder_hf_config(cfg) -> dict:
    return {"model_type": "xlm-roberta" if cfg.position_style == "roberta" else "bert",
            "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
            "num_hidden_layers": cfg.num_layers, "num_attention_heads": cfg.num_heads,
            "intermediate_size": cfg.intermediate_size,
            "max_position_embeddings": cfg.max_position_embeddings,
            "type_vocab_size": cfg.type_vocab_size, "layer_norm_eps": cfg.layer_norm_eps,
            "pad_token_id": cfg.pad_token_id}


def write_checkpoints(root: str, engine, names: dict) -> dict:
    """The engine's two models as HF snapshots under `root` (one directory a
    model, named as `find_snapshot` looks for it): model.safetensors in the
    parameters' own dtype and config.json. Returns the bytes of each."""
    from rag_serving_system_torch.models.weights import write_safetensors

    out = {}
    for which, params, cfg, to_hf, to_cfg in (
            ("encoder", engine.enc_params, engine.enc_cfg, encoder_to_hf, encoder_hf_config),
            ("decoder", engine.dec_params, engine.dec_cfg, decoder_to_hf, decoder_hf_config)):
        d = os.path.join(root, names[which])
        os.makedirs(d, exist_ok=True)
        out[which] = write_safetensors(os.path.join(d, "model.safetensors"),
                                       to_hf(params, cfg))
        with open(os.path.join(d, "config.json"), "w", encoding="utf-8") as f:
            json.dump(to_cfg(cfg), f)
    return out


def phase_serve_checkpoint(queries: list) -> dict:
    """The checkpoint loader at full width. An engine with seeded random
    weights writes both models as HF snapshots (safetensors in BF16 and a
    config.json each) into a temporary directory; a second engine starts
    with WEIGHTS_DIR on it. Required: both architectures derived from the
    config.json files equal the presets, every loaded leaf bit-equal to the
    seeded one, a lone request and 32 at once answered through the
    processor, and one greedy batch of 32 answered exactly as by the
    random-init engine. Both engines name their models by the snapshot
    directories, which hold the repository's BPE tokenizer from the start, so
    both tokenize alike: through the HF adapter where `transformers` is
    importable, else by hashing (the line says which). With less than
    10 GB free in the temporary directory the models are cut to 4 layers
    each (widths are never cut) and the line says so."""
    import dataclasses
    import shutil
    import tempfile
    from unittest import mock

    import torch
    from rag_serving_system_torch.core import engine as engine_mod
    from rag_serving_system_torch.main import build_processor
    from rag_serving_system_torch.models.weights import named_leaves

    root = tempfile.mkdtemp(prefix="rag_ckpt_")
    try:
        free_gb = shutil.disk_usage(root).free / 1e9
        reduced = free_gb < 10.0
        names = {"encoder": "e5-large-seeded", "decoder": "qwen2.5-1.5b-seeded"}
        dirs = {k: os.path.join(root, v) for k, v in names.items()}
        for d in dirs.values():
            # the repository's BPE tokenizer stands in for both models' own
            # (its 27,056 ids fit both vocabularies)
            shutil.copytree(os.path.join(DATA, "bpe_tokenizer"), d)
        cut = (lambda cfg: dataclasses.replace(cfg, num_layers=4)) if reduced else (lambda c: c)
        enc_for, dec_for = engine_mod.encoder_config_for, engine_mod.decoder_config_for
        env = dict(DO_SAMPLE="0", EMBED_MODEL_NAME=dirs["encoder"],
                   LLM_MODEL_NAME=dirs["decoder"], QUERY_CACHE_SIZE="0")
        _serve_env(**env)
        with mock.patch.object(engine_mod, "encoder_config_for", lambda p: cut(enc_for(p))), \
                mock.patch.object(engine_mod, "decoder_config_for", lambda p: cut(dec_for(p))):
            _, seeded, _, _ = build_processor()
        require(seeded.weights_loaded == {"encoder": False, "decoder": False},
                f"serve_checkpoint: the first engine loaded {seeded.weights_loaded}")
        batch = queries[33:65]
        want = seeded.process(batch, [2] * len(batch))
        t0 = time.perf_counter()
        nbytes = write_checkpoints(root, seeded, names)
        write_s = time.perf_counter() - t0

        _serve_env(WEIGHTS_DIR=root, **env)
        reset_launches()
        t0 = time.perf_counter()
        processor, loaded, request_queue, settings = build_processor()
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        require(loaded.weights_loaded == {"encoder": True, "decoder": True}
                and settings.weights_dir == root,
                f"serve_checkpoint: WEIGHTS_DIR={root} loaded {loaded.weights_loaded}")
        require(loaded.enc_cfg == seeded.enc_cfg and loaded.dec_cfg == seeded.dec_cfg
                and (reduced or (loaded.enc_cfg == enc_for(settings.model_preset)
                                 and loaded.dec_cfg == dec_for(settings.model_preset))),
                f"serve_checkpoint: derived configs {loaded.enc_cfg} / {loaded.dec_cfg}")
        n_leaves, unequal = 0, []
        for a, b in ((seeded.enc_params, loaded.enc_params),
                     (seeded.dec_params, loaded.dec_params)):
            mine = dict(named_leaves(b))
            for name, leaf in named_leaves(a):
                n_leaves += 1
                other = mine.pop(name, None)
                if (other is None or other.dtype != leaf.dtype or other.device != leaf.device
                        or not torch.equal(other, leaf)):
                    unequal.append(name)
            unequal += list(mine)
        require(not unequal, f"serve_checkpoint: leaves differ after the round trip: {unequal}")
        toks = [type(t).__name__ for t in (loaded.enc_tok, loaded.dec_tok,
                                           seeded.enc_tok, seeded.dec_tok)]
        require(toks[:2] == toks[2:], f"serve_checkpoint: the engines tokenize "
                f"differently: {toks}")
        r = _drive(processor, request_queue, queries[:33], 32)
        launches = read_launches()
        loaded.prefix_cache.clear()     # all misses, as the seeded engine's batch was
        got = loaded.process(batch, [2] * len(batch))
        equal = sum(a == b for a, b in zip(got, want))
        emit("serve_checkpoint", reduced="layers=4" if reduced else None,
             tmp_free_gb=free_gb, dtype="bfloat16", stored="BF16", bytes=nbytes,
             write_s=write_s, load_s=loaded.models_ready_s, init_s=init_s,
             random_init_s=seeded.models_ready_s, leaves=n_leaves, leaves_bit_equal=True,
             configs_equal_presets=not reduced, tokenizers=toks[:2],
             answers_equal=equal, of=len(batch), launches=launches, **r)
        require(equal == len(batch), f"serve_checkpoint: {len(batch) - equal} of "
                f"{len(batch)} greedy answers differ from the random-init engine's")
        for name in ("cosine_topk", "flash_attention"):
            require(launches[name] > 0, f"kernel {name} never launched in serve_checkpoint")
        del processor, loaded, seeded
        _release()
        return launches
    finally:
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# the pipelined processor and the roles
# ---------------------------------------------------------------------------

PIPELINE_MODES = (("serial", dict(prefetch=False), {}),
                  ("w1_async", {}, dict(PREFETCH_WORKERS="1", FINALIZE_ASYNC="1")),
                  ("w2_async", {}, dict(PREFETCH_WORKERS="2", FINALIZE_ASYNC="1")),
                  ("w1_sync", {}, dict(PREFETCH_WORKERS="1", FINALIZE_ASYNC="0")),
                  ("w2_sync", {}, dict(PREFETCH_WORKERS="2", FINALIZE_ASYNC="0")))


def _through_processor(engine, settings, queries: list, kw: dict, env: dict) -> tuple:
    """`queries` at once through a new queue and a new processor of the given
    mode over `engine`: (answers in request order, seconds, the processor)."""
    from rag_serving_system_torch.core.batch_processor import BatchProcessor
    from rag_serving_system_torch.core.request_queue import make_queue

    for var in ("PREFETCH_WORKERS", "FINALIZE_ASYNC"):
        os.environ.pop(var, None)
    os.environ.update(env)
    request_queue = make_queue(settings)
    processor = BatchProcessor(request_queue, engine,
                               polling_interval=min(settings.polling_interval, 0.05), **kw)
    processor.start()
    try:
        results, seconds = _answered(request_queue, queries)
    finally:
        processor.stop(drain_timeout=10.0)
        processor.join(timeout=30)
    require(not processor.is_alive() and processor.requests_processed == len(queries),
            f"serve_pipeline: the processor counted {processor.requests_processed} of "
            f"{len(queries)} requests, alive={processor.is_alive()}")
    return [r["result"] for r in results], seconds, processor


def phase_serve_pipeline(queries: list) -> dict:
    """The full processor at full width.

    (a) f32, greedy, the decoder's matrices scaled by 4 (answers then follow
    the prompt, and picks have clear gaps): 129 requests at once through the
    serial mode (`prefetch=False`) and through PREFETCH_WORKERS 1 and 2 with
    FINALIZE_ASYNC 1 and 0. A request's batch differs between modes
    (regrouping, partial batches), and so do its matmul shapes, so the bound
    is 127 of 129 answers identical to the serial mode's, printed with the
    count; a wrong request-to-answer mapping would change most.
    (b) bf16 at the defaults (sampling): the same 129 through each mode, in
    seconds, after one untimed pass (the 129th request is a batch of its
    own, which `get_batch` holds for MAX_WAIT_TIME in every mode); then the
    A/B behind the default of PREFETCH_WORKERS: 64 at once, all misses (the
    prefix cache emptied) and all hits, at 1, 2, 2, 1 workers.
    (c) ROLE=api and ROLE=engine built by `main.build_app` in this process
    over one in-memory queue (a stand-in for Redis): one request through
    HTTP where aiohttp is importable, else through the queue."""
    import importlib.util
    import urllib.request
    from unittest import mock

    import torch
    from rag_serving_system_torch import main as main_mod
    from rag_serving_system_torch.core import request_queue as rq_mod
    from rag_serving_system_torch.main import build_processor

    batch = queries[:129]
    _serve_env(COMPUTE_DTYPE="float32", DO_SAMPLE="0")
    _, engine, _, settings = build_processor()
    _scale_decoder(engine, 4.0)
    engine.warmup()
    # one untimed pass first: the first batches at a new shape pay for it
    _through_processor(engine, settings, batch, dict(prefetch=False), {})
    answers, f32_seconds = {}, {}
    for name, kw, env in PIPELINE_MODES:
        engine.prefix_cache.clear()
        answers[name], f32_seconds[name], _ = _through_processor(engine, settings, batch,
                                                                 kw, env)
    same = {name: sum(a == b for a, b in zip(got, answers["serial"]))
            for name, got in answers.items()}
    distinct = len(set(answers["serial"]))
    emit("serve_pipeline_equal", dtype="float32", decoder_scale=4.0, requests=len(batch),
         identical_to_serial=same, required=len(batch) - 2, distinct_answers=distinct,
         seconds=f32_seconds)
    require(all(n >= len(batch) - 2 for n in same.values()),
            f"serve_pipeline: answers identical to the serial mode's: {same}")
    require(distinct >= 10, f"serve_pipeline: only {distinct} distinct answers")
    del engine
    _release()

    _serve_env()
    _, engine, _, settings = build_processor()
    engine.warmup()
    reset_launches()    # the untimed pass retrieves; the query cache answers after it
    _through_processor(engine, settings, batch, dict(prefetch=False), {})
    seconds, backlog = {}, {}
    for name, kw, env in PIPELINE_MODES:
        engine.prefix_cache.clear()
        _, seconds[name], proc = _through_processor(engine, settings, batch, kw, env)
        backlog[name] = {"batches": proc.batches_processed,
                         "workers": proc.prefetch_workers,
                         "finalize_async": proc.finalize_async and proc.prefetch}
    launches = read_launches()
    ab = []
    for workers in ("1", "2", "2", "1"):
        row = {"workers": int(workers)}
        for step, clear in (("misses_s", True), ("hits_s", False)):
            if clear:
                engine.prefix_cache.clear()
            _, row[step], _ = _through_processor(
                engine, settings, queries[1:65], {},
                dict(PREFETCH_WORKERS=workers, FINALIZE_ASYNC="1"))
        ab.append(row)
    emit("serve_pipeline", dtype="bfloat16", requests=len(batch), seconds=seconds,
         modes=backlog, launches=launches, prefetch_workers_ab_64_requests=ab,
         stages=engine.timer.summary())
    for name in ("cosine_topk", "flash_attention"):
        require(launches[name] > 0, f"kernel {name} never launched in serve_pipeline")
    del engine
    _release()

    # (c) the two roles over one queue
    _serve_env(REDIS_URL="redis://in-process-stand-in:6379", MAX_WAIT_TIME="0.1")
    shared = rq_mod.RequestQueue(max_batch_size=32, max_wait_time=0.1)
    have_http = importlib.util.find_spec("aiohttp") is not None
    with mock.patch.object(rq_mod, "make_queue", lambda s: shared):
        app = None
        if have_http:
            app, no_proc, no_engine, _ = main_mod.build_app(role="api")
            require(app is not None and no_proc is None and no_engine is None,
                    "serve_pipeline: ROLE=api built an engine")
        no_app, processor, engine, _ = main_mod.build_app(role="engine", warmup=False)
    require(no_app is None and processor.is_alive() and engine is not None,
            "serve_pipeline: ROLE=engine did not start a processor without an app")
    t0 = time.perf_counter()
    try:
        if have_http:
            from rag_serving_system_torch.api.endpoints import ServerThread

            server = ServerThread(app).start()
            try:
                req = urllib.request.Request(
                    server.url + "/rag?wait=30", method="POST",
                    data=json.dumps({"query": queries[0], "k": 2}).encode(),
                    headers={"content-type": "application/json"})
                with urllib.request.urlopen(req, timeout=120) as resp:
                    body = json.loads(resp.read())
                with urllib.request.urlopen(server.url + "/stats", timeout=30) as resp:
                    stats_keys = sorted(json.loads(resp.read()))
            finally:
                server.stop()
            result = body.get("result")
        else:
            stats_keys = None
            result = shared.get_result(shared.add_request(queries[0], 2), timeout=120)
    finally:
        processor.stop(drain_timeout=10.0)
        processor.join(timeout=30)
    emit("serve_roles", through="http" if have_http else "queue (aiohttp is not importable)",
         seconds=time.perf_counter() - t0, api_stats_keys=stats_keys, answer=result)
    require(isinstance(result, dict) and isinstance(result.get("result"), str),
            f"serve_pipeline: the api and engine roles did not answer: {result}")
    del processor, engine
    _release()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# traces and the trainer
# ---------------------------------------------------------------------------

def trace_summary(prof, wall_s: float, top: int = 5) -> dict:
    """What a `device_trace` profiler saw on the card over a window of
    wall_s seconds (host clock, synchronised at both ends): the share of it
    in which the device ran a kernel or a copy (the union of their
    intervals), the kernel count, and the `top` kernels by device time. The
    device-side copies of `record_function` ranges (and of the optimizer's
    own range) are annotations, not work: they are left out."""
    from torch.autograd import DeviceType

    events = prof.events()
    host_names = {e.name for e in events if e.device_type != DeviceType.CUDA}
    spans, by_name, kernels = [], {}, 0
    for e in events:
        if (e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False)
                or e.name in host_names):
            continue
        spans.append((e.time_range.start, e.time_range.end))
        if not e.name.startswith(("Memcpy", "Memset")):
            kernels += 1
            by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_us, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        busy_us += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"wall_ms": wall_s * 1e3, "device_busy_ms": busy_us / 1e3,
            "busy_share": busy_us / (wall_s * 1e6), "kernels": kernels,
            "top_kernels": [{"name": n[:120], "ms": us / 1e3} for n, us in ranked]}


def launch_share(prof, region: str) -> dict:
    """Kernel launches on the host (the CUDA runtime's launch calls) inside
    the `record_function(region)` ranges, against all of them."""
    events = prof.events()
    ranges = [(e.time_range.start, e.time_range.end) for e in events if e.name == region]
    launches = [e.time_range.start for e in events if "LaunchKernel" in e.name]
    inside = sum(any(lo <= t <= hi for lo, hi in ranges) for t in launches)
    return {"launches": len(launches), f"{region}_launches": inside,
            f"{region}_share": inside / max(len(launches), 1)}


def _traced_serve_batch(engine, queries: list) -> dict:
    """One `engine.process` of the batch under `device_trace`, with the
    decode loop marked as a profiler range: the device-busy share, the
    kernel count, the top kernels and the share of launches in decode. The
    profiler slows the host, so the same batch is also timed untraced just
    before, and the traced device time is set against that wall too."""
    import tempfile
    from unittest import mock

    import torch
    from rag_serving_system_torch.models import qwen2
    from rag_serving_system_torch.utils.timing import device_trace

    def marked(fn):
        def call(*a, **kw):
            with torch.profiler.record_function("decode"):
                return fn(*a, **kw)
        return call

    ks = [2] * len(queries)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.process(queries, ks)
    torch.cuda.synchronize()
    untraced = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as log_dir, \
            mock.patch.object(qwen2, "_decode_loop", marked(qwen2._decode_loop)):
        with device_trace(log_dir, device=engine.device) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = engine.process(queries, ks)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        files = os.listdir(log_dir)
    require(len(out) == len(queries) and all(isinstance(r.get("result"), str) for r in out),
            f"the traced batch did not answer: {out[:2]}")
    require(len(files) == 1, f"device_trace wrote {files}")
    summary = trace_summary(prof, wall)
    summary = {"batch": len(queries), **summary, "untraced_wall_ms": untraced * 1e3,
               "busy_share_of_untraced": summary["device_busy_ms"] / (untraced * 1e3),
               **launch_share(prof, "decode")}
    require(summary["kernels"] > 0 and summary["decode_launches"] > 0,
            f"the serve trace saw no kernels on the card or none in decode: {summary}")
    return summary


TRAIN_BATCH, TRAIN_LEN = 16, 64


def _train_parity(params: dict, cfg, tok, pairs: list, dev) -> dict:
    """(a) The full-width tree cut to its first 2 layers: one f32
    contrastive_loss, backward and AdamW step on the card and on the CPU from
    the same weights and batch. The loss within 1e-4; every gradient leaf
    within 1e-4 of its largest magnitude; the parameters after the step
    within 1e-6, or 2 lr where either gradient is within 1e-6 of zero (Adam's
    first step moves an element by lr times the sign of its gradient, so a
    near-zero gradient whose sign differs between the two sums may move it
    the other way)."""
    import dataclasses

    import torch
    from rag_serving_system_torch.models.weights import map_tree, named_leaves
    from rag_serving_system_torch.training import contrastive as tc

    lr, layers = 1e-5, 2
    cut = dataclasses.replace(cfg, num_layers=layers)
    runs = []
    for where in (dev, torch.device("cpu")):
        p = map_tree({"embed": params["embed"],
                      "layers": {k: v[:layers] for k, v in params["layers"].items()}},
                     lambda t: t.detach().to(where, copy=True))
        opt = tc.adamw(p, lr)
        batch = next(tc.pair_batches(tok, pairs, TRAIN_BATCH, TRAIN_LEN, device=where))
        loss, acc = tc.contrastive_loss(p, cut, batch, dtype=torch.float32)
        loss.backward()
        grads = {n: t.grad.cpu() for n, t in named_leaves(p)}
        opt.step()
        runs.append((float(loss.detach()), float(acc), grads,
                     {n: t.detach().cpu() for n, t in named_leaves(p)}))
        del p, opt
    (l_gpu, a_gpu, g_gpu, p_gpu), (l_cpu, a_cpu, g_cpu, p_cpu) = runs
    grad_rel, param_err, caveat = {}, {}, 0
    for name, g in g_cpu.items():
        grad_rel[name] = float((g_gpu[name] - g).abs().max() / g.abs().max().clamp(min=1e-30))
        near = torch.minimum(g.abs(), g_gpu[name].abs()) <= 1e-6
        err = (p_gpu[name] - p_cpu[name]).abs()
        caveat += int((near & (err > 1e-6)).sum())
        param_err[name] = float(err[~near].max()) if bool((~near).any()) else 0.0
        require(bool((err <= 1e-6 + 2 * lr * near.float()).all()),
                f"train parity: {name} after the step differs by {float(err.max())}")
    out = {"layers": layers, "lr": lr, "loss_card": l_gpu, "loss_cpu": l_cpu,
           "acc_card": a_gpu, "acc_cpu": a_cpu, "max_grad_rel_err": max(grad_rel.values()),
           "grad_rel_err": grad_rel, "max_param_err": max(param_err.values()),
           "near_zero_elements_past_1e-6": caveat}
    require(abs(l_gpu - l_cpu) <= 1e-4, f"train parity: loss {l_gpu} on the card, {l_cpu} "
            f"on the CPU")
    require(max(grad_rel.values()) <= 1e-4, f"train parity: gradients differ: {grad_rel}")
    return out


def _fixed_batch(params: dict, cfg, batch: dict, dev) -> dict:
    """(b) 8 steps on one fixed batch at full depth in bf16, from a copy of
    `params`: at lr 5e-4 (the JAX package's test), and again from the same
    weights at a lower rate only if the loss did not fall."""
    import torch
    from rag_serving_system_torch.models.weights import map_tree
    from rag_serving_system_torch.training import contrastive as tc

    tries = []
    for lr in (5e-4, 1e-4, 2e-5):
        p = map_tree(params, lambda t: t.detach().to(dev, copy=True))
        step = tc.make_train_step(cfg, tc.adamw(p, lr), dtype=torch.bfloat16)
        losses = [float(step(p, batch)["loss"]) for _ in range(8)]
        tries.append({"lr": lr, "losses": losses})
        del p, step
        torch.cuda.empty_cache()
        if losses[-1] < losses[0]:
            break
    require(tries[-1]["losses"][-1] < tries[-1]["losses"][0],
            f"train: the loss on a fixed batch did not fall at any rate: {tries}")
    return {"steps": 8, "lr_used": tries[-1]["lr"], "tries": tries}


def _recall(params: dict, cfg, tok, pairs: list, dev) -> dict:
    """(d) Recall@1 and @5 of every query of `pairs` against the distinct
    facts, both embedded as the trainer embeds them (`_embed`: masked mean,
    unit norm, bf16), retrieved through B1 and through its plain version;
    the ids must agree."""
    import torch
    from rag_serving_system_torch.ops import topk
    from rag_serving_system_torch.training import contrastive as tc

    facts = list(dict.fromkeys(p["fact"] for p in pairs))
    target = torch.tensor([facts.index(p["fact"]) for p in pairs], device=dev)

    @torch.inference_mode()
    def embed(texts):
        out = []
        for lo in range(0, len(texts), 250):
            ids, mask = tok.encode_batch(texts[lo:lo + 250], TRAIN_LEN)
            out.append(tc._embed(params, cfg, torch.as_tensor(ids, device=dev),
                                 torch.as_tensor(mask, device=dev), torch.bfloat16))
        return torch.cat(out)

    corpus = embed(["passage: " + f for f in facts]).contiguous()
    queries = embed(["query: " + p["query"] for p in pairs])
    _, ids = topk.cosine_topk(corpus, queries, 5)
    _, plain = topk.cosine_topk_reference(corpus, queries, 5)
    hits = ids.long() == target[:, None]
    return {"queries": len(pairs), "facts": len(facts), "ids_equal_plain": bool(
        torch.equal(ids, plain)), "recall_at_1": float(hits[:, 0].float().mean()),
        "recall_at_5": float(hits.any(dim=1).float().mean())}


def phase_train(_queries=None) -> dict:
    """The contrastive trainer at full width on the card: e5-large (24
    layers, 1024 wide, 250,002-row vocabulary) with f32 parameters from a
    seed, on squad_real's 1,000 (query, fact) pairs, hashed to the vocabulary,
    batches of 16 at 64 tokens: (a) parity with the CPU at 2 layers, (b) 8
    steps on one fixed batch, (c) one epoch through `train_encoder` (62
    steps, lr 1e-5, bf16 activations), (d) recall through B1 before and after
    (c), (e) a checkpoint round trip of the trained tree, (f) one step under
    `device_trace`. Returns each kernel's launch count in the phase."""
    import math
    import statistics
    import tempfile
    from unittest import mock

    import torch
    from rag_serving_system_torch.device import resolve_device
    from rag_serving_system_torch.models.configs import E5_LARGE
    from rag_serving_system_torch.models.tokenizer import HashTokenizer
    from rag_serving_system_torch.models.weights import init_encoder_params, named_leaves
    from rag_serving_system_torch.training import contrastive as tc
    from rag_serving_system_torch.utils.timing import device_trace

    dev = resolve_device("cuda")
    cfg = E5_LARGE
    with open(os.path.join(DATA, "squad_real_pairs.json"), encoding="utf-8") as f:
        pairs = json.load(f)
    tok = HashTokenizer(cfg.vocab_size, pad_id=cfg.pad_token_id)
    params = init_encoder_params(cfg, seed=0, dtype=torch.float32, device=dev)
    n_params = sum(t.numel() for _, t in named_leaves(params))
    reset_launches()

    t0 = time.perf_counter()
    emit("train_parity", **_train_parity(params, cfg, tok, pairs, dev))
    emit("timing", of="train_parity", seconds=time.perf_counter() - t0)
    batch = next(tc.pair_batches(tok, pairs, TRAIN_BATCH, TRAIN_LEN, device=dev))
    emit("train_fixed_batch", **_fixed_batch(params, cfg, batch, dev))

    before = _recall(params, cfg, tok, pairs, dev)
    step_events = []

    make_step = tc.make_train_step

    def timed_steps(*a, **kw):
        step = make_step(*a, **kw)

        def call(p, b):
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            out = step(p, b)
            end.record()
            step_events.append((start, end))
            return out
        return call

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with mock.patch.object(tc, "make_train_step", timed_steps):
        trained, history = tc.train_encoder(params, cfg, tok, pairs, epochs=1,
                                            batch_size=TRAIN_BATCH, max_len=TRAIN_LEN,
                                            lr=1e-5, dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    step_ms = [s.elapsed_time(e) for s, e in step_events]
    losses = [h["loss"] for h in history]
    epoch = {"pairs": len(pairs), "steps": len(history), "seconds": seconds,
             "median_step_ms": statistics.median(step_ms), "min_step_ms": min(step_ms),
             "max_step_ms": max(step_ms), "pairs_per_s": len(history) * TRAIN_BATCH / seconds,
             "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
             "params": n_params, "first_loss": losses[0], "last_loss": losses[-1],
             "first_acc": history[0]["in_batch_acc"], "last_acc": history[-1]["in_batch_acc"],
             "losses": losses}
    emit("train_epoch", **epoch)
    require(len(history) == len(pairs) // TRAIN_BATCH, f"train: {len(history)} steps")
    require(all(map(math.isfinite, losses)), f"train: a loss is not finite: {losses}")
    del params
    torch.cuda.empty_cache()

    after = _recall(trained, cfg, tok, pairs, dev)
    emit("train_recall", before=before, after=after)
    for r in (before, after):
        require(r["ids_equal_plain"], f"train: B1's ids differ from its plain version's: {r}")

    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "encoder.safetensors")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nbytes = tc.save_checkpoint(path, trained)
        t_write = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = tc.load_checkpoint(path, trained)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
    equal = all(b.device == a.device and b.dtype == a.dtype and torch.equal(a, b)
                for (_, a), (_, b) in zip(named_leaves(trained), named_leaves(back)))
    emit("train_checkpoint", bytes=nbytes, write_s=t_write, load_s=t_load,
         leaves=len(list(named_leaves(back))), bit_equal=equal)
    require(equal, "train: the checkpoint did not load back bit for bit")
    del back

    step = tc.make_train_step(cfg, tc.adamw(trained, 1e-5), dtype=torch.bfloat16)
    step(trained, batch)     # the optimizer's state is made here
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(trained, batch)     # untraced, for the wall beside the traced one
    torch.cuda.synchronize()
    untraced = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as log_dir:
        with device_trace(log_dir) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(trained, batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        files = os.listdir(log_dir)
        trace_bytes = sum(os.path.getsize(os.path.join(log_dir, f)) for f in files)
    summary = trace_summary(prof, wall)
    emit("train_trace", files=len(files), trace_bytes=trace_bytes, **summary,
         untraced_wall_ms=untraced * 1e3,
         busy_share_of_untraced=summary["device_busy_ms"] / (untraced * 1e3))
    require(len(files) == 1 and trace_bytes > 0 and summary["kernels"] > 0,
            f"train: the traced step wrote {files} and saw {summary['kernels']} kernels")
    launches = read_launches()
    emit("train_launches", **launches)
    require(launches["cosine_topk"] > 0, "train: B1 never launched in the recall check")
    del trained, step
    torch.cuda.empty_cache()
    return launches


# the mesh of serve_mesh: two data groups of two model positions, all on one
# card (positions share the device; a layout check, never a multi-card time)
MESH_SHAPE = "2,2"


def _mesh_recorders(qwen2, sharded_topk, log: dict):
    """Patches that record, beside each launch, the thread (the mesh
    position) and the shapes: B2's from qwen2, B1's from the sharded top-k."""
    import threading
    from unittest import mock

    b2, b1 = qwen2.flash_attention, sharded_topk.cosine_topk

    def flash(q, k, v, mask, causal=True):
        log["b2"].append((threading.current_thread().name, tuple(q.shape), tuple(k.shape)))
        return b2(q, k, v, mask, causal)

    def topk(corpus, queries, k, normalize_queries=True):
        log["b1"].append((tuple(corpus.shape), k))
        return b1(corpus, queries, k, normalize_queries)

    return (mock.patch.object(qwen2, "flash_attention", flash),
            mock.patch.object(sharded_topk, "cosine_topk", topk))


def _mesh_bytes(model) -> dict:
    """Bytes a position holds of the split leaves and of the replicated rest,
    per model position of data group 0."""
    from rag_serving_system_torch.ops.quant import weight_bytes
    from rag_serving_system_torch.parallel import tp

    split = tp._COL | tp._ROW | tp._COL_BIAS
    out = []
    for p in model.params[0]:
        tp_bytes = sum(weight_bytes(w) for k, w in p["layers"].items() if k in split)
        out.append({"split_leaves": tp_bytes, "replicated": weight_bytes(p) - tp_bytes})
    return out


def _sharded_topk_check(dev, mesh) -> list:
    """The sharded top-k at 1,048,576 x 1024 (f32 and bf16), B = 32, over the
    mesh's 4 shards of one card, at k = 16 (warp lists) and 1024 (score
    kernel and select): ids equal unsharded B1's, each shard's B1 call
    against its plain version, and the times of both (4 shards on ONE card:
    not a multi-card time)."""
    import torch
    from rag_serving_system_torch.ops import topk
    from rag_serving_system_torch.parallel.sharded_topk import (shard_corpus,
                                                                 sharded_cosine_topk)

    n = 1 << 20
    g = torch.Generator(device=dev).manual_seed(21)
    corpus = topk.l2_normalize(torch.randn((n, 1024), generator=g, device=dev))
    queries = torch.randn((32, 1024), generator=g, device=dev)
    out = []
    for dtype in (torch.float32, torch.bfloat16):
        c = corpus.to(dtype)
        shards = shard_corpus(c, mesh)
        for k in (16, 1024):
            s_sh, i_sh = sharded_cosine_topk(shards, queries, k, mesh, valid_n=n)
            s_one, i_one = topk.cosine_topk(c, queries, k)
            require(torch.equal(i_sh, i_one), f"sharded top-k ids differ from unsharded B1 "
                    f"({dtype}, k={k}) at {(i_sh != i_one).nonzero().tolist()[:8]}")
            err = (s_sh - s_one).abs().max().item()
            require(err == 0.0, f"sharded top-k scores differ by {err} ({dtype}, k={k})")
            per_shard = [_check_topk(sh, queries, k, reps=3) for sh in shards]
            rec = {"n": n, "d": 1024, "b": 32, "k": k, "corpus": str(dtype),
                   "shards": len(shards), "shard_rows": shards[0].shape[0],
                   "ids_equal_unsharded": True,
                   "shard_max_abs_err": max(r["max_abs_err"] for r in per_shard),
                   "shard_ms": [r["ms"] for r in per_shard],
                   "shard_plain_ms": [r["plain_ms"] for r in per_shard],
                   "sharded_ms": cuda_ms(lambda: sharded_cosine_topk(
                       shards, queries, k, mesh, valid_n=n), 5),
                   "unsharded_ms": cuda_ms(lambda: topk.cosine_topk(c, queries, k), 5)}
            emit("sharded_topk", **rec)
            out.append(rec)
        del c, shards
        torch.cuda.empty_cache()
    return out


def _mesh_parity(docs, emb, mesh, queries: list) -> dict:
    """Full width, f32, greedy, decoder scaled by 4: the mesh engine answers
    8 queries (and a lone one) exactly as the one-device engine, on the
    miss route (cache emptied) and the hit route (the same 8 again)."""
    import torch
    from rag_serving_system_torch.config import get_settings
    from rag_serving_system_torch.core.engine import RagEngine

    _serve_env(COMPUTE_DTYPE="float32", DO_SAMPLE="0", QUERY_CACHE_SIZE="0")
    settings = get_settings()
    single = RagEngine(settings, docs, emb)
    meshed = RagEngine(settings, docs, emb, mesh=mesh)
    _scale_decoder(single, 4.0)
    meshed.enc_params, meshed.dec_params = single.enc_params, single.dec_params
    routes, same = {}, {}
    for name, qs in (("lone", queries[:1]), ("batch_of_8", queries[1:9])):
        for eng in (single, meshed):
            eng.prefix_cache.clear()
        for route in ("miss", "hit"):
            before = meshed.prefix_cache.stats()
            a = single.process(qs, [2] * len(qs))
            b = meshed.process(qs, [2] * len(qs))
            after = meshed.prefix_cache.stats()
            routes[f"{name}_{route}"] = {k: after[k] - before[k] for k in ("hits", "misses")}
            same[f"{name}_{route}"] = a == b
            if name == "batch_of_8" and route == "miss":
                sample = [r["result"] for r in b[:2]]
    emit("serve_mesh_parity", dtype="float32", identical=same, routes=routes,
         sample_answers=sample)
    require(all(same.values()), f"serve_mesh parity: mesh answers differ from one "
            f"device's: {same}")
    for key, r in routes.items():
        want_hit = key.endswith("hit")
        require((r["misses"] == 0) == want_hit and (r["hits"] > 0) == want_hit,
                f"serve_mesh parity {key} took the wrong route: {r}")
    del single, meshed
    _release()
    return same


def phase_serve_mesh(queries: list) -> dict:
    """The engine over a "2,2" mesh of four positions on the one card, at
    full width (e5-large, Qwen2.5-1.5B, seeded random weights, bf16, every
    default: PREFIX_CACHE=1): the lone miss, 64 misses, the same 64 as hits,
    then 8 cold requests (the prefix cache switched off: padded prefill),
    through the processor. B1 must launch once per shard per retrieval, B2
    on every model position (6 query heads and 1 KV head each) in
    compute_prefix_kv and in the padded prefill; each prefix pool part holds
    one of the two KV heads. Then B2 at the mesh's shapes and B1 on a shard
    against their plain versions, the f32 parity with one device, and the
    sharded top-k at 1M rows."""
    from unittest import mock

    import numpy as np
    import torch
    from rag_serving_system_torch.main import build_processor
    from rag_serving_system_torch.models import qwen2
    from rag_serving_system_torch.parallel import sharded_topk
    from rag_serving_system_torch.parallel.mesh import make_mesh

    dev = torch.device("cuda", 0)
    mesh = make_mesh(MESH_SHAPE, devices=[dev] * 4)
    _serve_env(MESH_SHAPE=MESH_SHAPE)
    with open(os.environ["DOCUMENT_TEXT_FILE"], encoding="utf-8") as f:
        docs = json.load(f)
    emb = np.load(os.environ["DOCUMENT_EMBEDDINGS_FILE"])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    processor, engine, request_queue, settings = build_processor(
        documents=docs, doc_embeddings=emb, mesh=mesh)
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    cache = engine.prefix_cache
    dec, enc = engine.dec_params, engine.enc_params
    layers, tp = engine.dec_cfg.num_layers, mesh.shape["model"]
    require(settings.prefix_cache and cache is not None, "serve_mesh: the prefix cache is off")
    require(dec.split == enc.split == {"attn": True, "mlp": True},
            f"serve_mesh: tp = 2 must split every block: {dec.split}, {enc.split}")
    require(len(engine.corpus) == 4 and not engine.packed,
            "serve_mesh: the corpus is not in 4 shards, or packed prefill is on")
    full_hk = engine.dec_cfg.num_kv_heads
    parts = {f"{p}@{d}": {"kv_heads": pool.shape[4], "bytes": pool.numel() * pool.element_size()}
             for (p, d), pool in cache._pools.items()}
    require(len(parts) == tp and all(v["kv_heads"] * tp == full_hk for v in parts.values()),
            f"serve_mesh: the prefix pool parts do not hold half the KV heads: {parts}")
    log = {"b1": [], "b2": []}
    rec_b2, rec_b1 = _mesh_recorders(qwen2, sharded_topk, log)
    steps = {}
    plans = (("a_lone_miss", queries[:1], False), ("b_64_misses", queries[1:65], False),
             ("c_64_hits", queries[1:65], False), ("d_8_cold", queries[65:73], True))
    with rec_b2, rec_b1:
        processor.start()
        try:
            for step, qs, cold in plans:
                log["b1"].clear()
                log["b2"].clear()
                before = cache.stats()
                torch.cuda.reset_peak_memory_stats()
                reset_launches()
                if cold:
                    with mock.patch.object(engine, "prefix_cache", None):
                        _, seconds = _answered(request_queue, qs)
                else:
                    _, seconds = _answered(request_queue, qs)
                launches = read_launches()
                after = cache.stats()
                steps[step] = {
                    "requests": len(qs), "seconds": seconds, "launches": launches,
                    "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                    **{k: after[k] - before[k] for k in ("hits", "misses", "bypassed")},
                    "entries": after["entries"],
                    "b2_positions": sorted({t for t, _, _ in log["b2"]}),
                    "b2_heads": sorted({(q[2], k[2]) for _, q, k in log["b2"]}),
                    "b2_shapes": sorted({(q[0], q[1]) for _, q, _ in log["b2"]}),
                    "b1_calls": len(log["b1"]),
                    "b1_shapes": sorted({(s[0], k) for s, k in log["b1"]})}
        finally:
            processor.stop(drain_timeout=10.0)
            processor.join(timeout=30)
    launches = {}
    for st in steps.values():
        for name, n in st["launches"].items():
            launches[name] = launches.get(name, 0) + n
    # one all-hit batch of 32 through the engine alone, beside the one-device
    # stage split of the serve phase
    t0 = time.perf_counter()
    engine.process(queries[1:33], [2] * 32)
    torch.cuda.synchronize()
    all_hit_32_s = time.perf_counter() - t0
    emit("serve_mesh", mesh=MESH_SHAPE, devices=[str(d) for d in mesh.devices],
         init_s=t_init, steps=steps, launches=launches, prefix_parts=parts,
         decoder_position_bytes=engine.position_weight_bytes,
         encoder_position_bytes=enc.position_bytes(),
         decoder_bytes_whole=engine.weight_bytes,
         decoder_split=_mesh_bytes(dec), encoder_split=_mesh_bytes(enc),
         peak_memory_gb=max(st["peak_memory_gb"] for st in steps.values()),
         prefix_stats=cache.stats(), stages=engine.timer.summary(),
         all_hit_batch_of_32_s=all_hit_32_s)
    require_launched("serve_mesh", launches)
    a, b, c, d = (steps[s] for s, _, _ in plans)
    group0 = ["mesh-0-0", "mesh-0-1"]
    every = ["mesh-0-0", "mesh-0-1", "mesh-1-0", "mesh-1-1"]
    shard_rows = engine.corpus[0].shape[0]
    for name, st in steps.items():
        # one warp-list launch a shard a retrieval, each on a quarter corpus
        require(st["launches"]["cosine_topk"] == st["b1_calls"] and st["b1_calls"] % 4 == 0
                and all(shape == (shard_rows, engine.max_k) for shape in st["b1_shapes"]),
                f"serve_mesh {name}: B1 did not run once per shard per retrieval: {st}")
        require(all(h == (6, 1) for h in st["b2_heads"]),
                f"serve_mesh {name}: B2 ran with other than 6 query / 1 KV heads: {st}")
    require((a["misses"], a["hits"], a["entries"]) == (1, 0, 1)
            and a["launches"]["flash_attention"] == tp * layers
            and a["b2_positions"] == group0 and a["launches"]["cosine_topk"] == 4,
            f"serve_mesh: the lone miss did not run B2 on both model positions "
            f"({tp} x {layers}) and B1 on the 4 shards: {a}")
    require(b["hits"] + b["misses"] == 64 and b["bypassed"] == 0 and b["misses"] > 0
            and b["launches"]["flash_attention"] > 0
            and b["launches"]["flash_attention"] % (tp * layers) == 0
            and set(group0) <= set(b["b2_positions"]) and b["launches"]["cosine_topk"] > 0,
            f"serve_mesh: the 64 requests did not take the miss route through B2: {b}")
    require(c["misses"] == 0 and c["hits"] == 64 and c["launches"]["flash_attention"] == 0
            and c["launches"]["cosine_topk"] == 0,
            f"serve_mesh: the repeated 64 requests did not hit: {c}")
    require(d["b2_positions"] == every and d["launches"]["flash_attention"] % (tp * layers) == 0
            and d["launches"]["flash_attention"] > 0 and d["hits"] + d["misses"] == 0,
            f"serve_mesh: the cold batch did not prefill through B2 on every position: {d}")
    # B2 and B1 against their plain versions at the shapes this run gave them
    # prefix compute (right-padded) in steps a and b, padded prefill in d
    shapes = {(m, s, "right") for st in (a, b) for m, s in st["b2_shapes"]}
    shapes |= {(m, s, "left") for m, s in d["b2_shapes"]}
    for m, s, padding in sorted(shapes):
        for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 2e-4)):
            emit("kernel", name="flash_attention", served_shape="serve_mesh",
                 **_check_flash(dev, dtype, tol, seed=31, b=m, s=s, padding=padding,
                                heads=(6, 1, engine.dec_cfg.head_dim)))
    g = torch.Generator(device=dev).manual_seed(32)
    q = torch.randn((32, engine.corpus[0].shape[1]), generator=g, device=dev)
    emit("kernel", name="cosine_topk", served_shape="serve_mesh",
         **_check_topk(engine.corpus[0], q, engine.max_k, reps=5))
    del processor, engine, cache, dec, enc
    _release()
    _mesh_parity(docs, emb, mesh, queries[73:82])
    _sharded_topk_check(dev, mesh)
    return launches


def phase_serve_mesh_cards(queries: list) -> dict:
    """The engine over meshes of SEVERAL cards (an even number; run it with
    `--phases serve_mesh_cards` on such a machine: the default run needs one
    card and leaves it out), at full width, bf16, every other setting at its
    default: one card without a mesh, every card on "data" ("N,1": each data
    group on a card of its own), and tensor parallelism ("N/2,2"). Each serves a lone miss, 64 misses and the same
    64 as hits through the processor, then one all-hit batch of 32 through
    the engine three times: seconds, launches, the peak memory of each card.
    On the meshes the batch of 32 is also timed under both turn-ring plans,
    taking turns: a ring a data group (the groups at once) and one ring for
    every group (the groups one after another). Then the f32 greedy answers
    of the "N/2,2" mesh equal to one card's (a lone request and 8, miss and
    hit routes)."""
    from unittest import mock

    import numpy as np
    import torch
    from rag_serving_system_torch.main import build_processor
    from rag_serving_system_torch.parallel import tp
    from rag_serving_system_torch.parallel.mesh import make_mesh

    n = torch.cuda.device_count()
    require(n >= 2 and n % 2 == 0, f"serve_mesh_cards needs an even number of cards: {n}")
    cards = [torch.device("cuda", i) for i in range(n)]
    with open(os.path.join(DATA, "squad_real_contexts.json"), encoding="utf-8") as f:
        docs = json.load(f)
    emb = np.load(os.path.join(DATA, "squad_real_embeddings.npy"))

    def synced() -> None:
        for c in cards:
            torch.cuda.synchronize(c)

    def all_hit_32(engine) -> float:
        t0 = time.perf_counter()
        engine.process(queries[1:33], [2] * 32)
        synced()
        return time.perf_counter() - t0

    plans = {"ring_per_group": lambda mesh, groups: [
                 [(g, m) for m in range(mesh.shape["model"])] for g in groups],
             "one_ring": lambda mesh, groups: [
                 [(g, m) for g in groups for m in range(mesh.shape["model"])]]}

    layouts = {}
    for shape in ("", f"{n},1", f"{n // 2},2"):
        _serve_env(MESH_SHAPE=shape)
        for c in cards:
            torch.cuda.reset_peak_memory_stats(c)
        t0 = time.perf_counter()
        processor, engine, request_queue, _ = build_processor(
            documents=docs, doc_embeddings=emb,
            mesh=make_mesh(shape, devices=cards) if shape else None)
        synced()
        t_init = time.perf_counter() - t0
        cache = engine.prefix_cache
        steps = {}
        processor.start()
        try:
            for step, qs in (("a_lone_miss", queries[:1]), ("b_64_misses", queries[1:65]),
                             ("c_64_hits", queries[1:65])):
                before = cache.stats()
                reset_launches()
                _, seconds = _answered(request_queue, qs)
                after = cache.stats()
                steps[step] = {"requests": len(qs), "seconds": seconds,
                               "launches": read_launches(),
                               **{k: after[k] - before[k] for k in ("hits", "misses")}}
        finally:
            processor.stop(drain_timeout=10.0)
            processor.join(timeout=30)
        all_hit = [all_hit_32(engine) for _ in range(3)]
        by_plan = {name: [] for name in plans} if shape else {}
        for _ in range(3 if shape else 0):
            for name, plan in plans.items():
                with mock.patch.object(tp, "rings", plan):
                    by_plan[name].append(all_hit_32(engine))
        rec = {"layout": shape or "one card", "cards": n, "init_s": t_init, "steps": steps,
               "all_hit_batch_of_32_s": all_hit,
               "all_hit_batch_of_32_s_by_ring_plan": by_plan, "stages": engine.timer.summary(),
               "peak_memory_gb": [torch.cuda.max_memory_allocated(c) / 1e9 for c in cards],
               "position_weight_bytes": engine.position_weight_bytes}
        emit("serve_mesh_cards", **rec)
        require(steps["c_64_hits"]["misses"] == 0 and steps["c_64_hits"]["hits"] == 64,
                f"serve_mesh_cards {rec['layout']}: the repeated 64 requests did not hit: "
                f"{steps['c_64_hits']}")
        layouts[rec["layout"]] = rec
        del processor, engine, cache
        _release()
    _mesh_parity(docs, emb, make_mesh(f"{n // 2},2", devices=cards), queries[73:82])
    return layouts


# ---------------------------------------------------------------------------
# the multi-process mesh and the native host path
# ---------------------------------------------------------------------------

MULTIHOST = {"shape": [1 << 20, 1024, 32],   # corpus rows, depth, queries
             "ks": [16, 1024],   # the warp lists; the score kernel and the select
             "reps": 5, "device": "cuda"}


def _multihost_data(spec: dict, dev):
    """The seeded (N, D) f32 corpus, normalized, and (B, D) queries, made on
    `dev`: the same bits in every process on the same kind of device."""
    import torch
    from rag_serving_system_torch.ops import topk

    n, d, b = spec["shape"]
    g = torch.Generator(device=dev).manual_seed(41)
    corpus = topk.l2_normalize(torch.randn((n, d), generator=g, device=dev))
    return corpus, torch.randn((b, d), generator=g, device=dev)


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def multihost_worker(rank: int, coord: str, out_dir: str) -> int:
    """One of the two processes of the multihost phase (`chip_smoke.py
    --multihost-worker RANK COORD DIR`; DIR/spec.json holds the shapes): 2
    positions on its device of a (2, 2) mesh over both processes, its half
    of the corpus placed, and the sharded top-k at each k. Writes its scores
    and ids to DIR and prints one JSON line: its launch counts (from 0
    before each first call), the milliseconds of each call (a barrier, then
    the host clock to a synced end) and those of the host all-gather alone
    on tensors of the candidates' shape."""
    import torch
    import torch.distributed as dist
    from rag_serving_system_torch.dryrun_multihost import local_devices
    from rag_serving_system_torch.parallel import mesh as pmesh
    from rag_serving_system_torch.parallel.sharded_topk import shard_corpus, sharded_cosine_topk

    with open(os.path.join(out_dir, "spec.json"), encoding="utf-8") as f:
        spec = json.load(f)
    torch.set_num_threads(2)
    dev = local_devices(spec["device"], rank, 1)[0]
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    pmesh.initialize(coord, 2, rank, timeout_s=300)
    try:
        mesh = pmesh.make_global_mesh("2,2", [dev, dev])
        corpus, queries = _multihost_data(spec, dev)
        n = corpus.shape[0]
        shards = shard_corpus(corpus, mesh)
        del corpus
        _release()
        rec = {"rank": rank, "mesh": mesh.shape, "processes": mesh.process_count,
               "devices": [str(d) for d in mesh.devices], "owners": mesh.owners,
               "held_gb": sum(s.numel() * s.element_size() for s in shards if s is not None) / 1e9,
               "k": {}}
        for k in spec["ks"]:
            reset_launches()
            s, i = sharded_cosine_topk(shards, queries, k, mesh, valid_n=n)
            _sync(dev)
            launches = read_launches()
            torch.save({"scores": s.cpu(), "ids": i.cpu()},
                       os.path.join(out_dir, f"rank{rank}_k{k}.pt"))
            times = []
            for _ in range(spec["reps"]):
                dist.barrier()
                _sync(dev)
                t0 = time.perf_counter()
                sharded_cosine_topk(shards, queries, k, mesh, valid_n=n)
                _sync(dev)
                times.append((time.perf_counter() - t0) * 1e3)
            # the collective alone, on host tensors of the candidates' shape
            cand = torch.zeros((s.shape[0], 2 * s.shape[1]), dtype=torch.float32)
            gather_ms = []
            for _ in range(spec["reps"]):
                dist.barrier()
                t0 = time.perf_counter()
                pmesh.process_allgather(cand.T)
                pmesh.process_allgather(cand.int().T)
                gather_ms.append((time.perf_counter() - t0) * 1e3)
            rec["k"][str(k)] = {"launches": {name: c for name, c in launches.items() if c},
                                "ms": sorted(times)[len(times) // 2], "ms_all": times,
                                "allgather_ms": sorted(gather_ms)[len(gather_ms) // 2]}
        print(json.dumps({"multihost_worker": rec}), flush=True)
        return 0
    finally:
        pmesh.shutdown()


def phase_multihost(_queries=None) -> dict:
    """The sharded top-k over a (2, 2) mesh that spans two processes (both
    on cuda:0 where one card is visible, a card each where more are), at
    1,048,576 x 1024 f32 (each process holds its half, 2.1 GB, on its card),
    B = 32, k = 16 and 1024: the ids and scores of both ranks equal
    unsharded B1's on the whole corpus; each rank's B1 launches; the ms of
    the two-process call beside unsharded B1 and the one-process call over
    four shards of one card (serve_mesh's)."""
    import tempfile

    import torch
    from rag_serving_system_torch.dryrun_multihost import free_port, run_workers
    from rag_serving_system_torch.ops import topk
    from rag_serving_system_torch.parallel.mesh import make_mesh
    from rag_serving_system_torch.parallel.sharded_topk import shard_corpus, sharded_cosine_topk

    spec = MULTIHOST
    dev = torch.device(spec["device"], 0) if spec["device"] == "cuda" else torch.device("cpu")
    corpus, queries = _multihost_data(spec, dev)
    n = corpus.shape[0]
    mesh4 = make_mesh("2,2", devices=[dev] * 4)
    shards4 = shard_corpus(corpus, mesh4)
    ref, ref_ms, one_process_ms = {}, {}, {}
    for k in spec["ks"]:
        s, i = topk.cosine_topk(corpus, queries, k)
        ref[k] = (s.cpu(), i.cpu())
        ref_ms[k] = cuda_ms(lambda: topk.cosine_topk(corpus, queries, k), spec["reps"])
        one_process_ms[k] = cuda_ms(lambda: sharded_cosine_topk(
            shards4, queries, k, mesh4, valid_n=n), spec["reps"])
    del corpus, queries, shards4
    _release()
    with tempfile.TemporaryDirectory() as out_dir:
        with open(os.path.join(out_dir, "spec.json"), "w", encoding="utf-8") as f:
            json.dump(spec, f)
        coord = f"127.0.0.1:{free_port()}"
        t0 = time.perf_counter()
        results = run_workers(
            [[sys.executable, os.path.abspath(__file__), "--multihost-worker", str(rank),
              coord, out_dir] for rank in range(2)], timeout_s=400,
            env=dict(os.environ, OMP_NUM_THREADS="2"))
        wall = time.perf_counter() - t0
        ranks = []
        for rank, (rc, out) in enumerate(results):
            lines = [x for x in out.splitlines() if x.startswith('{"multihost_worker"')]
            require(rc == 0 and len(lines) == 1,
                    f"multihost: worker {rank} exited {rc}:\n{out[-3000:]}")
            ranks.append(json.loads(lines[0])["multihost_worker"])
            for k in spec["ks"]:
                got = torch.load(os.path.join(out_dir, f"rank{rank}_k{k}.pt"))
                require(torch.equal(got["ids"], ref[k][1]),
                        f"multihost: rank {rank} ids differ from unsharded B1 at k={k}: "
                        f"{(got['ids'] != ref[k][1]).nonzero().tolist()[:8]}")
                err = (got["scores"] - ref[k][0]).abs().max().item()
                require(err == 0.0, f"multihost: rank {rank} scores differ by {err} at k={k}")
    per_k = {}
    for k in spec["ks"]:
        kk = str(k)
        per_k[kk] = {"two_process_ms": [r["k"][kk]["ms"] for r in ranks],
                     "two_process_ms_all": [r["k"][kk]["ms_all"] for r in ranks],
                     "unsharded_b1_ms": ref_ms[k], "one_process_four_shards_ms": one_process_ms[k],
                     "allgather_ms": [r["k"][kk]["allgather_ms"] for r in ranks],
                     "launches_per_rank": [r["k"][kk]["launches"] for r in ranks],
                     "ids_equal_unsharded": True, "max_abs_err": 0.0}
        for r in ranks:
            require(r["k"][kk]["launches"].get("cosine_topk", 0) > 0,
                    f"multihost: rank {r['rank']} never launched B1 at k={k}")
    emit("multihost", n=n, d=spec["shape"][1], b=spec["shape"][2], mesh="2,2", processes=2,
         devices=ranks[0]["devices"], owners=ranks[0]["owners"],
         held_gb=[r["held_gb"] for r in ranks], workers_wall_s=wall, k=per_k)
    return {"cosine_topk": sum(r["k"][str(spec["ks"][0])]["launches"].get("cosine_topk", 0)
                               for r in ranks)}


def http_load(spec: dict) -> dict:
    """A client of its own process (`chip_smoke.py --http-load SPEC`, no
    torch): spec["queries"] to spec["url"] with spec["inflight"] requests in
    flight, each a connection kept alive; request i is a sync POST ?wait=30
    when i % spec["sync_every"] == 0, else an async POST, and either polls
    GET /rag/result/<id>?timeout=10 while it reads "processing". Each
    request's seconds run from its POST to its complete result."""
    import http.client
    import threading
    from urllib.parse import urlparse

    url = urlparse(spec["url"])
    queries, recs = spec["queries"], [None] * len(spec["queries"])
    nxt, lock = [0], threading.Lock()

    def one(conn, i: int) -> dict:
        sync = i % spec["sync_every"] == 0
        t0 = time.perf_counter()
        conn.request("POST", "/rag?wait=30" if sync else "/rag",
                     body=json.dumps({"query": queries[i], "k": 2}),
                     headers={"Content-Type": "application/json"})
        r = conn.getresponse()
        status, out = r.status, json.loads(r.read())
        rid, polls = out.get("request_id"), 0
        while status == 200 and out.get("status") == "processing":
            polls += 1
            conn.request("GET", f"/rag/result/{rid}?timeout=10")
            r = conn.getresponse()
            status, out = r.status, json.loads(r.read())
        result = out.get("result")
        return {"ok": status == 200 and out.get("status") == "complete"
                and isinstance(result, dict) and isinstance(result.get("result"), str),
                "status": status, "s": time.perf_counter() - t0, "sync": sync, "polls": polls,
                "body": None if status == 200 else out}

    def worker() -> None:
        conn = http.client.HTTPConnection(url.hostname, url.port, timeout=120)
        while True:
            with lock:
                i = nxt[0]
                nxt[0] += 1
            if i >= len(queries):
                conn.close()
                return
            try:
                recs[i] = one(conn, i)
            except Exception as e:  # noqa: BLE001 - recorded as a failed request
                recs[i] = {"ok": False, "error": repr(e)}
                conn.close()
                conn = http.client.HTTPConnection(url.hostname, url.port, timeout=120)

    threads = [threading.Thread(target=worker, daemon=True) for _ in range(spec["inflight"])]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    wall = time.perf_counter() - t0
    done = [r for r in recs if r is not None and r["ok"]]
    lat = sorted(r["s"] for r in done)

    def pct(p: float):
        return lat[max(0, -(-len(lat) * p // 100) - 1)] if lat else None

    return {"requests": len(queries), "answered": len(done), "inflight": spec["inflight"],
            "sync": sum(r["sync"] for r in done), "polls": sum(r["polls"] for r in done),
            "wall_s": wall, "req_per_s": len(done) / wall, "p50_s": pct(50), "p99_s": pct(99),
            "failures": [r for r in recs if r is None or not r["ok"]][:3]}


def _load_through(url: str, queries: list, inflight: int, sync_every: int) -> dict:
    """`http_load` in a process of its own (no interpreter lock shared with
    the server); every request must come back complete with a result."""
    import subprocess
    import tempfile

    with tempfile.NamedTemporaryFile("w", suffix=".json", delete=False) as f:
        json.dump({"url": url, "queries": queries, "inflight": inflight,
                   "sync_every": sync_every}, f)
    try:
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--http-load", f.name],
                             capture_output=True, text=True, timeout=700)
    finally:
        os.unlink(f.name)
    require(out.returncode == 0, f"the HTTP client exited {out.returncode}: {out.stderr[-2000:]}")
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    require(rec["answered"] == rec["requests"],
            f"{rec['requests'] - rec['answered']} of {rec['requests']} requests to {url} were "
            f"not answered with a result: {rec['failures']}")
    return rec


class _CountingTokLib:
    """A tokenizer's C library, counting its calls."""

    def __init__(self, lib):
        import threading

        self.lib, self.calls, self._lock = lib, 0, threading.Lock()

    def hashtok_encode(self, *args):
        with self._lock:
            self.calls += 1
        return self.lib.hashtok_encode(*args)


def _clear_caches(engine) -> None:
    """Empty the prefix cache and the query cache, so that a round starts
    from the same state as the one before it."""
    engine.prefix_cache.clear()
    with engine._query_cache_lock:
        engine._query_cache.clear()


def phase_serve_native_front(queries: list) -> dict:
    """The main path at full width with every default, started as `main`
    starts it (`build_app(role="all")`) with NATIVE_FRONT_PORT set: the C++
    front on that port, aiohttp on its own. 129 squad_real queries, half as
    a sync POST ?wait= and half as an async POST then polls, at 32 in flight
    from a client process, through the native front and through aiohttp in
    turns (front, aiohttp, aiohttp, front; both caches emptied before each
    round): req/s and p50 / p99 of each. Every answer is a 200 with a
    result, /stats `native_front` counts the front's requests, B1 and B2
    launch, and both hash tokenizers encode through their C library."""
    import urllib.request

    import torch
    from rag_serving_system_torch import main as main_mod
    from rag_serving_system_torch.api.endpoints import ServerThread
    from rag_serving_system_torch.api.native_front import FrontQueue
    from rag_serving_system_torch.dryrun_multihost import free_port
    from rag_serving_system_torch.models.tokenizer import HashTokenizer

    port = free_port()
    _serve_env(NATIVE_FRONT_PORT=str(port))
    t0 = time.perf_counter()
    app, processor, engine, _ = main_mod.build_app(role="all")
    t_init = time.perf_counter() - t0
    require(isinstance(processor.request_queue, FrontQueue),
            "serve_native_front: the processor does not see the front's queue")
    front = processor.request_queue._front
    server = ServerThread(app).start()
    toks = {"encoder": engine.enc_tok, "decoder": engine.dec_tok}
    counted = {}
    for name, tok in toks.items():
        require(isinstance(tok, HashTokenizer) and tok._lib is not None,
                f"serve_native_front: the {name} tokenizer has no C library: {tok!r}")
        counted[name] = tok._lib = _CountingTokLib(tok._lib)
    rounds = []
    try:
        reset_launches()
        for surface in ("native", "aiohttp", "aiohttp", "native"):
            _clear_caches(engine)
            url = f"http://127.0.0.1:{port}" if surface == "native" else server.url
            rec = _load_through(url, queries[:129], inflight=32, sync_every=2)
            rounds.append({"surface": surface, **rec})
            emit("serve_native_front_round", **rounds[-1])
        launches = read_launches()
        with urllib.request.urlopen(server.url + "/stats", timeout=30) as r:
            stats = json.loads(r.read())
    finally:
        for tok in toks.values():
            if isinstance(tok._lib, _CountingTokLib):
                tok._lib = tok._lib.lib
        server.stop()
        processor.stop(drain_timeout=10.0)
        processor.join(timeout=30)
        front.stop()
    nf = stats.get("native_front", {})
    by_surface = {s: [r for r in rounds if r["surface"] == s] for s in ("native", "aiohttp")}
    emit("serve_native_front", init_s=t_init, port=port, native_front=nf,
         requests_processed=stats.get("requests_processed"),
         tokenizer_c_calls={k: c.calls for k, c in counted.items()}, launches=launches,
         **{s: {"req_per_s": [r["req_per_s"] for r in rs], "p50_s": [r["p50_s"] for r in rs],
                "p99_s": [r["p99_s"] for r in rs]} for s, rs in by_surface.items()},
         stages=engine.timer.summary())
    n_front = sum(r["requests"] for r in by_surface["native"])
    require(nf.get("accepted") == nf.get("completed") == n_front and nf.get("rejected") == 0
            and nf.get("bad_requests") == 0 and nf.get("inflight") == 0,
            f"serve_native_front: /stats native_front does not count the {n_front} "
            f"requests: {nf}")
    for name in ("cosine_topk", "flash_attention"):
        require(launches[name] > 0, f"kernel {name} never launched in serve_native_front")
    require(all(c.calls > 0 for c in counted.values()),
            f"serve_native_front: a tokenizer never called its C library: "
            f"{ {k: c.calls for k, c in counted.items()} }")
    del app, processor, engine
    _release()
    torch.cuda.empty_cache()
    return launches


def _wait_for(what: str, ready, procs: list, timeout_s: float) -> None:
    """Poll `ready()` until it holds; fail when a process of `procs` has
    exited or `timeout_s` passes."""
    deadline = time.monotonic() + timeout_s
    while not ready():
        dead = [p.args for p in procs if p.poll() is not None]
        require(not dead, f"serve_replicas: {dead} exited while waiting for {what}")
        require(time.monotonic() < deadline, f"serve_replicas: no {what} in {timeout_s} s")
        time.sleep(0.2)


def phase_serve_replicas(queries: list) -> dict:
    """The reference's own scaling axis on a Redis the port carries: the
    port's miniredis on a free port, one ROLE=api process and two ROLE=engine
    processes (`python -m rag_serving_system_torch.main`, full width, every
    default; on one card both engines share it, else each has its own). Two
    rounds of 64 requests at once through the api's HTTP, then one engine
    stopped (SIGTERM: it drains) and two rounds of 64 other requests through
    the one left: the seconds of each round, and the rows and seconds of
    each batch an engine logged. Every request must be answered."""
    import re
    import signal
    import socket
    import subprocess
    import tempfile

    import torch
    from rag_serving_system_torch.dryrun_multihost import free_port
    from rag_serving_system_torch.native import get_miniredis_path

    cards = torch.cuda.device_count()
    redis_port, api_port = free_port(), free_port()
    _serve_env(REDIS_URL=f"redis://127.0.0.1:{redis_port}/0")
    procs, logs = [], {}

    def can_connect(port: int) -> bool:
        try:
            socket.create_connection(("127.0.0.1", port), timeout=0.2).close()
            return True
        except OSError:
            return False

    with tempfile.TemporaryDirectory() as logdir:
        def start(name: str, argv: list, **env) -> subprocess.Popen:
            logs[name] = os.path.join(logdir, f"{name}.log")
            with open(logs[name], "w") as log:
                p = subprocess.Popen(argv, cwd=ROOT, stdout=log, stderr=subprocess.STDOUT,
                                     env=dict(os.environ, **env))
            procs.append(p)
            return p

        def log_has(name: str, text: str) -> bool:
            with open(logs[name]) as f:
                return text in f.read()

        def batches(name: str) -> list:
            """(rows, seconds) of each batch the engine's processor logged."""
            with open(logs[name]) as f:
                return [(int(n), float(t)) for n, t in re.findall(
                    r"(?:generated|processed) batch of (\d+) in ([\d.]+)s", f.read())]

        def tails() -> str:
            out = []
            for name, path in logs.items():
                with open(path) as f:
                    out.append(f"--- {name} ---\n" + f.read()[-1500:])
            return "\n".join(out)

        try:
            t0 = time.perf_counter()
            start("miniredis", [get_miniredis_path(), str(redis_port)])
            _wait_for("miniredis", lambda: can_connect(redis_port), procs, 30)
            main_argv = [sys.executable, "-m", "rag_serving_system_torch.main"]
            start("api", main_argv, ROLE="api", HOST="127.0.0.1", PORT=str(api_port))
            engines = [start(f"engine{i}", main_argv, ROLE="engine",
                             **({"CUDA_VISIBLE_DEVICES": str(i)} if cards > 1 else {}))
                       for i in range(2)]
            _wait_for("api", lambda: can_connect(api_port), procs, 120)
            for i in range(2):
                _wait_for(f"engine{i}", lambda i=i: log_has(f"engine{i}", "role=engine: consuming"),
                          procs, 300)
            t_up = time.perf_counter() - t0
            url = f"http://127.0.0.1:{api_port}"
            two = [_load_through(url, queries[i:i + 64], inflight=64, sync_every=1)
                   for i in (0, 128)]
            two_batches = [batches("engine0"), batches("engine1")]
            engines[1].send_signal(signal.SIGTERM)
            rc = engines[1].wait(timeout=120)
            require(rc == 0, f"serve_replicas: the stopped engine exited {rc}")
            one = [_load_through(url, queries[i:i + 64], inflight=64, sync_every=1)
                   for i in (64, 192)]
            one_batches = batches("engine0")[len(two_batches[0]):]
            split = [sum(n for n, _ in b) for b in two_batches]
            require(sum(split) == 128 and sum(n for n, _ in one_batches) == 128,
                    f"serve_replicas: the engines' logs count {split}, then "
                    f"{one_batches} requests")
            dead = [p.args for p in procs if p is not engines[1] and p.poll() is not None]
            require(not dead, f"serve_replicas: {dead} exited while serving")
        except SmokeFailure as e:
            raise SmokeFailure(f"{e}\n{tails()}") from None
        finally:
            for p in procs:
                if p.poll() is None:
                    p.send_signal(signal.SIGTERM)
            for p in procs:
                try:
                    p.wait(timeout=60)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
    rec = {"cards": cards, "engines_share_a_card": cards < 2, "startup_s": t_up,
           "two_engines_s": [r["wall_s"] for r in two], "one_engine_s": [r["wall_s"] for r in one],
           "two_engines_requests_by_engine": split,
           "two_engines_batches": two_batches, "one_engine_batches": one_batches,
           "two_engines": two, "one_engine": one}
    emit("serve_replicas", **rec)
    return rec


def timed(phase: str, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    emit("timing", of=phase, seconds=time.perf_counter() - t0)
    return out


def main() -> int:
    if sys.argv[1:2] == ["--http-load"] and len(sys.argv) == 3:
        # a client process of serve_native_front / serve_replicas: no torch
        with open(sys.argv[2], encoding="utf-8") as f:
            print(json.dumps(http_load(json.load(f))), flush=True)
        return 0
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch is not importable: {e}", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--multihost-worker"] and len(sys.argv) == 5:
        # a worker of the multihost phase, on the device its spec names
        sys.path.insert(0, ROOT)
        return multihost_worker(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    try:
        from rag_serving_system_torch.device import resolve_device
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})",
              file=sys.stderr)
        return 1
    if not os.path.exists(os.path.join(DATA, "squad_real_embeddings.npy")):
        print(f"chip_smoke: {DATA} lacks the squad_real corpus", file=sys.stderr)
        return 1
    with open(os.path.join(DATA, "squad_real_queries.json"), encoding="utf-8") as f:
        queries = json.load(f)
    only = {"serve": phase_serve, "serve_spec": phase_serve_spec, "serve_checkpoint": phase_serve_checkpoint,
            "serve_pipeline": phase_serve_pipeline, "parity": phase_parity,
            "serve_mesh": phase_serve_mesh, "serve_mesh_cards": phase_serve_mesh_cards,
            "train": phase_train, "multihost": phase_multihost,
            "serve_native_front": phase_serve_native_front,
            "serve_replicas": phase_serve_replicas,
            "attention": lambda _queries: check_attention(resolve_device("cuda"))}
    if sys.argv[1:] in (["--stage-split"], ["--crossover"]) or (
            sys.argv[1:2] == ["--phases"] and len(sys.argv) == 3
            and set(sys.argv[2].split(",")) <= set(only)):
        smi = phase_device()
        phase_build()
        try:
            if sys.argv[1] == "--stage-split":
                phase_stage_split(queries)
            elif sys.argv[1] == "--crossover":
                for seed in (9, 10):
                    _crossover(resolve_device("cuda"), seed)
            else:
                for name in sys.argv[2].split(","):
                    timed(name, only[name], queries)
        except SmokeFailure as e:
            print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
            return 1
        print(smi, flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0
    try:
        t_start = time.perf_counter()
        dev = resolve_device("cuda")
        smi = phase_device()
        timed("build", phase_build)
        records = timed("kernels", phase_kernels, dev)
        launches = {"roofline": timed("roofline", phase_roofline)}
        launches["serve"], bf16_splits = timed("serve", phase_serve, queries)
        launches["serve_cold"] = timed("serve_cold", phase_serve_cold, queries)
        timed("parity", phase_parity, queries)
        launches["serve_int8"] = timed("serve_int8", phase_serve_int8, queries[74:107])
        timed("serve_ivf", phase_serve_ivf, queries[107:139])
        launches["serve_wide_k"] = timed("serve_wide_k", phase_serve_wide_k, queries[139:147])
        launches["serve_quant"] = timed("serve_quant", phase_serve_quant, queries, bf16_splits)
        launches["serve_continuous"], launches["serve_continuous_packed"] = timed(
            "serve_continuous", phase_serve_continuous, queries)
        launches["serve_tiny"] = timed("serve_tiny", phase_serve_tiny, 16)
        launches["serve_tiny_d32"] = timed("serve_tiny_d32", phase_serve_tiny, 32)
        launches["serve_spec"], launches["serve_spec_cold"] = timed(
            "serve_spec", phase_serve_spec, queries)
        launches["serve_checkpoint"] = timed("serve_checkpoint", phase_serve_checkpoint,
                                             queries)
        launches["serve_pipeline"] = timed("serve_pipeline", phase_serve_pipeline, queries)
        launches["serve_mesh"] = timed("serve_mesh", phase_serve_mesh, queries)
        launches["train"] = timed("train", phase_train, queries)
        launches["multihost"] = timed("multihost", phase_multihost, queries)
        launches["serve_native_front"] = timed("serve_native_front", phase_serve_native_front,
                                               queries)
        timed("serve_replicas", phase_serve_replicas, queries)
        emit("timing", of="all", seconds=time.perf_counter() - t_start)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    summary = []
    for name, (source, replaces, path) in KERNELS.items():
        r = records[name]
        summary.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[path][wrapper_of(name)],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    print(smi, flush=True)
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
