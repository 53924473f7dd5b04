#!/usr/bin/env python3
"""Drive the PyTorch port's main RAG path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each (with its seconds); any failure exits non-zero:

1. device     - the card (torch and nvidia-smi).
2. build      - nvcc builds the kernels in rag_serving_system_torch/csrc/.
3. kernels    - each kernel against its plain PyTorch version at main-path
                shapes, with CUDA-event times of both: B1 at 1M rows (f32
                and bf16 corpus, k = 16, 64, 256) and 1000 rows, B2, B3, B4
                at 1M rows (k = 16, 64, 256) and chunked over 10M rows
                (10.24 GB of int8 on the card), P1 and P2 at 1M rows.
4. roofline   - profile_topk's 1M-row rows: P1 (stream), P2 (dot) and the
                top-k kernel (full) for f32, bf16 and int8 corpora.
5. serve      - the port's engine at full width (e5-large + Qwen2.5-1.5B,
                random weights from a seed, bf16, PREFIX_CACHE=0, other
                settings at their defaults) behind the queue and batch
                processor: one lone request (padded prefill), then 64 at
                once (packed prefill).
6. parity     - a full-width f32 greedy engine answers a lone request and a
                batch of 8 identically through the kernels and through
                their plain versions.
7. serve_int8 - RETRIEVAL_CORPUS_DTYPE=int8 over 1,048,576 rows in 4 chunks
                of 262,144 (squad_real rows and seeded noisy copies): a lone
                request, then 32 at once; the retrieved ids equal the plain
                version's.
8. serve_ivf  - RETRIEVER=ivf over a seeded clustered corpus (65,536 rows,
                256 centres) through its startup recall gate; 32 requests.

Each path phase (roofline, serve, serve_int8, serve_ivf) sets every launch
count to 0 just before it and reads the counts just after; each kernel of
the path must have launched, and every request must come back as
{"result": str}. Then the nvidia-smi name and power limit, the kernels'
summary line, and the last line {"ok": true, "device": {...}}. Needs a CUDA
device; exits 1 without one, and when run outside a checkout of the
repository.
"""

from __future__ import annotations

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
    "flash_attention_packed": ("rag_serving_system_torch/csrc/flash_attention.cu",
                               "rag_serving_system_tpu/ops/attention.py:100", "serve"),
    "cosine_topk_int8": ("rag_serving_system_torch/csrc/topk_int8.cu",
                         "rag_serving_system_tpu/ops/topk.py:189", "serve_int8"),
    "stream_probe": ("rag_serving_system_torch/csrc/probes.cu",
                     "scripts/profile_topk.py:36", "roofline"),
    "dot_probe": ("rag_serving_system_torch/csrc/probes.cu",
                  "scripts/profile_topk.py:51", "roofline"),
}
SERVE_ENV = {"PREFIX_CACHE": "0", "MODEL_PRESET": "full", "TORCH_DEVICE": "cuda"}
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
            "dot_probe": probes.dot_probe}


def reset_launches() -> None:
    for w in wrappers().values():
        w.launches = 0


def read_launches() -> dict:
    return {name: w.launches for name, w in wrappers().items()}


def require_launched(phase: str, launches: dict) -> None:
    for name, (_, _, path) in KERNELS.items():
        if path == phase:
            require(launches[name] > 0, f"kernel {name} never launched in {phase}")


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
    return {"n": corpus.shape[0], "b": queries.shape[0], "k": k, "corpus": str(corpus.dtype),
            "max_abs_err": err, "near_tie_swaps": n_swapped, "ms": ms, "plain_ms": plain_ms}


def _seeded_qkv(dev, shape_q, shape_kv, dtype, seed):
    import torch

    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn(s, generator=g, device=dev).to(dtype)
            for s in (shape_q, shape_kv, shape_kv)]


def _check_flash(dev, dtype, tol, seed):
    import numpy as np
    import torch
    from rag_serving_system_torch.ops import attention as att

    b, s, hq, hk, d = 32, 512, 12, 2, 128
    q, k, v = _seeded_qkv(dev, (b, s, hq, d), (b, s, hk, d), dtype, seed)
    rng = np.random.default_rng(seed)
    pads = rng.integers(0, s, size=b)
    pads[-1] = s                      # one row with every key masked
    mask = torch.as_tensor((np.arange(s)[None, :] >= pads[:, None]).astype(np.int32),
                           device=dev)
    out = att.flash_attention(q, k, v, mask)
    ref = att.flash_attention_plain(q, k, v, mask)
    real = mask.bool()
    err = (out.float() - ref.float())[real].abs().max().item()
    require(err <= tol, f"flash_attention {dtype} differs by {err} > {tol}")
    require(not out[~real].any().item(),
            "flash_attention: fully masked rows are not 0")
    ms = cuda_ms(lambda: att.flash_attention(q, k, v, mask), 10)
    plain_ms = cuda_ms(lambda: att.flash_attention_plain(q, k, v, mask), 3)
    return {"shape": [b, s, hq, hk, d], "dtype": str(dtype), "max_abs_err": err,
            "tol": tol, "ms": ms, "plain_ms": plain_ms}


def packed_lengths(seed: int, n_seg: int = 32, t: int = 8192) -> list:
    """n_seg seeded segment lengths in [64, 512] that leave a pad tail in t
    (skewed toward short rows, as retrieved prompts are)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    while True:
        lens = (64 + np.floor(448 * rng.random(n_seg) ** 2)).astype(int)
        if lens.sum() < t:
            return lens.tolist()


def _check_flash_packed(dev, dtype, tol, seed):
    import numpy as np
    import torch
    from rag_serving_system_torch.ops import attention as att

    t, hq, hk, d = 8192, 12, 2, 128
    lens = packed_lengths(seed)
    n_real = sum(lens)
    seg_np = np.full(t, len(lens), np.int32)   # pad tail: id = number of rows
    seg_np[:n_real] = np.repeat(np.arange(len(lens)), lens)
    seg = torch.as_tensor(seg_np[None], device=dev)
    q, k, v = _seeded_qkv(dev, (1, t, hq, d), (1, t, hk, d), dtype, seed)
    out = att.flash_attention_packed(q, k, v, seg)
    ref = att.flash_attention_packed_plain(q, k, v, seg)
    err = (out.float() - ref.float())[0, :n_real].abs().max().item()
    require(err <= tol, f"flash_attention_packed {dtype} differs by {err} > {tol}")
    ms = cuda_ms(lambda: att.flash_attention_packed(q, k, v, seg), 10)
    plain_ms = cuda_ms(lambda: att.flash_attention_packed_plain(q, k, v, seg), 3)
    return {"t": t, "segments": len(lens), "real_tokens": n_real,
            "sum_len_sq": int(sum(x * x for x in lens)), "dtype": str(dtype),
            "max_abs_err": err, "tol": tol, "ms": ms, "plain_ms": plain_ms}


def _check_topk_int8(dev, seed):
    """B4 at 1M rows (k = 16, 64, 256), then chunked over 10M: indices
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
           "ms": ms, "plain_ms": plain_ms}
    wide = []
    for kw in (64, 256):
        s_k, i_k = topk.cosine_topk_int8(corpus, scales, queries, kw, corpus_mean=mean)
        s_p, i_p = topk.cosine_topk_int8_reference(corpus, scales, queries, kw,
                                                   corpus_mean=mean)
        torch.cuda.synchronize()
        require(torch.equal(i_k, i_p), f"cosine_topk_int8 indices differ at k={kw}")
        require(torch.equal(s_k, s_p), f"cosine_topk_int8 scores at k={kw} are not "
                "bit-identical")
        wide.append({"n": n, "b": b, "k": kw, "max_abs_err": (s_k - s_p).abs().max().item(),
                     "ms": cuda_ms(lambda: topk.cosine_topk_int8(
                         corpus, scales, queries, kw, corpus_mean=mean), 5),
                     "plain_ms": cuda_ms(lambda: topk.cosine_topk_int8_reference(
                         corpus, scales, queries, kw, corpus_mean=mean), 2)})
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
           "plain_ms": plain_ms}
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
        records.append({"name": "stream_probe", "corpus": name, "n": n, "block_n": block_n,
                        "max_abs_err": err.max().item(), "tol": tol.min().item(),
                        "ms": cuda_ms(lambda: probes.stream_probe(corpus, block_n), 20),
                        "plain_ms": cuda_ms(lambda: probes.stream_probe_plain(corpus, block_n), 3)})
        for highest in ((True, False) if name == "f32" else (True,)):
            out = probes.dot_probe(corpus, q, block_n, highest)
            ref = probes.dot_probe_plain(corpus, q, block_n, highest)
            tol = 32 * 2.0 ** -24 * probes.abs_terms(corpus, q, block_n, highest)
            err = (out - ref).abs()
            require(bool((err <= tol).all()), f"dot_probe {name} highest={highest} "
                    f"differs beyond its summation-order bound: {err.max().item()}")
            records.append({
                "name": "dot_probe", "corpus": name, "highest": highest, "n": n, "b": b,
                "max_abs_err": err.max().item(), "tol": tol.min().item(),
                "ms": cuda_ms(lambda: probes.dot_probe(corpus, q, block_n, highest), 20),
                "plain_ms": cuda_ms(lambda: probes.dot_probe_plain(corpus, q, block_n,
                                                                   highest), 3)})
    del base, c8
    torch.cuda.empty_cache()
    return records


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
            for k in ((16, 64, 256) if n > 1000 else (16,)):
                r = _check_topk(c, queries, k, reps=20 if k == 16 else 5)
                emit("kernel", name="cosine_topk", **r)
                out.setdefault("cosine_topk", r)
            del c
        del corpus
        torch.cuda.empty_cache()
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 2e-4)):
        r = _check_flash(dev, dtype, tol, seed=1)
        emit("kernel", name="flash_attention", **r)
        out.setdefault("flash_attention", r)
        r = _check_flash_packed(dev, dtype, tol, seed=2)
        emit("kernel", name="flash_attention_packed", **r)
        out.setdefault("flash_attention_packed", r)
    torch.cuda.empty_cache()
    one, wide, ten = _check_topk_int8(dev, seed=3)
    for r in (one, *wide):
        emit("kernel", name="cosine_topk_int8", **r)
    emit("kernel", name="cosine_topk_int8_chunked", **ten)
    out["cosine_topk_int8"] = one
    for r in _check_probes(dev, seed=5):
        emit("kernel", **r)
        out.setdefault(r["name"], r)
    return out


def phase_roofline() -> None:
    """profile_topk's 1M-row decomposition: the path that runs P1 and P2."""
    from rag_serving_system_torch.profile_topk import roofline

    reset_launches()
    roofline(1 << 20, ("fp", "int8"), emit=lambda line: emit("roofline", **json.loads(line)))
    launches = read_launches()
    require_launched("roofline", launches)
    return launches


def _drive(processor, request_queue, queries: list, n_batch: int) -> dict:
    """One lone request, then n_batch at once, through the running
    processor; returns the results and their wall times."""
    processor.start()
    try:
        t0 = time.perf_counter()
        lone = request_queue.add_request(queries[0], 2)
        results = [request_queue.get_result(lone, timeout=300)]
        t_lone = time.perf_counter() - t0
        t0 = time.perf_counter()
        ids = [request_queue.add_request(q, 2) for q in queries[1:1 + n_batch]]
        results += [request_queue.get_result(i, timeout=300) for i in ids]
        t_batch = time.perf_counter() - t0
    finally:
        processor.stop(drain_timeout=10.0)
        processor.join(timeout=30)
    answered = sum(isinstance(r, dict) and isinstance(r.get("result"), str)
                   for r in results)
    require(answered == len(results) == n_batch + 1,
            f"{answered}/{len(results)} of {n_batch + 1} requests came back as "
            f"{{'result': str}}: {[r for r in results if not isinstance(r, dict) or 'result' not in r][:3]}")
    return {"lone_request_s": t_lone, f"batch_of_{n_batch}_s": t_batch,
            "requests": len(results), "answered": answered,
            "sample_answer": results[0]}


def phase_serve(queries: list) -> dict:
    """The full-width engine behind the queue and the batch processor.
    Returns each kernel's launch count over the served requests."""
    import torch
    from rag_serving_system_torch.main import build_processor

    set_env(DOCUMENT_TEXT_FILE=os.path.join(DATA, "squad_real_contexts.json"),
            DOCUMENT_EMBEDDINGS_FILE=os.path.join(DATA, "squad_real_embeddings.npy"))
    t0 = time.perf_counter()
    processor, engine, request_queue, _ = build_processor()
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    reset_launches()
    r = _drive(processor, request_queue, queries[:65], 64)
    launches = read_launches()
    emit("serve", init_s=t_init, **r, launches=launches,
         batches=processor.batches_processed, stages=engine.timer.summary())
    require_launched("serve", launches)
    del processor, engine
    torch.cuda.empty_cache()
    return launches


def phase_parity(queries: list) -> None:
    """End to end on a small input: a full-width f32 engine, greedy, answers
    through the kernels exactly as with each kernel's plain version swapped
    in; a lone request (padded prefill) and a batch of 8 (packed)."""
    from unittest import mock

    import torch
    from rag_serving_system_torch.core import engine as engine_mod
    from rag_serving_system_torch.main import build_processor
    from rag_serving_system_torch.models import qwen2
    from rag_serving_system_torch.ops import attention, topk

    set_env(DOCUMENT_TEXT_FILE=os.path.join(DATA, "squad_real_contexts.json"),
            DOCUMENT_EMBEDDINGS_FILE=os.path.join(DATA, "squad_real_embeddings.npy"),
            COMPUTE_DTYPE="float32", DO_SAMPLE="0", QUERY_CACHE_SIZE="0")
    _, engine, _, _ = build_processor()
    cases = {"lone": queries[65:66], "batch_of_8": queries[66:74]}
    routes = {name: engine.stage_prompts(engine.prepare(qs, [2] * len(qs)))[0]
              for name, qs in cases.items()}
    require(routes == {"lone": "padded", "batch_of_8": "packed"},
            f"parity inputs took routes {routes}")

    def run():
        return {name: (engine.embed_and_retrieve(qs, [2] * len(qs)),
                       engine.process(qs, [2] * len(qs)))
                for name, qs in cases.items()}

    with_kernels = run()
    with mock.patch.object(engine_mod, "cosine_topk", topk.cosine_topk_reference), \
            mock.patch.object(qwen2, "flash_attention", attention.flash_attention_plain), \
            mock.patch.object(qwen2, "flash_attention_packed",
                              attention.flash_attention_packed_plain):
        plain = run()
    same = {name: with_kernels[name] == plain[name] for name in cases}
    emit("parity", dtype="float32", routes=routes, identical=same,
         answer=with_kernels["lone"][1][0])
    require(all(same.values()), f"kernel and plain runs differ: {same}")
    del engine
    torch.cuda.empty_cache()


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


def timed(phase: str, fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    emit("timing", of=phase, seconds=time.perf_counter() - t0)
    return out


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: torch is not importable: {e}", file=sys.stderr)
        return 1
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
    try:
        t_start = time.perf_counter()
        dev = resolve_device("cuda")
        smi = phase_device()
        timed("build", phase_build)
        records = timed("kernels", phase_kernels, dev)
        launches = {"roofline": timed("roofline", phase_roofline),
                    "serve": timed("serve", phase_serve, queries)}
        timed("parity", phase_parity, queries)
        launches["serve_int8"] = timed("serve_int8", phase_serve_int8, queries[74:107])
        timed("serve_ivf", phase_serve_ivf, queries[107:139])
        emit("timing", of="all", seconds=time.perf_counter() - t_start)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    summary = []
    for name, (source, replaces, path) in KERNELS.items():
        r = records[name]
        summary.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[path][name],
                        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                        "plain_ms": r["plain_ms"]})
    print(smi, flush=True)
    print(json.dumps({"kernels": summary}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
