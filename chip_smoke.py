#!/usr/bin/env python3
"""Drive the PyTorch port's main RAG path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each; any failure exits non-zero:

1. device  - the card (torch and nvidia-smi).
2. build   - nvcc builds the kernels in rag_serving_system_torch/csrc/.
3. kernels - each kernel against its plain PyTorch version at main-path
             shapes, with CUDA-event times of both.
4. serve   - the port's engine at full width (e5-large + Qwen2.5-1.5B, random
             weights from a seed, bf16, PREFIX_CACHE=0, other settings at
             their defaults) behind the queue and batch processor: one lone
             request (padded prefill), then 64 at once (packed prefill). Every
             kernel on the path must have launched during this phase, and
             every request must come back as {"result": str}.
5. parity  - a full-width f32 greedy engine answers a lone request and a
             batch of 8 identically through the kernels and through their
             plain versions.

Then the nvidia-smi name and power limit, the kernels' summary line, and
the last line {"ok": true, "device": {...}}. Needs a CUDA device; exits 1
without one, and when run outside a checkout of the repository.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(ROOT, "data")

# (wrapper, source, TPU kernel it replaces)
KERNELS = {
    "cosine_topk": ("rag_serving_system_torch/csrc/topk.cu",
                    "rag_serving_system_tpu/ops/topk.py:93"),
    "flash_attention": ("rag_serving_system_torch/csrc/flash_attention.cu",
                        "rag_serving_system_tpu/ops/attention.py:42"),
    "flash_attention_packed": ("rag_serving_system_torch/csrc/flash_attention.cu",
                               "rag_serving_system_tpu/ops/attention.py:100"),
}


class SmokeFailure(Exception):
    pass


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() over reps launches, after two warm-up calls."""
    import torch

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


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    line = smi.stdout.strip().splitlines()[0]
    emit("device", torch=torch.__version__, cuda=torch.version.cuda,
         name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         nvidia_smi=line)
    return line


def phase_build():
    from rag_serving_system_torch.ops import _build

    t0 = time.perf_counter()
    _build.library()
    emit("build", seconds=time.perf_counter() - t0, nvcc_seconds=_build.build_seconds)


def _check_topk(dev, n, b, k, seed):
    import torch
    from rag_serving_system_torch.ops import topk

    g = torch.Generator(device=dev).manual_seed(seed)
    corpus = topk.l2_normalize(torch.randn((n, 1024), generator=g, device=dev))
    queries = torch.randn((b, 1024), generator=g, device=dev)
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
    ms = cuda_ms(lambda: topk.cosine_topk(corpus, queries, k), 20)
    plain_ms = cuda_ms(lambda: topk.cosine_topk_reference(corpus, queries, k), 5)
    return {"n": n, "b": b, "k": k, "max_abs_err": err, "near_tie_swaps": n_swapped,
            "ms": ms, "plain_ms": plain_ms}


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


def phase_kernels(dev) -> dict:
    """Each kernel against its plain version. Returns the main-path record of
    each (f32 retrieval at 1M docs; bf16 attention)."""
    import torch

    out = {}
    for n in (1_000_000, 1000):  # the exact regime's scale; the served corpus
        r = _check_topk(dev, n, 32, 16, seed=0)
        emit("kernel", name="cosine_topk", **r)
        out.setdefault("cosine_topk", r)
    for dtype, tol in ((torch.bfloat16, 2e-2), (torch.float32, 2e-4)):
        r = _check_flash(dev, dtype, tol, seed=1)
        emit("kernel", name="flash_attention", **r)
        out.setdefault("flash_attention", r)
        r = _check_flash_packed(dev, dtype, tol, seed=2)
        emit("kernel", name="flash_attention_packed", **r)
        out.setdefault("flash_attention_packed", r)
    torch.cuda.empty_cache()
    return out


def phase_serve(queries: list) -> dict:
    """The full-width engine behind the queue and the batch processor.
    Returns each kernel's launch count over the served requests."""
    import torch
    from rag_serving_system_torch.main import build_processor
    from rag_serving_system_torch.ops import attention, topk

    os.environ.update({
        "PREFIX_CACHE": "0",
        "MODEL_PRESET": "full",
        "TORCH_DEVICE": "cuda",
        "DOCUMENT_TEXT_FILE": os.path.join(DATA, "squad_real_contexts.json"),
        "DOCUMENT_EMBEDDINGS_FILE": os.path.join(DATA, "squad_real_embeddings.npy"),
    })
    t0 = time.perf_counter()
    processor, engine, request_queue, _ = build_processor()
    torch.cuda.synchronize()
    t_init = time.perf_counter() - t0
    wrappers = {"cosine_topk": topk.cosine_topk,
                "flash_attention": attention.flash_attention,
                "flash_attention_packed": attention.flash_attention_packed}
    for w in wrappers.values():
        w.launches = 0
    processor.start()
    try:
        t0 = time.perf_counter()
        lone = request_queue.add_request(queries[0], 2)
        results = [request_queue.get_result(lone, timeout=300)]
        t_lone = time.perf_counter() - t0
        t0 = time.perf_counter()
        ids = [request_queue.add_request(q, 2) for q in queries[1:65]]
        results += [request_queue.get_result(i, timeout=300) for i in ids]
        t_batch = time.perf_counter() - t0
    finally:
        processor.stop(drain_timeout=10.0)
        processor.join(timeout=30)
    launches = {name: w.launches for name, w in wrappers.items()}
    answered = sum(isinstance(r, dict) and isinstance(r.get("result"), str)
                   for r in results)
    emit("serve", init_s=t_init, lone_request_s=t_lone, batch_of_64_s=t_batch,
         requests=len(results), answered=answered, launches=launches,
         batches=processor.batches_processed, stages=engine.timer.summary(),
         sample_answer=results[0])
    require(answered == len(results) == 65,
            f"{answered}/{len(results)} of 65 requests came back as "
            f"{{'result': str}}: {[r for r in results if not isinstance(r, dict) or 'result' not in r][:3]}")
    for name, n in launches.items():
        require(n > 0, f"kernel {name} never launched while serving")
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

    os.environ.update({"COMPUTE_DTYPE": "float32", "DO_SAMPLE": "0",
                       "QUERY_CACHE_SIZE": "0"})
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
        dev = resolve_device("cuda")
        smi = phase_device()
        phase_build()
        records = phase_kernels(dev)
        launches = phase_serve(queries)
        phase_parity(queries)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    summary = []
    for name, (source, replaces) in KERNELS.items():
        r = records[name]
        summary.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": launches[name],
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
