"""Retrieval roofline probes: kernels P1 (stream) and P2 (dot), each beside
its plain PyTorch version.

Port of `scripts/profile_topk.py` (`_stream_kernel`, `_dot_kernel`). Each
probe runs one half of the top-k kernels' work over the same rows, so their
times split a top-k kernel's time into a streaming part and an arithmetic
part (`rag_serving_system_torch/profile_topk.py`).

`stream_probe` and `dot_probe` are the kernels' wrappers: CPU tensors take
the plain versions; CUDA tensors launch `csrc/probes.cu` or raise.
"""

from __future__ import annotations

import torch

from rag_serving_system_torch.ops import _build
from rag_serving_system_torch.ops.topk import INT8_MAX_D, float_grid, int8_grid

LANES = 128  # P2 folds corpus row n into output lane n % 128
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def stream_probe_plain(corpus: torch.Tensor, block_n: int) -> torch.Tensor:
    """(1, D) f32: the sum over whole blocks of block_n rows of each block's
    column max; the tail N % block_n rows are dropped."""
    n, d = corpus.shape
    nb = n // block_n
    return corpus[:nb * block_n].view(nb, block_n, d).amax(1).float().sum(0, keepdim=True)


def _probe_queries(corpus, queries, highest):
    """Queries as both versions multiply them: int8 for an int8 corpus; a
    bf16 corpus, or highest=False on an f32 one, meets bf16-rounded queries.
    highest=False also rounds an f32 corpus to bf16: the TPU's one-pass
    Precision.DEFAULT."""
    if corpus.dtype == torch.int8:
        return queries
    if corpus.dtype == torch.bfloat16 or not highest:
        return queries.to(torch.bfloat16).float()
    return queries.float()


def dot_probe_plain(corpus: torch.Tensor, queries: torch.Tensor, block_n: int,
                    highest: bool = True) -> torch.Tensor:
    """(B, 128) f32: out[b, l] = sum over rows n < (N // block_n) * block_n
    with n % 128 == l of q[b] . c[n]. An int8 corpus takes int8 queries
    (exact int32 dots while D * 127^2 < 2^24)."""
    n, d = corpus.shape
    rows = n // block_n * block_n
    c = corpus[:rows].float()
    if corpus.dtype == torch.float32 and not highest:
        c = c.to(torch.bfloat16).float()
    s = _probe_queries(corpus, queries, highest).float() @ c.T    # (B, rows)
    return s.view(s.shape[0], rows // LANES, LANES).sum(1)


def _check(name, corpus, block_n):
    if corpus.device.type != "cuda":
        raise ValueError(f"{name}: corpus on {corpus.device}; needs a CUDA device")
    if corpus.dtype not in _DTYPE_CODE or corpus.dim() != 2:
        raise ValueError(f"{name}: corpus must be (N, D) f32, bf16 or int8, got "
                         f"{corpus.dtype} {tuple(corpus.shape)}")
    n, d = corpus.shape
    if (d * corpus.element_size()) % 16 or block_n < 1 or n < block_n:
        raise ValueError(f"{name}: needs D * itemsize % 16 == 0 and "
                         f"1 <= block_n <= N; got D={d}, block_n={block_n}, N={n}")
    if not corpus.is_contiguous() or corpus.data_ptr() % 16:
        raise ValueError(f"{name}: the corpus must be contiguous and 16-byte aligned")


def stream_probe(corpus: torch.Tensor, block_n: int = 2048) -> torch.Tensor:
    """Kernel P1: the corpus streamed once, per-block column max, summed."""
    if corpus.device.type == "cpu":
        return stream_probe_plain(corpus, block_n)
    _check("stream_probe", corpus, block_n)
    n, d = corpus.shape
    dev = corpus.device
    partial = torch.empty((n // block_n, d), dtype=torch.float32, device=dev)
    out = torch.empty((1, d), dtype=torch.float32, device=dev)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.rag_stream_probe(corpus.data_ptr(), _DTYPE_CODE[corpus.dtype], n, d,
                                   block_n, partial.data_ptr(), out.data_ptr(),
                                   torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "rag_stream_probe")
    _build.count_launch(stream_probe)
    return out


stream_probe.launches = 0


def dot_probe(corpus: torch.Tensor, queries: torch.Tensor, block_n: int = 2048,
              highest: bool = True) -> torch.Tensor:
    """Kernel P2: the top-k kernels' score arithmetic without the selection,
    folded to (B, 128). block_n must be a multiple of 128."""
    if corpus.device.type == "cpu" and queries.device.type == "cpu":
        return dot_probe_plain(corpus, queries, block_n, highest)
    _check("dot_probe", corpus, block_n)
    n, d = corpus.shape
    dev = corpus.device
    want = torch.int8 if corpus.dtype == torch.int8 else torch.float32
    if (queries.device != dev or queries.dim() != 2 or queries.shape[1] != d
            or queries.shape[0] < 1 or queries.dtype != want):
        raise ValueError(f"dot_probe: queries {queries.dtype} "
                         f"{tuple(queries.shape)} on {queries.device} vs corpus "
                         f"{corpus.dtype} {tuple(corpus.shape)} on {dev}; "
                         f"queries must be {want}")
    if block_n % LANES:
        raise ValueError(f"dot_probe: block_n={block_n} is not a multiple of {LANES}")
    if corpus.dtype == torch.int8 and d > INT8_MAX_D:
        raise ValueError(f"dot_probe: an int8 corpus needs D <= {INT8_MAX_D}, got {d}")
    q = _probe_queries(corpus, queries, highest).contiguous()
    b = q.shape[0]
    rows = n // block_n * block_n
    if corpus.dtype == torch.int8:
        tiles_per_cta, n_ctas = int8_grid("dot", rows, b, d, dev)
    else:
        tiles_per_cta, n_ctas = float_grid(rows, b, dev)
    partial = torch.empty((n_ctas, b, LANES), dtype=torch.float32, device=dev)
    out = torch.empty((b, LANES), dtype=torch.float32, device=dev)
    round_bf16 = int(corpus.dtype == torch.float32 and not highest)
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.rag_dot_probe(q.data_ptr(), corpus.data_ptr(), _DTYPE_CODE[corpus.dtype],
                                round_bf16, b, rows, d, tiles_per_cta, n_ctas,
                                partial.data_ptr(), out.data_ptr(),
                                torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "rag_dot_probe")
    _build.count_launch(dot_probe)
    return out


dot_probe.launches = 0


def abs_terms(corpus: torch.Tensor, queries: torch.Tensor | None, block_n: int,
              highest: bool = True) -> torch.Tensor:
    """The sum of the absolute values of the terms each probe output sums:
    what a change of summation order can move it by scales with this, not
    with the output, which cancels. Shaped like the probe's output."""
    if queries is None:  # P1's terms are the block maxima
        n, d = corpus.shape
        nb = n // block_n
        return corpus[:nb * block_n].view(nb, block_n, d).amax(1).float().abs().sum(
            0, keepdim=True)
    q = _probe_queries(corpus, queries, highest).float().abs()
    c = corpus.float()
    if corpus.dtype == torch.float32 and not highest:
        c = c.to(torch.bfloat16).float()
    return dot_probe_plain(c.abs(), q, block_n)
