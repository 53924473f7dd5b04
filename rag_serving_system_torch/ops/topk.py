"""Exact cosine top-k retrieval: kernels B1 (f32 / bf16 corpus) and B4
(int8 corpus), each beside its plain PyTorch version.

Port of `rag_serving_system_tpu/ops/topk.py` (`_l2_normalize`,
`cosine_topk_reference`, `cosine_topk_pallas`, the int8 quantizers,
`cosine_topk_pallas_int8` and `cosine_topk_int8_chunked`). The corpus is
expected pre-normalized; queries are normalized here. Equal scores rank the
lower corpus index first, as `lax.top_k` does.

`cosine_topk` and `cosine_topk_int8` are the kernels' wrappers: a CPU
tensor takes the plain version (`cosine_topk_reference`,
`cosine_topk_int8_reference`); a CUDA tensor launches `csrc/topk.cu` or
`csrc/topk_int8.cu`, or raises. Any k <= N is served, as by the JAX engine:
up to LIST_K[corpus dtype] the kernels keep each query's running list in a
warp's registers; beyond it they write the scores of chunks of rows, and
`select_topk` (`csrc/select.cu`: two reads of the scores, a select over the
candidates, a bitonic sort) ranks them, with no `torch.topk` or
`torch.sort` on the card.
"""

from __future__ import annotations

import ctypes
import functools
import logging
import math
from typing import NamedTuple

import numpy as np
import torch

from rag_serving_system_torch.ops import _build

logger = logging.getLogger(__name__)

# The largest k each corpus dtype keeps in the warp lists, which hold
# LIST_MAX (one register of a warp's 32 lanes); beyond it the score kernel
# and select_topk. Each is the largest k at which the lists beat the scores
# and the select on the card (chip_smoke.py --crossover; PERF.md): bf16 ties
# at k = 16 over 1M rows and loses from 32 on.
LIST_MAX = 32
LIST_K = {torch.float32: 32, torch.bfloat16: 16, torch.int8: 32}
# beyond LIST_K: (B, rows) f32 scores are written and selected this many
# bytes at a time (512 MB: 4,194,304 rows at B = 32)
SCORE_CHUNK_BYTES = 1 << 29
# corpus rows per tile of the float score tile in csrc/topk_common.cuh
# (FT_ROWS); one CTA an SM, as its ring fills an SM's shared memory
FLOAT_ROWS = 512
INT8_ROWS = 128   # corpus rows per tile of the int8 score tile (NT)
INT8_MAX_D = 4096  # its (32, D) query block stays in shared memory
SELECT_BINS = 4096    # level 0's bins in csrc/select.cu (the key's top 12 bits)
SELECT_TILE = 8192    # scores a CTA of the select's full-row passes reads at once
SELECT_CAND_CAP = 65_536  # candidates a row may stop its digit search at
# the kernels read rows in 16-byte pieces; a multiple of 16 columns gives
# that for every corpus dtype
DEPTH_ALIGN = 16
_PLAIN_ROWS = 262_144  # row block of the plain int8 scan (bounds its scratch)


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    xf = x.float()
    n = torch.sqrt(torch.sum(xf * xf, dim=-1, keepdim=True))
    return (x / torch.clamp(n, min=eps)).to(x.dtype)


def pad_depth(x):
    """x (..., D), a tensor or a numpy array, with zero columns appended up
    to the next multiple of DEPTH_ALIGN. Zero columns change no dot product
    and no norm, so corpus and queries padded alike score as before. A
    holder of a corpus pads it once at set-up and its queries per call."""
    extra = -x.shape[-1] % DEPTH_ALIGN
    if not extra:
        return x
    if isinstance(x, np.ndarray):
        return np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, extra)])
    return torch.nn.functional.pad(x, (0, extra))


@functools.cache
def _warn_unpadded_corpus(name: str, d: int) -> None:
    logger.warning("%s: a corpus of depth %d is copied with zero columns on every "
                   "call; pad it once with pad_depth where it is set up", name, d)


def _kernel_queries(corpus: torch.Tensor, queries: torch.Tensor,
                    normalize: bool) -> torch.Tensor:
    """f32 queries as both versions score them. As on the TPU, a bf16 corpus
    meets bf16-rounded queries, so each product is exact in f32."""
    q = (l2_normalize(queries) if normalize else queries).float()
    if corpus.dtype == torch.bfloat16:
        q = q.to(torch.bfloat16).float()
    return q


def stable_topk(s: torch.Tensor, k: int):
    """`lax.top_k` along dim 1: the k largest values and their positions,
    equal values in position order (`torch.topk` does not promise that)."""
    s, pos = torch.sort(s, dim=1, descending=True, stable=True)
    return s[:, :k].contiguous(), pos[:, :k]


def cosine_topk_reference(corpus: torch.Tensor, queries: torch.Tensor, k: int,
                          normalize_queries: bool = True):
    """Plain exact top-k: an IEEE f32 product (TF32 is off, see device.py),
    then `stable_topk`, which keeps equal scores in index order. Returns
    ((B, k) f32, (B, k) i32).
    For an f32 corpus this is the JAX oracle's arithmetic."""
    q = _kernel_queries(corpus, queries, normalize_queries)
    s, i = stable_topk(q @ corpus.float().T, k)
    return s, i.to(torch.int32)


def cosine_topk(corpus: torch.Tensor, queries: torch.Tensor, k: int,
                normalize_queries: bool = True):
    """Kernel B1: fused cosine scoring and top-k over a pre-normalized
    (N, D) f32 or bf16 corpus. Returns ((B, k) f32 scores, (B, k) i32)."""
    if corpus.device.type == "cpu" and queries.device.type == "cpu":
        return cosine_topk_reference(corpus, queries, k, normalize_queries)
    if corpus.device.type != "cuda" or queries.device != corpus.device:
        raise ValueError(f"cosine_topk: corpus on {corpus.device}, queries on "
                         f"{queries.device}; both must be on one CUDA device")
    if corpus.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"cosine_topk: corpus dtype {corpus.dtype}")
    if (corpus.dim() != 2 or queries.dim() != 2
            or queries.shape[1] != corpus.shape[1]):
        raise ValueError(f"cosine_topk: corpus {tuple(corpus.shape)} vs "
                         f"queries {tuple(queries.shape)}")
    if corpus.shape[1] % DEPTH_ALIGN:
        # any depth is taken, as by the JAX wrapper; a holder pads at set-up
        _warn_unpadded_corpus("cosine_topk", corpus.shape[1])
        corpus, queries = pad_depth(corpus), pad_depth(queries)
    n, d = corpus.shape
    b = queries.shape[0]
    if not 1 <= k <= n or b < 1:
        raise ValueError(f"cosine_topk: needs 1 <= k <= N and B >= 1; "
                         f"got k={k}, N={n}, B={b}")
    if not corpus.is_contiguous() or corpus.data_ptr() % 16:
        raise ValueError("cosine_topk: the corpus must be contiguous and 16-byte aligned")
    q = _kernel_queries(corpus, queries, normalize_queries).contiguous()

    dev = corpus.device
    lib = _build.library()
    if k > LIST_K[corpus.dtype]:
        def scores(lo: int, hi: int) -> torch.Tensor:
            out = torch.empty((b, hi - lo), dtype=torch.float32, device=dev)
            tiles_per_cta, n_ctas = float_grid(hi - lo, b, dev)
            with torch.cuda.device(dev):
                err = lib.rag_score_rows(
                    q.data_ptr(), corpus.data_ptr() + lo * d * corpus.element_size(),
                    int(corpus.dtype == torch.bfloat16), b, hi - lo, d, tiles_per_cta,
                    n_ctas, out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
            _build.check(err, "rag_score_rows")
            _build.count_launch(cosine_topk)
            return out

        return scan_select(n, k, score_chunk_rows(b, FLOAT_ROWS), scores)
    tiles_per_cta, n_ctas = float_grid(n, b, dev)
    bufs = _merge_buffers(b, n_ctas, k, dev)
    with torch.cuda.device(dev):
        err = lib.rag_cosine_topk(
            q.data_ptr(), corpus.data_ptr(), int(corpus.dtype == torch.bfloat16),
            b, n, d, k, tiles_per_cta, n_ctas, *(t.data_ptr() for t in bufs),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "rag_cosine_topk")
    _build.count_launch(cosine_topk)
    return bufs[-2], bufs[-1]


cosine_topk.launches = 0


def select_topk_plain(scores: torch.Tensor, k: int, indices: torch.Tensor | None = None,
                      base: int = 0):
    """Plain version of `select_topk`: `stable_topk`, then each position's
    index (base + position, or indices[position])."""
    s, pos = stable_topk(scores, k)
    if indices is None:
        return s, (pos + base).to(torch.int32)
    return s, torch.gather(indices, 1, pos)


class SelectSizes(NamedTuple):
    """The launch and scratch sizes of `select_topk` over (b, L) scores."""
    slices: int          # G: CTAs a row in the passes over the scores
    width: int           # P: the sort's width, a power of two >= max(k, 2)
    scratch_words: int   # int32: (b, G, SELECT_BINS) counts, b states, 3 x (b, G)
    candidates: int      # entries of each of the candidate key and position lists


def select_sizes(b: int, ln: int, k: int, sms: int) -> SelectSizes:
    """One wave of two 512-thread CTAs an SM over the b rows, at most one a
    SELECT_TILE of scores; a row's candidate list holds what its digit
    search may stop at, and never more than the row."""
    g = max(1, min(2 * sms // b, -(-ln // SELECT_TILE)))
    return SelectSizes(slices=g, width=1 << max(1, (k - 1).bit_length()),
                       scratch_words=b * (g * SELECT_BINS + 8 + 3 * g),
                       candidates=b * min(ln, SELECT_CAND_CAP))


def select_topk(scores: torch.Tensor, k: int, indices: torch.Tensor | None = None,
                base: int = 0):
    """The k best of each row of (B, L) f32 scores, as `stable_topk` orders
    them (score desc, then position asc; -0.0 equals +0.0): ((B, k) scores,
    (B, k) i32 indices), an index being base + position, or indices[b,
    position] when (B, L) i32 indices are given. Launches the candidate
    select and bitonic sort of `csrc/select.cu` on a CUDA tensor."""
    if scores.device.type == "cpu":
        return select_topk_plain(scores, k, indices, base)
    b, ln = scores.shape
    if (scores.device.type != "cuda" or scores.dtype != torch.float32
            or not scores.is_contiguous() or not 1 <= k <= ln or b > 65535
            or (indices is not None and (indices.shape != scores.shape
                                         or indices.dtype != torch.int32
                                         or indices.device != scores.device
                                         or not indices.is_contiguous()))):
        raise ValueError(f"select_topk: scores {scores.dtype} {tuple(scores.shape)} on "
                         f"{scores.device}, k={k}; needs contiguous (B <= 65535, L) f32 "
                         "on a CUDA device, 1 <= k <= L, and (B, L) i32 indices or none")
    dev = scores.device
    size = select_sizes(b, ln, k, _sms(dev))
    scratch = torch.empty(size.scratch_words, dtype=torch.int32, device=dev)
    cand_k, cand_p, keys, pos = (torch.empty(n, dtype=torch.int32, device=dev)
                                 for n in (size.candidates, size.candidates,
                                           b * size.width, b * size.width))
    out_s = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = _build.library().rag_select_topk(
            scores.data_ptr(), None if indices is None else indices.data_ptr(), base,
            b, ln, ln, k, size.width, size.slices, scratch.data_ptr(), cand_k.data_ptr(),
            cand_p.data_ptr(), keys.data_ptr(), pos.data_ptr(), out_s.data_ptr(),
            out_i.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "rag_select_topk")
    _build.count_launch(select_topk)
    return out_s, out_i


select_topk.launches = 0


def score_chunk_rows(b: int, tile_rows: int) -> int:
    """Rows whose (b, rows) f32 scores fill SCORE_CHUNK_BYTES, in whole tiles."""
    return max(tile_rows, SCORE_CHUNK_BYTES // (4 * b) // tile_rows * tile_rows)


def merge_selected(parts: list, k: int):
    """The k best of several (scores, indices) lists, each ordered by (score
    desc, index asc) and together in index order: equal scores keep the
    lower index first."""
    if len(parts) == 1:
        return parts[0]
    return select_topk(torch.cat([s for s, _ in parts], dim=1), k,
                       indices=torch.cat([i for _, i in parts], dim=1))


def scan_select(n: int, k: int, rows: int, scores):
    """Top-k over n corpus rows in chunks of `rows`: scores(lo, hi) gives
    the (B, hi - lo) f32 scores of rows lo .. hi - 1; each chunk's best are
    selected, then merged."""
    parts = []
    for lo in range(0, n, rows):
        hi = min(n, lo + rows)
        parts.append(select_topk(scores(lo, hi), min(k, hi - lo), base=lo))
    return merge_selected(parts, k)


def _merge_buffers(b: int, n_ctas: int, k: int, dev: torch.device):
    """The top-k kernels' scratch and outputs: (scores, indices) of the
    n_ctas candidate lists, of the merge tree's first level (8 lists to
    one), and (B, k)."""
    out = []
    for width in (n_ctas * k, (n_ctas + 7) // 8 * k, k):
        out += [torch.empty((b, width), dtype=torch.float32, device=dev),
                torch.empty((b, width), dtype=torch.int32, device=dev)]
    return out


def one_wave(n: int, b: int, rows: int, sms: int, per_sm: int) -> tuple[int, int]:
    """(tiles_per_cta, n_ctas) for n rows in tiles of `rows`: one wave of
    per_sm CTAs on each of sms SMs over all ceil(b / 32) query groups, each
    CTA streaming a contiguous span."""
    n_tiles = math.ceil(n / rows)
    wave = max(1, per_sm * sms // math.ceil(b / 32))
    tiles_per_cta = max(1, math.ceil(n_tiles / wave))
    return tiles_per_cta, math.ceil(n_tiles / tiles_per_cta)


def _sms(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def float_grid(n: int, b: int, dev: torch.device) -> tuple[int, int]:
    """(tiles_per_cta, n_ctas) of a float-tile kernel: one wave, one CTA an
    SM."""
    return one_wave(n, b, FLOAT_ROWS, _sms(dev), 1)


class TileInfo(NamedTuple):
    """What the occupancy calculator says of an int8-tile kernel."""
    ctas_per_sm: int
    registers: int     # a thread
    local_bytes: int   # stack frame a thread
    smem_bytes: int    # dynamic shared memory a CTA


@functools.lru_cache(maxsize=64)
def int8_tile_info(kernel: str, d: int, device_index: int) -> TileInfo:
    """The int8 tile's kernel on device `device_index` at depth d: "topk"
    (B4), "scores" (the score kernel beyond the lists) or "dot" (P2)."""
    out = (ctypes.c_int * 4)()
    lib = _build.library()
    with torch.cuda.device(device_index):
        if kernel == "dot":
            err = lib.rag_dot_probe_int8_info(d, ctypes.addressof(out))
        else:
            err = lib.rag_int8_tile_info({"topk": 0, "scores": 1}[kernel], d,
                                         ctypes.addressof(out))
    _build.check(err, f"rag_int8_tile_info({kernel}, D={d})")
    info = TileInfo(*out)
    if info.ctas_per_sm < 1:
        raise RuntimeError(f"int8 {kernel} kernel at D={d} fits no SM: {info}")
    return info


def int8_grid(kernel: str, n: int, b: int, d: int, dev: torch.device) -> tuple[int, int]:
    """(tiles_per_cta, n_ctas) of an int8-tile kernel: one wave of as many
    CTAs an SM as fit."""
    info = int8_tile_info(kernel, d, dev.index)
    return one_wave(n, b, INT8_ROWS, _sms(dev), info.ctas_per_sm)


# ---------------------------------------------------------------------------
# int8 corpus (RETRIEVAL_CORPUS_DTYPE=int8): mean-centred per-row symmetric
# quantization; the kernel ranks by the int32 dot times the row's scale, and
# the query scale and the rank-invariant q . mean term are applied outside.
# ---------------------------------------------------------------------------

def quantize_corpus_int8(corpus: torch.Tensor):
    """Mean-centred per-row symmetric int8 quantization. Returns
    (values (N, D) int8, scales (1, N) f32, mean (1, D) f32) with
    corpus ~ mean + values * scales.T."""
    c = corpus.float()
    mean = c.mean(dim=0, keepdim=True)
    r = c - mean
    amax = r.abs().amax(dim=1, keepdim=True)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(r / scale), -127, 127).to(torch.int8)
    return q, scale.reshape(1, -1), mean


def _quantize_queries_int8(q: torch.Tensor):
    qf = q.float()
    amax = qf.abs().amax(dim=1, keepdim=True)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    qi = torch.clamp(torch.round(qf / scale), -127, 127).to(torch.int8)
    return qi, scale


def quantize_corpus_int8_chunked(corpus, chunk_rows: int = 4_194_304,
                                 device: str | torch.device = "cpu"):
    """Quantize on the host (numpy, the JAX package's arithmetic line for
    line, so values and scales match it bit for bit) into `chunk_rows`-row
    chunks. Returns ([(values (C, D) int8, scales (1, C) f32), ...],
    mean (1, D) f32) on `device`; the last chunk is not padded."""
    c = np.asarray(corpus, dtype=np.float32)
    mean = c.mean(axis=0, keepdims=True)
    out = []
    for lo in range(0, c.shape[0], chunk_rows):
        r = c[lo:lo + chunk_rows] - mean
        scale = np.maximum(np.abs(r).max(axis=1, keepdims=True), 1e-12) / 127.0
        qv = np.clip(np.round(r / scale), -127, 127).astype(np.int8)
        out.append((torch.as_tensor(qv, device=device),
                    torch.as_tensor(scale.reshape(1, -1), device=device)))
    return out, torch.as_tensor(mean, device=device)


def _int8_queries(queries: torch.Tensor, normalize: bool):
    """(f32 queries, int8 queries, (B, 1) query scales) as both versions
    take them."""
    qn = (l2_normalize(queries) if normalize else queries).float()
    qi, qscale = _quantize_queries_int8(qn)
    return qn, qi, qscale


def _int8_finish(s, i, qn, qscale, corpus_mean):
    """Fold the query scale back in (ranks are already final) and add the
    per-query mean term, so scores approximate true cosine."""
    s = s * qscale
    if corpus_mean is not None:
        s = s + qn @ corpus_mean.reshape(-1, 1).float()
    return s, i


def _int8_raw_plain(qi, corpus_q, scales, k):
    """Exact int32 dots times the row scales, then an exact running top-k
    over row blocks of at most 262,144 rows (about 1 GB of f32 scratch at
    D = 1024). An f32 product of int8 values is exact while D * 127^2 < 2^24;
    past that, f64."""
    n, d = corpus_q.shape
    dt = torch.float32 if d * 127 * 127 < 2 ** 24 else torch.float64
    q = qi.to(dt)
    sc = scales.reshape(-1)
    best_s = best_i = None
    for lo in range(0, n, _PLAIN_ROWS):
        blk = corpus_q[lo:lo + _PLAIN_ROWS]
        s = (q @ blk.to(dt).T).to(torch.int32).float() * sc[lo:lo + blk.shape[0]]
        i = torch.arange(lo, lo + blk.shape[0], dtype=torch.int32,
                         device=s.device).expand_as(s)
        if best_s is not None:   # held entries first: they have lower indices
            s = torch.cat([best_s, s], dim=1)
            i = torch.cat([best_i, i], dim=1)
        best_s, pos = stable_topk(s, k)
        best_i = torch.gather(i, 1, pos)
    return best_s, best_i


def cosine_topk_int8_reference(corpus_q, corpus_scales, queries, k: int,
                               corpus_mean=None, normalize_queries: bool = True):
    """Plain version of `cosine_topk_int8`: the same quantized arithmetic
    (exact int32 dots, one f32 product with the row scale) and a stable
    descending selection. Returns ((B, k) f32, (B, k) i32)."""
    qn, qi, qscale = _int8_queries(queries, normalize_queries)
    s, i = _int8_raw_plain(qi, corpus_q, corpus_scales, k)
    return _int8_finish(s, i, qn, qscale, corpus_mean)


def cosine_topk_int8(corpus_q, corpus_scales, queries, k: int,
                     corpus_mean=None, normalize_queries: bool = True):
    """Kernel B4: top-k over an int8 mean-centred corpus (N, D) with
    per-row scales (1, N) or (N,). Returns ((B, k) f32 scores approximating
    cosine, (B, k) i32 indices)."""
    if corpus_q.device.type == "cpu" and queries.device.type == "cpu":
        return cosine_topk_int8_reference(corpus_q, corpus_scales, queries, k,
                                          corpus_mean, normalize_queries)
    dev = corpus_q.device
    if (dev.type != "cuda" or queries.device != dev
            or corpus_scales.device != dev):
        raise ValueError(f"cosine_topk_int8: corpus on {dev}, scales on "
                         f"{corpus_scales.device}, queries on {queries.device}; "
                         "all must be on one CUDA device")
    if corpus_q.dtype != torch.int8 or corpus_q.dim() != 2:
        raise ValueError(f"cosine_topk_int8: corpus must be (N, D) int8, got "
                         f"{corpus_q.dtype} {tuple(corpus_q.shape)}")
    n, d = corpus_q.shape
    if (corpus_scales.dtype != torch.float32
            or tuple(corpus_scales.shape) not in ((1, n), (n,))
            or not corpus_scales.is_contiguous()):
        raise ValueError(f"cosine_topk_int8: scales must be contiguous (1, N) "
                         f"or (N,) f32, got {corpus_scales.dtype} "
                         f"{tuple(corpus_scales.shape)} for N={n}")
    if queries.dim() != 2 or queries.shape[1] != d or queries.shape[0] < 1:
        raise ValueError(f"cosine_topk_int8: queries {tuple(queries.shape)} vs "
                         f"corpus {tuple(corpus_q.shape)}")
    if not 1 <= d <= INT8_MAX_D or not 1 <= k <= n:
        # the (32, D) query block must fit an SM's shared memory
        raise ValueError(f"cosine_topk_int8: needs 1 <= D <= {INT8_MAX_D} and "
                         f"1 <= k <= N; got D={d}, k={k}, N={n}")
    if d % DEPTH_ALIGN:
        _warn_unpadded_corpus("cosine_topk_int8", d)
        corpus_q, queries = pad_depth(corpus_q), pad_depth(queries)
        if corpus_mean is not None:
            corpus_mean = pad_depth(corpus_mean.reshape(1, -1))
        d = corpus_q.shape[1]
    if not corpus_q.is_contiguous() or corpus_q.data_ptr() % 16:
        raise ValueError("cosine_topk_int8: the corpus must be contiguous and "
                         "16-byte aligned")
    qn, qi, qscale = _int8_queries(queries, normalize_queries)
    qi = qi.contiguous()
    b = qi.shape[0]
    lib = _build.library()
    if k > LIST_K[torch.int8]:
        def scores(lo: int, hi: int) -> torch.Tensor:
            out = torch.empty((b, hi - lo), dtype=torch.float32, device=dev)
            tiles_per_cta, n_ctas = int8_grid("scores", hi - lo, b, d, dev)
            with torch.cuda.device(dev):
                err = lib.rag_score_rows_int8(
                    qi.data_ptr(), corpus_q.data_ptr() + lo * d,
                    corpus_scales.data_ptr() + lo * 4, b, hi - lo, d, tiles_per_cta,
                    n_ctas, out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
            _build.check(err, "rag_score_rows_int8")
            _build.count_launch(cosine_topk_int8)
            return out

        s, i = scan_select(n, k, score_chunk_rows(b, INT8_ROWS), scores)
        return _int8_finish(s, i, qn, qscale, corpus_mean)
    tiles_per_cta, n_ctas = int8_grid("topk", n, b, d, dev)
    bufs = _merge_buffers(b, n_ctas, k, dev)
    with torch.cuda.device(dev):
        err = lib.rag_cosine_topk_int8(
            qi.data_ptr(), corpus_q.data_ptr(), corpus_scales.data_ptr(),
            b, n, d, k, tiles_per_cta, n_ctas, *(t.data_ptr() for t in bufs),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "rag_cosine_topk_int8")
    _build.count_launch(cosine_topk_int8)
    return _int8_finish(bufs[-2], bufs[-1], qn, qscale, corpus_mean)


cosine_topk_int8.launches = 0


def cosine_topk_int8_chunked(chunks, queries, k: int, corpus_mean=None,
                             normalize_queries: bool = True):
    """Exact merge of per-chunk `cosine_topk_int8` winners. `chunks` is
    [(values (C, D) int8, scales (1, C) f32), ...] in corpus order. Returns
    ((B, k) scores, (B, k) global indices); equal scores rank the lower
    global index first. Beyond LIST_K the merge is `select_topk`."""
    all_s, all_i = [], []
    base = 0
    for values, scales in chunks:
        s, i = cosine_topk_int8(values, scales, queries, min(k, values.shape[0]),
                                corpus_mean, normalize_queries)
        all_s.append(s)
        all_i.append(i + base)
        base += values.shape[0]
    if len(chunks) == 1:
        return all_s[0], all_i[0]
    if k > LIST_K[torch.int8]:
        return merge_selected(list(zip(all_s, all_i)), k)
    top_s, pos = stable_topk(torch.cat(all_s, dim=1), k)
    return top_s, torch.gather(torch.cat(all_i, dim=1), 1, pos)
