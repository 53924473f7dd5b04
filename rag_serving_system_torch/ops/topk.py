"""Exact cosine top-k retrieval: kernel B1 and its plain PyTorch version.

Port of `rag_serving_system_tpu/ops/topk.py` (`_l2_normalize`,
`cosine_topk_reference`, `cosine_topk_pallas`). The corpus is expected
pre-normalized; queries are normalized here. Equal scores rank the lower
corpus index first, as `lax.top_k` does.

`cosine_topk` is the kernel's wrapper: a CPU tensor takes the plain version,
`cosine_topk_reference`; a CUDA tensor launches `csrc/topk.cu` or raises.
"""

from __future__ import annotations

import math

import torch

from rag_serving_system_torch.ops import _build

MAX_K = 32        # the kernel keeps each running list in one warp's lanes
_TILE_ROWS = 128  # corpus rows per tile in csrc/topk.cu (NT)


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    xf = x.float()
    n = torch.sqrt(torch.sum(xf * xf, dim=-1, keepdim=True))
    return (x / torch.clamp(n, min=eps)).to(x.dtype)


def _kernel_queries(corpus: torch.Tensor, queries: torch.Tensor,
                    normalize: bool) -> torch.Tensor:
    """f32 queries as both versions score them. As on the TPU, a bf16 corpus
    meets bf16-rounded queries, so each product is exact in f32."""
    q = (l2_normalize(queries) if normalize else queries).float()
    if corpus.dtype == torch.bfloat16:
        q = q.to(torch.bfloat16).float()
    return q


def cosine_topk_reference(corpus: torch.Tensor, queries: torch.Tensor, k: int,
                          normalize_queries: bool = True):
    """Plain exact top-k: an IEEE f32 product (TF32 is off, see device.py),
    then a stable descending sort, which keeps equal scores in index order
    (`torch.topk` does not promise that). Returns ((B, k) f32, (B, k) i32).
    For an f32 corpus this is the JAX oracle's arithmetic."""
    q = _kernel_queries(corpus, queries, normalize_queries)
    s, i = torch.sort(q @ corpus.float().T, dim=1, descending=True, stable=True)
    return s[:, :k].contiguous(), i[:, :k].to(torch.int32)


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
    n, d = corpus.shape
    b = queries.shape[0]
    if d % 4 or not 1 <= k <= min(MAX_K, n) or b < 1:
        raise ValueError(f"cosine_topk: needs D % 4 == 0 and 1 <= k <= "
                         f"min({MAX_K}, N); got D={d}, k={k}, N={n}, B={b}")
    if not corpus.is_contiguous() or corpus.data_ptr() % 16:
        raise ValueError("cosine_topk: the corpus must be contiguous and 16-byte aligned")
    q = _kernel_queries(corpus, queries, normalize_queries).contiguous()

    lib = _build.library()
    dev = corpus.device
    n_tiles = math.ceil(n / _TILE_ROWS)
    # one wave of CTAs, a few per SM, each streaming a contiguous span
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    tiles_per_cta = max(1, math.ceil(n_tiles / (4 * sms)))
    n_ctas = math.ceil(n_tiles / tiles_per_cta)
    cand_s = torch.empty((b, n_ctas * k), dtype=torch.float32, device=dev)
    cand_i = torch.empty((b, n_ctas * k), dtype=torch.int32, device=dev)
    out_s = torch.empty((b, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((b, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.rag_cosine_topk(
            q.data_ptr(), corpus.data_ptr(), int(corpus.dtype == torch.bfloat16),
            b, n, d, k, tiles_per_cta, n_ctas, cand_s.data_ptr(),
            cand_i.data_ptr(), out_s.data_ptr(), out_i.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "rag_cosine_topk")
    cosine_topk.launches += 1
    return out_s, out_i


cosine_topk.launches = 0
