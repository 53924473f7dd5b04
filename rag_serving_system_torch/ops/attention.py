"""Prefill attention: kernels B2 (padded) and B3 (packed) and their plain
PyTorch versions.

Port of `rag_serving_system_tpu/ops/attention.py` (`flash_attention`,
`flash_attention_packed`). Layouts are the JAX package's: q (B, S, Hq, D),
k/v (B, S, Hk, D); query head h reads kv head h // (Hq // Hk). Rows whose
visible keys are all masked output 0, as the TPU kernels emit.

Each wrapper takes its plain version for a CPU tensor and launches
`csrc/flash_attention.cu` for a CUDA tensor, or raises: a wgmma / TMA kernel
for bf16 at head sizes 64 and 128 (a CTA serves every query head of one KV
head, so Hq // Hk may be at most WG_ROWS), the FP32 CUDA-core kernel for f32
and for the narrow heads (16 and 32) of either type.

B3 takes `n_real`, the count of real tokens at the head of the stream (the
engine's packed batches end in a pad tail that no caller reads): rows from
`n_real` on are written as 0 and no kernel block is launched for them. Real
rows never see a pad key (their segments differ), so they are the same with
or without it.
"""

from __future__ import annotations

import math

import torch

from rag_serving_system_torch.ops import _build

NEG_INF = -1.0e30
HEAD_DIMS = (16, 32, 64, 128)  # the head sizes csrc/flash_attention.cu instantiates
WG_ROWS = 128  # (position, head) rows of a bf16 CTA at D = 64 and 128: G <= WG_ROWS


def _attend_plain(q, k, v, valid: torch.Tensor) -> torch.Tensor:
    """Plain masked attention with the kernels' semantics. valid: (B, S, S)
    bool, query by key. f32 math; q is scaled before the product, as the
    kernels scale it."""
    b, s, hq, d = q.shape
    hk = k.shape[2]
    qf = q.float().reshape(b, s, hk, hq // hk, d) * (1.0 / math.sqrt(d))
    scores = torch.einsum("bshgd,bthd->bhgst", qf, k.float())
    scores = scores.masked_fill(~valid[:, None, None], NEG_INF)
    out = torch.einsum("bhgst,bthd->bshgd", torch.softmax(scores, dim=-1),
                       v.float())
    live = valid.any(dim=-1)[:, :, None, None, None]
    return (out * live).reshape(b, s, hq, d).to(q.dtype)


def _check_qkv(name: str, q, k, v) -> None:
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"{name}: q/k/v on {q.device}/{k.device}/{v.device}; "
                         "all must be on one CUDA device")
    if q.dtype not in (torch.float32, torch.bfloat16) or not (
            k.dtype == v.dtype == q.dtype):
        raise ValueError(f"{name}: dtypes {q.dtype}/{k.dtype}/{v.dtype}; "
                         "expected one of float32, bfloat16")
    b, s, hq, d = q.shape
    hk = k.shape[2]
    if (k.shape != (b, s, hk, d) or v.shape != k.shape or hq % hk
            or d not in HEAD_DIMS):
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}; needs Hq % Hk == 0 and "
                         f"D in {HEAD_DIMS}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{name}: q/k/v must be contiguous")
    if q.data_ptr() % 16 or k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError(f"{name}: q/k/v must be 16-byte aligned")
    if q.dtype == torch.bfloat16 and d in (64, 128) and hq // hk > WG_ROWS:
        raise ValueError(f"{name}: {hq // hk} query heads a KV head; the bf16 "
                         f"kernel takes at most {WG_ROWS}")


def _launch(q, k, v, mask, seg, packed: bool, causal: bool, n_q: int,
            out: torch.Tensor) -> torch.Tensor:
    """Launch the kernel over query rows [0, n_q) of out."""
    b, s, hq, d = q.shape
    lib = _build.library()
    with torch.cuda.device(q.device):
        err = lib.rag_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if mask is None else mask.data_ptr(),
            None if seg is None else seg.data_ptr(), out.data_ptr(),
            int(q.dtype == torch.bfloat16), int(packed), int(causal), b, s, n_q, hq,
            k.shape[2], d, 1.0 / math.sqrt(d), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "rag_flash_attention")
    return out


def _real_count(n_real, t: int) -> int:
    """n_real as an int in [0, T]; None means T."""
    if n_real is None:
        return t
    n = int(n_real)
    if not 0 <= n <= t:
        raise ValueError(f"flash_attention_packed: n_real {n_real} outside [0, {t}]")
    return n


def flash_attention_plain(q, k, v, mask, causal: bool = True) -> torch.Tensor:
    """Plain version of kernel B2, on any device."""
    s = q.shape[1]
    valid = (mask[:, None, :] > 0).expand(-1, s, -1)
    if causal:
        valid = valid & torch.tril(
            torch.ones((s, s), dtype=torch.bool, device=q.device))
    return _attend_plain(q, k, v, valid)


def flash_attention_packed_plain(q, k, v, seg, n_real: int | None = None) -> torch.Tensor:
    """Plain version of kernel B3, on any device. Every row is computed as
    without `n_real` and the rows from `n_real` on are then zeroed, so the
    real rows are bit-identical whether it is given or not."""
    t = q.shape[1]
    n = _real_count(n_real, t)
    sg = seg[0]
    valid = (sg[:, None] == sg[None, :]) & torch.tril(
        torch.ones((t, t), dtype=torch.bool, device=q.device))
    out = _attend_plain(q, k, v, valid[None])
    out[:, n:] = 0
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    mask: torch.Tensor, causal: bool = True) -> torch.Tensor:
    """Kernel B2: attention over a padded batch. mask: (B, S) {0, 1} key-side
    padding mask; causal adds j <= i. Returns (B, S, Hq, D) in q's dtype."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, mask, causal)
    _check_qkv("flash_attention", q, k, v)
    if mask.shape != q.shape[:2] or mask.device != q.device:
        raise ValueError(f"flash_attention: mask {tuple(mask.shape)} on "
                         f"{mask.device}, expected {tuple(q.shape[:2])}")
    out = _launch(q, k, v, mask.to(torch.int32).contiguous(), None,
                  packed=False, causal=causal, n_q=q.shape[1], out=torch.empty_like(q))
    _build.count_launch(flash_attention)
    return out


def flash_attention_packed(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           seg: torch.Tensor, n_real: int | None = None) -> torch.Tensor:
    """Kernel B3: causal attention over one packed (1, T) stream; token i
    attends to token j iff seg[i] == seg[j] and j <= i. seg: (1, T) int
    segment ids, ascending (rows back to back, the pad tail last). n_real:
    the real tokens at the head of the stream, a host int (None: all T);
    rows from it on come back 0. The kernel visits, per query block, only
    the keys from the block's first segment start to the diagonal, so its
    work grows with sum(len^2) over the real rows."""
    if q.device.type == "cpu":
        return flash_attention_packed_plain(q, k, v, seg, n_real)
    _check_qkv("flash_attention_packed", q, k, v)
    if q.shape[0] != 1 or seg.shape != q.shape[:2] or seg.device != q.device:
        raise ValueError(f"flash_attention_packed: q {tuple(q.shape)}, seg "
                         f"{tuple(seg.shape)} on {seg.device}; expected one "
                         "(1, T) stream")
    n = _real_count(n_real, q.shape[1])
    out = torch.empty_like(q)
    out[:, n:] = 0
    if n == 0:
        return out
    _launch(q, k, v, None, seg.to(torch.int32).contiguous(), packed=True, causal=True,
            n_q=n, out=out)
    _build.count_launch(flash_attention_packed)
    return out


flash_attention.launches = 0
flash_attention_packed.launches = 0
