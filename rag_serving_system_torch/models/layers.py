"""Shared building blocks in PyTorch, counterparts of
`rag_serving_system_tpu.models.layers` with the same layouts: dense weights
are (in, out), attention takes (B, S, H, D), masks are additive f32 biases
with the NEG_INF = -1e9 convention.

Products of bf16 operands accumulate in f32, as the JAX package's
`preferred_element_type=jnp.float32` does, and are cast back to the input
dtype at the end. `dense` also takes the quantized weights of `ops/quant.py`
and `dense_w8a8` is the int8 x int8 prefill product; both are library
products (cuBLAS), as they are XLA's outside every Pallas kernel.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from rag_serving_system_torch.ops.quant import quantize_act_int8, unpack_int4

NEG_INF = -1.0e9  # additive attention-mask value (f32-safe, avoids NaN in softmax)


def dense(x: torch.Tensor, w, b: torch.Tensor | None = None) -> torch.Tensor:
    """x: (..., in) @ w: (in, out) [+ b]. `w` is a plain tensor, an
    `ops.quant.QuantizedWeight` (int8, one scale per output channel) or a
    `QuantizedWeight4` (packed int4, one scale per (group, output channel)).

    The quantized forms multiply by the raw integers converted to x's dtype
    (exact: |q| <= 127) and apply the scale to the PRODUCT in f32, then the
    bias, then one cast, in the JAX package's order. The int4 form is the
    grouped product, scaled per (group, out) and summed over the groups.
    The converted copy of the weight lives for the call only: nothing
    dequantized is kept.

    A plain `w` of another dtype than `x` (bf16 activations over f32
    parameters, as the trainer runs) follows jnp's promotion, as the JAX
    einsum does: the product in the wider type (IEEE f32: TF32 stays off),
    the bias added in it, one cast back to x's dtype."""
    if not hasattr(w, "q") and w.dtype != x.dtype:
        wide = torch.promote_types(x.dtype, w.dtype)
        y = torch.matmul(x.to(wide), w.to(wide))
        if b is not None:
            y = y + b.to(wide)
        return y.to(x.dtype)
    if not hasattr(w, "q"):
        y = torch.matmul(x, w)
        if b is not None:
            y = y + b
        return y
    if w.q.ndim == 3:
        gq, g2, _ = w.q.shape
        xg = x.reshape(*x.shape[:-1], gq, 2 * g2)
        y = torch.einsum("...gi,gio->...go", xg, unpack_int4(w.q).to(x.dtype)).float()
        y = (y * w.scale[:, 0, :]).sum(dim=-2)
    else:
        # a bf16 product rounds to bf16 at the matmul's end, then widens
        y = torch.matmul(x, w.q.to(x.dtype)).float() * w.scale
    if b is not None:
        y = y + b.to(y.dtype)
    return y.to(x.dtype)


def int_matmul(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 → (M, N) int32, exact. On a CUDA device
    `torch._int_mm` (s8 tensor cores), which raises on what it does not
    take: K and N must be multiples of 8. It needs more than 16 rows, so
    fewer are padded with zero rows. The weight goes in COLUMN-major, the
    layout cuBLASLt's int8 kernels are written for: a transposed int8 copy
    that lives for the call. Measured on an H100 at 8192 rows, the stored
    row-major weight took 0.43 / 3.56 ms (1536 x 2048 / 1536 x 17920)
    against 0.09 / 0.67 ms column-major, and was refused outright at
    K <= 96 beside fewer than 128 rows. On the CPU an int32 matmul."""
    if xq.device.type != "cuda":
        return torch.matmul(xq.to(torch.int32), wq.to(torch.int32))
    m, k = xq.shape
    wq = wq.t().contiguous().t()
    if m <= 16:
        pad = torch.zeros((17 - m, k), dtype=torch.int8, device=xq.device)
        return torch._int_mm(torch.cat([xq, pad]), wq)[:m]
    return torch._int_mm(xq.contiguous(), wq)


def int_matmul_plain(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """The same int32 sums without `torch._int_mm`, on any device: f32
    products over K-chunks of 1024 (a chunk's sum stays below 2^24, so each
    is exact in f32), added in int32."""
    acc = torch.zeros((xq.shape[0], wq.shape[1]), dtype=torch.int32, device=xq.device)
    for k0 in range(0, xq.shape[1], 1024):
        part = torch.matmul(xq[:, k0:k0 + 1024].float(), wq[k0:k0 + 1024].float())
        acc += part.to(torch.int32)
    return acc


def dense_w8a8(x: torch.Tensor, w, b: torch.Tensor | None = None) -> torch.Tensor:
    """W8A8 product for prefill: per-token int8 activations against the int8
    weights with exact int32 sums, rescaled in f32 (`acc * xs * w.scale`),
    then the bias and one cast. int4 weights run per group (W4A8); a plain
    weight falls through to `dense`."""
    if not hasattr(w, "q"):
        return dense(x, w, b)
    xq, xs = quantize_act_int8(x)
    lead = x.shape[:-1]
    xq2 = xq.reshape(-1, xq.shape[-1])
    if w.q.ndim == 3:
        gq, g2, o = w.q.shape
        wq = unpack_int4(w.q)
        xg = xq2.reshape(-1, gq, 2 * g2)
        acc = torch.stack([int_matmul(xg[:, g], wq[g]) for g in range(gq)], dim=1)
        y = (acc.float() * w.scale[:, 0, :]).sum(dim=-2).reshape(*lead, o) * xs
    else:
        acc = int_matmul(xq2, w.q)
        y = acc.float().reshape(*lead, -1) * xs * w.scale
    if b is not None:
        y = y + b.to(y.dtype)
    return y.to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(x.dtype)


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def gelu(x: torch.Tensor) -> torch.Tensor:
    # erf-based (exact) GELU, matching BERT-family 'gelu'
    return F.gelu(x, approximate="none")


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


# ---------------------------------------------------------------------------
# Rotary position embeddings (Qwen2/Llama "half-rotation" layout)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """(head_dim/2,) f32 inverse frequencies."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, inv_freq: torch.Tensor) -> torch.Tensor:
    """x: (B, S, H, D), positions: (B, S) int → rotated x (same dtype), HF
    'rotate_half' convention."""
    angles = positions.float()[..., None] * inv_freq      # (B, S, D/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    xf = x.float()
    d2 = x.shape[-1] // 2
    x1, x2 = xf[..., :d2], xf[..., d2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              bias: torch.Tensor) -> torch.Tensor:
    """Grouped-query scaled dot-product attention.
    q: (B, S, Hq, D); k, v: (B, T, Hk, D); bias: (B, 1, S, T) additive f32.
    Hq must be a multiple of Hk; K/V are never repeated."""
    b, s, hq, d = q.shape
    hk = k.shape[2]
    qf = q.reshape(b, s, hk, hq // hk, d).float()
    scores = torch.einsum("bshgd,bthd->bhgst", qf, k.float())
    scores = scores * (1.0 / math.sqrt(d))
    scores = scores + bias[:, :, None, :, :]
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgst,bthd->bshgd", probs.to(v.dtype).float(), v.float())
    return out.reshape(b, s, hq, d).to(q.dtype)


def padding_bias(mask: torch.Tensor) -> torch.Tensor:
    """(B, T) {0,1} → (B, 1, 1, T) additive f32 bias."""
    zero = torch.zeros((), dtype=torch.float32, device=mask.device)
    return torch.where(mask[:, None, None, :] > 0, zero, NEG_INF)


def causal_padding_bias(mask: torch.Tensor) -> torch.Tensor:
    """(B, S) {0,1} → (B, 1, S, S) causal + padding additive f32 bias."""
    s = mask.shape[-1]
    causal = torch.tril(torch.ones((s, s), dtype=torch.bool, device=mask.device))
    allowed = causal[None, :, :] & (mask[:, None, :] > 0)
    zero = torch.zeros((), dtype=torch.float32, device=mask.device)
    return torch.where(allowed, zero, NEG_INF)[:, None, :, :]
