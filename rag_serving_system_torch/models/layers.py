"""Shared building blocks in PyTorch, counterparts of
`rag_serving_system_tpu.models.layers` with the same layouts: dense weights
are (in, out), attention takes (B, S, H, D), masks are additive f32 biases
with the NEG_INF = -1e9 convention.

Products of bf16 operands accumulate in f32, as the JAX package's
`preferred_element_type=jnp.float32` does, and are cast back to the input
dtype at the end.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NEG_INF = -1.0e9  # additive attention-mask value (f32-safe, avoids NaN in softmax)


def dense(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None) -> torch.Tensor:
    """x: (..., in) @ w: (in, out) [+ b], plain weights only."""
    y = torch.matmul(x, w)
    if b is not None:
        y = y + b
    return y


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
