"""Weight-only int8 / int4 quantization of the decoder (QUANT_WEIGHTS=int8|int4)
and the per-token int8 activations of W8A8 prefill (QUANT_ACT=int8).

Counterpart of `rag_serving_system_tpu/ops/quant.py`, with its shapes and
its bits. int8 weights carry one scale per output channel; int4 weights one
scale per (group of 128 inputs, output channel), two nibbles packed per int8
byte (group half j pairs with half j + g/2: `hi << 4 | lo & 0xF`). The
embedding (the tied LM head) is int8 per row and an untied `lm_head` int8
per column in either mode. Norms and biases keep the compute dtype.

`models.layers.dense` takes a plain tensor or either node; it converts the
integers to the activation dtype at each call and holds no dequantized copy,
so the weight bytes held are the integers and their scales.

Rounding. XLA compiles a division by a constant into a product with the
constant's f32 reciprocal; an eager JAX op divides. The JAX engine quantizes
its weights eagerly (`quantize_int8`, `quantize_rows_int8`, also under
`vmap`), so those divide by 127 here; `quantize_int4` is always jitted and
`quantize_act_int8` always runs inside the jitted prefill, so those multiply
by the f32 reciprocal. The values and scales then equal the JAX engine's bit
for bit (`jax.jit(quantize_int8)` alone would differ in a scale's last bit).
"""

from __future__ import annotations

from typing import NamedTuple, Union

import torch


class QuantizedWeight(NamedTuple):
    q: torch.Tensor        # (in, out) int8
    scale: torch.Tensor    # (1, out) f32, or (V, 1) for a per-row table


class QuantizedWeight4(NamedTuple):
    # the input dim in G groups of g; byte [G, j, out] holds the nibbles of
    # group rows j (low) and j + g/2 (high)
    q: torch.Tensor        # (G, g/2, out) int8
    scale: torch.Tensor    # (G, 1, out) f32


WeightLike = Union[torch.Tensor, QuantizedWeight, QuantizedWeight4]
QUANT_KEYS = frozenset({"qkv_w", "o_w", "gu_w", "down_w", "ff_w1", "ff_w2"})


def _symmetric_int8(wf: torch.Tensor, dim: int) -> tuple[torch.Tensor, torch.Tensor]:
    scale = torch.clamp(wf.abs().amax(dim=dim, keepdim=True), min=1e-8) / 127.0
    q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return q, scale


def quantize_int8(w: torch.Tensor) -> QuantizedWeight:
    """Per-output-channel symmetric quantization of an (in, out) weight; a
    stacked (L, in, out) leaf is quantized matrix by matrix."""
    return QuantizedWeight(*_symmetric_int8(w.float(), dim=-2))


def quantize_rows_int8(w: torch.Tensor) -> QuantizedWeight:
    """Per-row symmetric quantization of a (V, H) embedding table."""
    return QuantizedWeight(*_symmetric_int8(w.float(), dim=-1))


def quantize_act_int8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-token symmetric int8 quantization of activations (..., d):
    (int8 values, (..., 1) f32 scales)."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1, keepdim=True), min=1e-8) * (1.0 / 127.0)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """(..., G, g/2, out) packed int8 → (..., G, g, out) int8 nibble values
    in [-8, 7], sign-extended by two arithmetic shifts."""
    lo = (packed << 4) >> 4
    hi = packed >> 4
    return torch.cat([lo, hi], dim=-2)


def quantize_int4(w: torch.Tensor, group: int = 128) -> QuantizedWeight4:
    """Group-wise symmetric int4 quantization of an (in, out) weight (or a
    stacked (L, in, out) leaf), two nibbles packed per byte."""
    *lead, i, o = w.shape
    g = min(group, i)
    if i % g or g % 2:   # an even group size that divides the input dim
        g = i
    if g % 2:
        raise ValueError(
            f"int4 nibble packing needs an even input dim, got {tuple(w.shape)}; "
            "quantize_decoder_params keeps such weights int8")
    wf = w.float().reshape(*lead, i // g, g, o)
    scale = torch.clamp(wf.abs().amax(dim=-2, keepdim=True), min=1e-8) * (1.0 / 7.0)
    q = torch.clamp(torch.round(wf / scale), -8, 7).to(torch.int32)
    lo, hi = q[..., : g // 2, :], q[..., g // 2:, :]
    # the low byte of the int32 is the packed pattern; values past 127 wrap
    byte = ((hi << 4) | (lo & 0xF)) & 0xFF
    packed = torch.where(byte > 127, byte - 256, byte).to(torch.int8)
    return QuantizedWeight4(q=packed, scale=scale)


def dequantize(qw, dtype=torch.bfloat16) -> torch.Tensor:
    """The floating-point weight (tests and oracles only; the served
    products never build it)."""
    if qw.q.ndim == 3:   # grouped packed int4 → (in, out)
        w = unpack_int4(qw.q).float() * qw.scale
        return w.reshape(-1, w.shape[-1]).to(dtype)
    return (qw.q.float() * qw.scale).to(dtype)


def quantize_decoder_params(params: dict, bits: int = 8, group: int = 128) -> dict:
    """A new tree with every matmul weight of a decoder tree quantized
    (`QUANT_KEYS`, 2-D or stacked (L, in, out)), the embedding per row and an
    untied `lm_head` per column. bits=4: the matmul weights go group-wise
    int4, except those with an odd input dim, which stay int8; the embedding
    and the head stay int8."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")

    def quant_mat(w):
        if bits == 8 or w.shape[-2] % 2:
            return quantize_int8(w)
        return quantize_int4(w, group=group)

    def walk(tree):
        if isinstance(tree, dict):
            out = {}
            for k, v in tree.items():
                nd = v.ndim if isinstance(v, torch.Tensor) else 0
                if k == "embed" and nd == 2:
                    out[k] = quantize_rows_int8(v)
                elif k == "lm_head" and nd == 2:
                    out[k] = quantize_int8(v)
                elif k in QUANT_KEYS and nd in (2, 3):
                    out[k] = quant_mat(v)
                else:
                    out[k] = walk(v)
            return out
        if isinstance(tree, list):
            return [walk(v) for v in tree]
        return tree

    return walk(params)


def weight_bytes(tree) -> int:
    """Bytes of every tensor in a parameter tree (quantized nodes count
    their integers and their scales)."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(weight_bytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(weight_bytes(v) for v in tree)
    return 0
