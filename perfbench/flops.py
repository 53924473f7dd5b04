"""Peaks of the card, and the operations and bytes of the work the metrics
divide by time. All counts come from shapes: corpus rows, real tokens (not
padded buckets), layer widths from the configuration's file.

Peaks: one NVIDIA H100 SXM (80 GB HBM3), NVIDIA's data sheet, dense: 3.35
TB/s of HBM, 67 TFLOP/s of IEEE float32 outside the tensor cores, 989
TFLOP/s of bf16 and 1,979 TOP/s of int8 on the tensor cores, at the card's
700 W power limit. A kernel's least time is the larger of its bytes over the
bandwidth and its operations over its type's peak (each input byte read
once, each output byte written once), as `chip_smoke.py`'s bounds count
them.
"""

from __future__ import annotations

HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"float32": 67e12, "bfloat16": 989e12, "int8": 1979e12}
MODEL_PEAK_FLOP_S = 989e12     # the bf16 tensor-core peak, for `mfu` in every configuration
ELEM_BYTES = {"float32": 4, "bfloat16": 2, "int8": 1}


def topk_least_s(rows: int, dim: int, queries: int, k: int, dtype: str) -> float:
    """B1 (float32 / bfloat16 corpus) or B4 (int8, a float32 scale a row):
    the corpus and the queries read once, k scores and ids a query written;
    2 * queries * rows * dim operations."""
    nbytes = rows * dim * ELEM_BYTES[dtype] + queries * dim * 4 + queries * k * 8
    if dtype == "int8":
        nbytes += rows * 4
    ops = 2.0 * queries * rows * dim
    return max(nbytes / HBM_BYTES_S, ops / PEAK_OPS_S[dtype])


def packed_attn_least_s(seg_lens: list, t: int, hq: int, hk: int, d: int) -> float:
    """B3, one layer's launch over a packed stream of T slots holding the
    segments `seg_lens` (causal within each): q, k, v of the real tokens
    read, o of the real tokens and the zero rows past them written, bf16;
    4 * Hq * D operations a visible (query, key) pair."""
    n_real = sum(seg_lens)
    nbytes = 2 * (n_real * (hq + 2 * hk) * d + t * hq * d)
    pairs = sum(n * (n + 1) // 2 for n in seg_lens)
    ops = 4.0 * hq * d * pairs
    return max(nbytes / HBM_BYTES_S, ops / PEAK_OPS_S["bfloat16"])


def encoder_flops(cfg: dict, n: int) -> float:
    """A forward of e5 over n real tokens: the products and the attention."""
    h, ff, L = int(cfg["hidden_size"]), int(cfg["intermediate_size"]), int(cfg["num_hidden_layers"])
    return L * (2.0 * n * (4 * h * h + 2 * h * ff) + 4.0 * n * n * h)


def decoder_flops(cfg: dict, start: int, end: int, logits: int) -> float:
    """Qwen2.5's forward over positions start..end-1 (the keys of position t
    are 0..t) and `logits` rows of the tied head."""
    h, ff, L = int(cfg["hidden_size"]), int(cfg["intermediate_size"]), int(cfg["num_hidden_layers"])
    hq, hk = int(cfg["num_attention_heads"]), int(cfg["num_key_value_heads"])
    d = int(cfg.get("head_dim") or h // hq)
    per_tok = 2.0 * (h * (hq + 2 * hk) * d + hq * d * h + h * 2 * ff + ff * h)
    n = max(0, end - start)
    keys = (end * (end + 1) - start * (start + 1)) / 2.0    # sum of t + 1 over the positions
    return L * (n * per_tok + 4.0 * hq * d * keys) + 2.0 * h * int(cfg["vocab_size"]) * logits
