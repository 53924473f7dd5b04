"""XLM-RoBERTa-family encoder (e5-large) on dicts of tensors.

Counterpart of `rag_serving_system_tpu/models/e5.py:39-128`. Pooling is the
reference's unmasked mean over every position, pads included (parity with
the upstream service, not a bug to fix). Encoder attention stays plain
torch: the JAX encoder uses einsum attention too, not a Pallas kernel.
"""

from __future__ import annotations

import torch

from rag_serving_system_torch.models.configs import EncoderConfig
from rag_serving_system_torch.models.layers import (
    attention,
    dense,
    gelu,
    layer_norm,
    padding_bias,
)


def roberta_position_ids(input_ids: torch.Tensor, pad_token_id: int) -> torch.Tensor:
    """RoBERTa: positions count non-pad tokens, offset by pad_token_id + 1;
    pad positions get pad_token_id."""
    mask = (input_ids != pad_token_id).to(torch.int64)
    return torch.cumsum(mask, dim=-1) * mask + pad_token_id


def position_ids(cfg: EncoderConfig, input_ids: torch.Tensor) -> torch.Tensor:
    if cfg.position_style == "roberta":
        return roberta_position_ids(input_ids, cfg.pad_token_id)
    b, n = input_ids.shape
    return torch.arange(n, device=input_ids.device).expand(b, n)


def encoder_forward(params: dict, cfg: EncoderConfig, input_ids: torch.Tensor,
                    attention_mask: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """(B, L) ids and {0, 1} mask → last hidden state (B, L, H)."""
    emb = params["embed"]
    max_l = emb["pos"].shape[0] - (cfg.pad_token_id + 1
                                   if cfg.position_style == "roberta" else 0)
    if input_ids.shape[1] > max_l:
        raise ValueError(
            f"sequence length {input_ids.shape[1]} exceeds the position "
            f"table ({max_l} usable rows); truncate or bucket the input")
    x = (emb["word"][input_ids] + emb["pos"][position_ids(cfg, input_ids)]
         + emb["type"][0]).to(dtype)
    x = layer_norm(x, emb["ln_scale"], emb["ln_bias"], cfg.layer_norm_eps)
    bias = padding_bias(attention_mask)
    b, n = input_ids.shape
    h, d = cfg.num_heads, cfg.head_dim
    for i in range(cfg.num_layers):
        layer = {name: w[i] for name, w in params["layers"].items()}
        qkv = dense(x, layer["qkv_w"], layer["qkv_b"])
        q, k, v = (qkv[..., j * h * d:(j + 1) * h * d].reshape(b, n, h, d)
                   for j in range(3))
        a = dense(attention(q, k, v, bias).reshape(b, n, h * d),
                  layer["o_w"], layer["o_b"])
        x = layer_norm(x + a, layer["attn_ln_scale"], layer["attn_ln_bias"],
                       cfg.layer_norm_eps)
        f = dense(gelu(dense(x, layer["ff_w1"], layer["ff_b1"])),
                  layer["ff_w2"], layer["ff_b2"])
        x = layer_norm(x + f, layer["ff_ln_scale"], layer["ff_ln_bias"],
                       cfg.layer_norm_eps)
    return x


@torch.inference_mode()
def encode(params: dict, cfg: EncoderConfig, input_ids: torch.Tensor,
           attention_mask: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """Pooled (B, H) f32 embeddings: the mean over all L positions."""
    hidden = encoder_forward(params, cfg, input_ids, attention_mask, dtype=dtype)
    return hidden.float().mean(dim=1)
