"""XLM-RoBERTa-family encoder (e5-large) on dicts of tensors.

Counterpart of `rag_serving_system_tpu/models/e5.py:39-128`. The engine
pools with the reference's unmasked mean over every position, pads included
(`mean_all`: parity with the upstream service, not a bug to fix); the
trainer pools with the masked mean (`mean_masked`), and `cls` takes the
first position. Encoder attention stays plain torch: the JAX encoder uses
einsum attention too, not a Pallas kernel.

Under tensor parallelism (`parallel/tp.py`) each model position runs this
forward on its slices: its head count is read from its qkv width, and the
attention output and FF output products are summed over the positions
(`row_parallel`) before their biases.
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
from rag_serving_system_torch.parallel.tp import row_parallel


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
    d = cfg.head_dim
    # each stacked weight unbound once: under autograd the backward stacks
    # the L layer gradients in one op, where indexing w[i] a layer would
    # build and add L zero-padded gradients of the whole stack
    stacked = {name: w.unbind(0) for name, w in params["layers"].items()}
    for i in range(cfg.num_layers):
        layer = {name: ws[i] for name, ws in stacked.items()}
        qkv = dense(x, layer["qkv_w"], layer["qkv_b"])
        h = qkv.shape[-1] // (3 * d)    # this position's heads (all, on one device)
        q, k, v = (qkv[..., j * h * d:(j + 1) * h * d].reshape(b, n, h, d)
                   for j in range(3))
        a = row_parallel(dense, attention(q, k, v, bias).reshape(b, n, h * d),
                         layer["o_w"], layer["o_b"], "attn")
        x = layer_norm(x + a, layer["attn_ln_scale"], layer["attn_ln_bias"],
                       cfg.layer_norm_eps)
        f = row_parallel(dense, gelu(dense(x, layer["ff_w1"], layer["ff_b1"])),
                         layer["ff_w2"], layer["ff_b2"], "mlp")
        x = layer_norm(x + f, layer["ff_ln_scale"], layer["ff_ln_bias"],
                       cfg.layer_norm_eps)
    return x


def pool(hidden: torch.Tensor, attention_mask: torch.Tensor,
         pooling: str = "mean_all") -> torch.Tensor:
    """(B, L, H) hidden states → (B, H) f32: `mean_all` (every position),
    `mean_masked` (real positions over max(count, 1)) or `cls` (position 0)."""
    hf = hidden.float()
    if pooling == "mean_all":
        return hf.mean(dim=1)
    if pooling == "mean_masked":
        m = attention_mask.float()[:, :, None]
        return (hf * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1.0)
    if pooling == "cls":
        return hf[:, 0, :]
    raise ValueError(f"unknown pooling: {pooling}")


@torch.inference_mode()
def encode(params: dict, cfg: EncoderConfig, input_ids: torch.Tensor,
           attention_mask: torch.Tensor, pooling: str = "mean_all",
           dtype=torch.bfloat16) -> torch.Tensor:
    """Pooled (B, H) f32 embeddings, under inference mode (no autograd: the
    trainer calls `encoder_forward` and `pool` itself)."""
    hidden = encoder_forward(params, cfg, input_ids, attention_mask, dtype=dtype)
    return pool(hidden, attention_mask, pooling)
