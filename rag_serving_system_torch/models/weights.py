"""Random-init parameters at full width, and the converters of JAX parameter
trees, prefix-KV entries and IVF indexes.

Counterpart of `rag_serving_system_tpu/models/weights.py:31-102`. The trees
keep the JAX layout: dense weights (in, out), layer weights stacked on a
leading L axis, the decoder's `lm_head` omitted when tied to `embed`. The
HF safetensors loader is not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch

from rag_serving_system_torch.models.configs import DecoderConfig, EncoderConfig


def _trunc_normal(g: torch.Generator, shape, dtype, device, std=0.02):
    """Normal clipped to +-2 sigma, times std: the JAX init's distribution
    (not its bits: torch.Generator and jax.random differ)."""
    x = torch.randn(shape, generator=g, dtype=torch.float32, device=device)
    return x.clamp_(-2.0, 2.0).mul_(std).to(dtype)


def init_encoder_params(cfg: EncoderConfig, seed: int = 0, dtype=torch.bfloat16,
                        device="cpu") -> dict:
    g = torch.Generator(device=device).manual_seed(seed)
    h, ff, n = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers

    def rnd(*shape):
        return _trunc_normal(g, shape, dtype, device)

    def const(value, *shape):
        return torch.full(shape, value, dtype=dtype, device=device)

    return {
        "embed": {
            "word": rnd(cfg.vocab_size, h),
            "pos": rnd(cfg.max_position_embeddings, h),
            "type": rnd(cfg.type_vocab_size, h),
            "ln_scale": const(1.0, h),
            "ln_bias": const(0.0, h),
        },
        "layers": {
            "qkv_w": rnd(n, h, 3 * h),
            "qkv_b": const(0.0, n, 3 * h),
            "o_w": rnd(n, h, h),
            "o_b": const(0.0, n, h),
            "attn_ln_scale": const(1.0, n, h),
            "attn_ln_bias": const(0.0, n, h),
            "ff_w1": rnd(n, h, ff),
            "ff_b1": const(0.0, n, ff),
            "ff_w2": rnd(n, ff, h),
            "ff_b2": const(0.0, n, h),
            "ff_ln_scale": const(1.0, n, h),
            "ff_ln_bias": const(0.0, n, h),
        },
    }


def init_decoder_params(cfg: DecoderConfig, seed: int = 1, dtype=torch.bfloat16,
                        device="cpu") -> dict:
    g = torch.Generator(device=device).manual_seed(seed)
    h, n, ff = cfg.hidden_size, cfg.num_layers, cfg.intermediate_size
    qkv = (cfg.num_heads + 2 * cfg.num_kv_heads) * cfg.head_dim

    def rnd(*shape):
        return _trunc_normal(g, shape, dtype, device)

    params = {
        "embed": rnd(cfg.vocab_size, h),
        "layers": {
            "ln1": torch.ones((n, h), dtype=dtype, device=device),
            "qkv_w": rnd(n, h, qkv),
            "o_w": rnd(n, cfg.num_heads * cfg.head_dim, h),
            "ln2": torch.ones((n, h), dtype=dtype, device=device),
            "gu_w": rnd(n, h, 2 * ff),
            "down_w": rnd(n, ff, h),
        },
        "ln_f": torch.ones((h,), dtype=dtype, device=device),
    }
    if cfg.qkv_bias:
        params["layers"]["qkv_b"] = torch.zeros((n, qkv), dtype=dtype, device=device)
    if not cfg.tie_word_embeddings:
        params["lm_head"] = rnd(h, cfg.vocab_size)
    return params


def _tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes: reinterpret the 16 bits
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_jax(tree, device="cpu"):
    """A JAX parameter tree (dicts of arrays; numpy or jax leaves) as the
    port's tree of tensors. The layouts already agree, so this is a
    leaf-by-leaf copy. A quantized node of the JAX package
    (`QuantizedWeight`, `QuantizedWeight4`: a named tuple of `q` and
    `scale`) becomes the port's node of the same name with the same bits."""
    from rag_serving_system_torch.ops.quant import QuantizedWeight, QuantizedWeight4

    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [params_from_jax(v, device) for v in tree]
    if hasattr(tree, "q") and hasattr(tree, "scale"):
        node = QuantizedWeight4 if type(tree).__name__ == "QuantizedWeight4" else QuantizedWeight
        return node(_tensor(tree.q, device), _tensor(tree.scale, device))
    return _tensor(tree, device)


def prefix_kv_from_jax(kv, device="cpu"):
    """A JAX prefix-KV batch (M, L, 2, PL, Hk, D) (numpy or jax leaves), or
    its (int8 values, f32 scales) pair, as the port's tensors: what
    `qwen2.prefill(prefix_kv=...)` takes."""
    if isinstance(kv, (tuple, list)):
        return tuple(_tensor(leaf, device) for leaf in kv)
    return _tensor(kv, device)


def ivf_index_from_jax(index, device="cpu"):
    """A JAX `IvfIndex` (numpy or jax leaves) as the port's `IvfIndex`."""
    from rag_serving_system_torch.ops.ivf import IvfIndex

    return IvfIndex(*(_tensor(leaf, device) for leaf in index))
