"""Model architecture configs: e5-large (XLM-RoBERTa) and Qwen2.5-1.5B.

A copy of `rag_serving_system_tpu/models/configs.py`. The `*_TINY` presets
keep the architectures at toy size for the CPU tests; `*_config_from_hf`
read an architecture from a checkpoint's config.json.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class EncoderConfig:
    """BERT/XLM-RoBERTa-family bidirectional encoder (post-LayerNorm)."""
    vocab_size: int = 250002
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    max_position_embeddings: int = 514
    type_vocab_size: int = 1
    layer_norm_eps: float = 1e-5
    pad_token_id: int = 1          # RoBERTa: position ids offset by pad_token_id + 1
    # "roberta": positions = cumsum(non-pad) + pad_token_id (XLM-R/e5);
    # "absolute": positions = 0..L-1 (BERT family)
    position_style: str = "roberta"

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


@dataclass(frozen=True)
class DecoderConfig:
    """Llama-family causal decoder: pre-RMSNorm, RoPE, GQA, SwiGLU.
    Qwen2 = the same architecture with QKV bias on (qkv_bias=True)."""
    vocab_size: int = 151936
    hidden_size: int = 1536
    num_layers: int = 28
    num_heads: int = 12
    num_kv_heads: int = 2
    head_dim: int = 128
    intermediate_size: int = 8960
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1_000_000.0
    tie_word_embeddings: bool = True
    max_position_embeddings: int = 32768
    eos_token_id: int = 151645     # <|im_end|> (primary)
    pad_token_id: int = 151643     # <|endoftext|>
    # every id that ends generation (Qwen2.5-Instruct's generation_config)
    eos_token_ids: tuple = (151645, 151643)
    qkv_bias: bool = True          # Qwen2 yes; Llama/Mistral no


E5_LARGE = EncoderConfig()

E5_TINY = EncoderConfig(
    vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
    intermediate_size=128, max_position_embeddings=514)

QWEN25_15B = DecoderConfig()

QWEN2_TINY = DecoderConfig(
    vocab_size=512, hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
    head_dim=16, intermediate_size=128, eos_token_id=1, pad_token_id=0,
    eos_token_ids=(1,))

LLAMA32_1B = DecoderConfig(
    vocab_size=128256, hidden_size=2048, num_layers=16, num_heads=32,
    num_kv_heads=8, head_dim=64, intermediate_size=8192,
    rms_norm_eps=1e-5, rope_theta=500_000.0, tie_word_embeddings=True,
    eos_token_id=128009, pad_token_id=128001, qkv_bias=False,
    eos_token_ids=(128001, 128008, 128009))


def encoder_config_for(preset: str) -> EncoderConfig:
    return E5_TINY if preset == "tiny" else E5_LARGE


def decoder_config_for(preset: str) -> DecoderConfig:
    if preset == "tiny":
        return QWEN2_TINY
    if preset == "llama":
        return LLAMA32_1B
    return QWEN25_15B


def decoder_config_from_hf(hf: dict) -> DecoderConfig:
    """A DecoderConfig from an HF snapshot's config.json dict. Covers the
    Llama family (llama / mistral / qwen2): pre-RMSNorm, RoPE, GQA, SwiGLU;
    Qwen2 has a QKV bias besides."""
    mt = hf.get("model_type", "llama")
    heads = hf["num_attention_heads"]
    eos = hf.get("eos_token_id", 2)
    eos_all = tuple(eos) if isinstance(eos, list) else (eos,)
    eos = eos_all[0]
    pad = hf.get("pad_token_id")
    return DecoderConfig(
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        num_layers=hf["num_hidden_layers"],
        num_heads=heads,
        num_kv_heads=hf.get("num_key_value_heads", heads),
        head_dim=hf.get("head_dim") or hf["hidden_size"] // heads,
        intermediate_size=hf["intermediate_size"],
        rms_norm_eps=hf.get("rms_norm_eps", 1e-6),
        rope_theta=hf.get("rope_theta", 10_000.0),
        tie_word_embeddings=hf.get("tie_word_embeddings", False),
        max_position_embeddings=hf.get("max_position_embeddings", 4096),
        eos_token_id=eos,
        eos_token_ids=eos_all,
        pad_token_id=pad if pad is not None else eos,
        qkv_bias=hf.get("attention_bias", mt == "qwen2"),
    )


def encoder_config_from_hf(hf: dict) -> EncoderConfig:
    """An EncoderConfig from an HF config.json dict (bert / roberta /
    xlm-roberta: one weight layout, two position-id conventions)."""
    mt = hf.get("model_type", "bert")
    pad = hf.get("pad_token_id", 1 if "roberta" in mt else 0)
    return EncoderConfig(
        vocab_size=hf["vocab_size"],
        hidden_size=hf["hidden_size"],
        num_layers=hf["num_hidden_layers"],
        num_heads=hf["num_attention_heads"],
        intermediate_size=hf["intermediate_size"],
        max_position_embeddings=hf["max_position_embeddings"],
        type_vocab_size=hf.get("type_vocab_size", 1),
        layer_norm_eps=hf.get("layer_norm_eps", 1e-5),
        pad_token_id=pad,
        position_style="roberta" if "roberta" in mt else "absolute",
    )
