"""Qwen2 (`decoder.model_type` "qwen2", Qwen2.5's): pre-RMSNorm, fused QKV
with bias, rotary embedding, grouped-query attention, SwiGLU, the LM head
tied to the embedding.

The five names the harness finds a decoder architecture by (README, "Adding
to it"), bound to the arithmetic of `weights.py`, `reference.py` and
`flops.py`.
"""

from __future__ import annotations

from perfbench import flops as _flops
from perfbench import reference as _ref
from perfbench import weights as _weights
from perfbench.judge import _float

# the tree the engine's `dec_params` setter takes, drawn from the seed
weights = _weights.decoder

# model FLOPs of positions start..end-1 and `logits` rows of the head
flops = _flops.decoder_flops

# configuration key -> the engine's `DecoderConfig` attribute, checked at set-up
ENGINE_KEYS = {"vocab_size": "vocab_size", "hidden_size": "hidden_size",
               "num_hidden_layers": "num_layers", "num_attention_heads": "num_heads",
               "num_key_value_heads": "num_kv_heads", "intermediate_size": "intermediate_size",
               "rms_norm_eps": "rms_norm_eps", "rope_theta": "rope_theta",
               "eos_token_id": "eos_token_id"}


def reference(cfg: dict, seed: int, device):
    """`logits(ids, at)`: the plain f32 forward's (len(at), V) logits at
    positions `at` of the token row `ids`, over the whole tree held in f32."""
    w = _float(_weights.decoder(cfg, seed, device))

    def logits(ids: list, at: list):
        return _ref.qwen_logits(w, cfg, ids, at, device=device)
    return logits


def pass_launches(cfg: dict) -> dict:
    """The launches one decoder pass makes at least: a SiLU a layer."""
    return {"silu": int(cfg["num_hidden_layers"])}
