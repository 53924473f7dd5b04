"""Weights and corpus from one fixed seed, `MODEL_SEED`, made on the device
in a few large calls. Every run serves the same models over the same
corpus, whatever its `--seed`: the run's seed orders the traffic, and does
not change the work (a seed of its own for the weights would pick other
contexts for every question, and so other prompt lengths).

The weights are e5-large's and Qwen2.5's trees in the layout the port's
engine takes through its `enc_params` / `dec_params` setters: matrices (in,
out), layers stacked on a leading axis, QKV and gate/up fused, the LM head
tied to the embedding. Every matrix of a model is a view of one flat bf16
buffer drawn in one call: a normal with the published `initializer_range`
as its deviation, as the models' own `_init_weights` draws it (not clipped:
a channel's largest weight, which sets its int8 scale, lies at 3-4
deviations as in a trained model's heavier tails, not at a clip's 2);
norms are 1 and biases 0. Row 0 of the decoder's
embedding is zero: it is the hash tokenizer's bos, which the service's
answer text drops, so a zero row (a logit of exactly 0, never the largest)
keeps every served token in the text.

The corpus is unit-normal rows from the seed, with the direction that every
query embedding of the seeded encoder shares taken out (`shared_direction`,
from the reference's embeddings of squad_real's first 128 questions), and
L2-normalised in float32.
The same seed gives the same tensors, so the reference makes them again
after the window instead of keeping a copy beside the program.
"""

from __future__ import annotations

import math

import torch

from perfbench.generator import sub_seed

# the draw whose sound and control readings set the limits on seed 101
MODEL_SEED = 101


def _views(shapes: dict, std: float, seed: int, device, dtype=torch.bfloat16) -> dict:
    total = sum(math.prod(s) for s in shapes.values())
    g = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=g, dtype=dtype, device=device)
    flat.mul_(std)
    out, off = {}, 0
    for name, s in shapes.items():
        n = math.prod(s)
        out[name] = flat[off:off + n].view(*s)
        off += n
    return out


def encoder(cfg: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    h, ff, n = int(cfg["hidden_size"]), int(cfg["intermediate_size"]), int(cfg["num_hidden_layers"])
    r = _views({"word": (int(cfg["vocab_size"]), h),
                "pos": (int(cfg["max_position_embeddings"]), h),
                "type": (int(cfg["type_vocab_size"]), h),
                "qkv_w": (n, h, 3 * h), "o_w": (n, h, h),
                "ff_w1": (n, h, ff), "ff_w2": (n, ff, h)},
               float(cfg["initializer_range"]), sub_seed(seed, "encoder"), device, dtype)

    def const(v, *shape):
        return torch.full(shape, v, dtype=dtype, device=device)

    return {
        "embed": {"word": r["word"], "pos": r["pos"], "type": r["type"],
                  "ln_scale": const(1.0, h), "ln_bias": const(0.0, h)},
        "layers": {"qkv_w": r["qkv_w"], "qkv_b": const(0.0, n, 3 * h),
                   "o_w": r["o_w"], "o_b": const(0.0, n, h),
                   "attn_ln_scale": const(1.0, n, h), "attn_ln_bias": const(0.0, n, h),
                   "ff_w1": r["ff_w1"], "ff_b1": const(0.0, n, ff),
                   "ff_w2": r["ff_w2"], "ff_b2": const(0.0, n, h),
                   "ff_ln_scale": const(1.0, n, h), "ff_ln_bias": const(0.0, n, h)},
    }


def decoder(cfg: dict, seed: int, device, dtype=torch.bfloat16) -> dict:
    h, ff, n = int(cfg["hidden_size"]), int(cfg["intermediate_size"]), int(cfg["num_hidden_layers"])
    hq, hk = int(cfg["num_attention_heads"]), int(cfg["num_key_value_heads"])
    d = int(cfg.get("head_dim") or h // hq)
    qkv = (hq + 2 * hk) * d
    r = _views({"embed": (int(cfg["vocab_size"]), h), "qkv_w": (n, h, qkv),
                "o_w": (n, hq * d, h), "gu_w": (n, h, 2 * ff), "down_w": (n, ff, h)},
               float(cfg["initializer_range"]), sub_seed(seed, "decoder"), device, dtype)
    r["embed"][0].zero_()
    ones = torch.ones((n, h), dtype=dtype, device=device)
    out = {"embed": r["embed"],
           "layers": {"ln1": ones, "qkv_w": r["qkv_w"], "qkv_b": torch.zeros((n, qkv), dtype=dtype, device=device),
                      "o_w": r["o_w"], "ln2": ones.clone(), "gu_w": r["gu_w"], "down_w": r["down_w"]},
           "ln_f": torch.ones((h,), dtype=dtype, device=device)}
    if not cfg.get("tie_word_embeddings", True):
        raise ValueError("the benchmark's decoders tie the LM head to the embedding")
    return out


def corpus(rows: int, dim: int, seed: int, device, away: torch.Tensor | None = None) -> torch.Tensor:
    """(rows, dim) f32 unit rows, orthogonal to the unit vector `away` when
    it is given."""
    g = torch.Generator(device=device).manual_seed(sub_seed(seed, "corpus"))
    c = torch.randn((rows, dim), generator=g, dtype=torch.float32, device=device)
    if away is not None:
        away = away.to(device=device, dtype=torch.float32)
    for lo in range(0, rows, 1 << 18):
        blk = c[lo:lo + (1 << 18)]
        if away is not None:
            blk.sub_((blk @ away)[:, None] * away[None, :])
        blk.div_(blk.norm(dim=-1, keepdim=True).clamp_(min=1e-12))
    return c


def shared_direction(enc: dict, cfg: dict, tokenizer, texts: list, buckets: list,
                     device) -> torch.Tensor:
    """The unit mean of the reference's pooled embeddings of `texts`: the
    direction every query of a randomly initialised encoder shares (their
    cosines to each other are ~0.96). A corpus orthogonal to it ranks by
    what tells the queries apart; one that is not returns the same rows to
    every query."""
    from perfbench import reference as ref

    w32 = {k: {kk: vv.float() for kk, vv in v.items()} for k, v in enc.items()}
    acc = torch.zeros(int(cfg["hidden_size"]), dtype=torch.float32, device=device)
    for t in texts:
        ids = tokenizer.encode(ref.QUERY_PREFIX + t)
        padded = next((b for b in sorted(buckets) if len(ids) <= b), max(buckets))
        acc += ref.normalize(ref.e5_pooled(w32, cfg, ids, padded, device=device))
    return (acc / acc.norm()).cpu()
