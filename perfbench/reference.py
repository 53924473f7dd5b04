"""The plain reference the benchmark holds the served answers to: e5-large's
pooled query embedding, exact cosine ranking over the benchmark's corpus,
and Qwen2.5's logits over a prompt and its served tokens.

Plain PyTorch in float32 (TF32 off), one request at a time, no kernels, no
cache, no batching. It imports nothing of the program: the tokenizer, the
prompt template and the service's pooling are written down here from the
service's published behaviour, and the weights are the tensors the benchmark
made from `weights.MODEL_SEED` (`perfbench/weights.py`), in the same layout:

- e5 (XLM-RoBERTa, post-LayerNorm): word + RoBERTa position (pad id + 1 +
  the count of real tokens; pads at the pad id) + type embeddings, LayerNorm,
  then 24 blocks of fused QKV, softmax attention over the real keys, output
  projection, residual and LayerNorm, erf GELU feed-forward, residual and
  LayerNorm. The service pools with the mean over every position of the
  padded row, pads included (the reference service's `mean_all`), so the
  reference is told the row's padded length.
- Qwen2.5 (pre-RMSNorm decoder): fused QKV with bias, rotary embedding
  (rotate-half, theta 1e6) on positions 0.., causal grouped-query attention
  (query head h reads KV head h // (Hq / Hk)), output projection, SwiGLU,
  final RMSNorm, logits through the tied embedding.

`quant` ("int8") gives the encoder computed in the next precision below
its bf16, for the control only: every weight symmetric int8 per output
channel, and every activation (each product's input and the residual
stream after each LayerNorm) symmetric int8 per token.
"""

from __future__ import annotations

import hashlib
import math
import re

import torch
import torch.nn.functional as F

PROMPT_TEMPLATE = "Context:\n{context}\n\nQuestion: {question}\n\nThe Answer to this question is: "
DOC_JOIN = "\n---\n"
QUERY_PREFIX = "query: "
NEG = -1.0e9


class HashTokenizer:
    """The word-hashing tokenizer both models are served with: words and
    single punctuation marks, each the 4-byte little-endian blake2b of its
    UTF-8 bytes modulo the vocabulary past 10 reserved ids, between a bos
    and an eos."""

    RESERVED = 10
    _word = re.compile(r"\w+|[^\w\s]")

    def __init__(self, vocab_size: int, bos_id: int, eos_id: int, pad_id: int):
        self.vocab_size, self.bos_id, self.eos_id, self.pad_id = vocab_size, bos_id, eos_id, pad_id
        self._memo: dict = {}

    def _id(self, word: str) -> int:
        i = self._memo.get(word)
        if i is None:
            h = int.from_bytes(hashlib.blake2b(word.encode("utf-8"), digest_size=4).digest(),
                               "little")
            i = self._memo[word] = self.RESERVED + h % (self.vocab_size - self.RESERVED)
        return i

    def encode(self, text: str) -> list:
        return [self.bos_id] + [self._id(w) for w in self._word.findall(text)] + [self.eos_id]


def prompt_text(question: str, docs: list) -> str:
    return PROMPT_TEMPLATE.format(context=DOC_JOIN.join(docs), question=question)


# ---------------------------------------------------------------------------
# arithmetic
# ---------------------------------------------------------------------------

def _int8_rows(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to symmetric int8 along `dim` and scaled back."""
    s = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-8) / 127.0
    return torch.round(x / s).clamp(-127, 127) * s


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None = None,
           quant: str | None = None) -> torch.Tensor:
    """x (..., in) @ w (in, out) + b, in f32."""
    wf = w.float()
    xf = x.float()
    if quant == "int8":
        wf = _int8_rows(wf, dim=0)
        xf = _int8_rows(xf, dim=-1)
    elif quant is not None:
        raise ValueError(f"quant {quant!r}")
    y = xf @ wf
    return y if b is None else y + b.float()


def _act(x: torch.Tensor, quant: str | None) -> torch.Tensor:
    return _int8_rows(x, dim=-1) if quant == "int8" else x


def _layer_norm(x, scale, bias, eps):
    return F.layer_norm(x, (x.shape[-1],), scale.float(), bias.float(), eps)


def _rms_norm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps) * scale.float()


# ---------------------------------------------------------------------------
# e5
# ---------------------------------------------------------------------------

@torch.no_grad()
def e5_pooled(w: dict, cfg: dict, ids: list, padded_len: int,
              quant: str | None = None, device=None) -> torch.Tensor:
    """The service's pooled (H,) f32 embedding of one token row right-padded
    to `padded_len`."""
    pad = int(cfg["pad_token_id"])
    h, nh = int(cfg["hidden_size"]), int(cfg["num_attention_heads"])
    d = h // nh
    eps = float(cfg["layer_norm_eps"])
    n = len(ids)
    t = torch.full((padded_len,), pad, dtype=torch.long, device=device)
    t[:n] = torch.as_tensor(ids, dtype=torch.long, device=device)
    real = torch.zeros(padded_len, dtype=torch.bool, device=device)
    real[:n] = True
    pos = torch.cumsum((t != pad).long(), 0) * (t != pad).long() + pad
    e = w["embed"]
    x = e["word"][t].float() + e["pos"][pos].float() + e["type"][0].float()
    x = _act(_layer_norm(x, e["ln_scale"], e["ln_bias"], eps), quant)
    key_bias = torch.where(real, 0.0, NEG)[None, None, :]
    L = w["layers"]
    for i in range(int(cfg["num_hidden_layers"])):
        qkv = linear(x, L["qkv_w"][i], L["qkv_b"][i], quant)
        q, k, v = (qkv[:, j * h:(j + 1) * h].reshape(padded_len, nh, d).transpose(0, 1)
                   for j in range(3))
        p = torch.softmax(q @ k.transpose(1, 2) / math.sqrt(d) + key_bias, dim=-1)
        a = (p @ v).transpose(0, 1).reshape(padded_len, h)
        x = _act(_layer_norm(x + linear(a, L["o_w"][i], L["o_b"][i], quant),
                             L["attn_ln_scale"][i], L["attn_ln_bias"][i], eps), quant)
        f = linear(F.gelu(linear(x, L["ff_w1"][i], L["ff_b1"][i], quant)),
                   L["ff_w2"][i], L["ff_b2"][i], quant)
        x = _act(_layer_norm(x + f, L["ff_ln_scale"][i], L["ff_ln_bias"][i], eps), quant)
    return x.mean(dim=0)


# ---------------------------------------------------------------------------
# Qwen2.5
# ---------------------------------------------------------------------------

def _rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (T, H, D) rotated by positions (T,), rotate-half layout."""
    d = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
    ang = pos.float()[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


@torch.no_grad()
def qwen_logits(w: dict, cfg: dict, ids: list, at: list, device=None) -> torch.Tensor:
    """(len(at), V) f32 logits at positions `at` of the token row `ids`
    (positions 0.., causal)."""
    h = int(cfg["hidden_size"])
    hq, hk = int(cfg["num_attention_heads"]), int(cfg["num_key_value_heads"])
    d = int(cfg.get("head_dim") or h // hq)
    eps = float(cfg["rms_norm_eps"])
    theta = float(cfg["rope_theta"])
    T = len(ids)
    t = torch.as_tensor(ids, dtype=torch.long, device=device)
    pos = torch.arange(T, device=device)
    x = w["embed"][t].float()
    causal = torch.full((T, T), NEG, device=device).triu(1)
    L = w["layers"]
    g = hq // hk
    for i in range(int(cfg["num_hidden_layers"])):
        y = _rms_norm(x, L["ln1"][i], eps)
        qkv = linear(y, L["qkv_w"][i], L["qkv_b"][i] if "qkv_b" in L else None)
        q = _rope(qkv[:, :hq * d].reshape(T, hq, d), pos, theta)
        k = _rope(qkv[:, hq * d:(hq + hk) * d].reshape(T, hk, d), pos, theta)
        v = qkv[:, (hq + hk) * d:].reshape(T, hk, d)
        k = k.repeat_interleave(g, dim=1)
        v = v.repeat_interleave(g, dim=1)
        s = torch.einsum("thd,shd->hts", q, k) / math.sqrt(d) + causal
        a = torch.einsum("hts,shd->thd", torch.softmax(s, dim=-1), v).reshape(T, hq * d)
        x = x + linear(a, L["o_w"][i])
        y = _rms_norm(x, L["ln2"][i], eps)
        gu = linear(y, L["gu_w"][i])
        f = gu.shape[-1] // 2
        x = x + linear(F.silu(gu[:, :f]) * gu[:, f:], L["down_w"][i])
    y = _rms_norm(x[torch.as_tensor(at, device=device)], w["ln_f"], eps)
    head = w.get("lm_head")
    return y @ (head.float() if head is not None else w["embed"].float().T)


# ---------------------------------------------------------------------------
# retrieval
# ---------------------------------------------------------------------------

def normalize(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    return x / x.norm(dim=-1, keepdim=True).clamp(min=1e-12)


def lower_corpus(corpus: torch.Tensor, kind: str) -> tuple:
    """(rows, a function of a query) at a lower precision, for the control:
    `bfloat16` rounds rows and queries to bf16; `int4` rounds the
    mean-centred rows and the query to symmetric 4-bit per row."""
    if kind == "bfloat16":
        return corpus.to(torch.bfloat16).float(), lambda q: q.to(torch.bfloat16).float()
    if kind == "int4":
        mean = corpus.mean(dim=0, keepdim=True)

        def q4(x):
            s = x.abs().amax(dim=-1, keepdim=True).clamp(min=1e-12) / 7.0
            return torch.round(x / s).clamp(-8, 7) * s
        rows = torch.empty_like(corpus)
        for lo in range(0, corpus.shape[0], 1 << 18):
            rows[lo:lo + (1 << 18)] = q4(corpus[lo:lo + (1 << 18)] - mean) + mean
        return rows, q4
    raise ValueError(f"control corpus {kind!r}")
