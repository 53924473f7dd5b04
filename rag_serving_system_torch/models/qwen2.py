"""Qwen2-family causal decoder (Qwen2.5-1.5B-Instruct) on dicts of tensors.

Counterpart of `rag_serving_system_tpu/models/qwen2.py`. The parameter tree
is the JAX one:
dense weights (in, out), QKV fused into one matmul and gate+up into another,
layer weights stacked on a leading L axis (the forwards loop over it),
`lm_head` omitted when tied to `embed`. Matmul weights, the embedding and
the head may be the quantized nodes of `ops/quant.py`; `act_quant` sends the
prefill products through `dense_w8a8` (decode never quantizes activations).

Every prefill whose queries and keys have one length goes through a kernel
wrapper: padded prompts and the prefix-KV compute through B2
(`ops.attention.flash_attention`), packed streams through B3
(`flash_attention_packed`), whatever the prompt length or head size. The
suffix prefill over cached prefix K/V (queries shorter than keys) and the
single-token decode attention are plain torch, as both are einsum in the
JAX package.
The fixed decode loop runs on the host, one step per iteration, and stops
as soon as every row is done. With `spec_gamma` > 0 (greedy only) the loop
is speculative: `draft_ngram` proposes gamma tokens a row from the row's own
history, `decode_step_spec` verifies them in one forward over gamma + 1
positions, and the longest matching prefix plus one token is emitted, so an
iteration yields 1 to gamma + 1 tokens. Its attention is plain torch too.
`decode_chunk` is the continuous mode's step:
`chunk` steps over the slot pool of `core/decode_pool.py` with no host read
between them.

Under tensor parallelism (`parallel/tp.py`) each model position runs these
functions on its slices with a config of its local head counts; the
attention output product and the MLP down product of every layer go through
`row_parallel`, which sums them over the positions (the plain product on
one device).
"""

from __future__ import annotations

import time
from typing import NamedTuple

import torch

from rag_serving_system_torch.models.configs import DecoderConfig
from rag_serving_system_torch.models.layers import (
    NEG_INF,
    apply_rope,
    attention,
    causal_padding_bias,
    dense,
    dense_w8a8,
    rms_norm,
    rope_freqs,
    silu,
)
from rag_serving_system_torch.ops.attention import (
    flash_attention,
    flash_attention_packed,
)
from rag_serving_system_torch.parallel.tp import row_parallel


class KVCache(NamedTuple):
    # (L, B, T_max, Hk, D) each; decode writes one slot per step in place
    k: torch.Tensor
    v: torch.Tensor


def _layer(params: dict, i: int) -> dict:
    """Layer i's weights; a quantized node is sliced field by field."""
    return {name: (type(w)(w.q[i], w.scale[i]) if hasattr(w, "q") else w[i])
            for name, w in params["layers"].items()}


def _qkv(layer, cfg, x, b, s, act_quant=False):
    qd = cfg.num_heads * cfg.head_dim
    kvd = cfg.num_kv_heads * cfg.head_dim
    mm = dense_w8a8 if act_quant else dense
    qkv = mm(x, layer["qkv_w"], layer.get("qkv_b"))
    q = qkv[..., :qd].reshape(b, s, cfg.num_heads, cfg.head_dim)
    k = qkv[..., qd:qd + kvd].reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    v = qkv[..., qd + kvd:].reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    return q, k, v.contiguous()


def _mlp(layer, x, act_quant=False):
    mm = dense_w8a8 if act_quant else dense
    gu = mm(x, layer["gu_w"])
    f = gu.shape[-1] // 2
    return row_parallel(mm, silu(gu[..., :f]) * gu[..., f:], layer["down_w"], None, "mlp")


def _layer_forward(layer, cfg, x, positions, inv_freq, b, p, attend,
                   act_quant=False):
    """One block: norm → fused QKV → RoPE → `attend(q, k, v)` → output
    projection → MLP. Returns (x, k, v) with k after RoPE."""
    h = rms_norm(x, layer["ln1"], cfg.rms_norm_eps)
    q, k, v = _qkv(layer, cfg, h, b, p, act_quant)
    q = apply_rope(q, positions, inv_freq)
    k = apply_rope(k, positions, inv_freq)
    a = attend(q, k, v).reshape(b, p, cfg.num_heads * cfg.head_dim)
    mm = dense_w8a8 if act_quant else dense
    x = x + row_parallel(mm, a, layer["o_w"], None, "attn")
    h = rms_norm(x, layer["ln2"], cfg.rms_norm_eps)
    return x + _mlp(layer, h, act_quant), k, v


def embed_lookup(params: dict, ids: torch.Tensor, dtype) -> torch.Tensor:
    """Token embedding gather; an int8 per-row table gathers values and
    scales and multiplies them in f32."""
    emb = params["embed"]
    if hasattr(emb, "q"):
        return (emb.q[ids].float() * emb.scale[ids]).to(dtype)
    return emb[ids].to(dtype)


def logits_from_hidden(params: dict, cfg: DecoderConfig, x: torch.Tensor) -> torch.Tensor:
    """Final norm and LM head, tied or untied → f32 logits. The product runs
    in f32 on upcast operands: bf16 products are exact in f32, so this is
    XLA's bf16-in, f32-accumulate, f32-out einsum. A quantized head
    multiplies by the raw integers and scales the output column."""
    x = rms_norm(x, params["ln_f"], cfg.rms_norm_eps).float()
    head = params.get("lm_head")
    if head is not None:
        if hasattr(head, "q"):
            return (x @ head.q.float()) * head.scale[0]
        return x @ head.float()
    emb = params["embed"]
    if hasattr(emb, "q"):   # tied int8 head: logits_v = scale_v * (x . q_v)
        return (x @ emb.q.float().T) * emb.scale[:, 0]
    return x @ emb.float().T


def _new_cache(cfg, b, t_max, dtype, device) -> KVCache:
    shape = (cfg.num_layers, b, t_max, cfg.num_kv_heads, cfg.head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def _prefix_mask(prefix_len: torch.Tensor, pool_len: int) -> torch.Tensor:
    """(B, PL) bool: prefix slot j of row b is valid iff j < prefix_len[b]."""
    return torch.arange(pool_len, device=prefix_len.device)[None, :] < prefix_len[:, None]


def _combined_mask(attention_mask, prefix_kv, prefix_len) -> torch.Tensor:
    """[prefix mask | suffix mask] (B, PL + P); the mask itself without a
    prefix."""
    if prefix_kv is None:
        return attention_mask
    pl = (prefix_kv[0] if isinstance(prefix_kv, (tuple, list)) else prefix_kv).shape[3]
    return torch.cat([_prefix_mask(prefix_len, pl).to(attention_mask.dtype),
                      attention_mask], dim=1)


def prefill(params: dict, cfg: DecoderConfig, input_ids: torch.Tensor,
            attention_mask: torch.Tensor, max_new_tokens: int,
            dtype=torch.bfloat16, prefix_kv=None,
            prefix_len: torch.Tensor | None = None,
            act_quant: bool = False) -> tuple[torch.Tensor, KVCache]:
    """Forward over a LEFT-padded (B, P) prompt batch. Returns (last-position
    logits (B, V) f32, cache of [PL +] P + max_new_tokens slots).
    `act_quant`: the W8A8 products (quantized weights only).

    Without `prefix_kv` the attention is kernel B2.

    With `prefix_kv` (B, L, 2, PL, Hk, D), each row's cached context K/V from
    `compute_prefix_kv` (left-aligned, valid for its first `prefix_len[b]`
    slots, RoPE positions 0..len-1), `input_ids` holds only the suffix: its
    tokens continue at positions prefix_len[b].., attend to [valid prefix
    slots | causal suffix], and the cache returned is the concatenation.
    `prefix_kv` may be an (int8 values, f32 scales) pair from
    `quantize_prefix_kv`, dequantized per layer as values * scales in
    `dtype`. This attention is `layers.attention` with an additive bias, the
    counterpart of the JAX package's einsum attention on this route: B2
    needs as many queries as keys, and here P queries meet PL + P keys."""
    b, p = input_ids.shape
    dev = input_ids.device
    px_q, px_s = (prefix_kv if isinstance(prefix_kv, (tuple, list))
                  else (prefix_kv, None))
    pl = 0 if prefix_kv is None else px_q.shape[3]
    inv_freq = rope_freqs(cfg.head_dim, cfg.rope_theta, device=dev)
    # left padding: positions count real tokens from the left edge of content
    positions = torch.clamp(torch.cumsum(attention_mask, dim=-1) - 1, min=0)
    x = embed_lookup(params, input_ids, dtype)
    cache = _new_cache(cfg, b, pl + p + max_new_tokens, dtype, dev)

    if prefix_kv is None:
        def attend(q, k, v):
            return flash_attention(q, k, v, attention_mask, causal=True)
    else:
        positions = positions + prefix_len[:, None]
        # (B, 1, P, PL + P): every prefix position precedes every suffix
        # position, so the prefix block has no causal term
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        pref_bias = torch.where(_prefix_mask(prefix_len, pl), zero, NEG_INF)
        bias = torch.cat([pref_bias[:, None, None, :].expand(b, 1, p, pl),
                          causal_padding_bias(attention_mask)], dim=-1)

    for i in range(cfg.num_layers):
        if prefix_kv is not None:
            pk, pv = px_q[:, i, 0], px_q[:, i, 1]
            if px_s is not None:
                pk = pk.to(dtype) * px_s[:, i, 0].to(dtype)
                pv = pv.to(dtype) * px_s[:, i, 1].to(dtype)
            cache.k[i, :, :pl] = pk
            cache.v[i, :, :pl] = pv

            def attend(q, k, v, i=i):
                # the cache already holds the prefix: write the suffix beside
                # it and attend over both without another copy
                cache.k[i, :, pl:pl + p] = k
                cache.v[i, :, pl:pl + p] = v
                return attention(q, cache.k[i, :, :pl + p], cache.v[i, :, :pl + p], bias)

        x, k, v = _layer_forward(_layer(params, i), cfg, x, positions, inv_freq,
                                 b, p, attend, act_quant)
        if prefix_kv is None:
            cache.k[i, :, :p] = k
            cache.v[i, :, :p] = v
    return logits_from_hidden(params, cfg, x[:, -1, :]), cache


@torch.inference_mode()
def compute_prefix_kv(params: dict, cfg: DecoderConfig, input_ids: torch.Tensor,
                      attention_mask: torch.Tensor, dtype=torch.bfloat16,
                      act_quant: bool = False) -> torch.Tensor:
    """Forward over a RIGHT-padded (M, PL) batch of context prefixes through
    kernel B2 and return their post-RoPE K/V as (M, L, 2, PL, Hk, D) in
    `dtype`: one prefix-cache entry a row, left-aligned.

    RoPE positions run 0..n-1 as at the front of a full prompt, so an entry
    is position-exact for any later prompt that starts with the same tokens.
    Rows attend causally within themselves (trailing pad keys are invisible
    to real queries), so a row's K/V does not depend on its batch. K/V at
    pad slots is whatever the pad queries computed; `prefix_len` masks it."""
    m, pl = input_ids.shape
    dev = input_ids.device
    inv_freq = rope_freqs(cfg.head_dim, cfg.rope_theta, device=dev)
    positions = torch.clamp(torch.cumsum(attention_mask, dim=-1) - 1, min=0)
    x = embed_lookup(params, input_ids, dtype)
    out = torch.empty((m, cfg.num_layers, 2, pl, cfg.num_kv_heads, cfg.head_dim),
                      dtype=dtype, device=dev)

    def attend(q, k, v):
        return flash_attention(q, k, v, attention_mask, causal=True)

    for i in range(cfg.num_layers):
        x, k, v = _layer_forward(_layer(params, i), cfg, x, positions, inv_freq,
                                 m, pl, attend, act_quant)
        out[:, i, 0] = k
        out[:, i, 1] = v
    return out


def quantize_prefix_kv(kv: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 quantization of prefix K/V along the head dim:
    (..., Hk, D) → int8 values and per-(token, head) f32 scales (..., Hk, 1).
    Not bit-exact reuse: PREFIX_CACHE_DTYPE=int8 opts into it. The scale is
    amax times the f32 reciprocal of 127, which is what the JAX package's
    compiled `amax / 127.0` computes (XLA turns a division by a constant into
    that product), so values and scales equal its bit for bit."""
    kf = kv.float()
    scale = torch.clamp(kf.abs().amax(dim=-1, keepdim=True), min=1e-8) * (1.0 / 127.0)
    q = torch.clamp(torch.round(kf / scale), -127, 127)
    return q.to(torch.int8), scale


def decode_step(params: dict, cfg: DecoderConfig, cache: KVCache,
                token: torch.Tensor, step: int, prompt_len: int,
                prompt_mask: torch.Tensor, dtype=torch.bfloat16):
    """One token for every row: writes its K/V at slot prompt_len + step of
    `cache` (in place) and returns ((B, V) f32 logits, cache)."""
    b = token.shape[0]
    t_max = cache.k.shape[2]
    inv_freq = rope_freqs(cfg.head_dim, cfg.rope_theta, device=token.device)
    positions = (prompt_mask.sum(dim=-1) + step)[:, None]
    write_at = prompt_len + step
    # prompt pads masked; generated slots valid up to the current step
    gen_valid = torch.arange(t_max - prompt_len, device=token.device) <= step
    valid = torch.cat([prompt_mask > 0, gen_valid.expand(b, -1)], dim=1)
    zero = torch.zeros((), dtype=torch.float32, device=token.device)
    bias = torch.where(valid, zero, NEG_INF)[:, None, None, :]

    x = embed_lookup(params, token[:, None], dtype)
    for i in range(cfg.num_layers):
        layer = _layer(params, i)
        h = rms_norm(x, layer["ln1"], cfg.rms_norm_eps)
        q, k, v = _qkv(layer, cfg, h, b, 1)
        q = apply_rope(q, positions, inv_freq)
        k = apply_rope(k, positions, inv_freq)
        cache.k[i, :, write_at] = k[:, 0]
        cache.v[i, :, write_at] = v[:, 0]
        a = attention(q, cache.k[i].to(dtype), cache.v[i].to(dtype), bias)
        x = x + row_parallel(dense, a.reshape(b, 1, cfg.num_heads * cfg.head_dim),
                             layer["o_w"], None, "attn")
        h = rms_norm(x, layer["ln2"], cfg.rms_norm_eps)
        x = x + _mlp(layer, h)
    return logits_from_hidden(params, cfg, x[:, 0, :]), cache


def decode_step_spec(params: dict, cfg: DecoderConfig, cache: KVCache,
                     toks: torch.Tensor, step0: torch.Tensor, prompt_len: int,
                     prompt_mask: torch.Tensor, dtype=torch.bfloat16):
    """The verify step of speculative decode: one forward over S consecutive
    positions a row against the cache. `toks` (B, S) holds [last accepted
    token, S - 1 drafts], `step0` (B,) the generation index of `toks[:, 0]`.
    Returns ((B, S, V) f32 logits, logits[:, j] predicting generation index
    step0 + j + 1, and the cache with all S tokens' K/V written in place).

    Rows stand at different offsets (each accepts its own number of drafts an
    iteration), so the cache write is one scatter at (row, prompt_len +
    step0[b] + j) a layer, not a slice. The bias is banded-causal inside the
    chunk: query j sees the valid prompt slots and the generated slots
    <= step0[b] + j. Slots past a row's frontier hold the K/V of rejected
    drafts; the band hides them, and the next iteration's writes begin at the
    new frontier, so each is overwritten before it can be read."""
    b, s = toks.shape
    t_max = cache.k.shape[2]
    dev = toks.device
    inv_freq = rope_freqs(cfg.head_dim, cfg.rope_theta, device=dev)
    gidx = step0[:, None] + torch.arange(s, device=dev)[None, :]       # (B, S)
    positions = prompt_mask.sum(dim=-1)[:, None] + gidx
    tidx = (prompt_len + gidx).long()                                  # cache slots
    slot = torch.arange(t_max - prompt_len, device=dev)
    gen_valid = slot[None, None, :] <= gidx[:, :, None]                # (B, S, Tg)
    valid = torch.cat([(prompt_mask > 0)[:, None, :].expand(b, s, prompt_len),
                       gen_valid], dim=-1)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    bias = torch.where(valid, zero, NEG_INF)[:, None, :, :]
    rows = torch.arange(b, device=dev)[:, None]

    x = embed_lookup(params, toks, dtype)
    for i in range(cfg.num_layers):
        layer = _layer(params, i)
        h = rms_norm(x, layer["ln1"], cfg.rms_norm_eps)
        q, k, v = _qkv(layer, cfg, h, b, s)
        q = apply_rope(q, positions, inv_freq)
        k = apply_rope(k, positions, inv_freq)
        # one (row, slot) per value: the indices of a call are distinct
        cache.k[i].index_put_((rows, tidx), k.to(cache.k.dtype))
        cache.v[i].index_put_((rows, tidx), v.to(cache.v.dtype))
        a = attention(q, cache.k[i].to(dtype), cache.v[i].to(dtype), bias)
        x = x + row_parallel(dense, a.reshape(b, s, cfg.num_heads * cfg.head_dim),
                             layer["o_w"], None, "attn")
        h = rms_norm(x, layer["ln2"], cfg.rms_norm_eps)
        x = x + _mlp(layer, h)
    return logits_from_hidden(params, cfg, x), cache


def sample_candidates(logits: torch.Tensor, temperature: float = 0.7,
                      top_k: int = 20, top_p: float = 0.8):
    """The kept candidates of Qwen2.5-Instruct's default sampling: exact top-k
    (the TPU's approx_max_k is TPU-only), temperature, then the smallest
    prefix with cumulative probability >= top_p (always keeps the argmax).
    Returns ((B, K) scaled logits, NEG_INF where dropped; (B, K) vocab ids)."""
    vals, idx = torch.topk(logits, top_k, dim=-1)
    vals = vals / max(temperature, 1e-5)
    probs = torch.softmax(vals, dim=-1)
    keep = torch.cumsum(probs, dim=-1) - probs < top_p
    return torch.where(keep, vals, NEG_INF), idx


def sample_token(logits: torch.Tensor, generator: torch.Generator | None,
                 temperature: float = 0.7, top_k: int = 20,
                 top_p: float = 0.8) -> torch.Tensor:
    vals, idx = sample_candidates(logits, temperature, top_k, top_p)
    choice = torch.multinomial(torch.softmax(vals, dim=-1), 1, generator=generator)
    return torch.gather(idx, 1, choice)[:, 0]


def eos_id_set(cfg: DecoderConfig) -> tuple:
    """All stop ids (Qwen2.5: <|im_end|> and <|endoftext|>), deduped."""
    return tuple(dict.fromkeys(
        (cfg.eos_token_id,) + tuple(getattr(cfg, "eos_token_ids", ()))))


def token_is_eos(tok: torch.Tensor, eos_ids: tuple) -> torch.Tensor:
    hit = tok == eos_ids[0]
    for e in eos_ids[1:]:
        hit = hit | (tok == e)
    return hit


def bias_eos(logits: torch.Tensor, eos_ids: tuple, eos_bias: float) -> torch.Tensor:
    """Add EOS_BIAS to the stop-token logits (0, the default, is a no-op)."""
    if not eos_bias:
        return logits
    logits = logits.clone()
    logits[:, list(eos_ids)] += eos_bias
    return logits


def pick_token(logits, generator, do_sample, temperature=0.7, top_k=20,
               top_p=0.8, eos_bias=0.0, eos_ids=()) -> torch.Tensor:
    """Qwen2.5 default sampling, or greedy (first index on ties)."""
    logits = bias_eos(logits, eos_ids, eos_bias)
    if do_sample:
        return sample_token(logits, generator, temperature, top_k, top_p)
    return torch.argmax(logits, dim=-1)


class _LoopSpans:
    """The `prefill` and `decode` spans of one generate call, into a
    `utils.timing.StageTimer` (None: nothing is recorded). The prefill runs
    from its first launch (this object's creation) to the decode loop's
    first host read of `done`, which waits for the prefill's device work;
    the decode from there to the loop's end, counted in its steps. Neither
    adds a sync: a loop's last step is read back by the caller."""

    __slots__ = ("timer", "t0", "t_sync")

    def __init__(self, timer):
        self.timer = timer
        self.t0 = time.time_ns()
        self.t_sync = None

    def synced(self) -> None:
        """After a host read of `done`: the first ends the prefill."""
        if self.t_sync is None and self.timer is not None:
            self.t_sync = time.time_ns()
            self.timer.add("prefill", (self.t_sync - self.t0) * 1e-9, start_ns=self.t0)

    def end(self, steps: int) -> None:
        if self.timer is None:
            return
        self.synced()       # a loop that never read `done` (one new token)
        if steps:
            self.timer.add("decode", (time.time_ns() - self.t_sync) * 1e-9, n=steps,
                           start_ns=self.t_sync)


def _decode_loop(params, cfg, logits0, cache, attention_mask, generator,
                 max_new_tokens, temperature, top_k, top_p, do_sample, dtype,
                 row_valid, p, row_budget=None, eos_bias=0.0, spans=None):
    """Sample, then decode until every row is done or max_new_tokens are out.
    Pad rows (row_valid False) are born done; a row is done at any stop id
    or once it holds row_budget[b] tokens. Returns (out (B, max_new_tokens)
    int32, pad_token_id past each row's end; the number of decode steps).
    `spans`, a `_LoopSpans`, is told of the first host read and the end."""
    b = attention_mask.shape[0]
    eos_ids = eos_id_set(cfg)
    pad = cfg.pad_token_id

    def pick(logits):
        return pick_token(logits, generator, do_sample, temperature, top_k,
                          top_p, eos_bias, eos_ids).to(torch.int32)

    tok = pick(logits0)
    if row_valid is not None:
        tok = torch.where(row_valid, tok, pad)
    done = token_is_eos(tok, eos_ids)
    if row_valid is not None:
        done = done | ~row_valid
    if row_budget is not None:
        done = done | (row_budget <= 1)
    out = torch.full((b, max_new_tokens), pad, dtype=torch.int32,
                     device=tok.device)
    out[:, 0] = tok
    steps = 0
    for step in range(max_new_tokens - 1):
        finished = bool(done.all())
        if spans is not None and not steps:
            spans.synced()
        if finished:
            break
        steps += 1
        logits, cache = decode_step(params, cfg, cache, tok, step, p,
                                    attention_mask, dtype=dtype)
        nxt = torch.where(done, pad, pick(logits))
        done = done | token_is_eos(nxt, eos_ids)
        if row_budget is not None:
            # column step + 1 was just written: the row holds step + 2 tokens
            done = done | (step + 2 >= row_budget)
        out[:, step + 1] = nxt
        tok = nxt
    if spans is not None:
        spans.end(steps)
    return out, steps


def draft_ngram(hist: torch.Tensor, cur: torch.Tensor, gamma: int) -> torch.Tensor:
    """Prompt-lookup drafting on the device: find the latest earlier
    occurrence of each row's last trigram in its history (B, H), else of its
    last bigram, and propose the `gamma` tokens that followed it; with
    neither, the last token repeated. `cur` (B,) is each row's next free
    history index. Returns (B, gamma) int32.

    The position bounds (window start <= cur - 4 for the trigram, cur - 3 for
    the bigram) keep the current occurrence itself out. The three lookups are
    clamped at 0 because `torch.gather` does not take a negative index; the
    decode loop starts every row at cur = P_in + 1 >= 2, so only `cur - 3`
    can go below 0 there, and then the position bound admits no trigram
    window anyway."""
    b, h = hist.shape
    dev = hist.device

    def at(i):
        return torch.gather(hist, 1, i.clamp(min=0)[:, None].long())   # (B, 1)

    t0, t1, t2 = at(cur - 3), at(cur - 2), at(cur - 1)
    idx2 = torch.arange(h - 1, device=dev)[None, :]
    win2 = (hist[:, :-1] == t1) & (hist[:, 1:] == t2)
    pos2 = torch.where(win2 & (idx2 <= (cur - 3)[:, None]), idx2, -1).amax(dim=-1)
    idx3 = torch.arange(h - 2, device=dev)[None, :]
    win3 = (hist[:, :-2] == t0) & (hist[:, 1:-1] == t1) & (hist[:, 2:] == t2)
    pos3 = torch.where(win3 & (idx3 <= (cur - 4)[:, None]), idx3, -1).amax(dim=-1)

    use3 = pos3 >= 0
    start = torch.where(use3, pos3 + 3, pos2 + 2)      # where the continuation begins
    found = use3 | (pos2 >= 0)
    cont = (start[:, None] + torch.arange(gamma, device=dev)[None, :]).clamp(0, h - 1)
    looked_up = torch.gather(hist, 1, cont)
    return torch.where(found[:, None], looked_up, t2.expand(b, gamma)).to(torch.int32)


def _spec_decode_loop(params, cfg, logits0, cache, attention_mask, max_new_tokens,
                      gamma, dtype, row_valid, p, input_ids, row_budget=None,
                      eos_bias=0.0, draft_source=None, spans=None):
    """Greedy speculative decode over a prefilled cache (of max_new_tokens +
    gamma generation slots): an iteration drafts `gamma` tokens a row
    (`draft_ngram`), verifies them in one forward (`decode_step_spec`) and
    emits the longest matching prefix plus the token after it.

    Greedy only, and output-preserving in exact arithmetic: position j's
    argmax comes from the model's own logits whenever drafts 0..j-1 matched,
    so the tokens are `_decode_loop`'s (EOS kept then pad, row budgets, pad
    rows born done, exit once every row is done). In f32 they are equal; in
    bf16 the chunk's products reduce in another order than a single step's,
    which can flip an argmax whose top-2 gap is below that noise.

    `input_ids` (B, P_in) seeds the lookup history; over a cached prefix it
    is the suffix only. `draft_source` (B, >= max_new_tokens + gamma), when
    given, replaces the drafter: the drafts for generation indices gc.. are
    read from it, which feeds the loop drafts of a chosen quality.

    The exit test reads `done.all()` on the host once an iteration, as
    `_decode_loop` does; nothing else is read back. Returns (out (B,
    max_new_tokens) int32, the number of iterations). `spans`: as in
    `_decode_loop`, the steps being iterations."""
    b = attention_mask.shape[0]
    dev = logits0.device
    s = gamma + 1
    eos_ids = eos_id_set(cfg)
    pad = cfg.pad_token_id
    mnt = max_new_tokens

    budget = (row_budget.clamp(1, mnt).to(torch.int32) if row_budget is not None
              else torch.full((b,), mnt, dtype=torch.int32, device=dev))
    tok0 = torch.argmax(bias_eos(logits0, eos_ids, eos_bias), dim=-1).to(torch.int32)
    if row_valid is not None:
        tok0 = torch.where(row_valid, tok0, pad)
    done = token_is_eos(tok0, eos_ids) | (budget <= 1)
    if row_valid is not None:
        done = done | ~row_valid

    # `out` and `hist` each end in a spill column, where the masked writes of
    # a scatter land (several a row, all the pad id); it lies past the last
    # real write slot and is cut off at the exit
    out = torch.full((b, mnt + 1), pad, dtype=torch.int32, device=dev)
    out[:, 0] = tok0
    if mnt == 1:
        if spans is not None:
            spans.end(0)
        return out[:, :mnt], 0
    p_in = input_ids.shape[1]
    hlen = p_in + mnt + 1
    hist = torch.cat([input_ids.to(torch.int32),
                      torch.full((b, mnt + 1), pad, dtype=torch.int32, device=dev)],
                     dim=1)
    hist[:, p_in] = tok0
    cur = torch.full((b,), p_in + 1, dtype=torch.int32, device=dev)
    rows = torch.arange(b, device=dev)[:, None]
    jar = torch.arange(s, device=dev)[None, :]
    last = tok0
    gc = torch.ones((b,), dtype=torch.int32, device=dev)   # tokens a row holds

    n_iters = 0
    while n_iters < mnt:
        finished = bool(done.all())
        if spans is not None and not n_iters:
            spans.synced()
        if finished:
            break
        if draft_source is not None:
            didx = (gc[:, None] + jar[:, :gamma]).clamp(0, draft_source.shape[1] - 1)
            drafts = torch.gather(draft_source, 1, didx.long()).to(torch.int32)
        else:
            drafts = draft_ngram(hist, cur, gamma)
        chunk = torch.cat([last[:, None], drafts], dim=1)              # (B, S)
        logits, cache = decode_step_spec(params, cfg, cache, chunk, gc - 1, p,
                                         attention_mask, dtype=dtype)
        if eos_bias:
            logits[:, :, list(eos_ids)] += eos_bias
        g = torch.argmax(logits, dim=-1).to(torch.int32)               # (B, S)
        # draft j (chunk[:, j + 1], generation index gc + j) is right iff it
        # is the model's own pick g[:, j]; the longest right prefix is taken
        match = (chunk[:, 1:] == g[:, :-1]).to(torch.int32)
        accept = torch.cumprod(match, dim=-1).sum(dim=-1)              # (B,)
        g_eos = token_is_eos(g, eos_ids).to(torch.int32)
        eos_before = torch.cumsum(g_eos, dim=-1) - g_eos               # exclusive
        emit = (~done[:, None] & (jar <= accept[:, None])
                & (jar < (budget - gc)[:, None]) & (eos_before == 0))  # (B, S)
        n_emit = emit.sum(dim=-1).to(torch.int32)
        val = torch.where(emit, g, pad)
        out.index_put_((rows, torch.where(emit, gc[:, None] + jar, mnt).long()), val)
        hist.index_put_((rows, torch.where(emit, cur[:, None] + jar, hlen - 1).long()),
                        val)
        gc = gc + n_emit
        done = done | (emit & (g_eos > 0)).any(dim=-1) | (gc >= budget)
        last_new = torch.gather(g, 1, (n_emit - 1).clamp(0, s - 1)[:, None].long())[:, 0]
        last = torch.where(n_emit > 0, last_new, last)
        cur = cur + n_emit
        n_iters += 1
    if spans is not None:
        spans.end(n_iters)
    return out[:, :mnt], n_iters


@torch.inference_mode()
def generate(params: dict, cfg: DecoderConfig, input_ids: torch.Tensor,
             attention_mask: torch.Tensor, generator: torch.Generator | None = None,
             max_new_tokens: int = 10, temperature: float = 0.7, top_k: int = 20,
             top_p: float = 0.8, do_sample: bool = True, dtype=torch.bfloat16,
             row_valid: torch.Tensor | None = None,
             row_budget: torch.Tensor | None = None,
             eos_bias: float = 0.0, prefix_kv=None,
             prefix_len: torch.Tensor | None = None,
             act_quant: bool = False, spec_gamma: int = 0,
             timer=None) -> torch.Tensor:
    """Padded prefill + decode. Returns (B, max_new_tokens) int32 ids.

    With `prefix_kv` / `prefix_len` (see `prefill`), `input_ids` holds each
    row's suffix only, and decode attends over the [prefix | suffix |
    generated] cache.

    `spec_gamma` > 0 makes the decode loop speculative (`_spec_decode_loop`)
    under greedy decoding; sampling ignores it and keeps the one-token loop.
    `timer`, a `StageTimer`, gets the `prefill` and `decode` spans
    (`_LoopSpans`)."""
    spans = _LoopSpans(timer)
    use_spec = spec_gamma > 0 and not do_sample and max_new_tokens > 1
    # a verify step writes up to gamma slots past a row's last token
    alloc = max_new_tokens + (spec_gamma if use_spec else 0)
    logits0, cache = prefill(params, cfg, input_ids, attention_mask,
                             alloc, dtype=dtype, prefix_kv=prefix_kv,
                             prefix_len=prefix_len, act_quant=act_quant)
    # decode sees one combined prompt of PL + P slots: the prefix part
    # left-aligned and valid for prefix_len, the suffix part left-padded
    attention_mask = _combined_mask(attention_mask, prefix_kv, prefix_len)
    p = attention_mask.shape[1]
    if use_spec:
        return _spec_decode_loop(
            params, cfg, logits0, cache, attention_mask, max_new_tokens,
            spec_gamma, dtype, row_valid, p, input_ids, row_budget=row_budget,
            eos_bias=eos_bias, spans=spans)[0]
    return _decode_loop(params, cfg, logits0, cache, attention_mask, generator,
                        max_new_tokens, temperature, top_k, top_p, do_sample,
                        dtype, row_valid, p, row_budget=row_budget,
                        eos_bias=eos_bias, spans=spans)[0]


def prefill_packed(params: dict, cfg: DecoderConfig, input_ids: torch.Tensor,
                   seg: torch.Tensor, positions: torch.Tensor,
                   last_idx: torch.Tensor, gather_idx: torch.Tensor,
                   prompt_mask: torch.Tensor, max_new_tokens: int,
                   dtype=torch.bfloat16,
                   act_quant: bool = False,
                   n_real: int | None = None) -> tuple[torch.Tensor, KVCache]:
    """Packed prefill: the batch's real tokens back to back in one (1, T)
    stream (`seg` ascending row ids, the pad tail last), attention through
    kernel B3. The per-token K/V is then unpacked into the usual left-padded
    (L, B, P + max_new_tokens, Hk, D) cache, slot [b, p] reading stream
    position gather_idx[b, p] and zeroed where prompt_mask is 0, so decode is
    the padded path's. n_real: the count of real tokens at the head of the
    stream, a host int (None: all T); B3 computes no pad-tail row (its
    attention output is 0), which no real row, gathered slot or last-token
    logit reads. Returns (each row's last-token logits (B, V) f32, cache)."""
    b, p = gather_idx.shape
    t = input_ids.shape[1]
    inv_freq = rope_freqs(cfg.head_dim, cfg.rope_theta, device=input_ids.device)
    x = embed_lookup(params, input_ids, dtype)
    cache = _new_cache(cfg, b, p + max_new_tokens, dtype, input_ids.device)
    flat = gather_idx.reshape(-1)
    keep = prompt_mask.reshape(b, p, 1, 1).to(dtype)

    def attend(q, k, v):
        return flash_attention_packed(q, k, v, seg, n_real)

    for i in range(cfg.num_layers):
        x, k, v = _layer_forward(_layer(params, i), cfg, x, positions, inv_freq,
                                 1, t, attend, act_quant)
        cache.k[i, :, :p] = k[0, flat].reshape(b, p, *k.shape[2:]) * keep
        cache.v[i, :, :p] = v[0, flat].reshape(b, p, *v.shape[2:]) * keep
    return logits_from_hidden(params, cfg, x[0, last_idx, :]), cache


@torch.inference_mode()
def generate_packed(params: dict, cfg: DecoderConfig, input_ids: torch.Tensor,
                    seg: torch.Tensor, positions: torch.Tensor,
                    last_idx: torch.Tensor, gather_idx: torch.Tensor,
                    prompt_mask: torch.Tensor,
                    generator: torch.Generator | None = None,
                    max_new_tokens: int = 10, temperature: float = 0.7,
                    top_k: int = 20, top_p: float = 0.8, do_sample: bool = True,
                    dtype=torch.bfloat16, row_valid: torch.Tensor | None = None,
                    row_budget: torch.Tensor | None = None,
                    eos_bias: float = 0.0, act_quant: bool = False,
                    spec_gamma: int = 0, timer=None,
                    n_real: int | None = None) -> torch.Tensor:
    """Packed prefill (B3) + the padded path's decode; same contract as
    `generate`. The speculative loop's history is each row's ids, rebuilt
    from the packed stream through `gather_idx`. n_real: as in
    `prefill_packed`."""
    spans = _LoopSpans(timer)
    use_spec = spec_gamma > 0 and not do_sample and max_new_tokens > 1
    alloc = max_new_tokens + (spec_gamma if use_spec else 0)
    logits0, cache = prefill_packed(params, cfg, input_ids, seg, positions,
                                    last_idx, gather_idx, prompt_mask,
                                    alloc, dtype=dtype, act_quant=act_quant,
                                    n_real=n_real)
    p = gather_idx.shape[1]
    if use_spec:
        row_ids = torch.where(prompt_mask > 0, input_ids[0][gather_idx.long()],
                              cfg.pad_token_id)
        return _spec_decode_loop(
            params, cfg, logits0, cache, prompt_mask, max_new_tokens, spec_gamma,
            dtype, row_valid, p, row_ids, row_budget=row_budget, eos_bias=eos_bias,
            spans=spans)[0]
    return _decode_loop(params, cfg, logits0, cache, prompt_mask, generator,
                        max_new_tokens, temperature, top_k, top_p, do_sample,
                        dtype, row_valid, p, row_budget=row_budget,
                        eos_bias=eos_bias, spans=spans)[0]


# ---------------------------------------------------------------------------
# the continuous decode pool's device functions (core/decode_pool.py)
# ---------------------------------------------------------------------------

def _first_token(cfg, logits0, generator, do_sample, temperature, top_k, top_p,
                 eos_bias, row_valid) -> torch.Tensor:
    tok0 = pick_token(logits0, generator, do_sample, temperature, top_k, top_p,
                      eos_bias, eos_id_set(cfg)).to(torch.int32)
    if row_valid is not None:
        tok0 = torch.where(row_valid, tok0, cfg.pad_token_id)
    return tok0


@torch.inference_mode()
def prefill_for_pool(params: dict, cfg: DecoderConfig, input_ids: torch.Tensor,
                     attention_mask: torch.Tensor,
                     generator: torch.Generator | None = None,
                     temperature: float = 0.7, top_k: int = 20, top_p: float = 0.8,
                     do_sample: bool = True, dtype=torch.bfloat16,
                     row_valid: torch.Tensor | None = None, act_quant: bool = False,
                     prefix_kv=None, prefix_len: torch.Tensor | None = None,
                     eos_bias: float = 0.0):
    """The prefill `generate` runs, and the first token, for the continuous
    decode pool: returns (tok0 (B,) int32, k (L, B, T, Hk, D), v, mask
    (B, T)) with T = [prefix pool length +] P, exactly the prompt K/V, no
    decode slots; the mask is [prefix mask | suffix mask] over a prefix.
    Pad rows (row_valid False) get tok0 = pad_token_id."""
    logits0, cache = prefill(params, cfg, input_ids, attention_mask, 0, dtype=dtype,
                             prefix_kv=prefix_kv, prefix_len=prefix_len,
                             act_quant=act_quant)
    tok0 = _first_token(cfg, logits0, generator, do_sample, temperature, top_k,
                        top_p, eos_bias, row_valid)
    return tok0, cache.k, cache.v, _combined_mask(attention_mask, prefix_kv, prefix_len)


@torch.inference_mode()
def prefill_packed_for_pool(params: dict, cfg: DecoderConfig, input_ids: torch.Tensor,
                            seg: torch.Tensor, positions: torch.Tensor,
                            last_idx: torch.Tensor, gather_idx: torch.Tensor,
                            prompt_mask: torch.Tensor,
                            generator: torch.Generator | None = None,
                            temperature: float = 0.7, top_k: int = 20,
                            top_p: float = 0.8, do_sample: bool = True,
                            dtype=torch.bfloat16, row_valid: torch.Tensor | None = None,
                            act_quant: bool = False, eos_bias: float = 0.0,
                            n_real: int | None = None):
    """Packed-prefill variant of `prefill_for_pool`: returns (tok0 (B,), k
    (L, B, P, Hk, D), v, prompt_mask). n_real: as in `prefill_packed`."""
    logits0, cache = prefill_packed(params, cfg, input_ids, seg, positions, last_idx,
                                    gather_idx, prompt_mask, 0, dtype=dtype,
                                    act_quant=act_quant, n_real=n_real)
    tok0 = _first_token(cfg, logits0, generator, do_sample, temperature, top_k,
                        top_p, eos_bias, row_valid)
    return tok0, cache.k, cache.v, prompt_mask


@torch.inference_mode()
def decode_chunk(params: dict, cfg: DecoderConfig, pool_k: torch.Tensor,
                 pool_v: torch.Tensor, valid: torch.Tensor, last_tok: torch.Tensor,
                 next_pos: torch.Tensor, active: torch.Tensor,
                 remaining: torch.Tensor, cursor: int,
                 generator: torch.Generator | None = None, chunk: int = 8,
                 temperature: float = 0.7, top_k: int = 20, top_p: float = 0.8,
                 do_sample: bool = True, dtype=torch.bfloat16, eos_bias: float = 0.0):
    """`chunk` decode steps over the slot pool, with no host read between
    them.

    The pool is a ring over the W axis of `pool_k` / `pool_v` (L, S, W, Hk,
    D) with ONE cursor: at every step every slot writes its token's K/V at
    column `cursor` (one strided write a layer, no per-row scatter). RoPE
    positions are baked into K at the write and attention masks by the
    per-slot `valid` (S, W) bitmap alone, so a slot's tokens may lie at any
    ring columns: softmax does not depend on key order. `active` and
    `remaining` flip on the device inside the chunk, so a finished slot
    stops sampling at once and emits `pad_token_id`; the host learns of it
    when it reads the (chunk, S) block.

    The state tensors are updated IN PLACE (the JAX function donates them).
    `cursor` is a host integer: it advances by one a step whatever the
    tokens, so the host always knows it. Returns (pool_k, pool_v, valid,
    last_tok, next_pos, active, remaining, cursor, toks (chunk, S) int32)."""
    s_slots, w = valid.shape
    dev = valid.device
    inv_freq = rope_freqs(cfg.head_dim, cfg.rope_theta, device=dev)
    eos_ids = eos_id_set(cfg)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    toks = torch.empty((chunk, s_slots), dtype=torch.int32, device=dev)
    for step in range(chunk):
        # the column being written is attendable iff its slot is active
        valid[:, cursor] = active
        bias = torch.where(valid, zero, NEG_INF)[:, None, None, :]
        x = embed_lookup(params, last_tok[:, None], dtype)
        positions = next_pos[:, None]
        for i in range(cfg.num_layers):
            layer = _layer(params, i)
            h = rms_norm(x, layer["ln1"], cfg.rms_norm_eps)
            q, k, v = _qkv(layer, cfg, h, s_slots, 1)
            q = apply_rope(q, positions, inv_freq)
            k = apply_rope(k, positions, inv_freq)
            pool_k[i, :, cursor] = k[:, 0]
            pool_v[i, :, cursor] = v[:, 0]
            a = attention(q, pool_k[i].to(dtype), pool_v[i].to(dtype), bias)
            x = x + row_parallel(dense, a.reshape(s_slots, 1, cfg.num_heads * cfg.head_dim),
                                 layer["o_w"], None, "attn")
            h = rms_norm(x, layer["ln2"], cfg.rms_norm_eps)
            x = x + _mlp(layer, h)
        logits = logits_from_hidden(params, cfg, x[:, 0, :])
        tok = pick_token(logits, generator, do_sample, temperature, top_k, top_p,
                         eos_bias, eos_ids).to(torch.int32)
        tok = torch.where(active, tok, cfg.pad_token_id)
        step_in = active.to(torch.int32)
        next_pos += step_in
        remaining -= step_in
        active &= ~token_is_eos(tok, eos_ids) & (remaining > 0)
        last_tok.copy_(torch.where(active, tok, last_tok))
        toks[step] = tok
        cursor = (cursor + 1) % w
    return pool_k, pool_v, valid, last_tok, next_pos, active, remaining, cursor, toks
