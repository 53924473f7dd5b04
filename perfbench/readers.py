"""What the metric readers of `perfbench/metrics/` share: deltas of the
counters over the window, window means of the stage timer, the model-FLOP
arithmetic over the window, and the rooflines and idle share over the
device trace that follows it (`perfbench/flops.py`). Each returns None
where the run has nothing to read."""

from __future__ import annotations

import math
import re

from perfbench import flops, spec
from perfbench import reference as ref

# B1 over a float32 corpus, B4 over an int8 one; each call is a partial
# kernel and the merge
TOPK_KERNELS = {"float32": r"topk_partial_kernel<float>|topk_merge_kernel",
                "int8": r"topk_int8_partial_kernel|topk_merge_kernel"}
TOPK_PARTIAL = {"float32": r"topk_partial_kernel<float>",
                "int8": r"topk_int8_partial_kernel"}
PACKED_ATTN = r"flash_wg_kernel<\d+, true>"


def percentile(values: list, q: float) -> float:
    """The q-quantile by linear interpolation between order statistics."""
    v = sorted(values)
    pos = q * (len(v) - 1)
    lo = int(math.floor(pos))
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def counter_delta(run, key: str):
    a, b = run.snap0.get(key), run.snap1.get(key)
    return None if a is None or b is None else b - a


def rows_per_batch(run):
    req, bat = counter_delta(run, "requests"), counter_delta(run, "batches")
    return req / bat if bat else None


def stage_mean_ms(run, stage: str):
    a = run.snap0["stages"].get(stage, (0.0, 0))
    b = run.snap1["stages"].get(stage, (0.0, 0))
    n = b[1] - a[1]
    return (b[0] - a[0]) / n * 1e3 if n > 0 else None


def prefix_hit_pct(run):
    a, b = run.snap0.get("prefix"), run.snap1.get("prefix")
    if not a or not b:
        return None
    hits, misses = b["hits"] - a["hits"], b["misses"] - a["misses"]
    return 100.0 * hits / (hits + misses) if hits + misses else None


def idle_pct(run):
    tr = run.trace
    if tr is None or tr.window_s <= 0 or tr.n_ops == 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def _traced_window(run):
    tr = run.trace
    return (run.t0, run.t1) if tr is None else (tr.t0, tr.t1)


def topk_roofline_pct(run):
    """Least time of the traced top-k calls (corpus bytes read once, over the
    bandwidth) over the device time of their kernels (partial and merge)."""
    tr = run.trace
    dtype = run.facts["corpus_dtype"]
    if tr is None or dtype not in TOPK_KERNELS:
        return None
    dev_s, _ = tr.time_of(TOPK_KERNELS[dtype])
    _, calls = tr.time_of(TOPK_PARTIAL[dtype])
    if calls == 0 or dev_s <= 0:
        return None
    corp = run.config["corpus"]
    lo, hi = _traced_window(run)
    rows = [len(qs) for t, qs, _ in run.embed_calls if lo <= t < hi] or [1]
    mean_rows = sum(rows) / len(rows)
    least = calls * flops.topk_least_s(int(corp["rows"]), int(corp["dim"]),
                                       int(round(mean_rows)), run.facts["max_k"], dtype)
    return 100.0 * least / dev_s


def packed_attn_roofline_pct(run):
    """Least time of the traced B3 launches (each packed prefill launches
    once a layer) over their device time."""
    tr = run.trace
    if tr is None:
        return None
    dev_s, launches = tr.time_of(PACKED_ATTN)
    lo, hi = _traced_window(run)
    calls = [(lens, t) for ts, lens, t in run.packed_calls if lo <= ts < hi]
    run.diag["packed_attn_seen"] = {"launches": launches, "calls": len(calls),
                                    "flash_kernels": {n[:120]: c for n, (_, c) in tr.by_name.items()
                                                      if "flash" in n}}
    if launches == 0 or dev_s <= 0 or not calls:
        return None
    dec = run.config["decoder"]
    hq, hk = int(dec["num_attention_heads"]), int(dec["num_key_value_heads"])
    d = int(dec.get("head_dim") or int(dec["hidden_size"]) // hq)
    per_launch = [flops.packed_attn_least_s(lens, t, hq, hk, d) for lens, t in calls]
    run.diag["packed_attn"] = {"launches": launches, "calls": len(calls), "device_s": dev_s,
                               "mean_real_tokens": sum(sum(x) for x, _ in calls) / len(calls)}
    least = launches * sum(per_launch) / len(per_launch)
    return 100.0 * least / dev_s


def model_flops_pct(run):
    """Model FLOPs of the requests answered in the window (untraced) over
    the window and the bf16 peak: e5 over the query's real tokens where the
    query was new to the run (a query-cache miss), the decoder (its
    architecture module's `flops`) over the prompt tokens the prefix cache
    did not serve (the window's hit share of each prompt's cached prefix) and
    the generated tokens, with attention."""
    lo, hi = run.t0, run.t1
    done = run.answered_in(lo, hi)
    if not done:
        return None
    cfg = run.config
    cell = getattr(run, "cell", None)
    dec = cell.decoder if cell is not None else spec.decoder_of(cfg["decoder"])
    tok = cfg["tokenizer"]
    enc_tok = ref.HashTokenizer(int(cfg["encoder"]["vocab_size"]), tok["bos_id"],
                                tok["encoder_eos_id"], int(cfg["encoder"]["pad_token_id"]))
    dec_tok = ref.HashTokenizer(int(cfg["decoder"]["vocab_size"]), tok["bos_id"],
                                tok["decoder_eos_id"], tok["decoder_pad_id"])
    first = {}
    for r in sorted(run.records, key=lambda r: r["send"]):
        first.setdefault(r["query"], r)
    a, b = run.snap0.get("prefix"), run.snap1.get("prefix")
    hit_share = 0.0
    if a and b:
        looked = (b["hits"] - a["hits"]) + (b["misses"] - a["misses"]) + (b["bypassed"] - a["bypassed"])
        hit_share = (b["hits"] - a["hits"]) / looked if looked else 0.0
    k = run.facts["k"]
    pool_len = run.facts["pool_len"]
    total = 0.0
    n_req = n_enc = n_tok = n_served = 0
    for r in done:
        ids = run.retrieved.get(r["query"])
        if ids is None:
            continue
        n_req += 1
        if first[r["query"]] is r:
            n_enc += 1
            total += flops.encoder_flops(cfg["encoder"],
                                         len(enc_tok.encode(ref.QUERY_PREFIX + r["query"])))
        docs = [run.docs[j % len(run.docs)] for j in ids[:k]]
        n_prompt = len(dec_tok.encode(ref.prompt_text(r["query"], docs)))
        n_prefix = min(pool_len, len(dec_tok.encode(
            "Context:\n" + ref.DOC_JOIN.join(docs) + "\n\nQuestion:")) - 1)
        served = len(re.findall(r"<\d+>", r["answer"] or ""))
        start = int(round(hit_share * max(0, n_prefix)))
        n_tok += n_prompt - start
        n_served += served
        total += dec.flops(cfg["decoder"], start, n_prompt + max(0, served - 1), max(1, served))
    run.diag["mfu"] = {"requests": n_req, "encoded": n_enc, "prompt_tokens": n_tok,
                       "served_tokens": n_served, "hit_share": hit_share, "flop": total,
                       "window_s": hi - lo, "answered_in_window": len(done)}
    return 100.0 * total / (hi - lo) / flops.MODEL_PEAK_FLOP_S
