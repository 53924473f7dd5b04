"""The check that decides `correct`: what the timed path served, held to the
plain reference (`perfbench/reference.py`) on a sample of the window's
answered requests drawn from the seed, with the longest prompt among them.

Its numbers, each over the sample; those with a limit in the
configuration's file are compared:

- `embed_err`: the distance between the unit vectors of the program's pooled
  e5 embedding of a query (as `_embed_queries` returned it) and the
  reference's, computed at the same padded length (the service pools over
  its batch's padded row);
- `retr_gap`: over the ranks 1..max_k the engine retrieved for the query
  (its query cache), how far the float32 cosine of the id it put at rank j
  falls below the float32 j-th best over the whole corpus. The scores are
  taken from the program's own embedding, which `embed_err` judges: the
  float32 ranks of a million rows lie closer together than bf16 rounding of
  the encoder moves a score, so a ranking judged from the reference's
  embedding would count the encoder's rounding again;
- `logit_gap` / `logit_gap_mean`: the reference runs once over the prompt
  (built from the retrieved ids with the service's template and tokenizer)
  followed by the served tokens; at each served token, how far the
  reference's logit of it lies below the reference's best, and where the
  answer stopped early, how far the best stop token lies below it: the
  widest such gap, and the mean over every served token of the sample.

A request that failed or never came back fails the check on its own, as
does an answer that is not a sequence of token ids or is longer than its
budget (the request's own `max_new_tokens`, or the service's). The weights
and the corpus are made again from `weights.MODEL_SEED`; the decoder's
logits come from its architecture's module (`decoders/<model_type>.py`
`reference`). With `control`, the served tokens come from the program's own
lower-precision path (the configuration's `control.env`), and the encoder
and the corpus are taken one step down in the reference itself.
"""

from __future__ import annotations

import math
import re

import numpy as np
import torch

from perfbench import reference as ref
from perfbench import weights
from perfbench.generator import sub_seed

_TOKEN = re.compile(r"<(\d+)>")


def parse_answer(text) -> list | None:
    """The token ids of a served answer (the hash tokenizer's text), or
    None where it is not one."""
    if not isinstance(text, str):
        return None
    ids = [int(m) for m in _TOKEN.findall(text)]
    if _TOKEN.sub("", text).strip():
        return None
    return ids


def _float(tree):
    if isinstance(tree, dict):
        return {k: _float(v) for k, v in tree.items()}
    return tree.float()


def pick_bucket(buckets: list, n: int) -> int:
    for b in sorted(buckets):
        if n <= b:
            return b
    return sorted(buckets)[-1]


class Judge:
    def __init__(self, cfg: dict, facts: dict, seed: int, device, decoder, away=None):
        """`decoder`: the module of the configuration's decoder architecture
        (`spec.Cell.decoder`)."""
        self.cfg, self.facts, self.away, self.decoder = cfg, facts, away, decoder
        self.seed, self.device = seed, torch.device(device)
        enc, dec = cfg["encoder"], cfg["decoder"]
        tok = cfg["tokenizer"]
        self.enc_tok = ref.HashTokenizer(int(enc["vocab_size"]), tok["bos_id"],
                                         tok["encoder_eos_id"], int(enc["pad_token_id"]))
        self.dec_tok = ref.HashTokenizer(int(dec["vocab_size"]), tok["bos_id"],
                                         tok["decoder_eos_id"], tok["decoder_pad_id"])
        self.stop_ids = list(tok["decoder_stop_ids"])

    def summary(self) -> dict:
        """Median and root mean square over the sample of each number, and
        the served tokens' count: how the widest reading sits in the rest."""
        out = {}
        for name, v in self.per_request.items():
            if v:
                out[name] = {"median": float(np.median(v)), "mean": float(np.mean(v)),
                             "rms": float(np.sqrt(np.mean(np.square(v)))), "n": len(v),
                             "nonzero": int(np.count_nonzero(v))}
        return out

    def sample(self, records: list, retrieved: dict, docs: list, n: int) -> list:
        """`n` answered window requests drawn from the seed, and the one with
        the longest prompt."""
        ok = [r for r in records if r["phase"] == "window" and r["status"] == "ok"
              and r["query"] in retrieved]
        if not ok:
            return []
        k = self.facts["k"]

        def size(r):
            return sum(len(docs[i % len(docs)]) for i in retrieved[r["query"]][:k]) + len(r["query"])
        longest = max(range(len(ok)), key=lambda i: size(ok[i]))
        rng = np.random.default_rng(sub_seed(self.seed, "check"))
        pick = set(rng.choice(len(ok), size=min(n, len(ok)), replace=False).tolist())
        pick.add(longest)
        return [ok[i] for i in sorted(pick)]

    @torch.no_grad()
    def check(self, sample: list, retrieved: dict, embed_calls: list, docs: list,
              control: bool = False) -> dict:
        """{number: value} over the sample."""
        cfg, dev = self.cfg, self.device
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        enc_w = _float(weights.encoder(cfg["encoder"], weights.MODEL_SEED, dev))
        dec_logits = self.decoder.reference(cfg["decoder"], weights.MODEL_SEED, dev)
        corp = cfg["corpus"]
        corpus = weights.corpus(int(corp["rows"]), int(corp["dim"]), weights.MODEL_SEED, dev,
                                 away=self.away)
        lower = (ref.lower_corpus(corpus, cfg["control"]["corpus"]) if control else None)
        enc_quant = cfg["control"]["encoder"] if control else None
        where = {}
        for _, qs, out in embed_calls:
            for i, q in enumerate(qs):
                where.setdefault(q, (qs, out, i))
        k, max_new = self.facts["k"], self.facts["max_new_tokens"]
        embed_err = retr_gap = logit_gap = 0.0
        self.per_request = {"embed_err": [], "retr_gap": [], "logit_gap": [], "served": [],
                            "token_gap": []}
        for r in sample:
            q = r["query"]
            ids = retrieved[q]
            # e5: the program's embedding against the reference's at its bucket
            if q not in where:
                return {"embed_err": math.inf, "retr_gap": math.inf, "logit_gap": math.inf,
                        "logit_gap_mean": math.inf}
            qs, out, i = where[q]
            rows = [self.enc_tok.encode(ref.QUERY_PREFIX + x) for x in qs]
            padded = pick_bucket(self.facts["encode_buckets"], max(len(x) for x in rows))
            e_ref = ref.normalize(ref.e5_pooled(enc_w, cfg["encoder"], rows[i], padded,
                                                device=dev))
            e_prog = ref.normalize(out[i].to(dev))
            e_judged = e_prog
            if control:
                e_judged = ref.normalize(ref.e5_pooled(enc_w, cfg["encoder"], rows[i], padded,
                                                       quant=enc_quant, device=dev))
            embed_err = max(embed_err, float((e_judged - e_ref).norm()))
            self.per_request["embed_err"].append(float((e_judged - e_ref).norm()))
            # retrieval: the ids at each rank against the float32 ranking
            scores = corpus @ e_prog
            best = torch.topk(scores, len(ids)).values
            got = ids
            if control:
                rows_c, q_c = lower
                got = torch.topk(rows_c @ q_c(e_prog), len(ids)).indices.tolist()
            if len(set(got)) != len(got) or not all(0 <= j < corpus.shape[0] for j in got):
                retr_gap = math.inf
            else:
                gap = best - scores[torch.as_tensor(got, device=dev)]
                retr_gap = max(retr_gap, float(gap.max()))
                self.per_request["retr_gap"].append(float(gap.max()))
            # generation: the served tokens under the reference's logits
            budget = min(max_new, r.get("max_new_tokens") or max_new)
            served = parse_answer(r["answer"])
            if served is None or len(served) > budget:
                logit_gap = math.inf
                continue
            prompt = self.dec_tok.encode(ref.prompt_text(q, [docs[j % len(docs)] for j in ids[:k]]))
            seq = prompt + served
            at = list(range(len(prompt) - 1, len(seq) - (0 if len(served) < budget else 1)))
            logits = dec_logits(seq, at)
            top = logits.max(dim=-1).values
            self.per_request["served"].append(len(served))
            worst = 0.0
            for j in range(len(at)):
                if j < len(served):
                    mine = logits[j, served[j]]
                else:
                    mine = logits[j, self.stop_ids].max()
                worst = max(worst, float(top[j] - mine))
                self.per_request["token_gap"].append(float(top[j] - mine))
            self.per_request["logit_gap"].append(worst)
            logit_gap = max(logit_gap, worst)
        gaps = self.per_request["token_gap"]
        return {"embed_err": embed_err, "retr_gap": retr_gap, "logit_gap": logit_gap,
                "logit_gap_mean": float(np.mean(gaps)) if gaps else math.inf}
