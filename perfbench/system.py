"""The system under test: the port's service built in this process as its
`main.py` serves it by default (`build_processor`, the processor started,
`create_api` on aiohttp on a free local port, the in-memory queue), with the
benchmark's weights and corpus put in, and the spans and counters the
metrics read.

The weights and the corpus are those of `weights.MODEL_SEED`, whatever the
run's seed; the decoder's are drawn by its architecture's module
(`decoders/<model_type>.py`). Spans are recorded here, around two calls into
the engine, and cost a list append each: `_embed_queries` (the batch of query
texts it encoded, and the pooled embeddings it returned, which the check
compares) and `_stage_packed` (the prompt lengths and stream length of a
packed prefill, which B3's roofline counts). Counters are read from the processor, the
engine's stage timer, its caches and the kernels' launch counts at the
window's edges.
"""

from __future__ import annotations

import gc
import logging
import os
import time

import torch

from perfbench import generator, weights
from perfbench import reference as ref

logger = logging.getLogger("perfbench")


def set_env(env: dict) -> None:
    """The service's settings: "" unsets a variable."""
    for k, v in env.items():
        if v == "":
            os.environ.pop(k, None)
        else:
            os.environ[k] = str(v)


class System:
    def __init__(self, cfg: dict, device: str, decoder, control: bool = False):
        """`decoder`: the module of the configuration's decoder architecture
        (`spec.Cell.decoder`)."""
        from rag_serving_system_torch.config import Settings
        from rag_serving_system_torch.main import build_processor
        from rag_serving_system_torch.ops.quant import quantize_decoder_params

        env = dict(cfg["env"])
        if control:
            env.update(cfg["control"]["env"])
        env["TORCH_DEVICE"] = device
        set_env(env)
        self.device = torch.device(device)
        corp = cfg["corpus"]
        rows, dim = int(corp["rows"]), int(corp["dim"])
        enc = weights.encoder(cfg["encoder"], weights.MODEL_SEED, self.device)
        self.away = weights.shared_direction(
            enc, cfg["encoder"], ref.HashTokenizer(int(cfg["encoder"]["vocab_size"]),
                                                   cfg["tokenizer"]["bos_id"],
                                                   cfg["tokenizer"]["encoder_eos_id"],
                                                   int(cfg["encoder"]["pad_token_id"])),
            generator.questions()[:128], [int(x) for x in env["ENCODE_LEN_BUCKETS"].split(",")],
            self.device)
        emb = weights.corpus(rows, dim, weights.MODEL_SEED, self.device, away=self.away).cpu().numpy()
        ctx = generator.contexts()
        documents = [ctx[i % len(ctx)] for i in range(rows)]
        self.settings = Settings()
        self.processor, self.engine, self.queue, _ = build_processor(
            self.settings, documents, emb)
        del emb
        self._check_shapes(cfg, decoder.ENGINE_KEYS)
        eng = self.engine
        eng.enc_params = enc
        del enc
        dec = decoder.weights(cfg["decoder"], weights.MODEL_SEED, self.device)
        qw = self.settings.quant_weights
        eng.dec_params = (quantize_decoder_params(dec, bits=4 if qw == "int4" else 8)
                          if qw in ("int8", "int4") else dec)
        del dec
        gc.collect()
        eng.warmup()
        self.embed_calls: list = []      # (time, queries, (bucket, D) pooled)
        self.packed_calls: list = []     # (time, prompt lengths, T)
        self._spans()
        self.server = None

    def _check_shapes(self, cfg: dict, decoder_keys: dict) -> None:
        """The engine serves the sizes the configuration's file states;
        `decoder_keys` maps the decoder's keys to the engine's attributes."""
        e, d = self.engine.enc_cfg, self.engine.dec_cfg
        want = {"encoder": (e, {"vocab_size": "vocab_size", "hidden_size": "hidden_size",
                                "num_hidden_layers": "num_layers", "num_attention_heads": "num_heads",
                                "intermediate_size": "intermediate_size",
                                "max_position_embeddings": "max_position_embeddings",
                                "pad_token_id": "pad_token_id"}),
                "decoder": (d, decoder_keys)}
        for part, (have, keys) in want.items():
            for ck, ak in keys.items():
                if float(cfg[part][ck]) != float(getattr(have, ak)):
                    raise ValueError(f"{part}.{ck} is {cfg[part][ck]} in the configuration "
                                     f"and {getattr(have, ak)} in the engine")

    def _spans(self) -> None:
        eng = self.engine
        embed, stage = eng._embed_queries, eng._stage_packed

        def embed_span(queries):
            out = embed(queries)
            self.embed_calls.append((time.time(), tuple(queries), out))
            return out

        def packed_span(rows, n, t, budgets):
            p = eng.packed_p
            self.packed_calls.append((time.time(), [min(len(r), p) for r in rows[:n]], t))
            return stage(rows, n, t, budgets)

        eng._embed_queries = embed_span
        eng._stage_packed = packed_span

    def start(self) -> str:
        from rag_serving_system_torch.api.endpoints import ServerThread, create_api

        self.processor.start()
        self.server = ServerThread(create_api(self.queue, self.processor, self.engine),
                                   host="127.0.0.1", port=0).start()
        return self.server.url

    def snapshot(self) -> dict:
        from rag_serving_system_torch.ops import attention, topk

        eng, proc = self.engine, self.processor
        t = eng.timer
        with t._lock:
            stages = {k: (t.totals[k], t.counts[k]) for k in list(t.totals)}
        launches = {"topk": topk.cosine_topk.launches + topk.cosine_topk_int8.launches,
                    "flash": (attention.flash_attention.launches
                              + attention.flash_attention_packed.launches)}
        return {"time": time.time(), "requests": proc.requests_processed,
                "batches": proc.batches_processed, "stages": stages, "launches": launches,
                "prefix": eng.prefix_cache.stats() if eng.prefix_cache is not None else None,
                "query": eng.query_cache_stats()}

    def facts(self) -> dict:
        """What the metrics and the check need of the engine after it is gone."""
        eng = self.engine
        return {"pool_len": eng.prefix_cache.pool_len if eng.prefix_cache is not None else 0,
                "packed_p": getattr(eng, "packed_p", None), "max_k": eng.max_k,
                "corpus_dtype": self.settings.retrieval_corpus_dtype,
                "encode_buckets": list(self.settings.encode_len_buckets),
                "max_new_tokens": self.settings.max_new_tokens}

    def retrieved(self, queries) -> dict:
        """query -> the ids the engine retrieved for it (its query cache)."""
        eng = self.engine
        with eng._query_cache_lock:
            return {q: list(eng._query_cache[q]) for q in queries if q in eng._query_cache}

    def stop(self) -> None:
        if self.server is not None:
            self.server.stop()
        self.processor.stop(drain_timeout=5.0)
        self.processor.join(timeout=10.0)
        if self.processor.is_alive():
            logger.warning("the batch processor did not stop within 10 s")

    def free(self) -> None:
        """Drop the program's state so that the reference has the card."""
        self.processor = self.engine = self.queue = self.server = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
