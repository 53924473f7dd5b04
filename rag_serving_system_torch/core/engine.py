"""The RAG serving engine in PyTorch: embed → retrieve → generate.

Counterpart of `rag_serving_system_tpu/core/engine.py` (`RagEngine`): the e5
encoder and retrieval over a device-resident corpus, then Qwen2.5
generation, by the fixed decode loop or (DECODE_MODE=continuous) through the
slot pool of `core/decode_pool.py`; the decoder's weights may be int8 or
int4 (QUANT_WEIGHTS) and its prefill W8A8 (QUANT_ACT=int8). A prompt whose
context prefix is in the exact prefix-KV cache (`core/prefix_cache.py`)
prefills only its question (the hit route); a miss first computes the
prefix K/V through kernel B2 and inserts it; batches that bypass the cache
prefill whole prompts, padded (B2) or packed (B3). Retrieval is exact cosine top-k over an f32 or bf16 corpus
(kernel B1) or an int8 corpus, one array or several chunks (kernel B4), or
approximate IVF (`RETRIEVER=ivf`). Public method signatures are the JAX
engine's, so one batch processor contract drives either.

With a local HF snapshot (under WEIGHTS_DIR or in the HF hub cache) the
architectures come from its config.json, the weights from its safetensors
files and the tokenizers from its tokenizer files; without one the presets
serve random weights behind the hashing tokenizer. SPEC_DECODE=gamma makes
the fixed decode loop speculative under greedy decoding.

One device is a mesh of one position (`parallel/mesh.py`), which every route
runs through: the mesh code calls a lone position directly. With `mesh=` of
more than one position the engine serves as the JAX engine does under its
mesh: both models tensor-parallel over
"model" (`parallel/tp.py`), batch rows over "data" (the first data group
serves a batch that does not divide), the corpus sharded over every
position (`parallel/sharded_topk.py`: B1 on each shard), the prefix pool
held per model position with that position's KV heads, the decode pool's
slots over "data". Packed prefill, the int8 corpus and IVF are one-device
routes: under a mesh prefill is padded, the corpus streams bf16 and
retrieval is the exact sharded scan, each with the JAX engine's warning.

Values this port does not know make the constructor raise rather than serve
another configuration (see `unsupported_settings`).
"""

from __future__ import annotations

import logging
import os
import threading
import time
from collections import OrderedDict
from typing import List, Sequence

import numpy as np
import torch

from rag_serving_system_torch.config import Settings
from rag_serving_system_torch.core.prefix_cache import (
    PrefixEntry,
    PrefixKVCache,
    PromptSpec,
    split_prefix_tokens,
)
from rag_serving_system_torch.device import resolve_device, torch_dtype
from rag_serving_system_torch.models.configs import (
    DecoderConfig,
    decoder_config_for,
    decoder_config_from_hf,
    encoder_config_for,
    encoder_config_from_hf,
)
from rag_serving_system_torch.models.e5 import encode
from rag_serving_system_torch.models.qwen2 import (
    DecodeGraphs,
    compute_prefix_kv,
    generate,
    generate_packed,
    prefill_for_pool,
    prefill_packed_for_pool,
    quantize_prefix_kv,
)
from rag_serving_system_torch.models.tokenizer import (
    HashTokenizer,
    get_tokenizer,
    pad_and_stack,
)
from rag_serving_system_torch.models.weights import (
    get_decoder_params,
    get_encoder_params,
    snapshot_hf_config,
)
from rag_serving_system_torch.ops.attention import HEAD_DIMS
from rag_serving_system_torch.ops.ivf import build_ivf, ivf_search
from rag_serving_system_torch.ops.quant import quantize_decoder_params, weight_bytes
from rag_serving_system_torch.ops.topk import (
    cosine_topk,
    cosine_topk_int8,
    cosine_topk_int8_chunked,
    pad_depth,
    quantize_corpus_int8_chunked,
)
from rag_serving_system_torch.parallel.mesh import Mesh, gather_to
from rag_serving_system_torch.parallel.sharded_topk import shard_corpus, sharded_cosine_topk
from rag_serving_system_torch.parallel.tp import row_groups, run_positions, shard_params
from rag_serving_system_torch.utils.lru import LockedLRU
from rag_serving_system_torch.utils.timing import StageTimer

logger = logging.getLogger(__name__)

# copies of rag_serving_system_tpu/core/engine.py:76-124 (that module imports
# jax); a test holds them equal
PROMPT_TEMPLATE = "Context:\n{context}\n\nQuestion: {question}\n\nThe Answer to this question is: "
# the cacheable (question-independent) prompt prefix; split_prefix_tokens
# handles tokenizer merges across its boundary with the question
PREFIX_TEMPLATE = "Context:\n{context}\n\nQuestion:"
DOC_JOIN = "\n---\n"
QUERY_PREFIX = "query: "
# packed prefill must undercut the padded token count by this factor
PACKED_MARGIN = float(os.environ.get("PACKED_MARGIN", "0.85"))


def _parse_len_buckets(spec: str) -> list[int]:
    try:
        out = sorted(int(x) for x in spec.split(",") if x.strip())
    except ValueError:
        logger.warning("unparseable SUFFIX_LEN_BUCKETS=%r; using default", spec)
        return [32, 64]
    out = [b for b in out if b > 0]
    return out or [32, 64]


# suffix (question and answer cue) length buckets of the prefix-cache route:
# finer than the prompt buckets, because suffixes are short
SUFFIX_LEN_BUCKETS = _parse_len_buckets(
    os.environ.get("SUFFIX_LEN_BUCKETS", "32,64"))


def pick_bucket(buckets: Sequence[int], n: int) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def _batch_buckets(settings: Settings) -> list[int]:
    """Batch buckets with max_batch_size guaranteed covered."""
    buckets = sorted(set(settings.batch_buckets))
    if settings.max_batch_size > buckets[-1]:
        logger.warning(
            "MAX_BATCH_SIZE=%d exceeds the largest batch bucket %d; "
            "auto-appending it to the bucket set",
            settings.max_batch_size, buckets[-1])
        buckets.append(settings.max_batch_size)
    return buckets


def _l2n(x: np.ndarray) -> np.ndarray:  # rag_serving_system_tpu/core/retriever.py:40
    return x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-12)


def unsupported_settings(settings: Settings, device: torch.device,
                         dec_cfg: DecoderConfig | None = None) -> list[str]:
    """The settings this port does not implement yet on `device`, each with
    its value. `dec_cfg` is the decoder the engine will serve (read from a
    snapshot's config.json, when there is one); the preset's by default."""
    bad = []
    if dec_cfg is None:
        dec_cfg = decoder_config_for(settings.model_preset)
    head_dim = dec_cfg.head_dim
    if device.type == "cuda" and head_dim not in HEAD_DIMS:
        # every prefill on a CUDA device goes through kernels B2 / B3 (every
        # preset's head size has an instance; a checkpoint's may not)
        bad.append(f"MODEL_PRESET={settings.model_preset} on a CUDA device (its "
                   f"decoder head size {head_dim} has no prefill attention "
                   f"kernel: those are built for {HEAD_DIMS})")
    if settings.decode_mode not in ("fixed", "continuous"):
        bad.append(f"DECODE_MODE={settings.decode_mode} (fixed or continuous)")
    if settings.quant_weights not in ("none", "int8", "int4"):
        bad.append(f"QUANT_WEIGHTS={settings.quant_weights} (none, int8 or int4)")
    if settings.quant_act not in ("none", "int8"):
        bad.append(f"QUANT_ACT={settings.quant_act} (none or int8)")
    return bad


class RagEngine:
    """Owns the models, tokenizers and the device-resident corpus."""

    def __init__(self, settings: Settings, documents: List[str],
                 doc_embeddings: np.ndarray, device: str | torch.device | None = None,
                 mesh=None):
        emb = np.asarray(doc_embeddings, dtype=np.float32)
        # one device is a mesh of one position: every route runs through the
        # mesh code, which calls a lone position directly
        self.mesh = mesh if mesh is not None else Mesh([[resolve_device(device)]])
        if self.mesh.process_count > 1:
            raise ValueError("the engine serves over a mesh of one process; a mesh "
                             "across processes runs the sharded top-k only")
        self.device = self.mesh.lead
        # the corpus sharded, and the one-device routes (packed prefill, the
        # int8 corpus, IVF) off, as in the JAX engine
        self.sharded = self.mesh.size > 1
        # architectures: from the snapshot's own config.json when a local
        # checkpoint exists (any BERT / XLM-R encoder, any Llama-family
        # decoder), else the preset
        enc_hf = snapshot_hf_config(settings.weights_dir, settings.embed_model_name)
        dec_hf = snapshot_hf_config(settings.weights_dir, settings.llm_model_name)
        self.enc_cfg = (encoder_config_from_hf(enc_hf) if enc_hf
                        else encoder_config_for(settings.model_preset))
        self.dec_cfg = (decoder_config_from_hf(dec_hf) if dec_hf
                        else decoder_config_for(settings.model_preset))
        if enc_hf or dec_hf:
            logger.info("architectures from snapshot config.json (enc=%s, dec=%s)",
                        bool(enc_hf), bool(dec_hf))
        bad = unsupported_settings(settings, self.device, self.dec_cfg)
        if bad:
            raise ValueError("rag_serving_system_torch does not implement: "
                             + "; ".join(bad))
        self.settings = settings
        self.batch_buckets = _batch_buckets(settings)
        self.documents = list(documents)
        self.dtype = torch_dtype(settings.dtype)
        if emb.ndim != 2 or emb.shape[1] != self.enc_cfg.hidden_size:
            raise ValueError(
                f"corpus embeddings {emb.shape} do not match encoder hidden size "
                f"{self.enc_cfg.hidden_size} (model_preset={settings.model_preset!r})")

        t0 = time.time()
        enc_params, enc_real = get_encoder_params(
            self.enc_cfg, settings.weights_dir, settings.embed_model_name,
            dtype=self.dtype, device=self.device)
        dec_params, dec_real = get_decoder_params(
            self.dec_cfg, settings.weights_dir, settings.llm_model_name,
            dtype=self.dtype, device=self.device)
        # which model came from a checkpoint, and the seconds both took (the
        # copies and the init run behind the host on a CUDA device: wait)
        self.weights_loaded = {"encoder": enc_real, "decoder": dec_real}
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.models_ready_s = time.time() - t0
        logger.info("models ready on %s in %.1fs (encoder weights: %s, decoder "
                    "weights: %s)", self.device, self.models_ready_s,
                    "hf" if enc_real else "random-init",
                    "hf" if dec_real else "random-init")
        # the decoder's weight bytes as initialised and as held for serving
        # (the whole model's; `position_weight_bytes` has each position's)
        self.weight_bytes_init = weight_bytes(dec_params)
        if settings.quant_weights in ("int8", "int4"):
            bits = 4 if settings.quant_weights == "int4" else 8
            dec_params = quantize_decoder_params(dec_params, bits=bits)
            logger.info("decoder weights quantized to %s (%s)", settings.quant_weights,
                        "group-128 matmuls, int8 embed/head" if bits == 4
                        else "per-channel")
        self.weight_bytes = weight_bytes(dec_params)
        # the setters shard both models over the mesh
        self.enc_params = enc_params
        self.dec_params = dec_params
        del enc_params, dec_params
        if self.sharded:
            logger.info("mesh %s: encoder split %s, decoder split %s, decoder "
                        "bytes a position %s", self.mesh.shape, self._enc.split,
                        self._dec.split, self._dec.position_bytes())
        self.act_quant = (settings.quant_act == "int8"
                          and settings.quant_weights in ("int8", "int4"))
        if settings.quant_act == "int8" and not self.act_quant:
            logger.warning("QUANT_ACT=int8 requires QUANT_WEIGHTS=int8/int4; "
                           "prefill stays %s", settings.dtype)
        # a real tokenizer loads when real weights were found, or when the
        # model name is a local directory (a tokenizer-only snapshot such as
        # data/bpe_tokenizer: real BPE over random weights, as long as its
        # vocabulary fits the model's, which _fits_vocab checks)
        self.enc_tok = (self._fits_vocab(
                            get_tokenizer(settings.embed_model_name,
                                          self.enc_cfg.vocab_size),
                            self.enc_cfg.vocab_size)
                        if enc_real or os.path.isdir(settings.embed_model_name)
                        else None) or HashTokenizer(
                            self.enc_cfg.vocab_size,
                            pad_id=self.enc_cfg.pad_token_id)
        self.dec_tok = (self._fits_vocab(
                            get_tokenizer(settings.llm_model_name,
                                          self.dec_cfg.vocab_size),
                            self.dec_cfg.vocab_size)
                        if dec_real or os.path.isdir(settings.llm_model_name)
                        else None) or HashTokenizer(
                            self.dec_cfg.vocab_size,
                            pad_id=self.dec_cfg.pad_token_id,
                            eos_id=self.dec_cfg.eos_token_id)
        logger.info("tokenizers: encoder %s, decoder %s",
                    type(self.enc_tok).__name__, type(self.dec_tok).__name__)
        emb = _l2n(emb)
        self.n_docs = emb.shape[0]
        self.corpus = None
        self.corpus_scales = None
        self.corpus_mean = None
        self.corpus_chunks = None
        self.ivf_index = None
        retriever_kind = settings.retriever
        corpus_dtype = settings.retrieval_corpus_dtype
        if self.sharded and corpus_dtype == "int8":
            logger.warning("int8 corpus is single-device only; the sharded "
                           "path streams bfloat16 instead")
            corpus_dtype = "bfloat16"
        if self.sharded and retriever_kind == "ivf":
            logger.warning("RETRIEVER=ivf is single-device only; the mesh "
                           "path serves the exact sharded scan instead")
            retriever_kind = "exact"
        # the exact kernels read rows in 16-byte pieces: their corpus gets its
        # depth padded once here (zero columns change no score) and _topk
        # pads the queries. IVF is plain tensor code and takes any depth.
        if retriever_kind != "ivf":
            emb = pad_depth(emb)
        if retriever_kind == "ivf":
            self._build_ivf(emb)
        elif self.sharded:
            dt = torch.bfloat16 if corpus_dtype == "bfloat16" else torch.float32
            self.corpus = shard_corpus(torch.as_tensor(emb).to(dt), self.mesh)
        elif corpus_dtype == "int8":
            # host-side chunked quantization (numpy): no corpus-size device
            # transients; several chunks when N > TOPK_CHUNK_ROWS
            chunks, self.corpus_mean = quantize_corpus_int8_chunked(
                emb, chunk_rows=settings.topk_chunk_rows, device=self.device)
            if len(chunks) == 1:
                self.corpus, self.corpus_scales = chunks[0]
            else:
                self.corpus_chunks = chunks
                logger.info("int8 corpus in %d chunks of <=%d rows",
                            len(chunks), settings.topk_chunk_rows)
        else:
            dt = torch.bfloat16 if corpus_dtype == "bfloat16" else torch.float32
            self.corpus = torch.as_tensor(emb, device=self.device).to(dt)
        self.max_k = min(settings.max_k, self.n_docs)
        # one sampling generator a position, seeded alike within a data
        # group: its positions sample the same tokens from the same logits
        self._generators = self._position_generators(0)
        self.timer = StageTimer()
        # the fixed decode loop's steps as CUDA graphs (they engage on a
        # CUDA device); a mesh of several positions decodes eager
        self.decode_graphs = DecodeGraphs() if self.mesh.size == 1 else None

        # packed prefill for no-prefix batches: B is pinned to the largest
        # batch bucket, T to a ladder of multiples of PACKED_T_STEP. One
        # device only: the packed stream has no batch axis to split
        self.packed = settings.packed_prefill and not self.sharded
        # speculative decode (SPEC_DECODE=gamma) is greedy only: sampling
        # would need rejection resampling to keep its distribution
        self.spec_gamma = settings.spec_gamma if not settings.do_sample else 0
        if self.spec_gamma:
            logger.info("speculative decode on: gamma=%d (greedy verify; a "
                        "feature for trained checkpoints)", self.spec_gamma)
        if self.packed:
            self.packed_p, mean_len = self._auto_packed_p(documents)
            cap = self.batch_buckets[-1]
            step = settings.packed_t_step
            rnd = lambda v: min(-(-int(v) // step) * step,  # noqa: E731
                                -(-cap * self.packed_p // step) * step)
            # small sizes for partial batches, a ladder around the sampled
            # full-batch mean up to 1.7x it, and the top (every row at packed_p)
            typ = cap * mean_len
            self.packed_t_buckets = sorted(
                {rnd(step * i) for i in (1, 2, 3, 4)}
                | {rnd(typ * f)
                   for f in (0.55, 0.65, 0.75, 0.85, 0.95, 1.05, 1.15,
                             1.25, 1.4, 1.55, 1.7)}
                | {rnd(cap * self.packed_p)})
            logger.info("packed prefill on: P=%d (sampled mean prompt %d), "
                        "T buckets %s", self.packed_p, mean_len,
                        self.packed_t_buckets)

        self._prefix_tok_cache = LockedLRU(4096)
        self._prompt_tok_cache = LockedLRU(
            int(os.environ.get("PROMPT_TOKEN_CACHE", "4096")))
        # exact query-result cache: query text → top-max_k index list
        self._query_cache: OrderedDict | None = (
            OrderedDict() if settings.query_cache_size > 0 else None)
        self._query_cache_lock = threading.Lock()
        self.query_cache_hits = 0
        self.query_cache_misses = 0

        # exact prefix-KV cache: one pool tensor on the engine's device; under
        # a mesh whose decoder splits its attention, one part a model
        # position (its KV heads) on each of that position's devices, else
        # the whole pool on every mesh device (`_prefix_placements`)
        self.prefix_cache = None
        self.prefix_int8 = False
        if settings.prefix_cache:
            c = self.dec_cfg
            want_len = settings.prefix_pool_len
            if want_len is None:
                want_len = self._auto_pool_len(documents)
                logger.info("prefix pool auto-sized to %d tokens from "
                            "corpus statistics", want_len)
            # no point caching beyond the longest prompt ever prefilled
            pool_len = min(want_len, max(settings.prompt_len_buckets))
            self.prefix_int8 = settings.prefix_cache_dtype == "int8"
            slots = c.num_layers * 2 * pool_len * c.num_kv_heads
            if self.prefix_int8:  # int8 values and one f32 scale per head-dim row
                entry_bytes = slots * (c.head_dim + 4)
            else:
                entry_bytes = slots * c.head_dim * self.dtype.itemsize
            self.prefix_cache = PrefixKVCache(
                pool_len=pool_len, entry_bytes=entry_bytes,
                budget_mb=settings.prefix_cache_mb,
                entry_shape=(c.num_layers, 2, pool_len, c.num_kv_heads, c.head_dim),
                dtype=self.dtype, int8=self.prefix_int8,
                # one batch may protect its hits and its own inserts from
                # slot reuse: a victim must exist past that
                min_slots=2 * self.batch_buckets[-1] + 1,
                adaptive=settings.prefix_adaptive,
                window=settings.prefix_adaptive_window,
                low_hit_rate=settings.prefix_adaptive_low,
                probe_every=settings.prefix_probe_every, device=self.device,
                **self._prefix_placements())
            logger.info("prefix-KV cache on: pool_len=%d, %s storage, "
                        "%.1f MB/entry, capacity %d entries",
                        pool_len, "int8" if self.prefix_int8 else "compute",
                        entry_bytes / 2**20, self.prefix_cache.capacity)

        # continuous (in-flight) batching: a persistent slot pool replaces
        # the fixed decode loop (core/decode_pool.py). A batch whose prompt
        # bucket plus budget overflows the window falls back to the fixed
        # path inside the pool's worker.
        self.decode_pool = None
        if settings.decode_mode == "continuous":
            from rag_serving_system_torch.core.decode_pool import DecodePool

            # slots may be FEWER than a batch bucket: prefilled rows enter
            # the pool in waves as slots free
            slots = max(1, settings.decode_slots or 2 * self.batch_buckets[-1])
            dp = self.mesh.shape["data"]
            if slots % dp:   # padded up so the slot axis splits evenly over "data"
                slots = -(-slots // dp) * dp
            window = settings.decode_window
            if window == 0:
                window = -(-(max(settings.prompt_len_buckets)
                             + settings.max_new_tokens) // 128) * 128
            self.decode_pool = DecodePool(self, slots=slots, window=window,
                                          chunk=max(1, settings.decode_chunk))

    # ------------------------------------------------------------------
    # the mesh
    # ------------------------------------------------------------------

    @property
    def enc_params(self):
        """The encoder's parameter tree; under a mesh of several positions
        its `ShardedModel`. Assigning a whole tree shards it over the mesh."""
        return self._enc if self.sharded else self._enc.params[0][0]

    @enc_params.setter
    def enc_params(self, params) -> None:
        self._enc = shard_params(params, self.mesh, self.enc_cfg)

    @property
    def dec_params(self):
        """The decoder's parameter tree; under a mesh of several positions
        its `ShardedModel`. Assigning a whole tree shards it over the mesh."""
        return self._dec if self.sharded else self._dec.params[0][0]

    @dec_params.setter
    def dec_params(self, params) -> None:
        self._dec = shard_params(params, self.mesh, self.dec_cfg)
        # a captured decode step reads the replaced tensors
        if getattr(self, "decode_graphs", None) is not None:
            self.decode_graphs.clear()

    @property
    def position_weight_bytes(self) -> list:
        """The decoder bytes each mesh position holds, data-major."""
        return self._dec.position_bytes()

    def _positions(self) -> list:
        dp, tp = self.mesh.shape["data"], self.mesh.shape["model"]
        return [(g, m) for g in range(dp) for m in range(tp)]

    def _position_generators(self, seed: int) -> dict:
        """A sampling generator a position, alike within a data group
        (seed + g)."""
        return {(g, m): torch.Generator(device=self.mesh.device(g, m)).manual_seed(seed + g)
                for g, m in self._positions()}

    def _prefix_part(self, m: int) -> int:
        """The prefix pool part model position m reads."""
        return m if self._dec.split["attn"] else 0

    def _prefix_parts(self) -> range:
        """The prefix pool's parts: one a model position when the decoder's
        attention is split, else one."""
        return range(self.mesh.shape["model"] if self._dec.split["attn"] else 1)

    def _prefix_placements(self) -> dict:
        """PrefixKVCache's `parts` and `placements`: one part a model
        position when the decoder's attention is split, on each of that
        position's devices; else one part on every device."""
        at = {(self._prefix_part(m), self.mesh.device(g, m)) for g, m in self._positions()}
        return {"parts": len(self._prefix_parts()),
                "placements": sorted(at, key=lambda a: (a[0], str(a[1])))}

    def _mesh_run(self, model, b: int, fn) -> tuple:
        """fn(params, g, m, rows, device) on every model position of the data
        groups that serve a b-row batch (`tp.row_groups`), in lockstep.
        Returns (the groups, {(g, m): result})."""
        parts = dict(row_groups(self.mesh, b))
        res = run_positions(
            self.mesh, model,
            lambda g, m: fn(model.params[g][m], g, m, parts[g], self.mesh.device(g, m)),
            list(parts))
        return list(parts), res

    def _gathered(self, tensors: list, dim: int = 0, device=None) -> torch.Tensor:
        """The data groups' pieces, gathered to `device` (the lead device)
        and concatenated along `dim`."""
        out = gather_to(tensors, device or self.device)
        return out[0] if len(out) == 1 else torch.cat(out, dim=dim)

    def _agreed(self, res: dict, groups: list) -> torch.Tensor:
        """The groups' (rows, ...) results of model position 0, gathered to
        the lead device, after checking that every model position of a group
        produced the same values: positions whose replicated state drifted
        apart would decode different tokens into their own K/V."""
        for g in groups:
            lead = res[(g, 0)]
            for m in range(1, self.mesh.shape["model"]):
                if not torch.equal(lead, res[(g, m)].to(lead.device)):
                    raise RuntimeError(f"model positions of data group {g} disagree")
        return self._gathered([res[(g, 0)] for g in groups])

    def _prefix_rows(self, slots, rows: slice, m: int, device):
        """Rows `rows` of a batch's prefix K/V (resolved to pool `slots`) as
        model position m reads them on `device`, or None."""
        if slots is None:
            return None
        return self.prefix_cache.gather(slots[rows], self._prefix_part(m), device)

    # ------------------------------------------------------------------
    # stages 1+2: embed + retrieve
    # ------------------------------------------------------------------

    def _build_ivf(self, emb: np.ndarray) -> None:
        """RETRIEVER=ivf: build the inverted-file index (ops/ivf.py) and gate
        it on recall@5 against exact search before serving. The gate's
        queries are sampled corpus rows; their exact ranks come from a
        chunked host-side scan, so the dense corpus never needs the device."""
        s = self.settings
        n = emb.shape[0]
        n_clusters = s.ivf_clusters or max(8, min(n, int(4 * np.sqrt(n))))
        self.ivf_index = build_ivf(torch.as_tensor(emb, device=self.device),
                                   n_clusters=min(n_clusters, n), iters=10)
        built = self.ivf_index.centroids.shape[0]
        self.ivf_nprobe = max(1, min(s.ivf_nprobe, built))

        # recall gate: sampled corpus rows as queries, exact top-k sets by a
        # chunked scan with a running merge (settings.max_k: self.max_k is
        # not assigned yet)
        rng = np.random.default_rng(0)
        k_gate = max(1, min(5, s.max_k, n))
        q = emb[rng.choice(n, size=min(64, n), replace=False)]
        best_s = best_i = None
        for i in range(0, n, 262144):
            sc = q @ emb[i:i + 262144].T
            kk = min(k_gate, sc.shape[1])
            part = np.argpartition(-sc, kk - 1, axis=1)[:, :kk]
            sc_top = np.take_along_axis(sc, part, axis=1)
            idx_top = part + i
            if best_s is None:
                best_s, best_i = sc_top, idx_top
            else:
                cat_s = np.concatenate([best_s, sc_top], axis=1)
                cat_i = np.concatenate([best_i, idx_top], axis=1)
                keep = np.argpartition(-cat_s, k_gate - 1, axis=1)[:, :k_gate]
                best_s = np.take_along_axis(cat_s, keep, axis=1)
                best_i = np.take_along_axis(cat_i, keep, axis=1)
        exact = best_i
        _, got = ivf_search(self.ivf_index, torch.as_tensor(q, device=self.device),
                            k_gate, nprobe=self.ivf_nprobe)
        got = got.cpu().numpy()
        hits = sum(len(set(exact[i]) & set(got[i])) for i in range(len(q)))
        self.ivf_recall = hits / exact.size
        logger.info("IVF index: %d clusters, nprobe=%d, startup recall@%d "
                    "= %.3f (gate %.2f)", built, self.ivf_nprobe, k_gate,
                    self.ivf_recall, s.ivf_recall_gate)
        if self.ivf_recall < s.ivf_recall_gate:
            raise ValueError(
                f"IVF startup recall@{k_gate} = {self.ivf_recall:.3f} is below "
                f"the gate {s.ivf_recall_gate}: raise IVF_NPROBE (current "
                f"{self.ivf_nprobe}/{built} clusters), lower IVF_RECALL_GATE "
                f"explicitly, or serve RETRIEVER=exact (this corpus may not "
                f"cluster)")

    def _put_batch(self, arr) -> torch.Tensor:
        """A host batch as a tensor on the engine's device (under a mesh the
        lead device: `_mesh_run` hands each data group its rows, split over
        "data" when they divide, else all of them to the first group)."""
        return torch.as_tensor(np.asarray(arr), device=self.device)

    def embed_and_retrieve(self, queries: List[str], ks: List[int]) -> List[List[int]]:
        """Per-query document-index lists (each k clamped to [1, max_k]),
        fronted by the exact query-result cache when it is enabled."""
        if not queries:
            return []
        cap = self.batch_buckets[-1]
        if len(queries) > cap:
            out: List[List[int]] = []
            for i in range(0, len(queries), cap):
                out.extend(self.embed_and_retrieve(queries[i:i + cap], ks[i:i + cap]))
            return out
        ks = [max(1, min(int(k), self.n_docs, self.max_k)) for k in ks]
        if self._query_cache is None:
            full = self._retrieve_full(queries)
            return [row[:k] for row, k in zip(full, ks)]
        with self._query_cache_lock:
            found = {}
            for q in queries:
                row = self._query_cache.get(q)
                if row is not None:
                    self._query_cache.move_to_end(q)
                    found[q] = row
            hits = sum(1 for q in queries if q in found)
            self.query_cache_hits += hits
            self.query_cache_misses += len(queries) - hits
            misses = list(dict.fromkeys(q for q in queries if q not in found))
        if misses:
            fresh = self._retrieve_full(misses)
            with self._query_cache_lock:
                for q, row in zip(misses, fresh):
                    found[q] = row
                    self._query_cache[q] = row
                    self._query_cache.move_to_end(q)
                while len(self._query_cache) > self.settings.query_cache_size:
                    self._query_cache.popitem(last=False)
        return [found[q][:k] for q, k in zip(queries, ks)]

    def query_cache_stats(self) -> dict | None:
        if self._query_cache is None:
            return None
        with self._query_cache_lock:
            lookups = self.query_cache_hits + self.query_cache_misses
            return {"entries": len(self._query_cache),
                    "capacity": self.settings.query_cache_size,
                    "hits": self.query_cache_hits,
                    "misses": self.query_cache_misses,
                    "hit_rate": (self.query_cache_hits / lookups)
                                if lookups else 0.0}

    def _retrieve_full(self, queries: List[str]) -> List[List[int]]:
        """Encode + top-max_k for <= cap queries; one device→host copy."""
        _, idx = self._topk(self._embed_queries(queries), self.max_k)
        idx = idx.cpu().numpy()
        # IVF pads short candidate lists with -1: drop the sentinels rather
        # than let negative indexing pick documents[-1]
        return [[int(j) for j in idx[i] if j >= 0] for i in range(len(queries))]

    def _embed_queries(self, queries: List[str]) -> torch.Tensor:
        """(bucket, D) query embeddings; rows past len(queries) are pads."""
        bsz = pick_bucket(self.batch_buckets, len(queries))
        texts = [QUERY_PREFIX + q for q in queries] + [""] * (bsz - len(queries))
        rows = self.enc_tok.encode_many(texts)
        max_len = pick_bucket(self.settings.encode_len_buckets,
                              max(len(r) for r in rows[:len(queries)]))
        ids, mask = pad_and_stack(rows, max_len, self.enc_tok.pad_id,
                                  pad_side="right")
        # give pad rows one real token so their unmasked mean is defined
        mask[len(queries):, 0] = 1
        ids, mask = self._put_batch(ids), self._put_batch(mask)
        groups, res = self._mesh_run(
            self._enc, bsz, lambda params, g, m, rows, dev: encode(
                params, self.enc_cfg, ids[rows].to(dev), mask[rows].to(dev),
                dtype=self.dtype))
        return self._gathered([res[(g, 0)] for g in groups])

    def _topk(self, q_emb: torch.Tensor, k: int):
        if self.ivf_index is not None:
            return ivf_search(self.ivf_index, q_emb, k, nprobe=self.ivf_nprobe)
        if self.sharded:
            return sharded_cosine_topk(self.corpus, q_emb, k, self.mesh,
                                       valid_n=self.n_docs)
        q_emb = pad_depth(q_emb)
        if self.corpus_chunks is not None:
            return cosine_topk_int8_chunked(self.corpus_chunks, q_emb, k,
                                            corpus_mean=self.corpus_mean)
        if self.corpus_scales is not None:
            return cosine_topk_int8(self.corpus, self.corpus_scales, q_emb, k,
                                    corpus_mean=self.corpus_mean)
        return cosine_topk(self.corpus, q_emb, k)

    # ------------------------------------------------------------------
    # stage 3: generate
    # ------------------------------------------------------------------

    def generate_answers(self, prompts: List[str]) -> List[str]:
        if not prompts:
            return []
        with self.timer.stage("generate"):
            return self._generate_answers(prompts)

    def _generate_answers(self, prompts: List[str]) -> List[str]:
        cap = self.batch_buckets[-1]
        if len(prompts) > cap:
            out: List[str] = []
            for i in range(0, len(prompts), cap):
                out.extend(self._generate_answers(prompts[i:i + cap]))
            return out
        return self.finalize_tokens(self.generate_tokens(prompts))

    def _auto_pool_len(self, documents: List[str]) -> int:
        """Size the prefix pool from the corpus: tokenize sampled 2-document
        context prefixes (k = 2 is the API default) and cover the longest,
        rounded up to a multiple of 128 and clamped to [128, 768]. A pool
        that covers the whole context leaves the question alone in the
        suffix; the maximum and not a percentile, because retrieval
        concentrates on a few hot contexts, of which a uniform sample of
        documents says little, while an oversized pool costs only lazily
        grown memory. Longer contexts still split: their overflow rides the
        suffix."""
        if not documents:
            return 384
        n = len(documents)
        step = max(1, n // 64)
        sample = [documents[i] for i in range(0, n, step)][:64]
        longest = max(
            len(self.dec_tok.encode(PREFIX_TEMPLATE.format(
                context=f"{doc}{DOC_JOIN}{sample[(i + 1) % len(sample)]}")))
            for i, doc in enumerate(sample))
        return min(768, max(128, -(-longest // 128) * 128))

    @staticmethod
    def _fits_vocab(tok, vocab_size: int):
        """Hold a loaded tokenizer against the model's embedding table: one
        with more ids than the table has rows would index past it. Returns
        the tokenizer, or None, which sends the caller to the hash
        tokenizer."""
        hf = getattr(tok, "tok", None)
        if hf is None:
            return tok  # get_tokenizer's hash fallback, made at the model's vocabulary
        if len(hf) > vocab_size:
            logger.warning("tokenizer vocab %d exceeds model vocab %d: falling back "
                           "to the hash tokenizer", len(hf), vocab_size)
            return None
        return tok

    def _auto_packed_p(self, documents: List[str]) -> tuple[int, int]:
        """Packed per-row cache bucket: the prompt bucket covering the longest
        sampled full prompt (2-doc context + a typical question) + 32; and the
        sampled mean prompt length, which centres the T bucket ladder."""
        buckets = self.settings.prompt_len_buckets
        if not documents:
            return buckets[-1], max(buckets[0] // 2, 16)
        n = len(documents)
        step = max(1, n // 64)
        sample = [documents[i] for i in range(0, n, step)][:64]
        q = "what is the answer to this sampled question about the subject?"
        lens = [len(self.dec_tok.encode(PROMPT_TEMPLATE.format(
                    context=f"{doc}{DOC_JOIN}{sample[(i + 1) % len(sample)]}",
                    question=q)))
                for i, doc in enumerate(sample)]
        return (pick_bucket(buckets, max(lens) + 32),
                max(16, sum(lens) // len(lens)))

    def _stage_packed(self, rows: list, n: int, t: int, budgets: np.ndarray):
        """The packed layout: rows back to back in one (1, T) stream. Stages
        a (3, T) [ids | seg | pos] stream, the (cap, P) gather map (-1 =
        empty slot), (cap,) last-token indices (-1 = pad row), the count of
        real rows, the count of real tokens at the head of the stream (a
        host int: B3 computes no pad-tail row, and nothing reads one back
        from the device) and the (cap,) per-row budgets, on the device and
        on the host."""
        cap = self.batch_buckets[-1]
        p = self.packed_p
        rows = [r[-p:] for r in rows[:n]]          # left-truncate over-long
        stream = np.zeros((3, t), dtype=np.int32)
        stream[0] = self.dec_tok.pad_id
        stream[1] = cap                             # pad segment id
        gather = np.full((cap, p), -1, dtype=np.int32)
        last = np.full((cap,), -1, dtype=np.int32)
        off = 0
        for b, r in enumerate(rows):
            ln = len(r)
            stream[0, off:off + ln] = r
            stream[1, off:off + ln] = b
            stream[2, off:off + ln] = np.arange(ln)
            gather[b, p - ln:] = off + np.arange(ln)
            last[b] = off + ln - 1
            off += ln
        return ("packed", self._put_batch(stream), self._put_batch(gather),
                self._put_batch(last), n, off,
                (self._put_batch(budgets), tuple(int(x) for x in budgets)))

    def _prefix_tokens(self, key, prefix_text: str) -> list:
        """Tokenize a context prefix, memoized by its cache key (rows that
        share a context, and repeated batches, tokenize it once)."""
        toks = self._prefix_tok_cache.get(key)
        if toks is None:
            toks = self.dec_tok.encode(prefix_text)
            self._prefix_tok_cache.put(key, toks)
        return toks

    def _prompt_tokens_batch(self, texts) -> list:
        """Batch tokenization fronted by a memo keyed by the prompt string
        (repeated queries repeat whole prompts); misses are deduplicated."""
        keys = [str(t) for t in texts]
        out = [self._prompt_tok_cache.get(k) for k in keys]
        miss = [i for i, v in enumerate(out) if v is None]
        if miss:
            uniq = list(dict.fromkeys(keys[i] for i in miss))
            fresh = dict(zip(uniq, self.dec_tok.encode_many(uniq)))
            for i in miss:
                self._prompt_tok_cache.put(keys[i], fresh[keys[i]])
                out[i] = fresh[keys[i]]
        return out

    def stage_prompts(self, prompts: List[str]):
        """Tokenize, pad and place a prompt batch on the device (the
        `stage_prompts` span). Returns a
        tuple whose first item names the layout and whose last is the rows'
        generation budgets as a (device tensor, host tuple) pair.

        With the prefix-KV cache on, each prompt is split at its cacheable
        context boundary: only the SUFFIX (question and answer cue) is staged
        as input ids, and each row's (cache key, prefix tokens) travels
        beside it for `generate_tokens` to resolve against the cache.
        Batches without a prefix (cache off, every row bypassed, or the
        adaptive gate closed) are staged as a packed stream when that
        undercuts the padded token count by PACKED_MARGIN (and no row is
        longer than packed_p), else as a left-padded batch."""
        with self.timer.stage("stage_prompts"):
            return self._stage_prompts(prompts)

    def _stage_prompts(self, prompts: List[str]):
        bsz = pick_bucket(self.batch_buckets, len(prompts))
        n = len(prompts)
        padded = list(prompts) + [""] * (bsz - n)
        rows = self._prompt_tokens_batch(padded)
        cap_mnt = self.settings.max_new_tokens

        def _bud(p):
            b = getattr(p, "gen_budget", None)
            # None = engine default; 0/negative clamp to 1
            return cap_mnt if b is None else min(cap_mnt, max(1, int(b)))

        bud_host = tuple(_bud(p) if i < n else cap_mnt for i, p in enumerate(padded))
        prompt_buckets = self.settings.prompt_len_buckets
        metas = None
        if (self.prefix_cache is not None
                and any(getattr(p, "cache_key", None) is not None for p in prompts)
                and self.prefix_cache.should_attempt()):
            pool_len = self.prefix_cache.pool_len
            max_cov = pool_len + prompt_buckets[-1]
            metas, suffix_rows = [], []
            for i in range(bsz):
                full = rows[i]
                key = getattr(padded[i], "cache_key", None) if i < n else None
                m = 0
                if key is not None and len(full) <= max_cov:
                    pre = self._prefix_tokens(key, padded[i].prefix_text)
                    m = split_prefix_tokens(full, pre, pool_len)
                    if m < self.prefix_cache.min_tokens:
                        m = 0
                if m > 0:
                    metas.append((key, tuple(full[:m])))
                else:
                    metas.append(None)
                    if i < n:
                        self.prefix_cache.note_bypass()
                suffix_rows.append(full[m:])
            if any(m is not None for m in metas):
                rows = suffix_rows
                plen = pick_bucket(SUFFIX_LEN_BUCKETS + prompt_buckets,
                                   max((len(r) for r in rows[:n]), default=1))
            else:
                # every row bypassed (short contexts, over-long prompts): the
                # plain route at a PROMPT bucket
                metas = None
        if metas is None:
            plen = pick_bucket(prompt_buckets, max(len(r) for r in rows[:n]))
            if self.packed and max(len(r) for r in rows[:n]) <= self.packed_p:
                total = sum(len(r) for r in rows[:n])
                t = pick_bucket(self.packed_t_buckets, total)
                if t <= PACKED_MARGIN * bsz * plen:
                    cap = self.batch_buckets[-1]
                    pb = np.full((cap,), cap_mnt, np.int32)
                    pb[:min(n, cap)] = bud_host[:min(n, cap)]
                    return self._stage_packed(rows, n, t, pb)
        # over-long prompts keep their tail (the question and answer cue)
        ids, mask = pad_and_stack(rows, plen, self.dec_tok.pad_id,
                                  pad_side="left", truncate_side="left")
        mask[n:, -1] = 1  # keep pad rows well-defined
        row_valid = np.arange(bsz) < n  # pad rows are born done
        return ("padded", self._put_batch(ids), self._put_batch(mask),
                self._put_batch(row_valid), n, metas,
                (self._put_batch(np.asarray(bud_host, np.int32)), bud_host))

    def generate_tokens(self, prompts: List[str] | None = None, staged=None):
        """Run generation for a prompt batch (or a `stage_prompts` result);
        returns a handle for `finalize_tokens`."""
        if staged is None:
            staged = self.stage_prompts(prompts)
        s = self.settings
        common = dict(max_new_tokens=s.max_new_tokens, do_sample=s.do_sample,
                      dtype=self.dtype, eos_bias=s.eos_bias, act_quant=self.act_quant,
                      spec_gamma=self.spec_gamma, graphs=self.decode_graphs)
        if staged[0] == "packed":
            _, stream, gather, last, n, n_real, bud = staged
            toks = generate_packed(
                self.dec_params, self.dec_cfg, *self._packed_args(stream, gather, last),
                row_valid=last >= 0, row_budget=bud[0], generator=self._generators[(0, 0)],
                timer=self.timer, n_real=n_real, **common)
            return toks, n
        _, ids, mask, row_valid, n, metas, bud = staged
        prefix_slots, prefix_len = self._staged_prefixes(metas)

        def fn(params, g, m, rows, dev):
            def at(t):
                return None if t is None else t[rows].to(dev)
            return generate(params, self._dec.cfg, at(ids), at(mask),
                            row_valid=at(row_valid), row_budget=at(bud[0]),
                            prefix_kv=self._prefix_rows(prefix_slots, rows, m, dev),
                            prefix_len=at(prefix_len), generator=self._generators[(g, m)],
                            timer=self.timer if (g, m) == (0, 0) else None,
                            **common)

        groups, res = self._mesh_run(self._dec, ids.shape[0], fn)
        return self._agreed(res, groups), n

    @staticmethod
    def _packed_args(stream, gather, last) -> tuple:
        """The packed prefill's tensors from the staged encoding: (ids, seg,
        positions) as (1, T) streams, last-token indices, the gather map and
        the (cap, P) prompt mask."""
        return (stream[0][None], stream[1][None], stream[2][None], last.clamp(min=0),
                gather.clamp(min=0), (gather >= 0).to(torch.int32))

    def _staged_prefixes(self, metas):
        """(prefix pool slots, prefix lengths) of a padded staged batch, or
        (None, None) when it carries no prefix."""
        if metas is None:
            return None, None
        with self.timer.stage("prefix_resolve"):
            return self._resolve_prefixes(metas)

    def prefill_rows(self, staged, generator):
        """Prefill a staged batch for the continuous decode pool: (tok0 (B,),
        k, v, mask (B, T), n): the prompt K/V rows, the combined validity
        mask (the prefix part included where the prefix cache contributed),
        each row's first token and the count of real rows. Staging, prefix
        resolution and the packed route are the fixed path's; only the
        decode differs. `generator` holds one generator a position.

        k and v are lists with one (L, B, T, Hk, D) tensor a prefix pool
        part: under a mesh whose attention is split, the KV heads of a model
        position, every row, on that position's device of the first data
        group. tok0 and mask are on the lead device."""
        s = self.settings
        common = dict(do_sample=s.do_sample, dtype=self.dtype,
                      act_quant=self.act_quant, eos_bias=s.eos_bias)
        if staged[0] == "packed":
            _, stream, gather, last, n, n_real, _bud = staged
            tok0, k, v, cmask = prefill_packed_for_pool(
                self.dec_params, self.dec_cfg, *self._packed_args(stream, gather, last),
                row_valid=last >= 0, generator=generator[(0, 0)], n_real=n_real, **common)
            return tok0, [k], [v], cmask, n
        _, ids, mask, row_valid, n, metas, _bud = staged
        prefix_slots, prefix_len = self._staged_prefixes(metas)

        def fn(params, g, m, rows, dev):
            def at(t):
                return None if t is None else t[rows].to(dev)
            return prefill_for_pool(params, self._dec.cfg, at(ids), at(mask),
                                    row_valid=at(row_valid),
                                    prefix_kv=self._prefix_rows(prefix_slots, rows, m, dev),
                                    prefix_len=at(prefix_len), generator=generator[(g, m)],
                                    **common)

        groups, res = self._mesh_run(self._dec, ids.shape[0], fn)
        tok0 = self._agreed({gm: r[0] for gm, r in res.items()}, groups)
        cmask = self._gathered([res[(g, 0)][3] for g in groups])
        k, v = ([self._gathered([res[(g, p)][j] for g in groups], dim=1,
                                device=self.mesh.device(0, p)) for p in self._prefix_parts()]
                for j in (1, 2))
        return tok0, k, v, cmask, n

    def _resolve_prefixes(self, metas):
        """Map each row's (key, prefix tokens) to a pool slot: cache hits are
        reused; the batch's distinct misses are computed in ONE
        `compute_prefix_kv` call (a context shared by several rows prefills
        once) and written with one insert. Returns the rows' pool slots
        (rows without a prefix read the zeros slot) and the (B,) valid
        lengths; each model position gathers its rows' (B, L, 2, PL, Hk, D)
        prefix K/V (or an (int8 values, scales) pair) from its own pool part
        (`_prefix_rows`)."""
        cache = self.prefix_cache
        entries: list = []
        need: dict = {}
        for meta in metas:
            if meta is None:
                entries.append(None)
                continue
            key, toks = meta
            # the entry key includes the split length: rows sharing a
            # document set can still split at different token boundaries
            ekey = (key, len(toks))
            e = cache.get(ekey, toks)
            if e is None:
                need.setdefault(ekey, toks)
                entries.append(ekey)    # placeholder, filled below
            else:
                entries.append(e)
        if need:
            keys = list(need)
            pids, pmask = pad_and_stack([list(need[k]) for k in keys],
                                        cache.pool_len, self.dec_tok.pad_id,
                                        pad_side="right")
            pids, pmask = self._put_batch(pids), self._put_batch(pmask)
            # B2 on every model position, for the rows of its data group;
            # each pool part gets its heads' K/V of every row
            groups, res = self._mesh_run(
                self._dec, len(keys), lambda params, g, m, rows, dev: compute_prefix_kv(
                    params, self._dec.cfg, pids[rows].to(dev), pmask[rows].to(dev),
                    dtype=self.dtype, act_quant=self.act_quant))
            kv = [self._gathered([res[(g, p)] for g in groups], device=self.mesh.device(0, p))
                  for p in self._prefix_parts()]
            if self.prefix_int8:
                kv = [quantize_prefix_kv(x) for x in kv]
            hit_slots = {e.slot for e in entries if isinstance(e, PrefixEntry)}
            fresh = cache.put_batch(keys, [need[k] for k in keys], kv,
                                    protected=hit_slots)
            entries = [e if isinstance(e, PrefixEntry) else fresh.get(e, e)
                       for e in entries]
        prefix_len = self._put_batch(np.asarray(
            [len(e.tokens) if e is not None else 0 for e in entries], np.int32))
        slots = [e.slot if e is not None else cache.zero_slot for e in entries]
        return slots, prefix_len

    def finalize_tokens(self, handle) -> List[str]:
        """Copy the tokens to the host and detokenize, dropping stop/pad ids."""
        toks_dev, n = handle
        toks = toks_dev.cpu().numpy()
        strip = {self.dec_cfg.pad_token_id, self.dec_cfg.eos_token_id,
                 *getattr(self.dec_cfg, "eos_token_ids", ())}
        return [self.dec_tok.decode([t for t in toks[i] if t not in strip])
                for i in range(n)]

    # ------------------------------------------------------------------
    # full pipeline
    # ------------------------------------------------------------------

    def prepare(self, queries: List[str], ks: List[int],
                budgets: List[int | None] | None = None) -> List[str]:
        """Stage 1: embed + retrieve + prompt build."""
        if budgets is None:
            budgets = [None] * len(queries)
        with self.timer.stage("embed_retrieve"):
            doc_idx = self.embed_and_retrieve(queries, ks)
            contexts = [DOC_JOIN.join(self.documents[i] for i in row)
                        for row in doc_idx]
            if self.prefix_cache is None:
                return [PROMPT_TEMPLATE.format(context=c, question=q) if b is None
                        else PromptSpec(PROMPT_TEMPLATE.format(context=c, question=q),
                                        gen_budget=b)
                        for q, c, b in zip(queries, contexts, budgets)]
            # a PromptSpec is a plain str to batching, and carries the
            # cacheable context prefix and its identity key
            return [PromptSpec(PROMPT_TEMPLATE.format(context=c, question=q),
                               prefix_text=PREFIX_TEMPLATE.format(context=c),
                               cache_key=("ctx", tuple(row)), gen_budget=b)
                    for q, c, row, b in zip(queries, contexts, doc_idx, budgets)]

    def process(self, queries: List[str], ks: List[int],
                budgets: List[int | None] | None = None) -> List[dict]:
        """Full RAG for a batch. Returns per-request result dicts."""
        t0 = time.time()
        prompts = self.prepare(queries, ks, budgets)
        t1 = time.time()
        answers = self.generate_answers(prompts)
        logger.info("batch=%d embed+retrieve=%.3fs generate=%.3fs",
                    len(queries), t1 - t0, time.time() - t1)
        return [{"result": a} for a in answers]

    def _capture_full_batch_steps(self) -> None:
        """Capture the fixed decode loop's step at every key a full batch
        can form (a prompt bucket; the prefix pool plus a suffix bucket), so
        that under load no 0.2-0.4 s capture falls among served batches.
        Partial batches capture on their key's first use. Nothing where the
        decode graphs do not engage or the fixed loop is not the path (the
        speculative loop, the continuous pool)."""
        s = self.settings
        if (self.decode_graphs is None or self.decode_pool is not None or self.spec_gamma
                or s.max_new_tokens < 2 or not DecodeGraphs.engages(self.device)):
            return
        slots = set(s.prompt_len_buckets)
        if self.prefix_cache is not None:
            slots |= {self.prefix_cache.pool_len + b
                      for b in list(SUFFIX_LEN_BUCKETS) + list(s.prompt_len_buckets)}
        if self.packed:
            slots.add(self.packed_p)
        rows, t0 = self.batch_buckets[-1], time.perf_counter()
        for p in sorted(slots):
            self.decode_graphs.prepare(self.dec_params, self.dec_cfg, rows, p,
                                       p + s.max_new_tokens, self.dtype, self.device)
        logger.info("decode step captured at %d keys of %d rows in %.2f s",
                    len(slots), rows, time.perf_counter() - t0)

    def warmup(self) -> None:
        """Build the kernels, run every stage once and capture the decode
        step's full-batch keys before serving; its timings, the cache
        counts and the prefix entry it made are dropped (the pool keeps the
        size it grew to)."""
        self.process(["warmup query"], [1])
        self._capture_full_batch_steps()
        if self.decode_pool is not None:
            # one batch THROUGH the pool: stage, prefill, insert, chunks,
            # delivery
            pool = self.decode_pool
            bcap = self.batch_buckets[-1]
            if not pool._running:
                pool.start()
            got: list = []
            pool.submit([f"w{i}" for i in range(bcap)], ["pool warmup query"] * bcap,
                        lambda rid, res: got.append(res))
            if (not pool.wait_idle(300.0)
                    or sum("result" in res for res in got) != bcap):
                raise RuntimeError(f"decode-pool warmup batch incomplete "
                                   f"({len(got)}/{bcap} delivered): {got[:2]}")
        self.timer.reset()
        if self.prefix_cache is not None:
            self.prefix_cache.clear(reset_counts=True)
        with self._query_cache_lock:
            self.query_cache_hits = 0
            self.query_cache_misses = 0
