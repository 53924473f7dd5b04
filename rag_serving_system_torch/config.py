"""Service configuration: the environment variables the port reads.

A trimmed copy of `rag_serving_system_tpu/config.py`: the same variable
names and defaults, for the fields this package reads only (the engine's
`unsupported_settings` refuses the ones it does not implement).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Optional


def _env(name: str, default: str) -> str:
    return os.environ.get(name, default)


def _flag(name: str, default: str) -> bool:
    return _env(name, default).lower() not in ("0", "false")


def _parse_int_list(s: str) -> List[int]:
    return [int(x) for x in s.split(",") if x.strip()]


@dataclass
class Settings:
    """Env-driven settings (reads a `.env` file if present)."""

    host: str = field(default_factory=lambda: _env("HOST", "0.0.0.0"))
    port: int = field(default_factory=lambda: int(_env("PORT", "8000")))

    # batching
    max_batch_size: int = field(default_factory=lambda: int(_env("MAX_BATCH_SIZE", "32")))
    max_wait_time: float = field(default_factory=lambda: float(_env("MAX_WAIT_TIME", "1.00")))
    polling_interval: float = field(default_factory=lambda: float(_env("POLLING_INTERVAL", "0.3")))

    # data artifacts
    document_text_file: str = field(
        default_factory=lambda: _env("DOCUMENT_TEXT_FILE", "data/short_facts_contexts.json"))
    document_embeddings_file: str = field(
        default_factory=lambda: _env("DOCUMENT_EMBEDDINGS_FILE", "data/short_facts_embeddings.npy"))
    document_queries_file: str = field(
        default_factory=lambda: _env("DOCUMENT_QUERIES_FILE", "data/short_facts_queries.json"))

    # models (a local directory here asks for a tokenizer loader the port lacks)
    embed_model_name: str = field(
        default_factory=lambda: _env("EMBED_MODEL_NAME", "intfloat/multilingual-e5-large-instruct"))
    llm_model_name: str = field(
        default_factory=lambda: _env("LLM_MODEL_NAME", "Qwen/Qwen2.5-1.5B-Instruct"))

    # queue backend: Redis iff REDIS_URL is set
    redis_url: Optional[str] = field(default_factory=lambda: os.environ.get("REDIS_URL"))

    # compute dtype of the model forwards
    dtype: str = field(default_factory=lambda: _env("COMPUTE_DTYPE", "bfloat16"))
    batch_buckets: List[int] = field(
        default_factory=lambda: _parse_int_list(_env("BATCH_BUCKETS", "1,2,4,8,16,32")))
    encode_len_buckets: List[int] = field(
        default_factory=lambda: _parse_int_list(_env("ENCODE_LEN_BUCKETS", "32,64,128,256,512")))
    prompt_len_buckets: List[int] = field(
        default_factory=lambda: _parse_int_list(_env("PROMPT_LEN_BUCKETS", "128,256,512,1024")))
    # packed prefill of cold batches: one (1, T) stream, T a multiple of
    # PACKED_T_STEP
    packed_prefill: bool = field(default_factory=lambda: _flag("PACKED_PREFILL", "1"))
    packed_t_step: int = field(default_factory=lambda: int(_env("PACKED_T_STEP", "1024")))
    max_new_tokens: int = field(default_factory=lambda: int(_env("MAX_NEW_TOKENS", "10")))
    # 'fixed' (one batch decodes together, done when its slowest row is) |
    # 'continuous' (a persistent slot pool, core/decode_pool.py: rows finish
    # and free their slot one by one, new requests join mid-flight)
    decode_mode: str = field(default_factory=lambda: _env("DECODE_MODE", "fixed"))
    # slot-pool size (0 = auto: 2x the largest batch bucket)
    decode_slots: int = field(default_factory=lambda: int(_env("DECODE_SLOTS", "0")))
    # decode steps per dispatch in continuous mode, with no host read between
    decode_chunk: int = field(default_factory=lambda: int(_env("DECODE_CHUNK", "8")))
    # ring window per slot in tokens (0 = auto: largest prompt bucket +
    # max_new_tokens, rounded up to 128); a batch staging more K/V than the
    # window falls back to fixed decode
    decode_window: int = field(default_factory=lambda: int(_env("DECODE_WINDOW", "0")))
    do_sample: bool = field(default_factory=lambda: _flag("DO_SAMPLE", "1"))
    # speculative decode draft length; 0 only in the port
    spec_gamma: int = field(default_factory=lambda: int(_env("SPEC_DECODE", "0")))
    # EOS logit bias under sampling (workload shaping; 0 = off)
    eos_bias: float = field(default_factory=lambda: float(_env("EOS_BIAS", "0")))
    # retrieval: the fixed k retrieved per batch; each request's k <= it is
    # sliced on the host
    max_k: int = field(default_factory=lambda: int(_env("MAX_K", "16")))
    # "dp,tp" mesh sizes over the visible CUDA devices (main.py, with more
    # than one); empty serves on one device
    mesh_shape: str = field(default_factory=lambda: _env("MESH_SHAPE", ""))
    # a checkpoint directory; none is loaded by the port yet
    weights_dir: Optional[str] = field(default_factory=lambda: os.environ.get("WEIGHTS_DIR"))
    # 'full' | 'tiny' | 'llama' model size preset (random weights)
    model_preset: str = field(default_factory=lambda: _env("MODEL_PRESET", "full"))
    # corpus dtype: 'float32' (oracle-exact) | 'bfloat16' | 'int8'
    # (mean-centred per-row quantization)
    retrieval_corpus_dtype: str = field(
        default_factory=lambda: _env("RETRIEVAL_CORPUS_DTYPE", "float32"))
    # an int8 corpus of more rows is split into chunks of this many
    topk_chunk_rows: int = field(
        default_factory=lambda: int(_env("TOPK_CHUNK_ROWS", str(4_194_304))))
    # "exact" or "ivf" (approximate, recall-gated at startup)
    retriever: str = field(default_factory=lambda: _env("RETRIEVER", "exact"))
    ivf_clusters: int = field(default_factory=lambda: int(_env("IVF_CLUSTERS", "0")))
    ivf_nprobe: int = field(default_factory=lambda: int(_env("IVF_NPROBE", "8")))
    ivf_recall_gate: float = field(
        default_factory=lambda: float(_env("IVF_RECALL_GATE", "0.9")))
    # exact prefix-KV cache of repeated RAG contexts (core/prefix_cache.py):
    # the context's K/V is kept on the device and only the question is prefilled
    prefix_cache: bool = field(default_factory=lambda: _flag("PREFIX_CACHE", "1"))
    # tokens of each cached entry; longer contexts cache their first
    # PREFIX_POOL_LEN tokens. Unset = sized from the corpus at construction
    prefix_pool_len: Optional[int] = field(
        default_factory=lambda: (int(os.environ["PREFIX_POOL_LEN"])
                                 if os.environ.get("PREFIX_POOL_LEN") else None))
    # device-memory budget of the prefix pool (LRU slot reuse beyond it)
    prefix_cache_mb: int = field(
        default_factory=lambda: int(_env("PREFIX_CACHE_MB", "2048")))
    # adaptive bypass: when the hit rate over the last PREFIX_ADAPTIVE_WINDOW
    # lookups falls below PREFIX_ADAPTIVE_LOW, only every
    # PREFIX_PROBE_EVERY-th batch takes the prefix path
    prefix_adaptive: bool = field(default_factory=lambda: _flag("PREFIX_ADAPTIVE", "1"))
    prefix_adaptive_window: int = field(
        default_factory=lambda: int(_env("PREFIX_ADAPTIVE_WINDOW", "512")))
    prefix_adaptive_low: float = field(
        default_factory=lambda: float(_env("PREFIX_ADAPTIVE_LOW", "0.25")))
    prefix_probe_every: int = field(
        default_factory=lambda: int(_env("PREFIX_PROBE_EVERY", "8")))
    # entry storage: 'compute' (the engine's dtype, bit-exact reuse) | 'int8'
    # (per-(token, head) symmetric quantization, not bit-exact)
    prefix_cache_dtype: str = field(
        default_factory=lambda: _env("PREFIX_CACHE_DTYPE", "compute"))
    # exact query-result cache entries (0 disables)
    query_cache_size: int = field(
        default_factory=lambda: int(_env("QUERY_CACHE_SIZE", "8192")))
    # decoder weights: 'none' | 'int8' (per output channel) | 'int4'
    # (groups of 128, two nibbles a byte; embedding and head stay int8)
    quant_weights: str = field(default_factory=lambda: _env("QUANT_WEIGHTS", "none"))
    # 'int8': per-token int8 activations in prefill (W8A8); needs
    # quantized weights
    quant_act: str = field(default_factory=lambda: _env("QUANT_ACT", "none"))


def load_dotenv(path: str = ".env") -> None:
    """Minimal .env loader (KEY=VALUE lines; does not override existing env)."""
    if not os.path.exists(path):
        return
    with open(path, "r", encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#") or "=" not in line:
                continue
            key, _, value = line.partition("=")
            key, value = key.strip(), value.strip().strip('"').strip("'")
            os.environ.setdefault(key, value)


def get_settings() -> Settings:
    load_dotenv()
    return Settings()
