"""PyTorch port: it imports nothing of the JAX package, and its copies of the
JAX package's host modules (settings, model presets, tokenizer, queue,
RESP client) agree with their originals.

The isolation check runs in a subprocess whose `sys.meta_path` refuses
`jax`, `jaxlib`, `rag_serving_system_tpu`, `optax`, `flax`, `safetensors` and
`transformers`: `build_app(role="api")` must come up there, and the native
host path (`native/`, `api/native_front.py`) import, without importing
`torch`; every module of the port (the trainer's, the mesh's and
`dryrun_multihost` included) and `chip_smoke` must import; the hash
tokenizer must load its C path where there is a C compiler; an engine over a 2 x 2 mesh of CPU positions
must serve; one query must be served end to end on the CPU
through `main.build_processor` at the tiny presets, with PREFIX_CACHE at its
default (on); and the same engine's models, written as HF snapshots by
`chip_smoke`'s writer, must load through WEIGHTS_DIR bit for bit and serve
under SPEC_DECODE=2 through two stage-1 workers as the first engine did.
The port's native sources are byte-for-byte the JAX package's."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from rag_serving_system_tpu import config as jax_config  # noqa: E402
from rag_serving_system_tpu.models import configs as jax_configs  # noqa: E402
from rag_serving_system_tpu.models import tokenizer as jax_tok  # noqa: E402
from rag_serving_system_tpu.utils import resp as jax_resp  # noqa: E402
from rag_serving_system_torch import config as port_config  # noqa: E402
from rag_serving_system_torch.models import configs as port_configs  # noqa: E402
from rag_serving_system_torch.models import tokenizer as port_tok  # noqa: E402
from rag_serving_system_torch.utils import resp as port_resp  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_ISOLATED = r'''
import importlib, importlib.abc, pkgutil, sys

BLOCKED = ("jax", "jaxlib", "rag_serving_system_tpu", "safetensors", "transformers",
           "optax", "flax")


class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"blocked import of {name}")
        return None


sys.meta_path.insert(0, Refuse())

# ROLE=api first, while nothing has imported torch: queue and HTTP only
from rag_serving_system_torch.config import Settings
from rag_serving_system_torch.core import request_queue
from rag_serving_system_torch.main import build_app
shared = request_queue.RequestQueue(max_batch_size=2, max_wait_time=0.1)
request_queue.make_queue = lambda settings: shared
app, no_processor, no_engine, _ = build_app(
    Settings(model_preset="tiny", redis_url="redis://stand-in:6379"), role="api")
assert app is not None and no_processor is None and no_engine is None
# the native host path imports no torch either
from rag_serving_system_torch.api import native_front
from rag_serving_system_torch import native
assert "torch" not in sys.modules, "ROLE=api or the native host path imported torch"

import rag_serving_system_torch
names = [m.name for m in pkgutil.walk_packages(rag_serving_system_torch.__path__,
                                               "rag_serving_system_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke  # noqa: F401
from rag_serving_system_torch import training
assert {"contrastive_loss", "make_train_step", "train_encoder", "pair_batches", "adamw",
        "save_checkpoint", "load_checkpoint"} <= set(vars(training))

import dataclasses, os, tempfile
import numpy as np
import torch
from rag_serving_system_torch.main import build_processor
from rag_serving_system_torch.models.weights import named_leaves

rng = np.random.default_rng(0)
docs = [" ".join(f"w{rng.integers(0, 50)}" for _ in range(12)) for _ in range(20)]
emb = rng.standard_normal((20, 64)).astype(np.float32)
s = Settings(model_preset="tiny", dtype="float32",
             batch_buckets=[1, 2], max_batch_size=2, encode_len_buckets=[16, 32],
             prompt_len_buckets=[64, 128], max_new_tokens=3, max_k=4,
             max_wait_time=0.1, polling_interval=0.05, redis_url=None)
processor, engine, queue, _ = build_processor(s, docs, emb)
processor.start()
try:
    rid = queue.add_request("what is w3 w7", 2)
    result = queue.get_result(rid, timeout=120)
finally:
    processor.stop(drain_timeout=5.0)
    processor.join(timeout=10)
assert isinstance(result, dict) and isinstance(result.get("result"), str), result
assert s.prefix_cache and engine.prefix_cache.stats()["entries"] == 1
import shutil
if shutil.which("cc"):
    assert engine.dec_tok._lib is not None, "the tokenizer's C path did not load"

# the new paths: checkpoints through the port's own reader, the hash
# tokenizer where `transformers` cannot be imported, greedy speculative
# decode, two stage-1 workers
with tempfile.TemporaryDirectory() as root:
    ckpt_names = {"encoder": "enc", "decoder": "dec"}
    chip_smoke.write_checkpoints(root, engine, ckpt_names)
    os.environ["PREFETCH_WORKERS"] = "2"
    s2 = dataclasses.replace(s, weights_dir=root, embed_model_name="enc",
                             llm_model_name="dec", do_sample=False, spec_gamma=2)
    processor2, loaded, queue2, _ = build_processor(s2, docs, emb)
    assert loaded.weights_loaded == {"encoder": True, "decoder": True}
    assert loaded.enc_cfg == engine.enc_cfg and loaded.dec_cfg == engine.dec_cfg
    for ours, ref in ((loaded.enc_params, engine.enc_params),
                      (loaded.dec_params, engine.dec_params)):
        ref = dict(named_leaves(ref))
        got = dict(named_leaves(ours))
        assert set(got) == set(ref)
        assert all(torch.equal(got[k], ref[k]) for k in ref)
    assert type(loaded.dec_tok).__name__ == "HashTokenizer"
    assert loaded.spec_gamma == 2 and processor2.prefetch_workers == 2
    processor2.start()
    try:
        rids = [queue2.add_request(f"what is w{i} w7", 2) for i in range(5)]
        results = [queue2.get_result(rid, timeout=120) for rid in rids]
    finally:
        processor2.stop(drain_timeout=5.0)
        processor2.join(timeout=10)
    assert all(isinstance(r, dict) and isinstance(r.get("result"), str)
               for r in results), results
    assert loaded.loop_stats["calls"] >= 3

# the mesh: its three modules import, and an engine over a (2, 2) mesh of
# CPU positions serves the first engine's answers from the first engine's
# weights (the decoder's attention and MLP split over "model")
assert {"rag_serving_system_torch.parallel.mesh", "rag_serving_system_torch.parallel.tp",
        "rag_serving_system_torch.parallel.sharded_topk"} <= set(names)
from rag_serving_system_torch.core.engine import RagEngine
from rag_serving_system_torch.parallel.mesh import make_mesh
meshed = RagEngine(s, docs, emb, mesh=make_mesh("2,2", devices=["cpu"] * 4))
meshed.enc_params, meshed.dec_params = engine.enc_params, engine.dec_params
assert meshed.dec_params.split == {"attn": True, "mlp": True}
qs = ["what is w3 w7", "what is w1 w7"]
assert meshed.embed_and_retrieve(qs, [2, 2]) == engine.embed_and_retrieve(qs, [2, 2])
assert all(isinstance(r.get("result"), str) for r in meshed.process(qs, [2, 2]))
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
print("MODULES", len(names), "LEAKED", leaked)
'''


def test_port_runs_with_the_jax_package_blocked():
    env = dict(os.environ, TORCH_DEVICE="cpu")
    env.pop("PREFIX_CACHE", None)
    out = subprocess.run([sys.executable, "-c", _ISOLATED], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    line = [x for x in out.stdout.splitlines() if x.startswith("MODULES")][-1]
    n_modules = int(line.split()[1])
    assert n_modules >= 30, line          # every module of the package was imported
    assert line.endswith("LEAKED []"), line


def _strings(seed: int, n: int = 40) -> list:
    """Seeded strings: ASCII words and punctuation, and words with accents,
    CJK and emoji (the non-ASCII path)."""
    rng = np.random.default_rng(seed)
    ascii_words = ["the", "Boiling", "point", "of", "water", "is", "100", "C", "x_1",
                   "?", ",", "(a)", "don't", "3.14", "A-B", "  ", "\t", "end."]
    other = ["café", "naïve", "Zürich", "東京", "日本語の文", "😀", "ß", "Ωmega", "façade"]
    out = []
    for i in range(n):
        pool = ascii_words + (other if i % 2 else [])
        out.append(" ".join(rng.choice(pool, size=int(rng.integers(0, 30)))))
    return out + ["", "   ", "a" * 300]


@pytest.mark.parametrize("vocab,pad,eos", [(512, 0, 1), (151936, 151643, 151645),
                                           (250002, 1, 2)])
def test_tokenizer_copy_gives_the_jax_ids(vocab, pad, eos):
    ours = port_tok.HashTokenizer(vocab, pad_id=pad, eos_id=eos)
    ref = jax_tok.HashTokenizer(vocab, pad_id=pad, eos_id=eos)
    texts = _strings(vocab)
    assert ours.encode_many(texts) == ref.encode_many(texts)
    ids = ours.encode(texts[3])
    assert ours.decode(ids) == ref.decode(ids)
    rows = ours.encode_many(texts[:6])
    for pad_side, trunc in (("right", "right"), ("left", "left")):
        for got, want in zip(port_tok.pad_and_stack(rows, 16, pad, pad_side, trunc),
                             jax_tok.pad_and_stack(rows, 16, pad, pad_side, trunc)):
            np.testing.assert_array_equal(got, want)


def test_model_presets_equal_jax():
    for name in ("E5_LARGE", "E5_TINY", "QWEN25_15B", "QWEN2_TINY", "LLAMA32_1B"):
        assert (dataclasses.asdict(getattr(port_configs, name))
                == dataclasses.asdict(getattr(jax_configs, name))), name
    for preset in ("tiny", "full", "llama", "other"):
        assert (dataclasses.asdict(port_configs.encoder_config_for(preset))
                == dataclasses.asdict(jax_configs.encoder_config_for(preset)))
        assert (dataclasses.asdict(port_configs.decoder_config_for(preset))
                == dataclasses.asdict(jax_configs.decoder_config_for(preset)))
    assert port_configs.E5_TINY.head_dim == jax_configs.E5_TINY.head_dim


_ENV = {"PORT": "8123", "MAX_BATCH_SIZE": "16", "MAX_WAIT_TIME": "0.25",
        "POLLING_INTERVAL": "0.01", "DOCUMENT_TEXT_FILE": "d.json",
        "DOCUMENT_EMBEDDINGS_FILE": "e.npy", "DOCUMENT_QUERIES_FILE": "q.json", "EMBED_MODEL_NAME": "e5",
        "LLM_MODEL_NAME": "qwen", "REDIS_URL": "redis://localhost:1/0",
        "COMPUTE_DTYPE": "float32", "BATCH_BUCKETS": "1,8", "ENCODE_LEN_BUCKETS": "16",
        "PROMPT_LEN_BUCKETS": "64,256", "PACKED_PREFILL": "false",
        "PACKED_T_STEP": "256", "MAX_NEW_TOKENS": "4", "DECODE_MODE": "continuous",
        "DO_SAMPLE": "0", "SPEC_DECODE": "2", "EOS_BIAS": "1.5", "MAX_K": "300",
        "MESH_SHAPE": "2,1", "WEIGHTS_DIR": "/w", "MODEL_PRESET": "tiny",
        "RETRIEVAL_CORPUS_DTYPE": "int8", "TOPK_CHUNK_ROWS": "99", "RETRIEVER": "ivf",
        "IVF_CLUSTERS": "7", "IVF_NPROBE": "3", "IVF_RECALL_GATE": "0.5",
        "PREFIX_CACHE": "0", "QUERY_CACHE_SIZE": "5", "QUANT_WEIGHTS": "int8",
        "QUANT_ACT": "int8", "HOST": "127.0.0.1", "PREFIX_POOL_LEN": "96",
        "PREFIX_CACHE_MB": "64", "PREFIX_ADAPTIVE": "0", "PREFIX_ADAPTIVE_WINDOW": "32",
        "PREFIX_ADAPTIVE_LOW": "0.5", "PREFIX_PROBE_EVERY": "4",
        "PREFIX_CACHE_DTYPE": "int8", "DECODE_SLOTS": "6", "DECODE_CHUNK": "4",
        "DECODE_WINDOW": "256"}


@pytest.mark.parametrize("env", [{}, _ENV], ids=["defaults", "environment"])
def test_settings_copy_equals_jax(monkeypatch, env):
    for var in _ENV:
        monkeypatch.delenv(var, raising=False)
    defaults = port_config.Settings()
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    ours, ref = port_config.Settings(), jax_config.Settings()
    fields = [f.name for f in dataclasses.fields(ours)]
    assert len(fields) == len(_ENV)
    for name in fields:
        assert getattr(ours, name) == getattr(ref, name), name
        # _ENV sets every variable the port reads, each to a non-default value
        assert (getattr(ours, name) != getattr(defaults, name)) == bool(env), name


def test_resp_wire_encoding_equals_jax():
    cmds = [("RPUSH", "rag_service:requests", '{"id": "a"}'), ("LPOP", b"k"),
            ("SETEX", "rag_service:result:x", 3600, b"\x00\xff"), ("BLPOP", "q", 0.1)]
    for cmd in cmds:
        assert port_resp.RespClient._encode(cmd) == jax_resp.RespClient._encode(cmd)
    c = port_resp.RespClient.from_url("redis://example:7000/3")
    assert c._addr == ("example", 7000) and c._db == 3


@pytest.mark.parametrize("source", ["hashtok.c", "httpfront.cc", "miniredis.cc"])
def test_native_sources_are_copies_of_the_jax_package_s(source):
    """The port builds its own copies of the native sources, byte for byte
    the JAX package's."""
    with open(os.path.join(ROOT, "rag_serving_system_torch", "native", source), "rb") as f:
        ours = f.read()
    with open(os.path.join(ROOT, "rag_serving_system_tpu", "native", source), "rb") as f:
        assert ours == f.read()
