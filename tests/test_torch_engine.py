"""PyTorch port: the serving engine, batch processor and HTTP surface against
the JAX engine, at the tiny presets in f32 with greedy decoding.

Both engines share one set of weights (the JAX engine's, converted; decoder
matrices scaled by 8 so greedy answers vary) and one seeded 64-dim corpus,
and must retrieve the same ids and give the same answers on the padded
route (a lone request) and the packed route (a full batch)."""

import json
import os
import subprocess
import sys
import time
import urllib.request

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from rag_serving_system_tpu import config as jax_config  # noqa: E402
from rag_serving_system_tpu.core import engine as jax_engine  # noqa: E402
from rag_serving_system_tpu.core.retriever import _l2n  # noqa: E402
from rag_serving_system_torch import config as port_config  # noqa: E402
from rag_serving_system_torch.core import engine as port_engine  # noqa: E402
from rag_serving_system_torch.core.batch_processor import BatchProcessor  # noqa: E402
from rag_serving_system_torch.core.request_queue import make_queue  # noqa: E402
from rag_serving_system_torch.models.weights import (  # noqa: E402
    ivf_index_from_jax,
    params_from_jax,
)
from rag_serving_system_tpu.ops import topk as jax_topk  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUERIES = ["what is w1 w2", "tell me w5", "w7 w8 w9 w10", "another question w3"]


def tiny_settings(cls=None, **over):
    """The verify skill's tiny buckets, as the port's `Settings` (or `cls`,
    the JAX package's). Prompt buckets 32,128 put the 4-row batch's
    ~55-token prompts in the 128 bucket, where the packed gate
    t <= 0.85 * bsz * plen opens for the 256-token stream."""
    base = dict(model_preset="tiny", dtype="float32", do_sample=False,
                prefix_cache=False, batch_buckets=[1, 4], max_batch_size=4,
                encode_len_buckets=[16, 32], prompt_len_buckets=[32, 128],
                packed_t_step=256, max_new_tokens=6, max_k=4,
                max_wait_time=0.2, polling_interval=0.05,
                decode_mode="fixed", quant_weights="none", quant_act="none",
                retrieval_corpus_dtype="float32", retriever="exact",
                spec_gamma=0, mesh_shape="", weights_dir=None,
                embed_model_name="e5", llm_model_name="qwen")
    base.update(over)
    return (cls or port_config.Settings)(**base)


def jax_settings(**over):
    return tiny_settings(jax_config.Settings, **over)


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(0)
    docs = [" ".join(f"w{rng.integers(0, 300)}" for _ in range(rng.integers(14, 24)))
            for _ in range(40)]
    return docs, rng.standard_normal((40, 64)).astype(np.float32)


def _scaled(tree, f):
    return {k: (_scaled(v, f) if isinstance(v, dict) else
                v * f if k in ("embed", "qkv_w", "o_w", "gu_w", "down_w") else v)
            for k, v in tree.items()}


@pytest.fixture(scope="module", params=[True, False], ids=["packed", "padded_only"])
def engines(request, corpus):
    docs, emb = corpus
    je = jax_engine.RagEngine(jax_settings(packed_prefill=request.param), docs, emb)
    je.dec_params = _scaled(je.dec_params, 8.0)
    te = port_engine.RagEngine(tiny_settings(packed_prefill=request.param), docs, emb,
                               device="cpu")
    te.enc_params = params_from_jax(jax.device_get(je.enc_params))
    te.dec_params = params_from_jax(jax.device_get(je.dec_params))
    return je, te


@pytest.mark.parametrize("n", [1, 4], ids=["lone", "full_batch"])
def test_engine_matches_jax(engines, n):
    je, te = engines
    qs, ks = QUERIES[:n], [2] * n
    assert te.embed_and_retrieve(qs, ks) == je.embed_and_retrieve(qs, ks)
    route = te.stage_prompts(te.prepare(qs, ks))[0]
    assert route == je.stage_prompts(je.prepare(qs, ks))[0]
    assert route == ("packed" if te.packed and n == 4 else "padded")
    ours = te.process(qs, ks)
    assert ours == je.process(qs, ks)
    assert all(r["result"] for r in ours)


def test_request_budgets_match_jax(engines):
    je, te = engines
    qs, ks, budgets = QUERIES, [2] * 4, [1, 3, None, 6]
    ours = te.process(qs, ks, budgets)
    assert ours == je.process(qs, ks, budgets)
    assert len(ours[0]["result"].split()) <= 1


def test_queue_and_processor_answer_requests(corpus):
    docs, emb = corpus
    s = tiny_settings(packed_prefill=True)
    engine = port_engine.RagEngine(s, docs, emb, device="cpu")
    q = make_queue(s)
    proc = BatchProcessor(q, engine, polling_interval=0.05)
    proc.start()
    try:
        ids = [q.add_request(text, 2) for text in QUERIES + ["one more w9"]]
        results = [q.get_result(i, timeout=120) for i in ids]
    finally:
        proc.stop(drain_timeout=5.0)
        proc.join(timeout=10)
    assert not proc.is_alive()
    assert all(isinstance(r, dict) and isinstance(r.get("result"), str)
               for r in results), results
    assert proc.requests_processed == 5 and proc.batches_processed >= 2


def test_processor_isolates_a_failing_batch(corpus):
    docs, emb = corpus
    s = tiny_settings()
    engine = port_engine.RagEngine(s, docs, emb, device="cpu")

    def boom(prompts):
        raise RuntimeError("device lost")

    engine.generate_tokens = boom
    q = make_queue(s)
    proc = BatchProcessor(q, engine, polling_interval=0.05)
    proc.start()
    try:
        rid = q.add_request("w1", 2)
        res = q.get_result(rid, timeout=60)
    finally:
        proc.stop(drain_timeout=2.0)
    assert res == {"error": "device lost", "status": "failed"}


def _http(method, url, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers={"content-type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def test_http_post_and_poll(corpus, tmp_path, monkeypatch):
    """POST /rag → poll GET /rag/result/{id} through the port's create_api,
    with main.build_app wiring the engine and processor."""
    pytest.importorskip("aiohttp")
    from rag_serving_system_torch.api.endpoints import ServerThread
    from rag_serving_system_torch.main import build_app

    docs, emb = corpus
    (tmp_path / "docs.json").write_text(json.dumps(docs))
    np.save(tmp_path / "emb.npy", emb)
    s = tiny_settings(document_text_file=str(tmp_path / "docs.json"),
                      document_embeddings_file=str(tmp_path / "emb.npy"))
    monkeypatch.setenv("TORCH_DEVICE", "cpu")
    app, proc, _, _ = build_app(s)
    server = ServerThread(app).start()
    try:
        sub = _http("POST", server.url + "/rag", {"query": "what is w1", "k": 2})
        assert sub["status"] == "processing"
        deadline = time.time() + 60
        while time.time() < deadline:
            res = _http("GET", server.url + f"/rag/result/{sub['request_id']}")
            if res["status"] == "complete":
                break
            time.sleep(0.05)
        assert res["status"] == "complete" and isinstance(res["result"]["result"], str)
        stats = _http("GET", server.url + "/stats")
        assert stats["requests_processed"] >= 1
    finally:
        server.stop()
        proc.stop(drain_timeout=2.0)


def _engine_pair(corpus, **over):
    """A JAX and a port engine on one corpus, sharing the JAX weights."""
    docs, emb = corpus
    je = jax_engine.RagEngine(jax_settings(**over), docs, emb)
    te = port_engine.RagEngine(tiny_settings(**over), docs, emb, device="cpu")
    te.enc_params = params_from_jax(jax.device_get(je.enc_params))
    return je, te


@pytest.mark.parametrize("over", [
    dict(retrieval_corpus_dtype="int8"),
    dict(retrieval_corpus_dtype="int8", topk_chunk_rows=15),   # 3 chunks, ragged tail
    dict(retriever="ivf", ivf_clusters=4, ivf_nprobe=2, ivf_recall_gate=0.0),
    dict(max_k=48),        # k = 40 over the 40-row corpus: lists past 32
], ids=["int8", "int8_chunked", "ivf", "max_k_48"])
def test_engine_serves_retrieval_settings_like_jax(corpus, over):
    je, te = _engine_pair(corpus, **over)
    if over.get("retriever") == "ivf":   # k-means inits differ: share JAX's index
        assert te.ivf_index is not None and te.corpus is None
        te.ivf_index = ivf_index_from_jax(jax.device_get(je.ivf_index))
        te.ivf_nprobe = je.ivf_nprobe
    else:
        chunked = "topk_chunk_rows" in over
        assert (te.corpus_chunks is not None) == chunked
        assert (je.corpus_chunks is not None) == chunked
        if chunked:
            assert [c.shape[0] for c, _ in te.corpus_chunks] == [15, 15, 10]
    ks = [4, 2, 3, 4]
    ids = te.embed_and_retrieve(QUERIES, ks)
    assert ids == je.embed_and_retrieve(QUERIES, ks)
    assert [len(r) for r in ids] == ks
    assert all(isinstance(r["result"], str) for r in te.process(QUERIES[:2], [2, 2]))


def test_engine_bfloat16_corpus_follows_the_kernel(corpus):
    """A bf16 corpus meets bf16-rounded queries, as the TPU kernel does; the
    JAX engine's CPU path scores unrounded f32 queries, so it must agree
    only where no near-tie exists."""
    docs, emb = corpus
    je, te = _engine_pair(corpus, retrieval_corpus_dtype="bfloat16")
    assert te.corpus.dtype == torch.bfloat16
    q = te._embed_queries(QUERIES).float().numpy()
    ids = te.embed_and_retrieve(QUERIES, [4] * 4)
    _, want = jax_topk.cosine_topk_pallas(jax.device_get(je.corpus), q, te.max_k,
                                          block_n=128, interpret=True)
    assert ids == np.asarray(want)[:4].tolist()
    exact = jax_topk.cosine_topk_reference(_l2n(emb), q[:4], te.max_k + 1)[0]
    gaps = -np.diff(np.asarray(exact), axis=1)
    clear = [i for i in range(4) if gaps[i].min() > 1e-2]
    assert clear
    ref = je.embed_and_retrieve(QUERIES, [4] * 4)
    assert [ids[i] for i in clear] == [ref[i] for i in clear]


@pytest.mark.parametrize("over,var", [
    (dict(prefix_cache=True), "PREFIX_CACHE"),
    (dict(decode_mode="continuous"), "DECODE_MODE"),
    (dict(quant_weights="int8"), "QUANT_WEIGHTS"),
    (dict(quant_act="int8"), "QUANT_ACT"),
    (dict(max_k=300), "MAX_K"),
    (dict(spec_gamma=2), "SPEC_DECODE"),
    (dict(mesh_shape="2,1"), "MESH_SHAPE"),
    (dict(weights_dir="/nonexistent"), "WEIGHTS_DIR"),
])
def test_unimplemented_settings_raise(corpus, over, var):
    """Each setting the port does not implement raises at construction.
    MAX_K is implemented at any value: MAX_K=300 over 300 rows (k = N, past
    the warp lists' 256) retrieves the JAX engine's ids."""
    docs, emb = corpus
    if var == "MAX_K":
        _assert_max_k_like_jax(over["max_k"], 300)
        return
    with pytest.raises(ValueError, match=var):
        port_engine.RagEngine(tiny_settings(**over), docs, emb, device="cpu")


def _assert_max_k_like_jax(max_k: int, n: int):
    """Both engines over n seeded rows at MAX_K=max_k retrieve the same ids
    for requests of k = n, 257, 2 and n - 1 (each clamped to max_k)."""
    rng = np.random.default_rng(1)
    docs = [f"doc {i}" for i in range(n)]
    emb = rng.standard_normal((n, 64)).astype(np.float32)
    emb[7] = emb[3]                     # an exact tie: the lower index first
    je = jax_engine.RagEngine(jax_settings(max_k=max_k), docs, emb)
    te = port_engine.RagEngine(tiny_settings(max_k=max_k), docs, emb, device="cpu")
    te.enc_params = params_from_jax(jax.device_get(je.enc_params))
    assert te.max_k == je.max_k == min(max_k, n)
    ks = [n, 257, 2, n - 1]
    got = te.embed_and_retrieve(QUERIES, ks)
    assert got == je.embed_and_retrieve(QUERIES, ks)
    assert [len(r) for r in got] == [min(k, max_k) for k in ks]


@pytest.mark.parametrize("max_k,n", [(257, 300), (1000, 300)], ids=["k257", "k_is_n"])
def test_engine_serves_max_k_beyond_the_warp_lists_like_jax(max_k, n):
    _assert_max_k_like_jax(max_k, n)


def test_max_k_above_the_kernels_clamps_to_a_small_corpus(corpus):
    """MAX_K=300 over 40 documents retrieves k = 40, as the JAX engine
    clamps it: the port builds and serves."""
    docs, emb = corpus
    te = port_engine.RagEngine(tiny_settings(max_k=300), docs, emb, device="cpu")
    assert te.max_k == 40
    assert [len(r) for r in te.embed_and_retrieve(QUERIES[:2], [300, 2])] == [40, 2]
    assert all(isinstance(r["result"], str) for r in te.process(QUERIES[:2], [2, 2]))


def test_default_device_is_cuda_and_raises_without_it(corpus):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    docs, emb = corpus
    with pytest.raises(RuntimeError, match="cuda"):
        port_engine.RagEngine(tiny_settings(), docs, emb)


def test_copied_constants_equal_jax():
    for name in ("PROMPT_TEMPLATE", "DOC_JOIN", "QUERY_PREFIX", "PACKED_MARGIN"):
        assert getattr(port_engine, name) == getattr(jax_engine, name), name
    for buckets, n in (([1, 2, 4, 8], 3), ([1, 2, 4, 8], 8), ([1, 2, 4, 8], 9)):
        assert port_engine.pick_bucket(buckets, n) == jax_engine.pick_bucket(buckets, n)
    for over in (dict(), dict(max_batch_size=48), dict(batch_buckets=[8, 2, 2])):
        assert (port_engine._batch_buckets(tiny_settings(**over))
                == jax_engine._batch_buckets(jax_settings(**over)))
    x = np.random.default_rng(0).standard_normal((5, 8)).astype(np.float32)
    x[2] = 0.0
    np.testing.assert_array_equal(port_engine._l2n(x), _l2n(x))


def test_port_never_imports_jax():
    mods = ["rag_serving_system_torch", "rag_serving_system_torch.device",
            "rag_serving_system_torch.ops._build", "rag_serving_system_torch.ops.topk",
            "rag_serving_system_torch.ops.attention", "rag_serving_system_torch.ops.ivf",
            "rag_serving_system_torch.ops.probes", "rag_serving_system_torch.profile_topk",
            "rag_serving_system_torch.models", "rag_serving_system_torch.models.layers",
            "rag_serving_system_torch.models.weights",
            "rag_serving_system_torch.models.e5", "rag_serving_system_torch.models.qwen2",
            "rag_serving_system_torch.core.engine",
            "rag_serving_system_torch.core.batch_processor",
            "rag_serving_system_torch.core.retriever",
            "rag_serving_system_torch.core.request_queue",
            "rag_serving_system_torch.main"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "print('jax' in sys.modules, 'aiohttp' in sys.modules,\n"
            "      any(m.startswith('rag_serving_system_tpu') for m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False", "False", "False"]
