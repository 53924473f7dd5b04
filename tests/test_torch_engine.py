"""PyTorch port: the serving engine, batch processor and HTTP surface against
the JAX engine, at the tiny presets in f32 with greedy decoding.

Both engines share one set of weights (the JAX engine's, converted; decoder
matrices scaled by 8 so greedy answers vary) and one seeded 64-dim corpus,
and must retrieve the same ids and give the same answers on the padded
route (a lone request) and the packed route (a full batch), and with the
prefix-KV cache on: the miss route, the hit route and the bypass route, with
the cache's counters equal to the JAX engine's after the same calls."""

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
from rag_serving_system_torch.models import qwen2 as port_qwen2  # noqa: E402
from rag_serving_system_torch.models.weights import (  # noqa: E402
    ivf_index_from_jax,
    params_from_jax,
)
from rag_serving_system_tpu.ops import topk as jax_topk  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUERIES = ["what is w1 w2", "tell me w5", "w7 w8 w9 w10", "another question w3"]
DEFAULT = object()   # tiny_settings(prefix_cache=DEFAULT): the Settings default


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
    if base["prefix_cache"] is DEFAULT:
        del base["prefix_cache"]
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


def test_packed_batch_passes_its_real_count_to_b3(engines, monkeypatch):
    """A cold packed batch stages the count of its real tokens, a host int
    below T, and every B3 call of its prefill gets it; greedy f32 answers
    are the JAX engine's, as with every row computed. The padded-only
    engine stages the batch padded and calls no B3."""
    je, te = engines
    qs, ks = QUERIES, [2] * 4
    staged = te.stage_prompts(te.prepare(qs, ks))
    calls, b3 = [], port_qwen2.flash_attention_packed

    def recorded(q, k, v, seg, n_real=None):
        calls.append(n_real)
        return b3(q, k, v, seg, n_real)
    monkeypatch.setattr(port_qwen2, "flash_attention_packed", recorded)
    ours = te.finalize_tokens(te.generate_tokens(staged=staged))
    assert ours == je.finalize_tokens(je.generate_tokens(je.prepare(qs, ks)))
    if not te.packed:
        assert staged[0] == "padded" and not calls
        return
    assert staged[0] == "packed"
    n_real, t = staged[5], staged[1].shape[1]
    assert isinstance(n_real, int) and 0 < n_real < t
    assert calls == [n_real] * te.dec_cfg.num_layers


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

    def boom(prompts, staged=None):
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
    monkeypatch.delenv("PREFIX_CACHE", raising=False)
    s = tiny_settings(document_text_file=str(tmp_path / "docs.json"),
                      document_embeddings_file=str(tmp_path / "emb.npy"),
                      prefix_cache=DEFAULT)
    assert s.prefix_cache is True
    monkeypatch.setenv("TORCH_DEVICE", "cpu")
    app, proc, engine, _ = build_app(s)
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
        assert stats["prefix_cache"] == engine.prefix_cache.stats()
        assert stats["prefix_cache"]["entries"] >= 1 and "prefix_resolve" in stats["stages"]
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
    (dict(llm_model_name=ROOT), "LLM_MODEL_NAME"),     # a local model directory
    (dict(decode_mode="paged"), "DECODE_MODE"),        # continuous is served; this is not
    (dict(quant_weights="fp8"), "QUANT_WEIGHTS"),      # int8 and int4 are served
    (dict(quant_act="fp8"), "QUANT_ACT"),
    (dict(max_k=300), "MAX_K"),
    (dict(spec_gamma=2), "SPEC_DECODE"),
    (dict(mesh_shape="2,1"), "MESH_SHAPE"),
    (dict(weights_dir="/nonexistent"), "WEIGHTS_DIR"),
])
def test_unimplemented_settings_raise(corpus, over, var):
    """Each setting (or value of one) the port does not implement raises at
    construction. The others behave as in the JAX engine: MAX_K=300 over 300
    rows (k = N, past the warp lists' 256) retrieves its ids; a model
    directory with no tokenizer files falls back to hashing; SPEC_DECODE=2
    serves its answers; a WEIGHTS_DIR that does not exist gives random
    init; MESH_SHAPE=2,1 is accepted, and the engine over that mesh (two
    CPU positions) gives the JAX engine's answers."""
    docs, emb = corpus
    if var == "MAX_K":
        _assert_max_k_like_jax(over["max_k"], 300)
        return
    if var == "MESH_SHAPE":
        from rag_serving_system_torch.parallel.mesh import make_mesh

        assert not port_engine.unsupported_settings(tiny_settings(**over),
                                                    torch.device("cpu"))
        je = jax_engine.RagEngine(jax_settings(**over), docs, emb)
        je.dec_params = _scaled(je.dec_params, 8.0)
        te = port_engine.RagEngine(tiny_settings(**over), docs, emb,
                                   mesh=make_mesh(over["mesh_shape"], devices=["cpu"] * 2))
        te.enc_params = params_from_jax(jax.device_get(je.enc_params))
        te.dec_params = params_from_jax(jax.device_get(je.dec_params))
        assert te.mesh.shape == {"data": 2, "model": 1} and len(te.corpus) == 2
        assert te.process(QUERIES, [2] * 4) == je.process(QUERIES, [2] * 4)
        return
    if var in ("LLM_MODEL_NAME", "SPEC_DECODE", "WEIGHTS_DIR"):
        assert not port_engine.unsupported_settings(tiny_settings(**over),
                                                    torch.device("cpu"))
        je = jax_engine.RagEngine(jax_settings(**over), docs, emb)
        je.dec_params = _scaled(je.dec_params, 8.0)
        te = port_engine.RagEngine(tiny_settings(**over), docs, emb, device="cpu")
        for tok, ref in ((te.enc_tok, je.enc_tok), (te.dec_tok, je.dec_tok)):
            # hashing on both sides, with the same special ids
            assert type(tok).__name__ == type(ref).__name__ == "HashTokenizer"
            assert (tok.pad_id, tok.eos_id, tok.bos_id, tok.vocab_size) == (
                ref.pad_id, ref.eos_id, ref.bos_id, ref.vocab_size)
        assert te.spec_gamma == je.spec_gamma == over.get("spec_gamma", 0)
        # random init: the seeded tree, whatever WEIGHTS_DIR says
        fresh = port_engine.get_decoder_params(te.dec_cfg, None, "qwen",
                                               dtype=te.dtype)[0]
        assert torch.equal(te.dec_params["embed"], fresh["embed"])
        te.enc_params = params_from_jax(jax.device_get(je.enc_params))
        te.dec_params = params_from_jax(jax.device_get(je.dec_params))
        assert te.process(QUERIES, [2] * 4) == je.process(QUERIES, [2] * 4)
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
    for name in ("PROMPT_TEMPLATE", "PREFIX_TEMPLATE", "DOC_JOIN", "QUERY_PREFIX",
                 "PACKED_MARGIN", "SUFFIX_LEN_BUCKETS"):
        assert getattr(port_engine, name) == getattr(jax_engine, name), name
    assert port_engine.SUFFIX_LEN_BUCKETS == [32, 64]
    for spec in ("64,24,32", "32", " 8 , 16,", "", "a,b", "0,-4", "0,48"):
        assert port_engine._parse_len_buckets(spec) == jax_engine._parse_len_buckets(spec)
    assert port_engine.pick_bucket(port_engine._parse_len_buckets("64,24,32"), 20) == 24
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
            "rag_serving_system_torch.core.prefix_cache",
            "rag_serving_system_torch.core.decode_pool",
            "rag_serving_system_torch.ops.quant",
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


# ---------------------------------------------------------------------------
# the prefix-KV cache: hit, miss and bypass routes
# ---------------------------------------------------------------------------

def _prefix_engines(corpus, **over):
    """A JAX and a port engine with the prefix cache on (48-token pool) and
    a port engine with it off, all on the JAX engine's weights, the
    decoder's matrices scaled by 8."""
    docs, emb = corpus
    over = dict(prefix_cache=True, prefix_pool_len=48, **over)
    je = jax_engine.RagEngine(jax_settings(**over), docs, emb)
    je.dec_params = _scaled(je.dec_params, 8.0)
    on = port_engine.RagEngine(tiny_settings(**over), docs, emb, device="cpu")
    off = port_engine.RagEngine(tiny_settings(**dict(over, prefix_cache=False)), docs, emb,
                                device="cpu")
    for te in (on, off):
        te.enc_params = params_from_jax(jax.device_get(je.enc_params))
        te.dec_params = params_from_jax(jax.device_get(je.dec_params))
    return je, on, off


COUNTERS = ("entries", "hits", "misses", "bypassed", "slots", "grows", "capacity",
            "bytes", "pool_reserved_bytes", "hit_rate")


def _counters(engine):
    st = engine.prefix_cache.stats()
    return {k: st[k] for k in COUNTERS}


@pytest.mark.parametrize("n", [1, 4], ids=["lone", "full_batch"])
def test_prefix_cache_answers_equal_cache_off_and_jax(corpus, n):
    """The miss route, then the hit route: the same answers as with the
    cache off and as the JAX engine's with the cache on (f32, greedy), and
    the JAX engine's counters after the same calls."""
    je, on, off = _prefix_engines(corpus)
    assert on.prefix_cache.pool_len == je.prefix_cache.pool_len == 48
    assert on.prefix_cache.entry_bytes == je.prefix_cache.entry_bytes
    qs, ks = QUERIES[:n], [2] * n
    staged = on.stage_prompts(on.prepare(qs, ks))
    assert staged[0] == "padded" and staged[1].shape[1] == 32     # a suffix bucket
    assert all(m is not None and 16 <= len(m[1]) <= 48 for m in staged[5][:n])
    miss = on.process(qs, ks)
    ref = je.process(qs, ks)
    assert miss == ref == off.process(qs, ks)
    assert all(r["result"] for r in miss)
    assert _counters(on) == _counters(je)
    before = on.prefix_cache.stats()
    assert before["misses"] == n and before["hits"] == 0 and 1 <= before["entries"] <= n
    assert on.process(qs, ks) == miss == je.process(qs, ks)
    after = on.prefix_cache.stats()
    assert after["hits"] == n and after["misses"] == n
    assert after["entries"] == before["entries"]
    assert _counters(on) == _counters(je)
    assert "prefix_resolve" in on.timer.summary()


def test_prefix_cache_request_budgets_match_jax(corpus):
    je, on, _ = _prefix_engines(corpus)
    qs, ks, budgets = QUERIES, [2] * 4, [1, 3, None, 6]
    ours = on.process(qs, ks, budgets)
    assert ours == je.process(qs, ks, budgets)
    assert len(ours[0]["result"].split()) <= 1


def test_prefix_cache_makes_one_entry_for_identical_queries(corpus):
    je, on, _ = _prefix_engines(corpus)
    qs = [QUERIES[0]] * 3 + [QUERIES[1]]
    assert on.process(qs, [2] * 4) == je.process(qs, [2] * 4)
    st = on.prefix_cache.stats()
    assert st["entries"] == 2 and st["misses"] == 4 and st["hits"] == 0
    assert _counters(on) == _counters(je)


def test_prefix_cache_bypass_route_goes_packed_like_jax(corpus):
    """Every row below min_tokens: each is counted as bypassed and the batch
    takes the plain route at a prompt bucket, packed here, with the cold
    answers."""
    je, on, off = _prefix_engines(corpus)
    for e in (je, on):
        e.prefix_cache.min_tokens = 1000
    qs, ks = QUERIES, [2] * 4
    assert on.stage_prompts(on.prepare(qs, ks))[0] == "packed"
    assert je.stage_prompts(je.prepare(qs, ks))[0] == "packed"
    assert on.process(qs, ks) == off.process(qs, ks) == je.process(qs, ks)
    assert on.prefix_cache.stats()["bypassed"] == 8 and len(on.prefix_cache) == 0
    assert _counters(on) == _counters(je)


def test_prefix_cache_adaptive_gate_closes_and_probes_like_jax(corpus):
    """A 4-lookup window and a threshold no hit rate reaches
    (PREFIX_ADAPTIVE_LOW=1.1): once the window has filled the gate closes,
    most batches take the plain route, every third probes; counters and
    answers follow the JAX engine's."""
    je, on, _ = _prefix_engines(corpus, prefix_adaptive_window=4, prefix_probe_every=3,
                                prefix_adaptive_low=1.1, query_cache_size=0)
    for i in range(7):
        qs = [f"w{20 * i + j} w{20 * i + j + 7} question" for j in range(2)]
        assert on.process(qs, [2, 2]) == je.process(qs, [2, 2])
        assert _counters(on) == _counters(je)
    st = on.prefix_cache.stats()
    assert st["bypass_mode"] is True and st["probes"] >= 1 and st["bypassed"] == 0
    assert st["hits"] + st["misses"] < 14          # the closed gate skipped lookups
    assert (st["bypass_mode"], st["probes"]) == (
        je.prefix_cache.stats()["bypass_mode"], je.prefix_cache.stats()["probes"])


def test_prefix_cache_int8_entries_are_smaller_and_hit_deterministically(corpus):
    docs, emb = corpus
    mk = lambda **over: port_engine.RagEngine(  # noqa: E731
        tiny_settings(prefix_cache=True, prefix_pool_len=48, **over), docs, emb, device="cpu")
    on, full = mk(prefix_cache_dtype="int8"), mk()
    assert on.prefix_int8 and on.prefix_cache.int8 and not full.prefix_int8
    assert on.prefix_cache.entry_bytes < full.prefix_cache.entry_bytes
    assert on.prefix_cache._pool.dtype == torch.int8
    je = jax_engine.RagEngine(jax_settings(prefix_cache=True, prefix_pool_len=48,
                                           prefix_cache_dtype="int8"), docs, emb)
    assert on.prefix_cache.entry_bytes == je.prefix_cache.entry_bytes
    r1 = on.process(QUERIES[:2], [2, 2])
    r2 = on.process(QUERIES[:2], [2, 2])    # the hit route
    assert r1 == r2 and on.prefix_cache.stats()["hits"] == 2


def test_prefix_cache_capacity_keeps_batch_headroom(corpus):
    """A byte budget far below one batch of entries still leaves
    2 * max_batch + 1 slots, as in the JAX engine."""
    je, on, _ = _prefix_engines(corpus, prefix_cache_mb=0)
    assert on.prefix_cache.capacity == je.prefix_cache.capacity == 2 * on.batch_buckets[-1] + 1
    assert all("result" in r for r in on.process(QUERIES, [2] * 4))


def test_warmup_leaves_no_prefix_entry_and_no_counts(corpus):
    """The warm-up batch takes the miss route; its entry, its lookups and the
    rolling window are dropped, so serving starts from an empty cache and
    /stats counts served requests only."""
    docs, emb = corpus
    on = port_engine.RagEngine(tiny_settings(prefix_cache=True, prefix_pool_len=48), docs, emb,
                               device="cpu")
    on.warmup()
    st = on.prefix_cache.stats()
    assert (st["entries"], st["hits"], st["misses"], st["bypassed"]) == (0, 0, 0, 0)
    assert st["rolling_hit_rate"] is None and st["bypass_mode"] is False
    on.process(QUERIES[:2], [2, 2])
    assert on.prefix_cache.stats()["misses"] >= len(on.prefix_cache) > 0


@pytest.mark.parametrize("kind", ["short", "long", "empty"])
def test_auto_pool_len_equals_jax(kind):
    """PREFIX_POOL_LEN unset: the pool is sized from sampled 2-document
    context prefixes, as the JAX engine sizes it; an explicit value wins and
    the largest prompt bucket clamps both."""
    rng = np.random.default_rng(0)
    emb = rng.standard_normal((20, 64)).astype(np.float32)
    docs = {"short": [f"short doc {i}" for i in range(20)],
            "long": [f"long doc {i} " + " ".join(f"w{i}_{j}" for j in range(150 + 9 * i))
                     for i in range(20)],
            "empty": []}[kind]
    if kind == "empty":
        emb = emb[:0]
    over = dict(prefix_cache=True, prompt_len_buckets=[64, 1024], batch_buckets=[1, 2],
                max_batch_size=2)
    je = jax_engine.RagEngine(jax_settings(**over), docs, emb)
    te = port_engine.RagEngine(tiny_settings(**over), docs, emb, device="cpu")
    assert te.prefix_cache.pool_len == je.prefix_cache.pool_len
    assert te._auto_pool_len(docs) == je._auto_pool_len(docs)
    assert te.prefix_cache.pool_len == {"short": 128, "long": 768, "empty": 384}[kind]
    pinned = port_engine.RagEngine(tiny_settings(**over, prefix_pool_len=256), docs, emb,
                                   device="cpu")
    assert pinned.prefix_cache.pool_len == 256
    clamped = port_engine.RagEngine(
        tiny_settings(**dict(over, prompt_len_buckets=[64, 128]), prefix_pool_len=256),
        docs, emb, device="cpu")
    assert clamped.prefix_cache.pool_len == 128


def test_queue_and_processor_serve_repeats_from_the_prefix_cache(corpus):
    docs, emb = corpus
    s = tiny_settings(prefix_cache=True, prefix_pool_len=48)
    engine = port_engine.RagEngine(s, docs, emb, device="cpu")
    q = make_queue(s)
    proc = BatchProcessor(q, engine, polling_interval=0.05)
    proc.start()
    try:
        first = [q.get_result(i, timeout=120)
                 for i in [q.add_request(text, 2) for text in QUERIES]]
        again = [q.get_result(i, timeout=120)
                 for i in [q.add_request(text, 2) for text in QUERIES]]
    finally:
        proc.stop(drain_timeout=5.0)
        proc.join(timeout=10)
    assert not proc.is_alive()
    assert all(isinstance(r.get("result"), str) for r in first + again), first + again
    st = engine.prefix_cache.stats()
    assert st["hits"] >= 4 and st["misses"] == 4 and st["entries"] <= 4


@pytest.mark.parametrize("preset,device,refused", [
    ("tiny", "cuda", False), ("tiny", "cpu", False), ("full", "cuda", False),
    ("llama", "cuda", False), ("head_48", "cuda", True), ("head_48", "cpu", False)])
def test_head_size_without_a_kernel_is_refused_on_cuda(preset, device, refused, monkeypatch):
    """Every preset's decoder head size (16, 128, 64) has a B2/B3 instance,
    so none is refused on a CUDA device any more. A head size without one
    (48) still is, at construction, naming MODEL_PRESET; on the CPU (the
    plain versions) any size is served. Needs no card: only the device's
    type is read."""
    import dataclasses

    if preset == "head_48":
        odd = dataclasses.replace(port_engine.decoder_config_for("tiny"), head_dim=48)
        monkeypatch.setattr(port_engine, "decoder_config_for", lambda name: odd)
    bad = port_engine.unsupported_settings(tiny_settings(model_preset=preset),
                                           torch.device(device))
    assert bool(bad) == refused
    if refused:
        assert len(bad) == 1 and "MODEL_PRESET=head_48" in bad[0] and "48" in bad[0]
