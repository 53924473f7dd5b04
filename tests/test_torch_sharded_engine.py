"""PyTorch port: the engine over a ("data", "model") mesh, against the JAX
engine over its mesh and against the port's one-device engine.

Each test of `tests/test_sharded_engine.py` has its counterpart here, at the
same settings (tiny presets, f32, greedy where the JAX test is greedy). The
JAX engines run on the 8 virtual CPU devices `tests/conftest.py` forces; the
port's mesh puts its 8 positions on `cpu` (`make_mesh(..., devices=[cpu] *
8)`). Weights cross with `params_from_jax`, the decoder's matrices scaled by
8 so that greedy answers depend on the context. Every greedy case is held
equal to both the port's one-device engine and the JAX mesh engine."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rag_serving_system_tpu import config as jax_config  # noqa: E402
from rag_serving_system_tpu.core import engine as jax_engine  # noqa: E402
from rag_serving_system_tpu.models.configs import QWEN2_TINY  # noqa: E402
from rag_serving_system_tpu.models.weights import init_decoder_params  # noqa: E402
from rag_serving_system_tpu.ops import quant as jquant  # noqa: E402
from rag_serving_system_tpu.ops import topk as jax_topk  # noqa: E402
from rag_serving_system_tpu.parallel import mesh as jax_mesh  # noqa: E402
from rag_serving_system_tpu.parallel import sharded_topk as jax_sharded  # noqa: E402
from rag_serving_system_tpu.parallel import tp as jax_tp  # noqa: E402
from rag_serving_system_torch import config as port_config  # noqa: E402
from rag_serving_system_torch.core import engine as port_engine  # noqa: E402
from rag_serving_system_torch.models.weights import params_from_jax  # noqa: E402
from rag_serving_system_torch.parallel import sharded_topk as port_sharded  # noqa: E402
from rag_serving_system_torch.parallel.mesh import make_mesh  # noqa: E402

CPU8 = [torch.device("cpu")] * 8


def _settings(cls, **over):
    base = dict(model_preset="tiny", dtype="float32", batch_buckets=[1, 4],
                encode_len_buckets=[16, 32], prompt_len_buckets=[64],
                max_new_tokens=3, max_k=4, do_sample=False, prefix_cache=False,
                embed_model_name="e5", llm_model_name="qwen")
    base.update(over)
    return cls(**base)


def _scaled(tree, f):
    return {k: (_scaled(v, f) if isinstance(v, dict) else
                v * f if k in ("embed", "qkv_w", "o_w", "gu_w", "down_w") else v)
            for k, v in tree.items()}


def _engines(shape, docs, emb, quant=None, **over):
    """(JAX mesh engine, port mesh engine, port one-device engine) on one set
    of weights: the JAX mesh engine's encoder and its decoder scaled by 8
    (quantized after the scaling when `quant` names int8 or int4)."""
    je = jax_engine.RagEngine(_settings(jax_config.Settings, mesh_shape=shape, **over),
                              docs, emb, mesh=jax_mesh.make_mesh(shape))
    fp = _scaled(init_decoder_params(QWEN2_TINY, dtype=jnp.float32), 8.0)
    if quant:
        fp = jquant.quantize_decoder_params(fp, bits=4 if quant == "int4" else 8)
    je.dec_params = jax_tp.shard_params(fp, je.mesh)
    port = _settings(port_config.Settings, mesh_shape=shape, **over)
    tm = port_engine.RagEngine(port, docs, emb, mesh=make_mesh(shape, devices=CPU8))
    ts = port_engine.RagEngine(port, docs, emb, device="cpu")
    enc, dec = (params_from_jax(jax.device_get(t)) for t in (je.enc_params, je.dec_params))
    for te in (tm, ts):
        te.enc_params, te.dec_params = enc, dec
    return je, tm, ts


@pytest.fixture(scope="module")
def fact_corpus():
    rng = np.random.default_rng(0)
    docs = [f"Fact {i}: the answer to question {i} is {i * i}." for i in range(64)]
    return docs, rng.standard_normal((64, 64)).astype(np.float32)


@pytest.fixture(scope="module")
def engines_42(fact_corpus):
    return _engines("4,2", *fact_corpus)


def test_sharded_engine_process(engines_42):
    _, tm, _ = engines_42
    results = tm.process(["what is 4 times 4?", "and 5?"], [2, 3])
    assert len(results) == 2
    assert all(isinstance(r["result"], str) for r in results)
    # the corpus is one shard a position, the weights a slice a model position
    assert len(tm.corpus) == 8 and all(s.shape == (8, 64) for s in tm.corpus)
    assert tm.dec_params.split == {"attn": True, "mlp": True}


def test_sharded_retrieval_matches_unsharded(engines_42):
    je, tm, ts = engines_42
    queries = ["what is the answer to question 7?", "question 13?"]
    got = tm.embed_and_retrieve(queries, [3, 4])
    assert got == ts.embed_and_retrieve(queries, [3, 4])
    assert got == je.embed_and_retrieve(queries, [3, 4])


@pytest.mark.parametrize("n,k", [(100, 5), (5, 5), (13, 3), (130, 16)])
def test_sharded_topk_exact_with_padding_and_negative_sims(n, k):
    """Zero-padded rows score 0 and can displace real rows of NEGATIVE
    similarity: the widened per-shard selection keeps the result exact. Ids
    equal to the JAX function's and the unsharded top-k's, scores within
    1e-5."""
    from jax.sharding import Mesh

    jmesh = Mesh(np.asarray(jax.devices()).reshape(4, 2), axis_names=("data", "model"))
    rng = np.random.default_rng(7 + n)
    d = 64
    corpus = rng.standard_normal((n, d)).astype(np.float32)
    corpus /= np.linalg.norm(corpus, axis=-1, keepdims=True)
    queries = -corpus[:3] + 0.01 * rng.standard_normal((3, d)).astype(np.float32)
    kk = min(k, n)
    js, ji = jax_sharded.sharded_cosine_topk(
        jax_sharded.shard_corpus(jnp.asarray(corpus), jmesh), jnp.asarray(queries), kk,
        jmesh, valid_n=n)
    mesh = make_mesh("4,2", devices=CPU8)
    shards = port_sharded.shard_corpus(torch.as_tensor(corpus), mesh)
    assert len(shards) == 8 and sum(s.shape[0] for s in shards) == -(-n // 8) * 8
    s, i = port_sharded.sharded_cosine_topk(shards, torch.as_tensor(queries), kk, mesh,
                                            valid_n=n)
    _, i_ref = jax_topk.cosine_topk_reference(jnp.asarray(corpus), jnp.asarray(queries), kk)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(i.numpy(), np.asarray(i_ref))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=1e-5)


def test_sharded_generation_value_parity(engines_42):
    """Greedy tokens from the 4 x 2 mesh engine EQUAL the one-device
    engine's and the JAX mesh engine's: a lone request (the first data
    group serves it) and a batch that splits over "data"."""
    je, tm, ts = engines_42
    for queries in (["what is 4 times 4?"],
                    ["what is 4 times 4?", "and question 11?", "question 3?", "q 9"]):
        ks = [2] * len(queries)
        got = tm.process(queries, ks)
        assert got == ts.process(queries, ks) == je.process(queries, ks)
    assert any(r["result"] for r in got)


@pytest.mark.parametrize("shape", ["8,1", "2,4", "1,8"])
def test_mesh_shape_variety_value_parity(shape):
    """Pure dp, tp-heavy and pure tp: the retrieved ids and the greedy
    answers equal the one-device engine's and the JAX mesh engine's. At
    tp = 4 and 8 the decoder's attention (Hq=4, Hk=2) is replicated, at
    tp = 8 the encoder's too (4 heads); the MLPs split."""
    rng = np.random.default_rng(3)
    docs = [f"Fact {i}: item {i} equals {i + 1}." for i in range(50)]
    emb = rng.standard_normal((50, 64)).astype(np.float32)
    je, tm, ts = _engines(shape, docs, emb, batch_buckets=[2], max_batch_size=2,
                          encode_len_buckets=[16], max_new_tokens=2)
    tp = int(shape.split(",")[1])
    assert tm.dec_params.split == {"attn": False, "mlp": tp > 1}
    assert tm.enc_params.split == {"attn": tp == 4, "mlp": tp > 1}
    queries = ["what does item 7 equal?", "item 13?"]
    got = tm.embed_and_retrieve(queries, [3, 4])
    assert got == ts.embed_and_retrieve(queries, [3, 4]) == je.embed_and_retrieve(queries, [3, 4])
    answers = tm.process(queries, [2, 2])
    assert answers == ts.process(queries, [2, 2]) == je.process(queries, [2, 2])


@pytest.mark.parametrize("qw", ["int8", "int4"])
def test_sharded_engine_with_quantized_weights(qw):
    """The TP rules over QuantizedWeight (int8, per-channel) and
    QuantizedWeight4 (int4, grouped and packed) leaves: the mesh engine
    serves the JAX mesh engine's and the one-device engine's greedy
    answers. int4's one-group matrices split the down product's packed axis
    (the MLP) and replicate the attention."""
    rng = np.random.default_rng(2)
    docs = [f"Doc {i} content." for i in range(32)]
    emb = rng.standard_normal((32, 64)).astype(np.float32)
    je, tm, ts = _engines("4,2", docs, emb, quant=qw, quant_weights=qw, batch_buckets=[2],
                          max_batch_size=2, encode_len_buckets=[16], max_new_tokens=2)
    assert tm.dec_params.split == {"attn": qw == "int8", "mlp": True}
    queries = ["what is doc 3?", "doc 7?"]
    results = tm.process(queries, [2, 2])
    assert len(results) == 2 and all("result" in r for r in results)
    assert results == ts.process(queries, [2, 2]) == je.process(queries, [2, 2])


def test_sharded_prefix_cache_value_parity():
    """The prefix-KV cache under the mesh: the miss pass and the hit pass
    answer as the one-device engine and the JAX mesh engine; the cache
    engaged (entries and hits); each model position's pool part holds half
    the pool's bytes (one of the two KV heads), replicated over "data"."""
    rng = np.random.default_rng(5)
    docs = [f"Document {i}. " + " ".join(f"d{i}w{j}" for j in range(24))
            for i in range(32)]
    emb = rng.standard_normal((32, 64)).astype(np.float32)
    je, tm, ts = _engines("4,2", docs, emb, batch_buckets=[2], max_batch_size=2,
                          encode_len_buckets=[16], prefix_cache=True, prefix_pool_len=48)
    assert tm.prefix_cache is not None, "cache off under mesh"
    queries = ["what is document 7 about?", "document 13?"]
    r_single = ts.process(queries, [2, 2])
    r_jax = je.process(queries, [2, 2])
    r_miss = tm.process(queries, [2, 2])   # cold: the insert path
    r_hit = tm.process(queries, [2, 2])    # warm: the gather path
    assert r_miss == r_single == r_jax and r_hit == r_single
    assert any(r["result"] for r in r_miss)
    st = tm.prefix_cache.stats()
    assert st["entries"] > 0 and st["hits"] > 0, st
    whole = ts.prefix_cache._pool
    parts = tm.prefix_cache._pools
    assert sorted(p for p, _ in parts) == [0, 1]
    for pool in parts.values():
        assert pool.shape[0] == whole.shape[0]
        assert pool.nbytes * 2 <= whole.nbytes, (pool.nbytes, whole.nbytes)
    # both parts together hold the one-device pool's entries exactly
    slots = [e.slot for e in tm.prefix_cache._entries.values()]
    got = torch.cat([parts[(p, torch.device("cpu"))][slots] for p in (0, 1)], dim=-2)
    ref_slots = [ts.prefix_cache._entries[k].slot for k in tm.prefix_cache._entries]
    lens = [len(e.tokens) for e in tm.prefix_cache._entries.values()]
    for j, n in enumerate(lens):
        torch.testing.assert_close(got[j][:, :, :n], whole[ref_slots[j]][:, :, :n],
                                   rtol=1e-5, atol=1e-5)


def test_data_groups_on_devices_of_their_own_value_parity():
    """A "2,2" mesh over cpu:0-3, which stand for four cards: the prefix
    pool has a part on each device and the decode pool copies each row set
    to the devices of its slots. Misses, hits and the continuous pool answer
    as the one-device engine's fixed path."""
    rng = np.random.default_rng(8)
    docs = [f"Document {i}. " + " ".join(f"d{i}w{j}" for j in range(24)) for i in range(32)]
    emb = rng.standard_normal((32, 64)).astype(np.float32)
    over = dict(batch_buckets=[2, 4], max_batch_size=4, encode_len_buckets=[16],
                prefix_cache=True, prefix_pool_len=48, mesh_shape="2,2")
    mesh = make_mesh("2,2", devices=[torch.device("cpu", i) for i in range(4)])
    ts = port_engine.RagEngine(_settings(port_config.Settings, **over), docs, emb, device="cpu")
    tm = port_engine.RagEngine(_settings(port_config.Settings, **over), docs, emb, mesh=mesh)
    tc = port_engine.RagEngine(_settings(port_config.Settings, decode_mode="continuous",
                                         decode_slots=4, **over), docs, emb, mesh=mesh)
    dec = params_from_jax(jax.device_get(
        _scaled(init_decoder_params(QWEN2_TINY, dtype=jnp.float32), 8.0)))
    for te in (tm, tc):
        te.enc_params, te.dec_params = ts.enc_params, dec
    ts.dec_params = dec
    assert len(tm.prefix_cache._pools) == 4 and tc.decode_pool.group_slots == 2
    queries = ["what is document 7 about?", "document 13?", "document 2 w3?", "d5w1 d5w2"]
    want = ts.process(queries, [2] * 4)
    assert tm.process(queries, [2] * 4) == want     # misses
    assert tm.process(queries, [2] * 4) == want     # hits
    assert tm.prefix_cache.stats()["hits"] > 0
    assert any(r["result"] for r in want)
    pool, got = tc.decode_pool, {}
    pool.start()
    try:
        pool.submit([str(i) for i in range(4)], tc.prepare(queries, [2] * 4),
                    lambda rid, res: got.__setitem__(rid, res))
        assert pool.wait_idle(120), pool.stats()
    finally:
        pool.stop()
    assert [got[str(i)] for i in range(4)] == want
