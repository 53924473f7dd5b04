"""PyTorch port: the quantized decoder (QUANT_WEIGHTS=int8|int4, QUANT_ACT=int8)
against the JAX package on the CPU, at the tiny preset in f32.

Seeded numpy inputs go through both packages. The quantizers must give the
JAX engine's bits: `quantize_int8` and `quantize_rows_int8` as the engine
calls them (eagerly, also under `vmap`: a true division by 127),
`quantize_int4` and `quantize_act_int8` as compiled (a product with the f32
reciprocal). The products are held to 2e-6 of the output's largest magnitude
(f32 sums in two orders); the W8A8 int32 sums are exact. Greedy tokens are
compared in f32 with the decoder's matrices scaled by 8, so trajectories
vary."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rag_serving_system_tpu import config as jax_config  # noqa: E402
from rag_serving_system_tpu.core import engine as jax_engine  # noqa: E402
from rag_serving_system_tpu.models import layers as jl  # noqa: E402
from rag_serving_system_tpu.models import qwen2 as jq  # noqa: E402
from rag_serving_system_tpu.models.configs import QWEN2_TINY  # noqa: E402
from rag_serving_system_tpu.models.weights import init_decoder_params  # noqa: E402
from rag_serving_system_tpu.ops import quant as jquant  # noqa: E402
from rag_serving_system_torch import config as port_config  # noqa: E402
from rag_serving_system_torch.core import engine as port_engine  # noqa: E402
from rag_serving_system_torch.models import layers as tl  # noqa: E402
from rag_serving_system_torch.models import qwen2 as tq  # noqa: E402
from rag_serving_system_torch.models.weights import params_from_jax  # noqa: E402
from rag_serving_system_torch.ops import quant as tquant  # noqa: E402

REL_TOL = 2e-6   # of the output's largest magnitude: f32 sums in two orders


def _w(seed, *shape, std=0.02):
    return (np.random.default_rng(seed).standard_normal(shape) * std).astype(np.float32)


def _same_bits(ours, ref):
    """A port node against a JAX node: dtype, shape and every bit."""
    for field in ("q", "scale"):
        a, b = getattr(ours, field).numpy(), np.asarray(getattr(ref, field))
        assert a.dtype == b.dtype and a.shape == b.shape, (field, a.dtype, b.dtype,
                                                           a.shape, b.shape)
        np.testing.assert_array_equal(a, b, err_msg=field)


# ---------------------------------------------------------------------------
# the quantizers, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(64, 128), (130, 24), (33, 7), (256, 96)])
def test_quantize_int8_bits_equal_jax(shape):
    w = _w(1, *shape)
    _same_bits(tquant.quantize_int8(torch.from_numpy(w)), jquant.quantize_int8(jnp.asarray(w)))


def test_quantize_int8_stacked_equals_jax_vmap():
    w = _w(2, 3, 64, 40)
    ours = tquant.quantize_int8(torch.from_numpy(w))
    _same_bits(ours, jax.vmap(jquant.quantize_int8)(jnp.asarray(w)))
    assert ours.scale.shape == (3, 1, 40)


@pytest.mark.parametrize("shape", [(512, 64), (37, 9)])
def test_quantize_rows_int8_bits_equal_jax(shape):
    w = _w(3, *shape)
    w[0] = 0.0           # an all-zero row: the 1e-8 floor
    ours = tquant.quantize_rows_int8(torch.from_numpy(w))
    _same_bits(ours, jquant.quantize_rows_int8(jnp.asarray(w)))
    assert ours.scale.shape == (shape[0], 1)


@pytest.mark.parametrize("shape", [(5, 7, 64), (3, 130), (1, 1, 9)])
def test_quantize_act_int8_bits_equal_compiled_jax(shape):
    """The activations are quantized inside the jitted prefill: the compiled
    form is the one to match."""
    x = _w(4, *shape, std=1.0)
    q, s = tquant.quantize_act_int8(torch.from_numpy(x))
    rq, rs = jax.jit(jquant.quantize_act_int8)(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))
    assert q.dtype == torch.int8 and s.shape == (*shape[:-1], 1)


@pytest.mark.parametrize("shape,packed", [
    ((256, 96), (2, 64, 96)),     # two groups of 128
    ((128, 8), (1, 64, 8)),
    ((200, 40), (1, 100, 40)),    # not a multiple of 128: one group of 200
    ((64, 16), (1, 32, 16)),      # below the group size
    ((130, 16), (1, 65, 16)),     # an odd half
])
def test_quantize_int4_packing_bits_equal_jax(shape, packed):
    w = _w(5, *shape, std=1.0)
    ours = tquant.quantize_int4(torch.from_numpy(w))
    ref = jquant.quantize_int4(jnp.asarray(w))
    _same_bits(ours, ref)
    assert tuple(ours.q.shape) == packed
    np.testing.assert_array_equal(tquant.unpack_int4(ours.q).numpy(),
                                  np.asarray(jquant.unpack_int4(ref.q)))
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)):
        np.testing.assert_array_equal(
            tquant.dequantize(ours, dtype).float().numpy(),
            np.asarray(jquant.dequantize(ref, jdtype).astype(jnp.float32)))


def test_quantize_int4_stacked_equals_jax_vmap_and_odd_dims_raise():
    w = _w(6, 2, 256, 24, std=1.0)
    ours = tquant.quantize_int4(torch.from_numpy(w))
    _same_bits(ours, jax.vmap(lambda m: jquant.quantize_int4(m, group=128))(jnp.asarray(w)))
    assert tuple(ours.q.shape) == (2, 2, 64, 24)
    with pytest.raises(ValueError, match="even input dim"):
        tquant.quantize_int4(torch.zeros((33, 8)))


def test_dequantize_int8_equals_jax():
    w = _w(7, 64, 32)
    ours, ref = tquant.quantize_int8(torch.from_numpy(w)), jquant.quantize_int8(jnp.asarray(w))
    np.testing.assert_array_equal(tquant.dequantize(ours, torch.float32).numpy(),
                                  np.asarray(jquant.dequantize(ref, jnp.float32)))
    err = np.abs(tquant.dequantize(ours, torch.float32).numpy() - w)
    assert (err <= ours.scale.numpy()[0] * 0.51 + 1e-8).all()   # half a step a channel


# ---------------------------------------------------------------------------
# the products
# ---------------------------------------------------------------------------

def _leaves(kind, w):
    if kind == "int8":
        return tquant.quantize_int8(torch.from_numpy(w)), jquant.quantize_int8(jnp.asarray(w))
    return tquant.quantize_int4(torch.from_numpy(w)), jquant.quantize_int4(jnp.asarray(w))


@pytest.mark.parametrize("fn", ["dense", "dense_w8a8"])
@pytest.mark.parametrize("kind", ["int8", "int4"])
@pytest.mark.parametrize("bias", [False, True], ids=["nobias", "bias"])
def test_dense_on_quantized_leaves_matches_jax(fn, kind, bias):
    """f32: within REL_TOL of the output's largest magnitude of the JAX
    function (compiled, as the engine runs it)."""
    x = _w(8, 3, 5, 256, std=1.0)
    tw, jw = _leaves(kind, _w(9, 256, 48, std=0.05))
    b = _w(10, 48, std=1.0) if bias else None
    ref = np.asarray(jax.jit(getattr(jl, fn))(
        jnp.asarray(x), jw, None if b is None else jnp.asarray(b)))
    ours = getattr(tl, fn)(torch.from_numpy(x), tw,
                           None if b is None else torch.from_numpy(b)).numpy()
    assert ours.shape == ref.shape == (3, 5, 48)
    assert np.abs(ours - ref).max() <= REL_TOL * np.abs(ref).max()


def test_dense_plain_weight_paths_are_unchanged():
    x, w, b = _w(11, 4, 32, std=1.0), _w(12, 32, 16), _w(13, 16)
    want = torch.from_numpy(x) @ torch.from_numpy(w) + torch.from_numpy(b)
    for fn in (tl.dense, tl.dense_w8a8):      # a plain weight falls through
        assert torch.equal(fn(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b)),
                           want)


@pytest.mark.parametrize("m,k,n", [(5, 64, 128), (40, 2048, 24), (1, 1536, 8)])
def test_w8a8_int32_sums_are_exact(m, k, n):
    """`int_matmul` (the CPU's int32 matmul here; `torch._int_mm` on a CUDA
    device) and `int_matmul_plain` (f32 over K-chunks of 1024) equal the
    int64 sums, at extreme values too, and the JAX int32 einsum."""
    rng = np.random.default_rng(14)
    xq = rng.integers(-127, 128, (m, k)).astype(np.int8)
    wq = rng.integers(-127, 128, (k, n)).astype(np.int8)
    xq[0], wq[:, 0] = 127, -127
    want = xq.astype(np.int64) @ wq.astype(np.int64)
    for fn in (tl.int_matmul, tl.int_matmul_plain):
        got = fn(torch.from_numpy(xq), torch.from_numpy(wq))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    ref = jnp.einsum("mk,kn->mn", jnp.asarray(xq), jnp.asarray(wq),
                     preferred_element_type=jnp.int32)
    np.testing.assert_array_equal(np.asarray(ref), want)


def test_bf16_dense_on_int8_stays_close_to_jax():
    """bf16: the port's matmul rounds the product to bf16 before the scale;
    the JAX function scales the f32 product and rounds once. Two roundings
    against one: within 2 bf16 ulps (2^-7 relative) of the output's largest
    magnitude."""
    x = torch.from_numpy(_w(15, 6, 64, std=1.0)).to(torch.bfloat16)
    w = _w(16, 64, 32, std=0.05)
    tw, jw = _leaves("int8", w)
    ref = np.asarray(jl.dense(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16), jw)
                     .astype(jnp.float32))
    ours = tl.dense(x, tw)
    assert ours.dtype == torch.bfloat16
    assert np.abs(ours.float().numpy() - ref).max() <= 2.0 ** -7 * np.abs(ref).max()


# ---------------------------------------------------------------------------
# the decoder tree
# ---------------------------------------------------------------------------

def _scaled(tree, f):
    return {k: (_scaled(v, f) if isinstance(v, dict) else
                v * f if k in ("embed", "qkv_w", "o_w", "gu_w", "down_w") else v)
            for k, v in tree.items()}


@pytest.fixture(scope="module")
def dec():
    jp = _scaled(init_decoder_params(QWEN2_TINY, dtype=jnp.float32), 8.0)
    return jp, params_from_jax(jax.device_get(jp))


def _walk(ours, ref, path=""):
    """Leaf by leaf: the same keys, the same node types by name, the same
    bits."""
    if isinstance(ref, dict):
        assert isinstance(ours, dict) and sorted(ours) == sorted(ref), path
        for k in ref:
            _walk(ours[k], ref[k], f"{path}/{k}")
    elif hasattr(ref, "q"):
        assert type(ours).__name__ == type(ref).__name__, path
        _same_bits(ours, ref)
    else:
        assert isinstance(ours, torch.Tensor), path
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref), err_msg=path)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_decoder_params_equals_jax_leaf_by_leaf(dec, bits):
    jp, tp = dec
    ours = tquant.quantize_decoder_params(tp, bits=bits)
    ref = jquant.quantize_decoder_params(jp, bits=bits)
    _walk(ours, ref)
    node = tquant.QuantizedWeight4 if bits == 4 else tquant.QuantizedWeight
    assert all(isinstance(ours["layers"][k], node) for k in ("qkv_w", "o_w", "gu_w", "down_w"))
    assert isinstance(ours["embed"], tquant.QuantizedWeight)
    assert ours["embed"].scale.shape == (QWEN2_TINY.vocab_size, 1)
    assert isinstance(ours["layers"]["ln1"], torch.Tensor) and ours["ln_f"] is tp["ln_f"]
    assert tquant.weight_bytes(ours) < tquant.weight_bytes(tp) / 3
    assert tp["layers"]["qkv_w"].dtype == torch.float32       # the input is left alone


def test_quantize_decoder_params_untied_head_odd_dims_and_lists():
    """An untied `lm_head` goes per column; under bits=4 a weight with an odd
    input dim stays int8; a list of per-layer dicts is walked; encoder keys
    (`ff_w1`, `ff_w2`) are matmul weights too."""
    tree = {"embed": _w(17, 40, 16), "lm_head": _w(18, 16, 40),
            "layers": [{"qkv_w": _w(19, 16, 24), "o_w": _w(20, 7, 16), "ln1": _w(21, 16)},
                       {"ff_w1": _w(22, 16, 8), "ff_b1": _w(23, 8)}]}
    jt = jax.tree.map(jnp.asarray, tree)
    ours = tquant.quantize_decoder_params(params_from_jax(tree), bits=4)
    ref = jquant.quantize_decoder_params(jt, bits=4)
    assert isinstance(ours["layers"], list)
    for o, r in zip(ours["layers"], ref["layers"]):
        _walk(o, r)
    _walk({k: ours[k] for k in ("embed", "lm_head")}, {k: ref[k] for k in ("embed", "lm_head")})
    assert isinstance(ours["layers"][0]["o_w"], tquant.QuantizedWeight)     # 7 inputs: int8
    assert isinstance(ours["layers"][0]["qkv_w"], tquant.QuantizedWeight4)
    assert ours["lm_head"].scale.shape == (1, 40)
    with pytest.raises(ValueError, match="bits"):
        tquant.quantize_decoder_params(tree, bits=2)


@pytest.mark.parametrize("bits", [8, 4])
def test_converter_carries_quantized_leaves_bit_for_bit(dec, bits):
    """`params_from_jax` on the JAX package's quantized tree (as numpy):
    the port's nodes, the same integers and scales."""
    jp, _ = dec
    ref = jquant.quantize_decoder_params(jp, bits=bits)
    ours = params_from_jax(jax.device_get(ref))
    _walk(ours, ref)
    assert isinstance(ours["layers"]["gu_w"],
                      tquant.QuantizedWeight4 if bits == 4 else tquant.QuantizedWeight)
    layer = tq._layer(ours, 1)
    assert layer["gu_w"].q.shape == ref["layers"]["gu_w"].q.shape[1:]
    assert type(layer["gu_w"]) is type(ours["layers"]["gu_w"])


def _prompts(seed, b, p, lens):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, QWEN2_TINY.vocab_size, (b, p)).astype(np.int32)
    mask = np.zeros((b, p), np.int32)
    for i, n in enumerate(lens):
        mask[i, p - n:] = 1
        ids[i, :p - n] = 0
    return ids, mask


QUANT_CASES = [(8, False), (8, True), (4, False), (4, True)]
QUANT_IDS = ["int8", "int8_w8a8", "int4", "int4_w4a8"]


@pytest.mark.parametrize("bits,act_quant", QUANT_CASES, ids=QUANT_IDS)
def test_quantized_prefill_logits_match_jax(dec, bits, act_quant):
    """First-token logits (magnitude ~10) on the same integers. Weight-only:
    atol 2e-4 (f32 sums in two orders). With quantized activations: atol
    5e-2, because a hidden value that differs in its last bits can round to
    the other side of a half, which moves one int8 activation by 1 (1/127 of
    its token's largest value) and every logit of that row with it; the
    greedy tokens below are equal all the same."""
    jp, _ = dec
    jqp = jquant.quantize_decoder_params(jp, bits=bits)
    tqp = params_from_jax(jax.device_get(jqp))
    ids, mask = _prompts(24, 3, 24, [24, 11, 17])
    ref, _ = jq.prefill(jqp, QWEN2_TINY, jnp.asarray(ids), jnp.asarray(mask), 2,
                        dtype=jnp.float32, act_quant=act_quant)
    ours, _ = tq.prefill(tqp, QWEN2_TINY, torch.tensor(ids), torch.tensor(mask), 2,
                         dtype=torch.float32, act_quant=act_quant)
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref),
                               atol=5e-2 if act_quant else 2e-4, rtol=0)


@pytest.mark.parametrize("bits,act_quant", QUANT_CASES, ids=QUANT_IDS)
def test_quantized_generate_greedy_tokens_equal_jax(dec, bits, act_quant):
    jp, _ = dec
    jqp = jquant.quantize_decoder_params(jp, bits=bits)
    tqp = params_from_jax(jax.device_get(jqp))
    ids, mask = _prompts(25, 4, 20, [20, 9, 14, 3])
    ref = np.asarray(jq.generate(jqp, QWEN2_TINY, jnp.asarray(ids), jnp.asarray(mask),
                                 jax.random.PRNGKey(0), max_new_tokens=8, do_sample=False,
                                 dtype=jnp.float32, act_quant=act_quant))
    ours = tq.generate(tqp, QWEN2_TINY, torch.tensor(ids), torch.tensor(mask), None,
                       max_new_tokens=8, do_sample=False, dtype=torch.float32,
                       act_quant=act_quant).numpy()
    np.testing.assert_array_equal(ours, ref)
    assert len(set(ref[0].tolist())) > 2          # a varied trajectory


def test_quantized_logits_track_the_unquantized_ones():
    """The bounds and the inputs of the JAX package's own quantization tests
    (unscaled random weights): int8 logits correlate with the f32 ones above
    0.99, int4 above 0.97, and W8A8 stays within cosine 0.999 of weight-only
    int8."""
    tp = params_from_jax(jax.device_get(init_decoder_params(QWEN2_TINY, seed=1,
                                                             dtype=jnp.float32)))
    ids = torch.tensor([[7, 23, 99, 45, 12, 88]], dtype=torch.int32)
    args = (QWEN2_TINY, ids, torch.ones_like(ids), 1)
    base = tq.prefill(tp, *args, dtype=torch.float32)[0][0].numpy()
    q8 = tquant.quantize_decoder_params(tp, bits=8)
    l8 = tq.prefill(q8, *args, dtype=torch.float32)[0][0].numpy()
    l4 = tq.prefill(tquant.quantize_decoder_params(tp, bits=4), *args,
                    dtype=torch.float32)[0][0].numpy()
    la = tq.prefill(q8, *args, dtype=torch.float32, act_quant=True)[0][0].numpy()
    assert np.corrcoef(base, l8)[0, 1] > 0.99
    assert np.corrcoef(base, l4)[0, 1] > 0.97
    assert (l8 * la).sum() / (np.linalg.norm(l8) * np.linalg.norm(la)) > 0.999


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

QUERIES = ["what is w1 w2", "tell me w5", "w7 w8 w9 w10", "another question w3"]


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(0)
    docs = [" ".join(f"w{rng.integers(0, 300)}" for _ in range(rng.integers(14, 24)))
            for _ in range(40)]
    return docs, rng.standard_normal((40, 64)).astype(np.float32)


def _settings(cls, **over):
    base = dict(model_preset="tiny", dtype="float32", do_sample=False, prefix_cache=False,
                batch_buckets=[1, 4], max_batch_size=4, encode_len_buckets=[16, 32],
                prompt_len_buckets=[32, 128], packed_t_step=256, max_new_tokens=6, max_k=4,
                max_wait_time=0.2, polling_interval=0.05, embed_model_name="e5",
                llm_model_name="qwen")
    base.update(over)
    return cls(**base)


def _engine_pair(corpus, **over):
    """A JAX and a port engine under one quantized setting. The JAX engine's
    decoder is re-quantized from its matrices scaled by 8, and the port gets
    that very tree: both compute on the same integers."""
    docs, emb = corpus
    je = jax_engine.RagEngine(_settings(jax_config.Settings, **over), docs, emb)
    te = port_engine.RagEngine(_settings(port_config.Settings, **over), docs, emb, device="cpu")
    assert type(te.dec_params["layers"]["qkv_w"]).__name__ == \
        type(je.dec_params["layers"]["qkv_w"]).__name__
    bits = 4 if over["quant_weights"] == "int4" else 8
    fp = _scaled(init_decoder_params(QWEN2_TINY, dtype=jnp.float32), 8.0)
    je.dec_params = jquant.quantize_decoder_params(fp, bits=bits)
    te.enc_params = params_from_jax(jax.device_get(je.enc_params))
    te.dec_params = params_from_jax(jax.device_get(je.dec_params))
    return je, te


@pytest.mark.parametrize("over", [
    dict(quant_weights="int8"),
    dict(quant_weights="int8", quant_act="int8"),
    dict(quant_weights="int4"),
    dict(quant_weights="int4", quant_act="int8"),
    dict(quant_weights="int8", quant_act="int8", prefix_cache=True, prefix_pool_len=48),
], ids=["int8", "int8_w8a8", "int4", "int4_w4a8", "int8_w8a8_prefix"])
def test_engine_serves_quantized_like_jax(corpus, over):
    """The engine under each quantized setting: the flags of the JAX engine,
    its answers for a lone request (padded) and a full batch (packed, or over
    the prefix cache: the miss, then the hit)."""
    je, te = _engine_pair(corpus, **over)
    assert te.act_quant == je.act_quant == (over.get("quant_act") == "int8")
    assert te.weight_bytes < te.weight_bytes_init / 3
    for n in (1, 4):
        qs, ks = QUERIES[:n], [2] * n
        ours = te.process(qs, ks)
        assert ours == je.process(qs, ks)
        assert all(r["result"] for r in ours)
    if over.get("prefix_cache"):
        assert te.process(QUERIES, [2] * 4) == je.process(QUERIES, [2] * 4)
        assert te.prefix_cache.stats()["hits"] == je.prefix_cache.stats()["hits"] >= 4


def test_quant_act_alone_warns_and_stays_off(corpus, caplog):
    docs, emb = corpus
    with caplog.at_level("WARNING"):
        te = port_engine.RagEngine(_settings(port_config.Settings, quant_act="int8"), docs, emb,
                                   device="cpu")
    assert not te.act_quant and isinstance(te.dec_params["embed"], torch.Tensor)
    assert any("QUANT_ACT=int8 requires QUANT_WEIGHTS" in r.message for r in caplog.records)
    assert te.weight_bytes == te.weight_bytes_init
    assert all(isinstance(r["result"], str) for r in te.process(QUERIES[:2], [2, 2]))


@pytest.mark.parametrize("over,var", [
    (dict(quant_weights="int2"), "QUANT_WEIGHTS=int2"),
    (dict(quant_act="int4"), "QUANT_ACT=int4"),
    (dict(decode_mode="paged"), "DECODE_MODE=paged"),
])
def test_unknown_quant_and_decode_values_are_refused_by_name(corpus, over, var):
    docs, emb = corpus
    with pytest.raises(ValueError, match=var):
        port_engine.RagEngine(_settings(port_config.Settings, **over), docs, emb, device="cpu")


def test_queue_and_processor_serve_under_int8_w8a8(corpus):
    """The production setting behind the queue and the batch processor, the
    prefix cache at its default."""
    from rag_serving_system_torch.core.batch_processor import BatchProcessor
    from rag_serving_system_torch.core.request_queue import make_queue

    docs, emb = corpus
    s = _settings(port_config.Settings, quant_weights="int8", quant_act="int8",
                  prefix_cache=True, prefix_pool_len=48)
    engine = port_engine.RagEngine(s, docs, emb, device="cpu")
    q = make_queue(s)
    proc = BatchProcessor(q, engine, polling_interval=0.05)
    proc.start()
    try:
        results = [q.get_result(i, timeout=120)
                   for i in [q.add_request(text, 2) for text in QUERIES]]
    finally:
        proc.stop(drain_timeout=5.0)
        proc.join(timeout=10)
    assert all(isinstance(r.get("result"), str) for r in results), results
    assert engine.act_quant and engine.prefix_cache.stats()["misses"] >= 1
