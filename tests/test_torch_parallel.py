"""PyTorch port: the mesh, its collectives, the tensor-parallel rules and the
lockstep runner (`rag_serving_system_torch/parallel/`), and the decode pool
over a mesh.

The rules are held against the JAX package's `param_shardings` (the spec of
each leaf) and checked leaf by leaf: column, row and bias splits, the fused
qkv split by whole heads, gate and up split alike, both quantized node types
and the replicate fallback. The pool under a mesh answers as the fixed path
of the one-device engine and of the JAX mesh engine. Tiny presets, f32."""

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from rag_serving_system_tpu import config as jax_config  # noqa: E402
from rag_serving_system_tpu.core import engine as jax_engine  # noqa: E402
from rag_serving_system_tpu.models import configs as jax_configs  # noqa: E402
from rag_serving_system_tpu.models.weights import (  # noqa: E402
    init_decoder_params,
    init_encoder_params,
)
from rag_serving_system_tpu.parallel import mesh as jax_mesh  # noqa: E402
from rag_serving_system_tpu.parallel import tp as jax_tp  # noqa: E402
from rag_serving_system_torch import config as port_config  # noqa: E402
from rag_serving_system_torch.core import engine as port_engine  # noqa: E402
from rag_serving_system_torch.core.retriever import (  # noqa: E402
    ShardedRetriever,
    SimpleRetriever,
    TorchRetriever,
)
from rag_serving_system_torch.models.configs import E5_TINY, QWEN2_TINY  # noqa: E402
from rag_serving_system_torch.models.layers import dense  # noqa: E402
from rag_serving_system_torch.models.weights import params_from_jax  # noqa: E402
from rag_serving_system_torch.ops import quant  # noqa: E402
from rag_serving_system_torch.parallel import tp  # noqa: E402
from rag_serving_system_torch.parallel.mesh import (  # noqa: E402
    all_reduce,
    gather_to,
    make_mesh,
    mesh_axis_sizes,
)

CPU = torch.device("cpu")


def _jax_decoder(dtype=jnp.float32):
    return init_decoder_params(jax_configs.QWEN2_TINY, dtype=dtype)


# ---------------------------------------------------------------------------
# the mesh and its collectives
# ---------------------------------------------------------------------------

def test_make_mesh_shapes_and_errors_like_jax():
    m = make_mesh("4,2", devices=[CPU] * 8)
    jm = jax_mesh.make_mesh("4,2")
    assert m.axis_names == jm.axis_names == ("data", "model")
    assert mesh_axis_sizes(m) == jax_mesh.mesh_axis_sizes(jm) == (4, 2)
    assert m.size == 8 and m.lead == CPU and m.device(3, 1) == CPU
    assert mesh_axis_sizes(make_mesh("", devices=[CPU] * 3)) == (3, 1)
    for shape in ("3,2", "1,1"):
        with pytest.raises(ValueError) as ours:
            make_mesh(shape, devices=[CPU] * 8)
        with pytest.raises(ValueError) as ref:
            jax_mesh.make_mesh(shape)
        assert str(ours.value) == str(ref.value)


def test_all_reduce_sums_in_position_order_and_gather_copies():
    rng = np.random.default_rng(0)
    parts = [torch.as_tensor(rng.standard_normal((3, 5)).astype(np.float32) * 10 ** i)
             for i in range(4)]
    got = all_reduce(parts, CPU)
    want = ((parts[0] + parts[1]) + parts[2]) + parts[3]
    assert torch.equal(got, want)
    assert torch.equal(all_reduce(parts[:1], CPU), parts[0])
    copies = gather_to(parts, CPU)
    assert all(c is p for c, p in zip(copies, parts))


# ---------------------------------------------------------------------------
# the sharded top-k and retriever
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", ["4,2", "1,8", "2,1"])
def test_sharded_retriever_equals_one_device_and_numpy(shape):
    rng = np.random.default_rng(11)
    emb = rng.standard_normal((45, 64)).astype(np.float32)
    emb[9] = emb[2]                       # a tie: the lower index first
    docs = [f"d{i}" for i in range(45)]
    n_dev = int(np.prod([int(x) for x in shape.split(",")]))
    sharded = ShardedRetriever(emb, docs, mesh=make_mesh(shape, devices=[CPU] * n_dev),
                               max_k=8)
    one = TorchRetriever(emb, docs, max_k=8, device="cpu")
    q = np.concatenate([emb[[2, 30]], rng.standard_normal((3, 64)).astype(np.float32)])
    ks = [8, 3, 1, 8, 5]
    got = sharded.batch_retrieve(q, ks)
    assert got == one.batch_retrieve(q, ks)
    assert got == SimpleRetriever(emb, docs).batch_retrieve(q, ks)
    assert got[0][:2] == ["d2", "d9"]
    assert sharded.batch_retrieve(q[:, :10], [2]) == [[]]


def test_default_mesh_and_sharded_retriever_on_the_cpu(monkeypatch):
    """C4: under TORCH_DEVICE=cpu, `make_mesh()` is one CPU position and
    `ShardedRetriever` without a mesh answers as `TorchRetriever` does; an
    empty device list is refused by name, and CUDA asked for where there is
    none raises the device's own message."""
    from rag_serving_system_torch.parallel.mesh import Mesh

    monkeypatch.setenv("TORCH_DEVICE", "cpu")
    m = make_mesh()
    assert mesh_axis_sizes(m) == (1, 1) and m.devices == [CPU]
    assert mesh_axis_sizes(make_mesh("1,1")) == (1, 1)
    rng = np.random.default_rng(12)
    emb = rng.standard_normal((30, 64)).astype(np.float32)
    docs = [f"d{i}" for i in range(30)]
    q = rng.standard_normal((4, 64)).astype(np.float32)
    ks = [3, 1, 8, 5]
    sharded = ShardedRetriever(emb, docs, max_k=8)
    assert sharded.device == CPU
    assert sharded.batch_retrieve(q, ks) == TorchRetriever(
        emb, docs, max_k=8, device="cpu").batch_retrieve(q, ks)
    with pytest.raises(ValueError, match="at least one position"):
        Mesh([])
    with pytest.raises(ValueError, match="at least one position"):
        make_mesh("", devices=[])
    if not torch.cuda.is_available():
        monkeypatch.setenv("TORCH_DEVICE", "cuda")
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            make_mesh()


# ---------------------------------------------------------------------------
# the tensor-parallel rules, leaf by leaf
# ---------------------------------------------------------------------------

def _sharded(params, shape="4,2", cfg=QWEN2_TINY):
    n = int(np.prod([int(x) for x in shape.split(",")]))
    return tp.shard_params(params, make_mesh(shape, devices=[CPU] * n), cfg)


def test_rules_column_row_and_bias_leaves_follow_the_jax_specs():
    """ff_w1 / ff_b1 (column), o_w / ff_w2 (row) of e5 at tp = 2: the JAX
    spec shards that axis over "model", and each position holds its
    contiguous half; o_b, ff_b2 and the norms are replicated."""
    jp = init_encoder_params(jax_configs.E5_TINY, dtype=jnp.float32)
    specs = jax_tp.param_shardings(jp, jax_mesh.make_mesh("4,2"))["layers"]
    assert specs["ff_w1"].spec == P(None, None, "model")
    assert specs["ff_b1"].spec == P(None, "model")
    assert specs["o_w"].spec == specs["ff_w2"].spec == P(None, "model", None)
    assert specs["o_b"].spec == specs["ff_b2"].spec == P(None, None)
    full = params_from_jax(jax.device_get(jp))
    sm = _sharded(full, cfg=E5_TINY)
    assert sm.split == {"attn": True, "mlp": True} and sm.cfg == E5_TINY
    lay = full["layers"]
    for m in range(2):
        got = sm.params[0][m]["layers"]
        assert torch.equal(got["ff_w1"], lay["ff_w1"].chunk(2, dim=-1)[m])
        assert torch.equal(got["ff_b1"], lay["ff_b1"].chunk(2, dim=-1)[m])
        assert torch.equal(got["ff_w2"], lay["ff_w2"].chunk(2, dim=-2)[m])
        assert torch.equal(got["o_w"], lay["o_w"].chunk(2, dim=-2)[m])
        for key in ("o_b", "ff_b2", "attn_ln_scale", "ff_ln_bias"):
            assert got[key] is lay[key]
        assert sm.params[0][m]["embed"]["word"] is full["embed"]["word"]


def test_rules_fused_qkv_splits_by_whole_heads_and_gate_up_alike():
    """qkv_w / qkv_b split q, k and v each by whole heads; gu_w splits gate
    and up into the same units; the local config has Hq / tp and Hk / tp."""
    full = params_from_jax(jax.device_get(_jax_decoder()))
    sm = _sharded(full)
    assert sm.cfg.num_heads == 2 and sm.cfg.num_kv_heads == 1
    d, hq, hk, inner = 16, 4, 2, QWEN2_TINY.intermediate_size
    lay = full["layers"]
    q, k, v = lay["qkv_w"].split([hq * d, hk * d, hk * d], dim=-1)
    qb, kb, vb = lay["qkv_b"].split([hq * d, hk * d, hk * d], dim=-1)
    g, u = lay["gu_w"].split([inner, inner], dim=-1)
    for m in range(2):
        got = sm.params[0][m]["layers"]
        want = torch.cat([q.chunk(2, -1)[m], k.chunk(2, -1)[m], v.chunk(2, -1)[m]], dim=-1)
        assert torch.equal(got["qkv_w"], want)
        assert torch.equal(got["qkv_b"], torch.cat([qb.chunk(2, -1)[m], kb.chunk(2, -1)[m],
                                                    vb.chunk(2, -1)[m]], dim=-1))
        assert torch.equal(got["gu_w"], torch.cat([g.chunk(2, -1)[m], u.chunk(2, -1)[m]], -1))
        assert torch.equal(got["down_w"], lay["down_w"].chunk(2, dim=-2)[m])
        assert torch.equal(got["o_w"], lay["o_w"].chunk(2, dim=-2)[m])


def test_rules_int8_scales_follow_columns_and_stay_whole_under_rows():
    jp = _jax_decoder()
    from rag_serving_system_tpu.ops import quant as jquant

    jq = jquant.quantize_decoder_params(jp, bits=8)
    specs = jax_tp.param_shardings(jq, jax_mesh.make_mesh("4,2"))["layers"]
    assert specs["gu_w"].scale.spec == P(None, None, "model")
    assert specs["down_w"].scale.spec == P(None, None, None)
    full = params_from_jax(jax.device_get(jq))
    sm = _sharded(full)
    inner = QWEN2_TINY.intermediate_size
    gu, down = full["layers"]["gu_w"], full["layers"]["down_w"]
    for m in range(2):
        got = sm.params[0][m]["layers"]
        cols = torch.cat([torch.arange(m * inner // 2, (m + 1) * inner // 2)] * 2)
        cols[inner // 2:] += inner
        assert torch.equal(got["gu_w"].q, gu.q[..., cols])
        assert torch.equal(got["gu_w"].scale, gu.scale[..., cols])
        assert torch.equal(got["down_w"].q, down.q.chunk(2, dim=-2)[m])
        assert got["down_w"].scale is down.scale


def test_rules_int4_group_axis_then_packed_axis():
    """A QuantizedWeight4 row weight splits its group axis when the group
    count divides (here 2 groups of 64 at tp = 2), else its packed axis with
    the scales whole (1 group of 128); the MLP units, and gate / up, follow.
    Either way the positions' products sum to the whole product."""
    rng = np.random.default_rng(4)
    x = torch.as_tensor(rng.standard_normal((3, 128)).astype(np.float32))
    w = torch.as_tensor(rng.standard_normal((1, 128, 8)).astype(np.float32))
    for group, split_axis in ((64, -3), (128, -2)):
        qw = quant.quantize_int4(w, group=group)
        layers = {"down_w": qw,
                  "gu_w": torch.zeros((1, 8, 256)), "o_w": torch.zeros((1, 64, 64)),
                  "qkv_w": torch.zeros((1, 64, 128))}
        units = tp._mlp_units(layers, 2)
        assert units is not None
        total = 0
        for m in range(2):
            part = tp._rows(qw, units[m], 2, m)
            assert part.q.shape[split_axis] * 2 == qw.q.shape[split_axis]
            assert (part.scale is qw.scale) == (split_axis == -2)
            layer = type(part)(part.q[0], part.scale[0])
            total = total + dense(x[:, units[m]], layer)
        whole = dense(x, type(qw)(qw.q[0], qw.scale[0]))
        torch.testing.assert_close(total, whole, rtol=1e-5, atol=1e-5)


def test_rules_int4_specs_and_port_splits_agree_with_jax():
    """The JAX rules on the tiny decoder's int4 tree: gu_w shards its output
    axis, down_w (one group of 128) its packed axis with whole scales; the
    port splits the MLP the same way, and replicates the attention, whose
    o_w (one group of 64) could only split inside heads."""
    from rag_serving_system_tpu.ops import quant as jquant

    jq = jquant.quantize_decoder_params(_jax_decoder(), bits=4)
    specs = jax_tp.param_shardings(jq, jax_mesh.make_mesh("4,2"))["layers"]
    assert specs["gu_w"].q.spec == P(None, None, None, "model")
    assert specs["down_w"].q.spec == P(None, None, "model", None)
    assert specs["down_w"].scale.spec == P(None, None, None, None)
    full = params_from_jax(jax.device_get(jq))
    sm = _sharded(full)
    assert sm.split == {"attn": False, "mlp": True} and sm.cfg == QWEN2_TINY
    got = sm.params[0][1]["layers"]
    for key in ("qkv_w", "o_w"):   # the very tensors, whole
        assert got[key].q is full["layers"][key].q and got[key].scale is full["layers"][key].scale
    assert torch.equal(got["down_w"].q, full["layers"]["down_w"].q.chunk(2, dim=-2)[1])


@pytest.mark.parametrize("shape,attn,mlp", [("2,4", False, True), ("1,8", False, True),
                                            ("8,1", False, False)])
def test_rules_replicate_what_tp_does_not_divide(shape, attn, mlp):
    """QWEN2_TINY (Hq=4, Hk=2) at tp = 4 and 8: the attention block is
    whole on every position (counted once: no sum follows it), the local
    config keeps every head; tp = 1 splits nothing."""
    full = params_from_jax(jax.device_get(_jax_decoder()))
    sm = _sharded(full, shape)
    assert sm.split == {"attn": attn, "mlp": mlp}
    assert sm.cfg == QWEN2_TINY
    t = int(shape.split(",")[1])
    for m in range(t):
        got = sm.params[0][m]["layers"]
        for key in ("qkv_w", "qkv_b", "o_w"):
            assert got[key] is full["layers"][key]
        assert got["down_w"].shape[-2] == QWEN2_TINY.intermediate_size // (t if mlp else 1)


def test_position_bytes_halve_the_split_leaves_and_share_a_device():
    full = params_from_jax(jax.device_get(_jax_decoder()))
    sm = _sharded(full)
    whole = quant.weight_bytes(full)
    split = sum(quant.weight_bytes(full["layers"][k])
                for k in ("qkv_w", "qkv_b", "o_w", "gu_w", "down_w"))
    assert sm.position_bytes() == [whole - split // 2] * 8
    # data groups on one device share their model position's tensors
    assert sm.params[0][1] is sm.params[3][1] and sm.params[0][0] is not sm.params[0][1]


# ---------------------------------------------------------------------------
# lockstep
# ---------------------------------------------------------------------------

def test_row_parallel_is_the_plain_product_outside_a_position():
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.standard_normal((2, 3, 8)).astype(np.float32))
    w = torch.as_tensor(rng.standard_normal((8, 5)).astype(np.float32))
    b = torch.as_tensor(rng.standard_normal(5).astype(np.float32))
    assert torch.equal(tp.row_parallel(dense, x, w, b, "attn"), dense(x, w, b))


def test_row_parallel_sums_the_positions_partials_then_the_bias():
    rng = np.random.default_rng(2)
    x = torch.as_tensor(rng.standard_normal((4, 8)).astype(np.float32))
    w = torch.as_tensor(rng.standard_normal((8, 5)).astype(np.float32))
    b = torch.as_tensor(rng.standard_normal(5).astype(np.float32))
    mesh = make_mesh("2,2", devices=[CPU] * 4)
    model = tp.ShardedModel(params=None, cfg=None, split={"attn": True, "mlp": False})

    def fn(g, m):
        rows = slice(4 * m, 4 * m + 4)
        y = tp.row_parallel(dense, x[:, rows], w[rows], b, "attn")
        z = tp.row_parallel(dense, x, w, None, "mlp")   # replicated: no sum
        return y, z

    res = tp.run_positions(mesh, model, fn, [0, 1])
    want = (x[:, :4] @ w[:4] + x[:, 4:] @ w[4:]) + b
    for g in (0, 1):
        for m in (0, 1):
            assert torch.equal(res[(g, m)][0], want)
            assert torch.equal(res[(g, m)][1], x @ w)
    assert tp.row_groups(mesh, 4) == [(0, slice(0, 2)), (1, slice(2, 4))]
    assert tp.row_groups(mesh, 3) == [(0, slice(0, 3))]


def test_a_failing_position_aborts_its_group_instead_of_hanging():
    mesh = make_mesh("1,2", devices=[CPU] * 2)
    model = tp.ShardedModel(params=None, cfg=None, split={"attn": True, "mlp": True})
    x = torch.ones((1, 2))

    def fn(g, m):
        if m == 1:
            raise ValueError("position 1 failed")
        return tp.row_parallel(dense, x, torch.ones((2, 2)), None, "attn")

    with pytest.raises(ValueError, match="position 1 failed"):
        tp.run_positions(mesh, model, fn, [0])


@pytest.mark.parametrize("own_devices", [True, False])
def test_data_groups_take_turns_in_one_ring(own_devices):
    """The data groups of a "2,2" mesh take their turns in one ring, on
    devices of their own (cpu:0-3 stand for four cards) as on shared ones:
    only one position of the four runs at a time (groups at once were slower
    on four H100s). The sums are right."""
    import threading

    devices = [torch.device("cpu", i) for i in range(4)] if own_devices else [CPU] * 4
    mesh = make_mesh("2,2", devices=devices)
    assert tp.rings(mesh, [0, 1]) == [[(0, 0), (0, 1), (1, 0), (1, 1)]]
    model = tp.ShardedModel(params=None, cfg=None, split={"attn": True, "mlp": True})
    lock, running, most = threading.Lock(), [0], [0]

    def summed(a, w, b=None):
        with lock:
            running[0] += 1
            most[0] = max(most[0], running[0])
        time.sleep(0.01)
        with lock:
            running[0] -= 1
        return a

    def fn(g, m):
        x = torch.full((1, 1), float(10 * g + m))
        return tp.row_parallel(summed, x, None, None, "attn").item()

    res = tp.run_positions(mesh, model, fn, [0, 1])
    assert res == {(g, m): float(20 * g + 1) for g in (0, 1) for m in (0, 1)}
    assert most[0] == 1


@pytest.mark.parametrize("shape", ["", "2,2"])
def test_main_builds_a_mesh_of_the_cards_only_when_mesh_shape_is_set(shape):
    """With four visible CUDA devices `main._mesh` builds the "dp,tp" mesh of
    MESH_SHAPE over them, and serves on one card (no mesh) while MESH_SHAPE
    is unset."""
    from unittest import mock

    from rag_serving_system_torch import device as port_device
    from rag_serving_system_torch import main as port_main

    settings = port_config.Settings(mesh_shape=shape)
    with mock.patch.object(torch.cuda, "device_count", return_value=4), \
            mock.patch.object(port_device, "resolve_device",
                              return_value=torch.device("cuda", 0)):
        mesh = port_main._mesh(settings)
    if not shape:
        assert mesh is None
    else:
        assert mesh.shape == {"data": 2, "model": 2}
        assert mesh.devices == [torch.device("cuda", i) for i in range(4)]


# ---------------------------------------------------------------------------
# the decode pool over a mesh
# ---------------------------------------------------------------------------

def _scaled(tree, f):
    return {k: (_scaled(v, f) if isinstance(v, dict) else
                v * f if k in ("embed", "qkv_w", "o_w", "gu_w", "down_w") else v)
            for k, v in tree.items()}


def _pool_answers(engine, queries):
    pool = engine.decode_pool
    got = {}
    pool.start()
    try:
        pool.submit([str(i) for i in range(len(queries))],
                    engine.prepare(queries, [2] * len(queries)),
                    lambda rid, res: got.__setitem__(rid, res))
        assert pool.wait_idle(120), pool.stats()
    finally:
        pool.stop()
    return [got[str(i)] for i in range(len(queries))]


@pytest.mark.parametrize("shape", ["2,1", "1,2"])
def test_decode_pool_over_a_mesh_answers_as_the_fixed_path(shape):
    """DECODE_MODE=continuous over a mesh: 3 slots, padded up to 4 under
    dp = 2, the slot axis over "data" ("2,1"), or the KV heads over "model"
    ("1,2"), the prefix cache on. Four requests through the pool
    answer exactly as the fixed path of the one-device engine and of the
    JAX engine over the same mesh."""
    rng = np.random.default_rng(6)
    docs = [f"Document {i}. " + " ".join(f"d{i}w{j}" for j in range(24)) for i in range(24)]
    emb = rng.standard_normal((24, 64)).astype(np.float32)
    over = dict(model_preset="tiny", dtype="float32", do_sample=False, batch_buckets=[2, 4],
                max_batch_size=4, encode_len_buckets=[16], prompt_len_buckets=[64],
                max_new_tokens=4, max_k=4, prefix_pool_len=48, mesh_shape=shape,
                embed_model_name="e5", llm_model_name="qwen")
    jmesh = jax_mesh.make_mesh(shape, devices=jax.devices()[:2])
    je = jax_engine.RagEngine(jax_config.Settings(**over), docs, emb, mesh=jmesh)
    je.dec_params = jax_tp.shard_params(_scaled(_jax_decoder(), 8.0), jmesh)
    cont = port_config.Settings(**over, decode_mode="continuous", decode_slots=3)
    tm = port_engine.RagEngine(cont, docs, emb, mesh=make_mesh(shape, devices=[CPU] * 2))
    ts = port_engine.RagEngine(port_config.Settings(**over), docs, emb, device="cpu")
    enc, dec = (params_from_jax(jax.device_get(t)) for t in (je.enc_params, je.dec_params))
    for te in (tm, ts):
        te.enc_params, te.dec_params = enc, dec
    pool = tm.decode_pool
    assert (pool.slots, pool.group_slots) == {"2,1": (4, 2), "1,2": (3, 3)}[shape]
    heads = QWEN2_TINY.num_kv_heads // int(shape[-1])
    assert all(st[0].shape[3] == heads for st in pool._states.values())
    queries = ["what is document 7 about?", "document 13?", "document 2 w3?", "d5w1 d5w2"]
    fixed = ts.process(queries, [2] * 4)
    assert fixed == je.process(queries, [2] * 4)
    assert _pool_answers(tm, queries) == fixed
    assert any(r["result"] for r in fixed)
    assert tm.decode_pool.stats()["completed"] == 4


def test_lockstep_sums_and_launch_counts_hold_under_thread_churn():
    """Sixteen positions (more threads than the 8 cores the tests run on) in
    four data groups, each position 100 sums of its own values under a 1 us
    thread switch interval: every sum is the expected one (a reused exchange
    buffer or a crossed group would break it), and 1,600 launch counts from
    the threads add up (a lost update would not)."""
    import sys
    import threading

    from rag_serving_system_torch.ops import _build

    mesh = make_mesh("4,4", devices=[CPU] * 16)
    model = tp.ShardedModel(params=None, cfg=None, split={"attn": True, "mlp": True})
    counted = type("Counted", (), {"launches": 0})

    def fn(g, m):
        got = []
        for r in range(100):
            x = torch.full((1, 1), float(1000 * g + 10 * r + m))
            got.append(tp.row_parallel(lambda a, w, b=None: a, x, None, None, "attn").item())
            _build.count_launch(counted)
        return got

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        done = []
        worker = threading.Thread(target=lambda: done.append(
            tp.run_positions(mesh, model, fn, range(4))), daemon=True)
        worker.start()
        worker.join(timeout=120)
        assert not worker.is_alive() and done
    finally:
        sys.setswitchinterval(old)
    for (g, m), got in done[0].items():
        assert got == [sum(1000 * g + 10 * r + j for j in range(4)) for r in range(100)]
    assert len(done[0]) == 16 and counted.launches == 16 * 100

