"""PyTorch port: the contrastive trainer against the JAX package's at
`E5_TINY` in f32, both given the same weights (`params_from_jax`) and the
same numpy-seeded batches: the loss and in-batch accuracy, every gradient
leaf, three AdamW steps (optax's defaults), the two-step `train_encoder`
history, the batches, the checkpoints, the poolings, the mixed-dtype
`dense`, `encode_batch` and `device_trace`. Plus the intent of the JAX
package's own training tests (a finite loss, a falling loss over 8 steps,
parameters that change)."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from rag_serving_system_tpu.models import e5 as je  # noqa: E402
from rag_serving_system_tpu.models import layers as jl  # noqa: E402
from rag_serving_system_tpu.models import tokenizer as jtok  # noqa: E402
from rag_serving_system_tpu.models.configs import E5_TINY  # noqa: E402
from rag_serving_system_tpu.models.weights import init_encoder_params  # noqa: E402
from rag_serving_system_tpu.training import contrastive as jc  # noqa: E402
from rag_serving_system_torch.models import e5 as te  # noqa: E402
from rag_serving_system_torch.models import layers as tl  # noqa: E402
from rag_serving_system_torch.models import tokenizer as ttok  # noqa: E402
from rag_serving_system_torch.models.weights import named_leaves, params_from_jax  # noqa: E402
from rag_serving_system_torch.training import (  # noqa: E402
    adamw,
    contrastive_loss,
    load_checkpoint,
    make_train_step,
    pair_batches,
    save_checkpoint,
    train_encoder,
)
from rag_serving_system_torch.utils.timing import device_trace  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAIRS = [{"fact": f"the color of object {i} is shade {i}",
          "query": f"what color is object {i}?"} for i in range(32)]
CPU = dict(device="cpu")
LR = 5e-4


@pytest.fixture(scope="module")
def setup():
    jp = init_encoder_params(E5_TINY, seed=0, dtype=jnp.float32)
    tok = jtok.HashTokenizer(E5_TINY.vocab_size, pad_id=E5_TINY.pad_token_id)
    port_tok = ttok.HashTokenizer(E5_TINY.vocab_size, pad_id=E5_TINY.pad_token_id)
    return jp, tok, port_tok


def _port(jp):
    return params_from_jax(jax.device_get(jp))


def _batch_pair(tok, port_tok, batch_size=16, max_len=32, seed=0):
    jb = next(jc.pair_batches(tok, PAIRS, batch_size=batch_size, max_len=max_len, seed=seed))
    tb = next(pair_batches(port_tok, PAIRS, batch_size=batch_size, max_len=max_len,
                           seed=seed, **CPU))
    return jb, tb


def _flat_jax(tree, prefix=""):
    return dict(named_leaves(jax.tree.map(np.asarray, tree), prefix))


def test_pair_batches_equal_jax(setup):
    _, tok, port_tok = setup
    for seed, bs, max_len in ((0, 8, 32), (3, 16, 12), (1, 5, 64)):
        ref = list(jc.pair_batches(tok, PAIRS, bs, max_len, seed=seed))
        ours = list(pair_batches(port_tok, PAIRS, bs, max_len, seed=seed, **CPU))
        assert len(ours) == len(ref) == len(PAIRS) // bs
        for jb, tb in zip(ref, ours):
            assert set(tb) == set(jb)
            for k in jb:
                assert tb[k].device.type == "cpu"
                np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
    # the "context" fallback when a pair has no "fact"
    ctx = [{"query": f"q{i}", "context": f"c {i} c"} for i in range(4)]
    jb = next(jc.pair_batches(tok, ctx, 4, 8))
    tb = next(pair_batches(port_tok, ctx, 4, 8, **CPU))
    np.testing.assert_array_equal(tb["p_ids"].numpy(), np.asarray(jb["p_ids"]))


def test_loss_and_accuracy_match_jax(setup):
    jp, tok, port_tok = setup
    for bs in (8, 16):
        jb, tb = _batch_pair(tok, port_tok, batch_size=bs)
        ref_loss, ref_acc = jc.contrastive_loss(jp, E5_TINY, jb, dtype=jnp.float32)
        loss, acc = contrastive_loss(_port(jp), E5_TINY, tb, dtype=torch.float32)
        # the JAX tests' intent: a finite loss and an accuracy in [0, 1]
        assert np.isfinite(float(loss)) and 0.0 <= float(acc) <= 1.0
        assert abs(float(loss) - float(ref_loss)) <= 1e-5
        assert abs(float(acc) - float(ref_acc)) <= 1e-5


def test_gradients_match_jax(setup):
    jp, tok, port_tok = setup
    jb, tb = _batch_pair(tok, port_tok)
    ref = _flat_jax(jax.grad(lambda p: jc.contrastive_loss(
        p, E5_TINY, jb, dtype=jnp.float32)[0])(jp))
    tp = _port(jp)
    for _, t in named_leaves(tp):
        t.requires_grad_(True)
    loss, _ = contrastive_loss(tp, E5_TINY, tb, dtype=torch.float32)
    loss.backward()
    got = {name: t.grad for name, t in named_leaves(tp)}
    assert set(got) == set(ref) and len(ref) == 17
    for name, want in ref.items():
        scale = max(float(np.abs(want).max()), 1e-30)
        err = float(np.abs(got[name].numpy() - want).max())
        assert err <= 1e-5 * scale, (name, err, scale)


def _jax_steps(jp, jb, n, lr=LR):
    opt = optax.adamw(lr)
    state = opt.init(jp)
    step = jc.make_train_step(E5_TINY, opt, dtype=jnp.float32)
    grads, losses = [], []
    for _ in range(n):
        grads.append(_flat_jax(jax.grad(lambda p: jc.contrastive_loss(
            p, E5_TINY, jb, dtype=jnp.float32)[0])(jp)))
        jp, state, m = step(jp, state, jb)
        losses.append(float(m["loss"]))
    return jp, grads, losses


def test_three_adamw_steps_match_optax(setup):
    """Adam's early steps move an element by about lr times the SIGN of its
    gradient, whatever the gradient's size: an element whose JAX gradient
    is within 1e-7 of zero may take the other sign here, and so differ by up
    to 2 lr a step. Every other element agrees within 2e-6."""
    jp, tok, port_tok = setup
    jb, tb = _batch_pair(tok, port_tok)
    ref, grads, ref_losses = _jax_steps(jp, jb, 3)
    tp = _port(jp)
    opt = adamw(tp, LR)
    assert opt.defaults["weight_decay"] == 1e-4 and opt.defaults["eps"] == 1e-8
    assert opt.defaults["betas"] == (0.9, 0.999)
    step = make_train_step(E5_TINY, opt, dtype=torch.float32)
    losses = [float(step(tp, tb)["loss"]) for _ in range(3)]
    np.testing.assert_allclose(losses, ref_losses, atol=1e-5, rtol=0)
    ref = _flat_jax(ref)
    for name, t in named_leaves(tp):
        near_zero = sum((np.abs(g[name]) <= 1e-7).astype(np.float32) for g in grads)
        allowed = 2e-6 + 2 * LR * near_zero
        err = np.abs(t.detach().numpy() - ref[name])
        assert (err <= allowed).all(), (name, float(err.max()))


def test_train_step_reduces_loss(setup):
    jp, tok, port_tok = setup
    _, tb = _batch_pair(tok, port_tok)
    tp = _port(jp)
    before = {name: t.clone() for name, t in named_leaves(tp)}
    step = make_train_step(E5_TINY, adamw(tp, LR), dtype=torch.float32)
    losses = [float(step(tp, tb)["loss"]) for _ in range(8)]
    assert losses[-1] < losses[0], losses
    assert all(not torch.equal(before[name], t) for name, t in named_leaves(tp))


def test_train_encoder_history_matches_jax(setup):
    jp, tok, port_tok = setup
    ref_params, ref_hist = jc.train_encoder(jp, E5_TINY, tok, PAIRS, epochs=1, batch_size=16,
                                            max_len=32, lr=1e-4, dtype=jnp.float32)
    tp = _port(jp)
    word = tp["embed"]["word"].clone()
    new, hist = train_encoder(tp, E5_TINY, port_tok, PAIRS, epochs=1, batch_size=16,
                              max_len=32, lr=1e-4, dtype=torch.float32, **CPU)
    assert len(hist) == len(ref_hist) == 2  # 32 pairs / 16
    for ours, want in zip(hist, ref_hist):
        assert set(ours) == set(want)
        for k in want:
            assert abs(ours[k] - want[k]) <= 1e-4, (k, ours, want)
    # the caller's tree is left as it was; the trained one moved
    assert torch.equal(tp["embed"]["word"], word)
    assert float((new["embed"]["word"] - word).abs().max()) > 0
    np.testing.assert_allclose(new["layers"]["qkv_w"].numpy(),
                               np.asarray(ref_params["layers"]["qkv_w"]), atol=1e-4, rtol=0)


def test_entry_points_need_the_card_unless_told_cpu(setup, monkeypatch, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a CUDA device")
    jp, _, port_tok = setup
    monkeypatch.delenv("TORCH_DEVICE", raising=False)
    with pytest.raises(RuntimeError, match="cuda"):
        train_encoder(_port(jp), E5_TINY, port_tok, PAIRS, batch_size=16, max_len=8)
    with pytest.raises(RuntimeError, match="cuda"):
        next(pair_batches(port_tok, PAIRS, 16, 8))
    with pytest.raises(RuntimeError, match="cuda"):
        with device_trace(str(tmp_path)):
            pass
    assert not any(tmp_path.iterdir())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_checkpoint_roundtrip_is_bit_exact(setup, tmp_path, dtype):
    jp, _, _ = setup
    tp = {k: {n: t.to(dtype) for n, t in v.items()} for k, v in _port(jp).items()}
    tp["layers"]["qkv_w"].add_(torch.randn_like(tp["layers"]["qkv_w"]))
    path = str(tmp_path / "enc.safetensors")
    nbytes = save_checkpoint(path, tp)
    assert nbytes == os.path.getsize(path)
    assert nbytes > sum(t.numel() * t.element_size() for _, t in named_leaves(tp))
    back = load_checkpoint(path, tp)
    assert list(back) == list(tp) and all(list(back[k]) == list(tp[k]) for k in tp)
    for (name, a), (_, b) in zip(named_leaves(tp), named_leaves(back)):
        assert b.dtype == dtype and b.device == a.device, name
        assert torch.equal(a.view(torch.uint8) if a.dim() else a, b.view(torch.uint8)
                           if b.dim() else b), name
    # the stored file names the leaves with dots
    n = int.from_bytes(open(path, "rb").read(8), "little")
    header = json.loads(open(path, "rb").read(8 + n)[8:])
    assert "embed.word" in header and "layers.ff_ln_bias" in header


def test_checkpoint_refuses_a_wrong_template(setup, tmp_path):
    jp, _, _ = setup
    tp = _port(jp)
    path = str(tmp_path / "enc.safetensors")
    save_checkpoint(path, tp)
    extra = {**tp, "head": {"w": torch.zeros(2)}}
    with pytest.raises(ValueError, match="missing"):
        load_checkpoint(path, extra)
    fewer = {"embed": dict(tp["embed"]), "layers": tp["layers"]}
    del fewer["embed"]["type"]
    with pytest.raises(ValueError, match="unexpected"):
        load_checkpoint(path, fewer)
    wrong = {"embed": dict(tp["embed"]), "layers": tp["layers"]}
    wrong["embed"]["word"] = torch.zeros(3, 3)
    with pytest.raises(ValueError, match="shape"):
        load_checkpoint(path, wrong)


@pytest.mark.parametrize("pooling", ["mean_all", "mean_masked", "cls"])
def test_pool_matches_jax_encode(setup, pooling):
    jp, _, _ = setup
    tp = _port(jp)
    rng = np.random.default_rng(5)
    ids = rng.integers(3, E5_TINY.vocab_size, (4, 16)).astype(np.int32)
    mask = np.ones((4, 16), np.int32)
    for row, n in ((1, 9), (2, 1), (3, 14)):
        mask[row, n:] = 0
        ids[row, n:] = E5_TINY.pad_token_id
    ref = np.asarray(je.encode(jp, E5_TINY, jnp.asarray(ids), jnp.asarray(mask),
                               pooling=pooling, dtype=jnp.float32))
    hidden = te.encoder_forward(tp, E5_TINY, torch.tensor(ids), torch.tensor(mask),
                                dtype=torch.float32)
    np.testing.assert_allclose(te.pool(hidden, torch.tensor(mask), pooling).numpy(), ref,
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(te.encode(tp, E5_TINY, torch.tensor(ids), torch.tensor(mask),
                                         pooling=pooling, dtype=torch.float32).numpy(),
                               ref, atol=1e-5, rtol=1e-5)


def test_pool_refuses_an_unknown_pooling():
    hidden = torch.zeros(2, 3, 4)
    with pytest.raises(ValueError, match="unknown pooling"):
        te.pool(hidden, torch.ones(2, 3), "max")
    # an all-pad row divides by max(count, 1): zeros, not NaN
    out = te.pool(torch.ones(2, 3, 4), torch.tensor([[1, 1, 0], [0, 0, 0]]), "mean_masked")
    assert torch.equal(out, torch.tensor([[1.0] * 4, [0.0] * 4]))


@pytest.mark.parametrize("with_bias", [True, False])
@pytest.mark.parametrize("x_dtype,w_dtype", [(torch.bfloat16, torch.float32),
                                             (torch.float32, torch.bfloat16)])
def test_mixed_dtype_dense_matches_jax(with_bias, x_dtype, w_dtype):
    """JAX's einsum promotes a bf16 x f32 product to f32, adds the bias in
    f32 and casts once: the port's result is within one ulp of x's dtype."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    w = (rng.standard_normal((64, 48)) * 0.1).astype(np.float32)
    b = rng.standard_normal(48).astype(np.float32)
    jdt = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32}
    ref = jl.dense(jnp.asarray(x, jdt[x_dtype]), jnp.asarray(w, jdt[w_dtype]),
                   jnp.asarray(b, jdt[w_dtype]) if with_bias else None)
    ours = tl.dense(torch.tensor(x).to(x_dtype), torch.tensor(w).to(w_dtype),
                    torch.tensor(b).to(w_dtype) if with_bias else None)
    assert ours.dtype == x_dtype and ref.dtype == jdt[x_dtype]
    want = np.asarray(ref.astype(jnp.float32))
    mantissa = 7 if x_dtype == torch.bfloat16 else 23
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - mantissa)
    if x_dtype == torch.float32:
        ulp = ulp * 64       # f32 sums of 64 products in another order
    assert (np.abs(ours.float().numpy() - want) <= ulp).all()


def test_hash_encode_batch_matches_jax():
    texts = ["query: what is the boiling point of water?", "", "a b c d e f g h i j k",
             "passage: Zürich, 東京 and naïve façade 😀 " * 4]
    for vocab, pad in ((512, 1), (250002, 1), (151936, 151643)):
        ours = ttok.HashTokenizer(vocab, pad_id=pad)
        ref = jtok.HashTokenizer(vocab, pad_id=pad)
        for max_len in (4, 16, 40):
            for pad_side in ("right", "left"):
                for trunc in ("right", "left"):
                    got = ours.encode_batch(texts, max_len, pad_side, trunc)
                    want = ref.encode_batch(texts, max_len, pad_side, trunc)
                    for g, w in zip(got, want):
                        assert g.dtype == w.dtype
                        np.testing.assert_array_equal(g, w)


def test_hf_encode_batch_matches_jax():
    pytest.importorskip("transformers")
    path = os.path.join(ROOT, "data", "bpe_tokenizer")
    ours, ref = ttok.HFTokenizer(path), jtok.HFTokenizer(path)
    texts = ["What is Anthrozoology also known as?", "", "passage: " + "word " * 50]
    for pad_side, trunc in (("right", "right"), ("left", "left"), ("right", "left")):
        for g, w in zip(ours.encode_batch(texts, 24, pad_side, trunc),
                        ref.encode_batch(texts, 24, pad_side, trunc)):
            np.testing.assert_array_equal(g, w)


def test_device_trace_off_is_a_no_op(tmp_path):
    for off in (None, ""):
        with device_trace(off) as prof:
            assert prof is None
    assert not any(tmp_path.iterdir())


def test_device_trace_writes_a_chrome_trace(tmp_path):
    log_dir = tmp_path / "trace"
    with device_trace(str(log_dir), device="cpu") as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    files = list(log_dir.iterdir())
    assert len(files) == 1 and files[0].suffix == ".json"
    assert "traceEvents" in json.loads(files[0].read_text())
    assert any("mm" in e.key for e in prof.key_averages())


def test_device_trace_stops_on_an_exception(tmp_path):
    with pytest.raises(KeyError, match="inside"):
        with device_trace(str(tmp_path), device="cpu"):
            assert torch.autograd._profiler_enabled()
            raise KeyError("inside")
    assert not torch.autograd._profiler_enabled()
    assert len(list(tmp_path.iterdir())) == 1
