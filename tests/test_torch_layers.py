"""PyTorch port: building blocks and weights against the JAX package.

Same seeded numpy inputs through `rag_serving_system_tpu.models.layers` and
`rag_serving_system_torch.models.layers`, in f32, at atol/rtol 1e-5."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rag_serving_system_tpu.models import layers as jl  # noqa: E402
from rag_serving_system_tpu.models import qwen2 as jq  # noqa: E402
from rag_serving_system_tpu.models.configs import (  # noqa: E402
    E5_TINY, QWEN2_TINY)
from rag_serving_system_tpu.models.weights import (  # noqa: E402
    init_decoder_params as jax_init_decoder,
    init_encoder_params as jax_init_encoder)
from rag_serving_system_torch.models import layers as tl  # noqa: E402
from rag_serving_system_torch.models import qwen2 as tq  # noqa: E402
from rag_serving_system_torch.models.weights import (  # noqa: E402
    init_decoder_params, init_encoder_params, params_from_jax)

TOL = dict(atol=1e-5, rtol=1e-5)


def _close(ours, ref, **tol):
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), **(tol or TOL))


@pytest.fixture
def data():
    return np.random.default_rng(7)


@pytest.mark.parametrize("with_bias", [False, True])
def test_dense(data, with_bias):
    x = data.standard_normal((2, 5, 16)).astype(np.float32)
    w = data.standard_normal((16, 24)).astype(np.float32)
    b = data.standard_normal((24,)).astype(np.float32) if with_bias else None
    ours = tl.dense(torch.tensor(x), torch.tensor(w),
                    None if b is None else torch.tensor(b))
    _close(ours, jl.dense(jnp.asarray(x), jnp.asarray(w),
                          None if b is None else jnp.asarray(b)))


def test_norms_and_activations(data):
    x = data.standard_normal((3, 7, 32)).astype(np.float32)
    s = data.standard_normal((32,)).astype(np.float32)
    b = data.standard_normal((32,)).astype(np.float32)
    tx, jx = torch.tensor(x), jnp.asarray(x)
    _close(tl.layer_norm(tx, torch.tensor(s), torch.tensor(b), 1e-5),
           jl.layer_norm(jx, jnp.asarray(s), jnp.asarray(b), 1e-5))
    _close(tl.rms_norm(tx, torch.tensor(s), 1e-6),
           jl.rms_norm(jx, jnp.asarray(s), 1e-6))
    _close(tl.gelu(tx), jl.gelu(jx))
    _close(tl.silu(tx), jl.silu(jx))


def test_rope(data):
    _close(tl.rope_freqs(16, 1e6), jl.rope_freqs(16, 1e6))
    x = data.standard_normal((2, 9, 4, 16)).astype(np.float32)
    pos = data.integers(0, 300, (2, 9)).astype(np.int32)
    inv = jl.rope_freqs(16, 1e6)
    _close(tl.apply_rope(torch.tensor(x), torch.tensor(pos), tl.rope_freqs(16, 1e6)),
           jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), inv))


def test_masks_and_attention(data):
    mask = np.ones((2, 12), np.int32)
    mask[0, :5] = 0
    tm, jm = torch.tensor(mask), jnp.asarray(mask)
    _close(tl.padding_bias(tm), jl.padding_bias(jm))
    _close(tl.causal_padding_bias(tm), jl.causal_padding_bias(jm))
    q = data.standard_normal((2, 12, 4, 8)).astype(np.float32)
    k = data.standard_normal((2, 12, 2, 8)).astype(np.float32)
    v = data.standard_normal((2, 12, 2, 8)).astype(np.float32)
    for tb, jb in ((tl.padding_bias(tm), jl.padding_bias(jm)),
                   (tl.causal_padding_bias(tm), jl.causal_padding_bias(jm))):
        _close(tl.attention(torch.tensor(q), torch.tensor(k), torch.tensor(v), tb),
               jl.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jb))


def test_params_from_jax_gives_same_layer_outputs(data):
    """A converted JAX tree drives one decoder block to the JAX output."""
    cfg = QWEN2_TINY
    jp = jax_init_decoder(cfg, dtype=jnp.float32)
    tp = params_from_jax(jax.device_get(jp))
    assert jax.tree_util.tree_structure(jp) == jax.tree_util.tree_structure(
        jax.tree_util.tree_map(lambda t: 0, tp))
    b, p = 2, 10
    x = data.standard_normal((b, p, cfg.hidden_size)).astype(np.float32)
    mask = np.ones((b, p), np.int32)
    pos = np.tile(np.arange(p, dtype=np.int32), (b, 1))
    bias_j = jl.causal_padding_bias(jnp.asarray(mask))
    bias_t = tl.causal_padding_bias(torch.tensor(mask))
    layer_j = jax.tree_util.tree_map(lambda a: a[1], jp["layers"])
    ref, _, _ = jq._layer_forward(
        layer_j, cfg, jnp.asarray(x), jnp.asarray(pos),
        jl.rope_freqs(cfg.head_dim, cfg.rope_theta), b, p, False,
        lambda q, k, v: (jl.attention(q, k, v, bias_j), k, v))
    ours, _, _ = tq._layer_forward(
        tq._layer(tp, 1), cfg, torch.tensor(x), torch.tensor(pos),
        tl.rope_freqs(cfg.head_dim, cfg.rope_theta), b, p,
        lambda q, k, v: tl.attention(q, k, v, bias_t))
    _close(ours, ref)


def test_params_from_jax_bfloat16_is_bit_exact():
    jp = jax_init_encoder(E5_TINY, dtype=jnp.bfloat16)
    tp = params_from_jax(jax.device_get(jp))
    w = tp["layers"]["qkv_w"]
    assert w.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        w.float().numpy(), np.asarray(jp["layers"]["qkv_w"].astype(jnp.float32)))


@pytest.mark.parametrize("kind", ["encoder", "decoder"])
def test_random_init_matches_jax_layout_and_distribution(kind):
    if kind == "encoder":
        jp = jax_init_encoder(E5_TINY, dtype=jnp.float32)
        tp = init_encoder_params(E5_TINY, dtype=torch.float32)
    else:
        jp = jax_init_decoder(QWEN2_TINY, dtype=jnp.float32)
        tp = init_decoder_params(QWEN2_TINY, dtype=torch.float32)
    jleaves = jax.tree_util.tree_leaves_with_path(jp)
    tleaves = dict(jax.tree_util.tree_leaves_with_path(tp))
    assert len(jleaves) == len(tleaves)
    for path, ja in jleaves:
        ta = tleaves[path].numpy()
        ja = np.asarray(ja)
        assert ta.shape == ja.shape, path
        if np.all(ja == ja.flat[0]):          # norms (ones) and biases (zeros)
            np.testing.assert_array_equal(ta, ja)
        else:                                 # normal clipped to +-2 sigma, sigma 0.02
            assert np.abs(ta).max() <= 0.04 + 1e-7
            if ta.size >= 4096:
                assert abs(ta.std() - ja.std()) < 0.05 * ja.std(), path
