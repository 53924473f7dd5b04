"""PyTorch port: the plain versions of the roofline probes P1 (stream) and
P2 (dot) against the Pallas probes of scripts/profile_topk.py, run in
interpret mode. The pallas_call is built here around the script's own
`_stream_kernel` and `_dot_kernel`, with the script's BlockSpecs.

The two sides sum in different orders. An f32 sum of m terms moves by at
most about m * 2^-24 * (the sum of the terms' absolute values) when the
order changes, so that bound sets each tolerance: m = 2 * blocks for P1's
sum of block maxima; m = 32 for P2's random-sign dot products, whose order
errors stay far below the worst case."""

import functools
import importlib.util
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from rag_serving_system_torch.ops import probes as tp  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@functools.lru_cache(maxsize=1)
def _script():
    spec = importlib.util.spec_from_file_location(
        "profile_topk_script", os.path.join(ROOT, "scripts", "profile_topk.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pallas_stream(corpus, block_n):
    n, d = corpus.shape
    return pl.pallas_call(
        functools.partial(_script()._stream_kernel, _=None), grid=(n // block_n,),
        in_specs=[pl.BlockSpec((block_n, d), lambda i: (i, 0), memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((1, d), lambda i: (0, 0), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((1, d), jnp.float32),
        scratch_shapes=[pltpu.VMEM((1, d), jnp.float32)], interpret=True)(corpus)


def _pallas_dot(corpus, queries, block_n):
    """The script's dot variant at Precision.HIGHEST (IEEE f32 on the CPU)."""
    n, d = corpus.shape
    b = queries.shape[0]
    return pl.pallas_call(
        functools.partial(_script()._dot_kernel, precision=jax.lax.Precision.HIGHEST),
        grid=(n // block_n,),
        in_specs=[pl.BlockSpec((b, d), lambda i: (0, 0), memory_space=pltpu.VMEM),
                  pl.BlockSpec((block_n, d), lambda i: (i, 0), memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((b, 128), lambda i: (0, 0), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((b, 128), jnp.float32),
        scratch_shapes=[pltpu.VMEM((b, 128), jnp.float32)],
        interpret=True)(queries.astype(corpus.dtype), corpus)


def _data(seed, n, d, b=0):
    rng = np.random.default_rng(seed)
    c = rng.standard_normal((n, d)).astype(np.float32)
    return c / np.linalg.norm(c, axis=1, keepdims=True), rng.standard_normal((b, d)).astype(
        np.float32)


def _bf16(x):
    """f32 numpy array rounded to bf16 (round to nearest even), as f32."""
    return torch.tensor(x).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("n,d,block_n", [(1000, 64, 128), (600, 128, 256)])
def test_stream_probe_matches_pallas(dtype, n, d, block_n):
    """N a multiple of no block: the tail rows are dropped on both sides."""
    c, _ = _data(n + d, n, d)
    if dtype == "int8":
        c = np.round(c * 400).clip(-127, 127).astype(np.int8)
        ours_in = torch.tensor(c)
    elif dtype == "bfloat16":
        ours_in = torch.tensor(c).to(torch.bfloat16)
    else:
        ours_in = torch.tensor(c)
    ref = _pallas_stream(jnp.asarray(c).astype(getattr(jnp, dtype)), block_n)
    ours = tp.stream_probe(ours_in, block_n)
    assert ours.shape == (1, d) and ours.dtype == torch.float32
    tol = 2 * (n // block_n) * 2.0 ** -24 * tp.abs_terms(ours_in, None, block_n).numpy()
    assert (np.abs(ours.numpy() - np.asarray(ref)) <= tol).all()


@pytest.mark.parametrize("dtype,highest", [("float32", True), ("float32", False),
                                           ("bfloat16", True)])
@pytest.mark.parametrize("n,d,b,block_n", [(1000, 64, 3, 128), (1280, 128, 5, 256)])
def test_dot_probe_matches_pallas(dtype, highest, n, d, b, block_n):
    """highest=False is one bf16 pass on an f32 corpus: the script's
    Precision.DEFAULT on the TPU. On the CPU that default is full f32, so
    its counterpart here is the HIGHEST probe on bf16-rounded inputs."""
    c, q = _data(n + b, n, d, b)
    tc, tq = torch.tensor(c), torch.tensor(q)
    if dtype == "bfloat16":
        tc = tc.to(torch.bfloat16)
        ref = _pallas_dot(jnp.asarray(c).astype(jnp.bfloat16), jnp.asarray(q), block_n)
    elif highest:
        ref = _pallas_dot(jnp.asarray(c), jnp.asarray(q), block_n)
    else:
        ref = _pallas_dot(jnp.asarray(_bf16(c)), jnp.asarray(_bf16(q)), block_n)
    ours = tp.dot_probe(tc, tq, block_n, highest)
    assert ours.shape == (b, 128) and ours.dtype == torch.float32
    tol = 32 * 2.0 ** -24 * tp.abs_terms(tc, tq, block_n, highest).numpy()
    assert (np.abs(ours.numpy() - np.asarray(ref)) <= tol).all()


def test_int8_dot_probe_is_exact():
    """int8 operands: exact int32 dots, folded by row mod 128 (every partial
    sum here stays below 2^24, so f32 holds it exactly)."""
    rng = np.random.default_rng(7)
    c = rng.integers(-127, 128, (700, 64), dtype=np.int8)
    q = rng.integers(-127, 128, (3, 64), dtype=np.int8)
    rows = 700 // 256 * 256
    dots = q.astype(np.int64) @ c[:rows].astype(np.int64).T
    want = dots.reshape(3, rows // 128, 128).sum(1).astype(np.float32)
    ours = tp.dot_probe(torch.tensor(c), torch.tensor(q), 256)
    np.testing.assert_array_equal(ours.numpy(), want)
