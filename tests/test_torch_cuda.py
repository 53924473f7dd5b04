"""PyTorch port: each CUDA kernel against its plain version, on the card.

Skipped without a CUDA device (the kernels have no CPU mode; their plain
versions are pinned to the JAX package by the other test_torch_* files).
On a machine with an NVIDIA GPU and nvcc:

    python -m pytest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from rag_serving_system_torch.device import resolve_device  # noqa: E402
from rag_serving_system_torch.ops import attention as ta  # noqa: E402
from rag_serving_system_torch.ops import topk as tt  # noqa: E402


@pytest.fixture(autouse=True)
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return resolve_device("cuda")


def _randn(dev, shape, seed, dtype=torch.float32):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=g, device=dev).to(dtype)


@pytest.mark.parametrize("n,b,k,dtype", [
    (1000, 32, 16, torch.float32),
    (777, 5, 1, torch.float32),        # N a multiple of no tile, k = 1
    (5000, 64, 16, torch.float32),     # two query groups of 32
    (4099, 3, 2, torch.bfloat16),
    (300, 2, 32, torch.float32),       # the widest list a warp holds
])
def test_topk_kernel_matches_plain(dev, n, b, k, dtype):
    corpus = tt.l2_normalize(_randn(dev, (n, 1024), n)).to(dtype)
    q = _randn(dev, (b, 1024), n + 1)
    before = tt.cosine_topk.launches
    s, i = tt.cosine_topk(corpus, q, k)
    assert tt.cosine_topk.launches == before + 1
    rs, ri = tt.cosine_topk_reference(corpus, q, k)
    torch.testing.assert_close(s, rs, atol=1e-5, rtol=0)
    assert torch.equal(i, ri)


def test_topk_kernel_ties_lowest_index_first(dev):
    pat = torch.where(_randn(dev, (4, 64), 9) > 0, 0.125, -0.125)
    corpus = pat[torch.arange(600, device=dev) % 4].contiguous()
    s, i = tt.cosine_topk(corpus, pat[:2].clone(), 16)
    rs, ri = tt.cosine_topk_reference(corpus, pat[:2].clone(), 16)
    assert torch.equal(i, ri) and torch.equal(s, rs)
    assert i[0].tolist() == list(range(0, 64, 4))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,s,hq,hk,d", [(3, 200, 12, 2, 128), (2, 128, 4, 4, 64)])
def test_flash_kernel_matches_plain(dev, dtype, tol, b, s, hq, hk, d):
    q = _randn(dev, (b, s, hq, d), 1, dtype)
    k = _randn(dev, (b, s, hk, d), 2, dtype)
    v = _randn(dev, (b, s, hk, d), 3, dtype)
    mask = torch.ones((b, s), dtype=torch.int32, device=dev)
    mask[0, :77] = 0
    mask[-1] = 0
    for causal in (True, False):
        out = ta.flash_attention(q, k, v, mask, causal=causal)
        ref = ta.flash_attention_plain(q, k, v, mask, causal=causal)
        torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol)
        assert not out[-1].any()


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4), (torch.bfloat16, 2e-2)])
def test_flash_packed_kernel_matches_plain(dev, dtype, tol):
    lens = [300, 1, 150, 64, 260]
    t = 1024
    seg = torch.full((1, t), len(lens), dtype=torch.int32, device=dev)
    seg[0, :sum(lens)] = torch.repeat_interleave(
        torch.arange(len(lens), device=dev), torch.tensor(lens, device=dev)).int()
    q = _randn(dev, (1, t, 12, 128), 4, dtype)
    k = _randn(dev, (1, t, 2, 128), 5, dtype)
    v = _randn(dev, (1, t, 2, 128), 6, dtype)
    out = ta.flash_attention_packed(q, k, v, seg)
    ref = ta.flash_attention_packed_plain(q, k, v, seg)
    n = sum(lens)
    torch.testing.assert_close(out[:, :n].float(), ref[:, :n].float(), atol=tol, rtol=tol)


def test_kernel_wrappers_check_inputs(dev):
    q = _randn(dev, (1, 64, 4, 96), 7)           # head size without a kernel
    with pytest.raises(ValueError):
        ta.flash_attention(q, q[:, :, :2], q[:, :, :2],
                           torch.ones((1, 64), device=dev))
    with pytest.raises(ValueError):                # k beyond a warp's list
        tt.cosine_topk(_randn(dev, (100, 64), 8), _randn(dev, (1, 64), 9), 33)
    assert np.isfinite(tt.cosine_topk(_randn(dev, (100, 64), 8),
                                      _randn(dev, (1, 64), 9), 4)[0].cpu().numpy()).all()
