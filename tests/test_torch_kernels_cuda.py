"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card. Every test here is marked ``cuda`` and skips where
no NVIDIA GPU is present (a CUDA kernel has no CPU mode). This file imports
neither jax nor the JAX package, so it runs on a machine with the card and
without jax:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

(``--noconftest``: ``tests/conftest.py`` sets up jax for the other tests.)
The kernels build at first use (``gan_deeplearning4j_tpu_torch/ops/_native.py``).
"""

import numpy as np
import pytest
import torch

from gan_deeplearning4j_tpu_torch.ops import linear


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _operands(rng, card, k, m):
    w_q = torch.from_numpy(rng.integers(-127, 128, (k, m)).astype(np.int8)).to(card)
    w_scale = torch.from_numpy((rng.random(m) * 0.01 + 1e-3).astype(np.float32)).to(card)
    b = torch.from_numpy(rng.standard_normal(m).astype(np.float32)).to(card)
    return w_q, w_scale, b


def _rows(rng, n, k, a):
    """Rows uniform over ±1.3·127·a (past the clip) whose first 20 values
    lie on half codes."""
    x = rng.uniform(-1.3, 1.3, (n, k)).astype(np.float32) * np.float32(127 * a)
    x[:, : min(k, 20)] = ((np.arange(min(k, 20)) - 10 + 0.5) * a).astype(np.float32)
    return x


def _launch_once(x, w_q, w_scale, b, a):
    before = linear.KERNEL_LAUNCHES["quant_dense"]
    y = linear.quant_dense(x, w_q, w_scale, b, a)
    assert linear.KERNEL_LAUNCHES["quant_dense"] == before + 1
    return y


@pytest.mark.cuda
@pytest.mark.parametrize("k,m", [(1152, 1024), (1024, 10), (6, 5), (37, 12), (1000, 48), (1001, 20)])
def test_quant_dense_kernel_equals_its_plain_version(card, k, m):
    """Bit-equal at the int8 bundle's shapes and ragged ones, through both
    load routes (TMA where out is a multiple of 16, else one bulk copy),
    with K-chunks that are not multiples of 32 (1000, 1001: the last chunk
    is ragged; 1001 also lands x without bulk copies) and n past one row
    tile (130, 257), on rows holding half codes and values past the clip;
    the launch count rises by one per call."""
    rng = np.random.default_rng(k * 1000 + m)
    a = 0.021
    w_q, w_scale, b = _operands(rng, card, k, m)
    assert linear.quant_dense_plan(1, k, m).route == ("tma" if m % 16 == 0 else "bulk")
    for n in (1, 3, 8, 21, 32, 128, 130, 257):
        x = torch.from_numpy(_rows(rng, n, k, a)).to(card)
        for bias in (b, None):
            y = _launch_once(x, w_q, w_scale, bias, a)
            assert torch.equal(y, linear.quant_dense_plain(x, w_q, w_scale, bias, a)), (n, bias is None)


@pytest.mark.cuda
def test_quant_dense_kernel_sums_exactly_across_the_cluster(card):
    """All-±127 codes and weights at K = 1152: |acc| reaches 127 · 127 · 1152
    = 18,580,608 > 2^24, split over 8 CTAs of a cluster; any lossy step of
    the cross-CTA reduction shows."""
    k, m, a = 1152, 1024, 0.01
    rng = np.random.default_rng(3)
    signs = np.where(rng.random((k, m)) < 0.5, -1, 1)
    signs[:, :4] = 1
    signs[:, 4:8] = -1
    w_q = torch.from_numpy((127 * signs).astype(np.int8)).to(card)
    w_scale = torch.full((m,), 3e-4, device=card)
    b = torch.from_numpy(rng.standard_normal(m).astype(np.float32)).to(card)
    for n in (1, 130):
        x = np.full((n, k), 2.0 * 127 * a, np.float32)  # past the clip: code +127
        x[1::2] *= -1.0
        x = torch.from_numpy(x).to(card)
        y = _launch_once(x, w_q, w_scale, b, a)
        plain = linear.quant_dense_plain(x, w_q, w_scale, b, a)
        assert torch.equal(y, plain)
        acc = torch.matmul(linear.quantize_activations(x, a).double(), w_q.double())
        assert float(acc.abs().max()) == 127 * 127 * k


@pytest.mark.cuda
def test_quant_dense_kernel_takes_x_at_any_alignment(card):
    """x as a contiguous view whose storage is 4 bytes past a 16-byte
    boundary: the kernel loads it without bulk copies, to the same bits."""
    k, m, a = 1152, 1024, 0.021
    rng = np.random.default_rng(5)
    w_q, w_scale, b = _operands(rng, card, k, m)
    for n in (1, 21, 130):
        flat = torch.empty(n * k + 1, device=card)
        x = flat[1:].view(n, k)
        x.copy_(torch.from_numpy(_rows(rng, n, k, a)))
        assert x.is_contiguous() and x.data_ptr() % 16 == 4
        y = _launch_once(x, w_q, w_scale, b, a)
        assert torch.equal(y, linear.quant_dense_plain(x, w_q, w_scale, b, a))


@pytest.mark.cuda
def test_quant_dense_kernel_refuses_views_it_would_misread(card):
    """A non-contiguous W_q view, and a contiguous one off the 16-byte
    alignment the kernel's copies need, raise and launch nothing."""
    rng = np.random.default_rng(6)
    w_q, w_scale, b = _operands(rng, card, 64, 32)
    x = torch.zeros((2, 64), device=card)
    before = linear.KERNEL_LAUNCHES["quant_dense"]
    with pytest.raises(ValueError, match="contiguous"):
        linear.quant_dense(x, w_q.t().contiguous().t(), w_scale, b, 0.1)
    flat = torch.zeros(64 * 32 + 1, dtype=torch.int8, device=card)
    with pytest.raises(ValueError, match="16-byte aligned"):
        linear.quant_dense(x, flat[1:].view(64, 32), w_scale, b, 0.1)
    assert linear.KERNEL_LAUNCHES["quant_dense"] == before


@pytest.mark.cuda
def test_quant_dense_kernel_refuses_other_dtypes(card):
    x = torch.zeros((2, 8), dtype=torch.bfloat16, device=card)
    w_q = torch.zeros((8, 4), dtype=torch.int8, device=card)
    w_scale = torch.ones(4, device=card)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        linear.quant_dense(x, w_q, w_scale, None, 0.1)
