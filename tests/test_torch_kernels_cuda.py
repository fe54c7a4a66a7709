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


@pytest.mark.cuda
@pytest.mark.parametrize("k,m", [(1152, 1024), (1024, 10), (6, 5), (37, 12)])
def test_quant_dense_kernel_equals_its_plain_version(card, k, m):
    """Bit-equal at the int8 bundle's shapes (and two ragged ones), on
    rows holding half codes and values past the clip; the launch count
    rises by one per call."""
    rng = np.random.default_rng(k * 1000 + m)
    a = 0.021
    w_q = torch.from_numpy(rng.integers(-127, 128, (k, m)).astype(np.int8)).to(card)
    w_scale = torch.from_numpy((rng.random(m) * 0.01 + 1e-3).astype(np.float32)).to(card)
    b = torch.from_numpy(rng.standard_normal(m).astype(np.float32)).to(card)
    for n in (1, 3, 8, 21, 32, 128, 130):
        x = rng.uniform(-1.3, 1.3, (n, k)).astype(np.float32) * np.float32(127 * a)
        x[:, : min(k, 20)] = ((np.arange(min(k, 20)) - 10 + 0.5) * a).astype(np.float32)
        x = torch.from_numpy(x).to(card)
        for bias in (b, None):
            before = linear.KERNEL_LAUNCHES["quant_dense"]
            y = linear.quant_dense(x, w_q, w_scale, bias, a)
            assert linear.KERNEL_LAUNCHES["quant_dense"] == before + 1
            assert torch.equal(y, linear.quant_dense_plain(x, w_q, w_scale, bias, a)), (n, bias is None)


@pytest.mark.cuda
def test_quant_dense_kernel_refuses_other_dtypes(card):
    x = torch.zeros((2, 8), dtype=torch.bfloat16, device=card)
    w_q = torch.zeros((8, 4), dtype=torch.int8, device=card)
    w_scale = torch.ones(4, device=card)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        linear.quant_dense(x, w_q, w_scale, None, 0.1)
