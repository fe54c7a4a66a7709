"""Dense (fully-connected) op — counterpart of
``gan_deeplearning4j_tpu/ops/linear.py::dense``.

The GEMM goes to cuBLAS through ``torch.matmul``, as the JAX package
leaves it to XLA. Kernels are ``(in, out)``, the JAX layout, so a
checkpoint's arrays are used as they are. The bias is added after the
product, as in the reference. The int8 ``quant_dense`` waits for the
quantization slice (ROADMAP.md queue 1, "Quantization").
"""

from __future__ import annotations

import torch


def dense(x, w, b=None):
    """y = x @ w + b.

    Args:
      x: (batch, in) activations.
      w: (in, out) kernel.
      b: optional (out,) bias.
    """
    y = torch.matmul(x, w)
    if b is not None:
        y = y + b
    return y
