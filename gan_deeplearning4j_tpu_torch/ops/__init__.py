"""Functional ops of the PyTorch port: plain functions on tensors.

Each module mirrors its counterpart in ``gan_deeplearning4j_tpu/ops`` and
keeps its layouts (NHWC activations, HWIO conv kernels, ``(in, out)``
dense kernels), so checkpoints are shared bit for bit. The JAX package has
no Pallas kernel: every op there is lowered by XLA, and here every op goes
to PyTorch's own kernels (cuDNN, cuBLAS) the same way, but one: the int8
``linear.quant_dense``, which stock torch cannot fuse, launches the port's
hand-written CUDA kernel (``csrc/quant_dense.cu``, built by ``_native``).
"""

from gan_deeplearning4j_tpu_torch.ops import activations, clipping, conv, initializers, linear, losses, norm

__all__ = ["activations", "clipping", "conv", "initializers", "linear", "losses", "norm"]
