"""Convolution, transposed convolution, max and average pooling and nearest
upsampling over NHWC tensors — counterpart of
``gan_deeplearning4j_tpu/ops/conv.py``.

The public functions keep the JAX package's layouts: NHWC activations and
HWIO kernels. Inside, ``x.permute(0, 3, 1, 2)`` is an NCHW view over
channels-last memory, which cuDNN takes without a copy, and
``w.permute(3, 2, 0, 1)`` is the OIHW kernel. Output sizes follow DL4J's
``ConvolutionMode.Truncate``: ``floor((in + 2p - k) / s) + 1``; a
transposed convolution inverts it: ``(in - 1)·s - 2p + k``.

Precision, as in the reference: both convolutions cast their operands to
the compute dtype (``runtime/dtype.py``), produce the output in that dtype
(under bf16, a bf16-rounded result of fp32 accumulation), upcast it to the
input's dtype and only then add the bias. On the card the bf16 operands go
to cuDNN's bf16 kernels. On the CPU the bf16-rounded operands are
convolved in fp32 and the output is rounded to bf16: XLA:CPU computes a
bf16 convolution that way, and torch's own CPU bf16 convolution differs
from it by about 1e-3 relative at 128 channels. Through autograd both
routes round the output's cotangent to bf16 and the operands' gradients
back to bf16 (then up to the params' dtype), as the reference's
transposes do.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from gan_deeplearning4j_tpu_torch.runtime.dtype import get_compute_dtype

IntPair = Union[int, Tuple[int, int], Sequence[int]]


def _pair(v: IntPair) -> Tuple[int, int]:
    if isinstance(v, int):
        return (v, v)
    a, b = v
    return (int(a), int(b))


def conv_out_size(in_size: int, kernel: int, stride: int, padding: int) -> int:
    """DL4J Truncate-mode output size: floor((in + 2p - k)/s) + 1."""
    return (in_size + 2 * padding - kernel) // stride + 1


def _in_compute_dtype(conv, x, w):
    """``conv(x, w)`` with both operands cast to the compute dtype and the
    output in that dtype, upcast to ``x``'s dtype (see the module
    docstring for the CPU route)."""
    cdt = get_compute_dtype()
    xc, wc = x.to(cdt), w.to(cdt)
    if cdt != torch.float32 and x.device.type == "cpu":
        y = conv(xc.float(), wc.float()).to(cdt)
    else:
        y = conv(xc, wc)
    return y.to(x.dtype)


def conv2d(x, w, b=None, *, stride: IntPair = 1, padding: IntPair = 0):
    """2-D cross-correlation, NHWC input, HWIO kernel, explicit symmetric
    padding; the bias is added after the convolution, as in the reference."""
    y = _in_compute_dtype(
        lambda xc, wc: F.conv2d(
            xc.permute(0, 3, 1, 2),
            wc.permute(3, 2, 0, 1),
            stride=_pair(stride),
            padding=_pair(padding),
        ).permute(0, 2, 3, 1),
        x, w,
    )
    if b is not None:
        y = y + b  # (out,) broadcasts over NHW
    return y


def conv2d_transpose(x, w, b=None, *, stride: IntPair = 1, padding: IntPair = 0):
    """Transposed convolution (DL4J Deconvolution2D), NHWC input, HWIO kernel
    ``(kh, kw, in, out)``: the JAX package's ``lax.conv_transpose`` without
    ``transpose_kernel``, at padding ``k - 1 - p``. That op correlates the
    stride-dilated input with the kernel as stored, while
    ``F.conv_transpose2d`` is the gradient of a correlation and so applies
    the kernel flipped in space: the kernel goes in flipped back, as
    ``(in, out, kh, kw)``."""
    y = _in_compute_dtype(
        lambda xc, wc: F.conv_transpose2d(
            xc.permute(0, 3, 1, 2),
            wc.flip(0, 1).permute(2, 3, 0, 1),
            stride=_pair(stride),
            padding=_pair(padding),
        ).permute(0, 2, 3, 1),
        x, w,
    )
    if b is not None:
        y = y + b
    return y


def max_pool2d(x, *, kernel: IntPair, stride: IntPair, padding: IntPair = 0):
    """Max pooling over NHWC; padded cells are -inf, so they never win."""
    ph, pw = _pair(padding)
    y = x.permute(0, 3, 1, 2)
    if ph or pw:
        y = F.pad(y, (pw, pw, ph, ph), value=float("-inf"))
    y = F.max_pool2d(y, kernel_size=_pair(kernel), stride=_pair(stride))
    return y.permute(0, 2, 3, 1)


def avg_pool2d(x, *, kernel: IntPair, stride: IntPair, padding: IntPair = 0):
    """Average pooling over NHWC; padded cells are left out of the divisor,
    as the JAX package divides by the count of real cells in each window
    (``count_include_pad=False``, where torch's default counts them)."""
    y = F.avg_pool2d(
        x.permute(0, 3, 1, 2),
        kernel_size=_pair(kernel),
        stride=_pair(stride),
        padding=_pair(padding),
        count_include_pad=False,
    )
    return y.permute(0, 2, 3, 1)


def upsample2d(x, *, scale: IntPair = 2):
    """Nearest-neighbour upsampling of NHWC rows: each pixel repeated
    ``scale`` times along H and W."""
    sh, sw = _pair(scale)
    n, h, w, c = x.shape
    y = x[:, :, None, :, None, :].expand(n, h, sh, w, sw, c)
    return y.reshape(n, h * sh, w * sw, c)
