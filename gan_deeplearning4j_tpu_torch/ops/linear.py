"""Dense (fully-connected) op — counterpart of
``gan_deeplearning4j_tpu/ops/linear.py::dense``.

Kernels are ``(in, out)``, the JAX layout, so a checkpoint's arrays are
used as they are. As in the reference, x and W are cast to the compute
dtype (``runtime/dtype.py``), the product is kept in float32, cast to x's
dtype, and the bias is added after it.

Routes of the product (all library GEMMs; the JAX package computes
``dense`` outside any Pallas kernel too):

- fp32 compute: ``torch.matmul`` (cuBLAS on the card, TF32 off);
- bf16 compute on the card: a bf16 tensor-core GEMM with an fp32 output,
  ``torch.mm(..., out_dtype=torch.float32)`` (``aten::mm.dtype``), where
  the installed torch has it. It has no autograd formula, so
  :class:`_MatmulF32Out` supplies the reference's transposes: each operand's
  gradient is the fp32 product of the fp32 cotangent and the other bf16
  operand, rounded to bf16 (then upcast to the param's dtype by the cast's
  own backward);
- bf16 compute otherwise (the CPU, or a torch without ``mm.dtype``): an
  fp32 matmul of the bf16-rounded operands, the same function, whose
  autograd gives the same gradients.

Never a bf16-output matmul: that would round the product to bf16, which
the reference does not (``preferred_element_type=float32``).

The int8 ``quant_dense`` waits for the quantization slice (ROADMAP.md
queue 1, "Quantization").
"""

from __future__ import annotations

import functools

import torch

from gan_deeplearning4j_tpu_torch.runtime.dtype import get_compute_dtype


@functools.lru_cache(maxsize=None)
def _mm_out_dtype_on_cuda(device: torch.device) -> bool:
    """Whether this process's torch runs ``aten::mm.dtype`` on ``device``
    (asked once per device, by one tiny product)."""
    try:
        one = torch.ones((1, 1), dtype=torch.bfloat16, device=device)
        torch.mm(one, one, out_dtype=torch.float32)
        return True
    except (TypeError, RuntimeError, NotImplementedError):
        return False


class _MatmulF32Out(torch.autograd.Function):
    """``x @ w`` of two bf16 (compute-dtype) matrices with an fp32 output,
    on the card. Its backward is written in differentiable ops, so the
    gradient penalty's double backward runs through it."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return torch.mm(x, w, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = torch.mm(g, w.float().t()).to(x.dtype)
        if ctx.needs_input_grad[1]:
            gw = torch.mm(x.float().t(), g).to(w.dtype)
        return gx, gw


def dense_route(device) -> str:
    """The route a bf16 product on ``device`` takes: ``"mm_out_fp32"`` (the
    bf16 tensor-core GEMM with an fp32 output) or ``"fp32_of_rounded"`` (an
    fp32 matmul of the bf16-rounded operands)."""
    device = torch.device(device)
    if device.type == "cuda" and _mm_out_dtype_on_cuda(device):
        return "mm_out_fp32"
    return "fp32_of_rounded"


def dense(x, w, b=None):
    """y = x @ w + b, the product in the compute dtype with an fp32 result.

    Args:
      x: (batch, in) activations.
      w: (in, out) kernel.
      b: optional (out,) bias.
    """
    cdt = get_compute_dtype()
    xc, wc = x.to(cdt), w.to(cdt)
    if cdt == torch.float32:
        y = torch.matmul(xc, wc)
    elif xc.is_cuda and xc.dim() == 2 and _mm_out_dtype_on_cuda(xc.device):
        y = _MatmulF32Out.apply(xc, wc)
    else:
        y = torch.matmul(xc.float(), wc.float())
    y = y.to(x.dtype)
    if b is not None:
        y = y + b
    return y
