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

``quant_dense`` is the int8 dense of a quantized serving bundle
(counterpart of ``gan_deeplearning4j_tpu/ops/linear.py::quant_dense``):
``quant_dense_plain`` computes it in torch ops, and on the card one
hand-written CUDA kernel (``csrc/quant_dense.cu``) fuses the quantize, the
exact int32 product, the dequantize and the bias.
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


#: launches of the port's hand-written kernels, counted where each wrapper
#: launches its kernel and nowhere else (``chip_smoke.py`` zeroes and reads
#: them around the main path)
KERNEL_LAUNCHES = {"quant_dense": 0}


def quantize_activations(x, act_scale: float):
    """The int8 codes the reference's ``quant_dense`` feeds its product:
    ``int8(clip(round(x * (1.0 / act_scale)), -127, 127))``, rounding half
    to even. (``x / act_scale`` would move some codes by one.)"""
    # the reciprocal in Python double, rounded to x's dtype as jnp's weak
    # typing rounds it, then one multiply in that dtype
    inv = torch.full((), 1.0 / act_scale, dtype=x.dtype, device=x.device)
    return torch.clamp(torch.round(x * inv), -127.0, 127.0).to(torch.int8)


def quant_dense_plain(x, w_q, w_scale, b, act_scale: float):
    """The reference's int8 dense in torch ops, on any device and dtype:
    ``x_q = int8(clip(round(x * (1.0 / act_scale)), ±127))`` (round half to
    even), an exact integer product (int32 on the CPU; float64 on the card,
    exact below 2^53, since CUDA has no integer matmul), one dequantize by
    ``w_scale * act_scale`` in float32, a cast to x's dtype, then ``+ b``.

    Args:
      x: (batch, in) float activations.
      w_q: (in, out) int8 kernel.
      w_scale: (out,) per-output-channel weight scales.
      b: optional (out,) bias, added after the dequantize.
      act_scale: the layer's static activation scale (a Python float).
    """
    x_q = quantize_activations(x, act_scale)
    if x.is_cuda:
        acc = torch.matmul(x_q.double(), w_q.double())
    else:
        acc = torch.matmul(x_q.to(torch.int32), w_q.to(torch.int32))
    scale = w_scale.to(torch.float32) * torch.full((), act_scale, dtype=torch.float32, device=x.device)
    y = acc.to(torch.float32) * scale
    y = y.to(x.dtype)
    if b is not None:
        y = y + b
    return y


def quant_dense(x, w_q, w_scale, b, act_scale: float):
    """Dequant-at-matmul int8 dense: float rows in, float rows out.

    On a CPU tensor, :func:`quant_dense_plain`. On a CUDA tensor, one
    launch of the hand-written kernel (``csrc/quant_dense.cu``), equal to
    the plain version bit for bit; it takes float32 x (what int8 bundles
    serve) and raises on anything it does not take, with no fallback.
    Arguments as for :func:`quant_dense_plain`."""
    if not x.is_cuda:
        return quant_dense_plain(x, w_q, w_scale, b, act_scale)
    return _quant_dense_cuda(x, w_q, w_scale, b, act_scale)


def _quant_dense_cuda(x, w_q, w_scale, b, act_scale: float):
    from gan_deeplearning4j_tpu_torch.ops import _native

    if x.dtype != torch.float32:
        raise NotImplementedError(
            f"the quant_dense kernel takes float32 activations, got {x.dtype}: other dtypes "
            f"wait for ROADMAP.md queue 1, 'Quantization'")
    if x.dim() != 2 or w_q.dim() != 2 or x.shape[1] != w_q.shape[0]:
        raise ValueError(f"quant_dense: x {tuple(x.shape)} and W_q {tuple(w_q.shape)} do not chain")
    n, k = x.shape
    m = w_q.shape[1]
    if w_q.dtype != torch.int8 or w_scale.dtype != torch.float32 or tuple(w_scale.shape) != (m,):
        raise ValueError(f"quant_dense: W_q must be int8 and w_scale float32 ({m},), got "
                         f"{w_q.dtype} and {w_scale.dtype} {tuple(w_scale.shape)}")
    if b is not None and (b.dtype != torch.float32 or tuple(b.shape) != (m,)):
        raise ValueError(f"quant_dense: b must be float32 ({m},), got {b.dtype} {tuple(b.shape)}")
    tensors = (x, w_q, w_scale) + (() if b is None else (b,))
    if any(t.device != x.device for t in tensors):
        raise ValueError("quant_dense: every operand must be on x's device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("quant_dense: the kernel takes contiguous operands")
    y = torch.empty((n, m), dtype=torch.float32, device=x.device)
    if n == 0:
        return y
    vec = int(m % 4 == 0 and w_q.data_ptr() % 4 == 0)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with torch.cuda.device(x.device):
        # ctypes rounds 1.0 / act_scale (taken in Python double) and
        # act_scale to float32, as the reference's weak typing does
        err = _native.quant_dense()(
            x.data_ptr(), w_q.data_ptr(), w_scale.data_ptr(), 0 if b is None else b.data_ptr(),
            y.data_ptr(), n, k, m, 1.0 / act_scale, act_scale, vec, stream)
    if err != 0:
        raise RuntimeError(f"quant_dense kernel launch failed: CUDA error {err} "
                           f"(n={n}, in={k}, out={m})")
    KERNEL_LAUNCHES["quant_dense"] += 1
    return y
