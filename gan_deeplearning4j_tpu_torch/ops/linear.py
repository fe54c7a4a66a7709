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

import ctypes
import dataclasses
import functools
import weakref

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


#: shared memory a block may use on an H100 (227 KB)
_SMEM_LIMIT = 232448
#: widest output strip a cluster owns: four 16-feature tiles of the tensor
#: cores' m16n8k32 product
_MAX_STRIP = 64
#: largest cluster that every sm_90 part schedules (the portable limit)
_MAX_CLUSTER = 8
#: 8-row groups of the largest row tile (a 128-row tile of 1152 → 1024
#: needs 126 KB of shared memory, one CTA an SM, and ran 2.3x slower than
#: two 64-row tiles on the H100), and the CTAs a plan keeps in flight
#: before it grows a row tile past 8 rows (the H100 has 132 SMs)
_MAX_NT, _MIN_CTAS = 8, 128


@dataclasses.dataclass(frozen=True)
class QuantDensePlan:
    """How one ``quant_dense`` launch splits its work (``csrc/quant_dense.cu``).

    A cluster of ``cluster`` CTAs owns one ``strip`` of output columns; CTA
    ``r`` of it takes rows ``[r * k_chunk, min(k, (r + 1) * k_chunk))`` of
    W_q. ``route`` is how the W_q tile lands in shared memory: ``"tma"`` (a
    2D tensor copy of ``boxes`` boxes of ``box_k`` rows, where N is a
    multiple of 16 bytes) or ``"bulk"`` (one bulk copy of the chunk's
    full-width rows). A row tile is ``8 * nt`` rows of x; ``row_tiles`` of
    them cover n."""

    route: str
    strip: int
    strips: int
    cluster: int
    k_chunk: int
    box_k: int
    boxes: int
    nt: int
    row_tiles: int
    smem_bytes: int

    @property
    def ctas(self) -> int:
        return self.strips * self.cluster * self.row_tiles


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def _smem_bytes(route: str, strip: int, m: int, k_chunk: int, box_k: int, boxes: int, nt: int,
                cluster: int) -> int:
    """Shared memory of one CTA, laid out as ``csrc/quant_dense.cu::layout``
    lays it out (the kernel refuses a launch whose plan disagrees): the
    landed W_q tile, its k-contiguous transpose, x's codes, the tile's int32
    partial sums (rows padded by 4), each cluster rank's partial sums of
    this CTA's slice of the outputs, the strip's scales and biases, and the
    mbarrier. The code tiles' rows are padded to 12 words mod 32 so that a
    warp's fragment loads hit 32 different banks."""
    rt = 8 * nt
    w = boxes * box_k * strip if route == "tma" else k_chunk * m + strip
    ld = k_chunk // 4 + ((12 - k_chunk // 4) & 31)
    slice_ = _round_up(-(-rt * strip // cluster), 4)
    parts = (w, strip * ld * 4, rt * ld * 4, rt * (strip + 4) * 4, slice_ * cluster * 4, 2 * strip * 4)
    return sum(_round_up(b, 128) for b in parts) + 16


def quant_dense_plan(n: int, k: int, m: int) -> QuantDensePlan:
    """The launch plan of the ``quant_dense`` kernel for x (n, k) and W_q
    (k, m). Raises ``ValueError`` for a shape the kernel does not take."""
    if n < 1 or k < 1 or m < 1:
        raise ValueError(f"quant_dense plan: n={n}, in={k}, out={m} must be positive")
    route = "tma" if m % 16 == 0 else "bulk"
    if route == "bulk" and m > _MAX_STRIP:
        raise ValueError(
            f"quant_dense kernel: out={m} is neither a multiple of 16 (the TMA route) nor at most "
            f"{_MAX_STRIP} (one strip of full-width rows): ROADMAP.md queue 1, 'Quantization'")
    # 16, 32 or 64 features: a warp's 16-feature tile stays the same across
    # its row tiles; TMA strips lie inside N, a bulk strip holds all of it
    if route == "tma":
        strip = max(s for s in (16, 32, _MAX_STRIP) if s <= m)
    else:
        strip = min(s for s in (16, 32, _MAX_STRIP) if s >= m)
    cluster = min(_MAX_CLUSTER, -(-k // 32))
    k_chunk = _round_up(-(-k // cluster), 32)
    cluster = -(-k // k_chunk)  # no empty chunk
    box_k = min(k_chunk, 256) if route == "tma" else 0
    boxes = -(-k_chunk // box_k) if route == "tma" else 0
    strips = -(-m // strip)
    # the smallest row tile of 8, 16, 32 or 64 rows that holds n, halved
    # while that leaves fewer than _MIN_CTAS CTAs in flight or needs more
    # shared memory than a block has
    nt = 1
    while 8 * nt < min(n, 8 * _MAX_NT):
        nt *= 2
    while nt > 1 and (strips * cluster * -(-n // (8 * nt)) < _MIN_CTAS or _smem_bytes(
            route, strip, m, k_chunk, box_k, boxes, nt, cluster) > _SMEM_LIMIT):
        nt //= 2
    smem = _smem_bytes(route, strip, m, k_chunk, box_k, boxes, nt, cluster)
    row_tiles = -(-n // (8 * nt))
    if smem > _SMEM_LIMIT or row_tiles > 65535:
        raise ValueError(f"quant_dense kernel: n={n}, in={k}, out={m} needs {smem} bytes of shared "
                         f"memory or {row_tiles} row tiles: ROADMAP.md queue 1, 'Quantization'")
    return QuantDensePlan(route=route, strip=strip, strips=strips, cluster=cluster,
                          k_chunk=k_chunk, box_k=box_k, boxes=boxes, nt=nt, row_tiles=row_tiles,
                          smem_bytes=smem)


_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _current_stream(device: torch.device) -> int:
    if _raw_stream is not None:
        return _raw_stream(device.index)
    return torch.cuda.current_stream(device).cuda_stream


class _PreparedQuantDense:
    """One layer's operands checked once for the kernel, with what every
    launch reuses: the launch plan per n, the TMA tensor map and the C
    entry point (held by the native layer handle). Per call only x is
    checked: its dtype and shape by ``_quant_dense_cuda``, its device and
    contiguity here."""

    def __init__(self, w_q, w_scale, b, act_scale: float):
        if w_q.dim() != 2:
            raise ValueError(f"quant_dense: W_q must be 2-D, got {tuple(w_q.shape)}")
        k, m = w_q.shape
        if w_q.dtype != torch.int8 or w_scale.dtype != torch.float32 or tuple(w_scale.shape) != (m,):
            raise ValueError(f"quant_dense: W_q must be int8 and w_scale float32 ({m},), got "
                             f"{w_q.dtype} and {w_scale.dtype} {tuple(w_scale.shape)}")
        if b is not None and (b.dtype != torch.float32 or tuple(b.shape) != (m,)):
            raise ValueError(f"quant_dense: b must be float32 ({m},), got {b.dtype} {tuple(b.shape)}")
        tensors = (w_q, w_scale) + (() if b is None else (b,))
        if any(t.device != w_q.device for t in tensors):
            raise ValueError("quant_dense: every operand must be on x's device")
        if not all(t.is_contiguous() for t in tensors):
            raise ValueError("quant_dense: the kernel takes contiguous operands")
        if w_q.data_ptr() % 16:
            raise ValueError("quant_dense: the kernel's copies need W_q's storage 16-byte aligned")
        if not w_q.is_cuda:
            raise ValueError("quant_dense: every operand must be on x's device")
        self.k, self.m = k, m
        self.device = w_q.device
        self.w_ptr = w_q.data_ptr()
        self.w_ref = weakref.ref(w_q)
        self.w_scale, self.b, self.act_scale = w_scale, b, act_scale
        plan = quant_dense_plan(1, k, m)
        self._plans = {}  # n -> (nt, row_tiles, smem bytes)

        from gan_deeplearning4j_tpu_torch.ops import _native

        native = _native.quant_dense()
        err = ctypes.c_int(0)
        with torch.cuda.device(self.device):
            # ctypes rounds 1.0 / act_scale (taken in Python double) and
            # act_scale to float32, as the reference's weak typing does
            handle = native.layer_new(
                self.w_ptr, w_scale.data_ptr(), 0 if b is None else b.data_ptr(), k, m,
                1.0 / act_scale, act_scale, 0 if plan.route == "tma" else 1, plan.strip,
                plan.cluster, plan.k_chunk, plan.box_k, plan.boxes, ctypes.byref(err))
        if not handle:
            raise RuntimeError(f"quant_dense: the layer's launch state was refused: CUDA error "
                               f"{err.value} (in={k}, out={m}, plan {plan})")
        self._handle = handle
        self._run = native.run
        weakref.finalize(self, native.layer_free, handle)

    def matches(self, w_q, w_scale, b, act_scale: float) -> bool:
        return (self.w_ref() is w_q and self.w_scale is w_scale and self.b is b
                and self.act_scale == act_scale and self.w_ptr == w_q.data_ptr())

    def __call__(self, x):
        if torch.cuda.current_device() != self.device.index:
            with torch.cuda.device(self.device):
                return self(x)
        if x.device != self.device:
            raise ValueError("quant_dense: every operand must be on x's device")
        if not x.is_contiguous():
            raise ValueError("quant_dense: the kernel takes contiguous operands")
        n = x.shape[0]
        y = x.new_empty((n, self.m))  # float32 on x's device, both checked
        if n == 0:
            return y
        launch = self._plans.get(n)
        if launch is None:
            plan = quant_dense_plan(n, self.k, self.m)
            launch = self._plans[n] = (plan.nt, plan.row_tiles, plan.smem_bytes)
        err = self._run(self._handle, x.data_ptr(), y.data_ptr(), n, *launch, _current_stream(self.device))
        if err != 0:
            raise RuntimeError(f"quant_dense kernel launch failed: CUDA error {err} "
                               f"(n={n}, in={self.k}, out={self.m})")
        KERNEL_LAUNCHES["quant_dense"] += 1
        return y


#: W_q's id -> its _PreparedQuantDense (the entry goes when W_q does)
_PREPARED: dict = {}


def _prepare(w_q, w_scale, b, act_scale: float) -> _PreparedQuantDense:
    """The prepared kernel state of one layer's operands, made at the first
    call on them (an engine's warmup) and reused while the same tensors are
    passed. Two threads that miss at once each build one, equal; the last
    stays."""
    prepared = _PREPARED.get(id(w_q))
    if prepared is None or not prepared.matches(w_q, w_scale, b, act_scale):
        prepared = _PreparedQuantDense(w_q, w_scale, b, act_scale)
        _PREPARED[id(w_q)] = prepared
        weakref.finalize(w_q, _PREPARED.pop, id(w_q), None)
    return prepared


def _quant_dense_cuda(x, w_q, w_scale, b, act_scale: float):
    if x.dtype != torch.float32:
        raise NotImplementedError(
            f"the quant_dense kernel takes float32 activations, got {x.dtype}: other dtypes "
            f"wait for ROADMAP.md queue 1, 'Quantization'")
    if x.dim() != 2 or w_q.dim() != 2 or x.shape[1] != w_q.shape[0]:
        raise ValueError(f"quant_dense: x {tuple(x.shape)} and W_q {tuple(w_q.shape)} do not chain")
    return _prepare(w_q, w_scale, b, act_scale)(x)
