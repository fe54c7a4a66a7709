"""PyTorch port, the int8 quantization slice: ``ops/linear.py::quant_dense``
(the plain version and the kernel's wrapper), ``QuantDenseLayer``, int8
leaves across the serializer, ``quant/variants.py``'s int8 half, the engine
serving int8 bundles, ``quant/cost.py``, and the slice as a whole, against
the JAX package on the CPU.

Tolerances:
- ``quant_dense``: the int8 codes equal the reference's exactly, and y lies
  within 1e-6 relative (both packages take an exact integer sum and round
  the same fp32 products; in practice y is bit-equal); over the op's wider
  domain (16-bit x, an N-D x, outs of 100 and 1000, in = 18432) the port
  equals the reference bit for bit, in dtype and shape too;
- ``quantize_dense_params``: bit-equal;
- calibration scales: 1e-6 relative (the amax of float32 activations whose
  summation order differs between the packages);
- int8 bundles served across the packages: the float layers before a
  quantized one differ in the last ulp between the two packages, which
  moves an activation code by one wherever ``x / act_scale`` lies that
  close to a half point. One moved code changes a quantized layer's output
  by ``|W_q[k, j]| · w_scale[j] · act_scale`` ≤ ``127 · w_scale[j] ·
  act_scale``; outputs are held to two such steps of the widest column
  (``_code_flip_atol``) plus 1e-5 of the largest output.

Run with ``JAX_PLATFORMS=cpu``. The kernel itself is tested on the card by
``tests/test_torch_kernels_cuda.py``.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gan_deeplearning4j_tpu.deploy.canary import CanaryGate as JaxGate
from gan_deeplearning4j_tpu.models import dcgan_mnist as jax_models
from gan_deeplearning4j_tpu.nn import DenseLayer as JaxDense
from gan_deeplearning4j_tpu.nn import GraphBuilder as JaxBuilder
from gan_deeplearning4j_tpu.nn import GraphConfig as JaxConfig
from gan_deeplearning4j_tpu.nn import InputType as JaxInputType
from gan_deeplearning4j_tpu.nn import OutputLayer as JaxOutput
from gan_deeplearning4j_tpu.ops import linear as jax_linear
from gan_deeplearning4j_tpu.quant import QuantDenseLayer as JaxQuantDense
from gan_deeplearning4j_tpu.quant import build_int8_variant as jax_build_int8
from gan_deeplearning4j_tpu.quant import calibrate_activation_scales as jax_calibrate
from gan_deeplearning4j_tpu.quant import default_calibration_rows as jax_default_rows
from gan_deeplearning4j_tpu.quant import measure_engine_cost as jax_measure
from gan_deeplearning4j_tpu.quant import quantize_dense_params as jax_quantize_params
from gan_deeplearning4j_tpu.serving import ServingEngine as JaxEngine
from gan_deeplearning4j_tpu.utils import serializer as jax_ser
from gan_deeplearning4j_tpu_torch.data import synthetic_mnist
from gan_deeplearning4j_tpu_torch.deploy import CanaryGate
from gan_deeplearning4j_tpu_torch.interop import params_from_numpy
from gan_deeplearning4j_tpu_torch.models import dcgan_mnist as pt_models
from gan_deeplearning4j_tpu_torch.nn import layers as pt_layers
from gan_deeplearning4j_tpu_torch.nn.graph import ComputationGraph as PtGraph
from gan_deeplearning4j_tpu_torch.ops import _native
from gan_deeplearning4j_tpu_torch.ops import linear as pt_linear
from gan_deeplearning4j_tpu_torch.quant import (
    QuantDenseLayer,
    build_int8_variant,
    calibrate_activation_scales,
    default_calibration_rows,
    manifest_cost,
    measure_bundle_cost,
    measure_engine_cost,
    quantize_dense_params,
    write_cost_block,
)
from gan_deeplearning4j_tpu_torch.serving import ServingEngine
from gan_deeplearning4j_tpu_torch.telemetry.registry import MetricsRegistry, set_registry
from gan_deeplearning4j_tpu_torch.utils import serializer as pt_ser

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
Y_REL = 1e-6
SCALE_REL = 1e-6
Z, FEAT, CLASSES, HIDDEN = 4, 6, 3, 5
#: resident param bytes of the full-width DCGAN-MNIST bundles
#: (BENCH_quant_r01.json): fp32, and its int8 variant
FP32_BYTES, INT8_BYTES = 32_260_188, 28_694_660


@pytest.fixture(autouse=True)
def _port_registry():
    previous = set_registry(MetricsRegistry())
    try:
        yield
    finally:
        set_registry(previous)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# -- quant_dense ------------------------------------------------------------------

def _jax_codes(x: np.ndarray, act_scale: float) -> np.ndarray:
    """The int8 codes inside the reference's ``quant_dense``, read through
    an identity weight: y = float(x_q) * float32(act_scale), from which the
    integer |x_q| <= 127 is recovered exactly."""
    k = x.shape[1]
    y = np.asarray(jax_linear.quant_dense(jnp.asarray(x), jnp.eye(k, dtype=jnp.int8),
                                          jnp.ones((k,), jnp.float32), None, act_scale))
    return np.rint(y / np.float32(act_scale)).astype(np.int8)


def _half_points(a):
    """x exactly on every half code (a is a power of two, so x * (1/a) is
    exact), and past the clip."""
    return ((np.arange(-135, 135) + 0.5) * a).astype(np.float32)


def _reciprocal_trap(a):
    """x within a few ulps of the half codes where the reference's
    ``x * float32(1 / a)`` and ``x / a`` round to different codes."""
    base = ((np.arange(-127, 127) + 0.5) * a).astype(np.float32)
    cands = [base]
    for _ in range(3):
        cands.append(np.nextafter(cands[-1], np.float32(np.inf)))
        cands.insert(0, np.nextafter(cands[0], np.float32(-np.inf)))
    x = np.concatenate(cands)
    inv, af = np.float32(1.0 / a), np.float32(a)
    return x[np.round(x * inv) != np.round(x / af)]


def _case(name):
    """(x (n, K), W_q (K, N), w_scale, b, act_scale) of one named case."""
    rng = np.random.default_rng(CASES.index(name))
    if name == "random":
        a, x = 0.0231, rng.standard_normal((9, 37)).astype(np.float32)
    elif name == "half_points":
        a = 0.0625
        x = _half_points(a).reshape(10, 27)
    elif name == "past_the_clip":
        a = 0.02
        big = np.float32(127 * a) * np.array([1.0, 1.004, 1.5, 2.0, 1e3, 1e30], np.float32)
        x = np.concatenate([big, -big, rng.standard_normal(12).astype(np.float32)]).reshape(4, 6)
    elif name == "reciprocal_trap":
        a = 0.013
        x = _reciprocal_trap(a)
        x = x[: (len(x) // 8) * 8].reshape(8, -1)
    else:  # all codes ±127 at K = 1152: |acc| reaches 127 * 127 * 1152 > 2^24
        a = 0.017
        signs = np.where(rng.random((5, 1152)) < 0.985, 1.0, -1.0).astype(np.float32)
        x = signs * np.float32(127 * a * 1.3)
        x[:, 0] = np.float32(126 * a)  # an odd total, which no float32 holds exactly
    k = x.shape[1]
    n_out = 10
    w_q = rng.integers(-127, 128, (k, n_out)).astype(np.int8)
    if name == "acc_past_2_24":
        w_q[:] = 127
        w_q[:, 1::2] = np.where(rng.random((k, 5)) < 0.5, 127, -127)
    w_scale = (rng.random(n_out).astype(np.float32) + 0.1) * np.float32(0.01)
    b = rng.standard_normal(n_out).astype(np.float32)
    return x, w_q, w_scale, b, a


CASES = ["random", "half_points", "past_the_clip", "reciprocal_trap", "acc_past_2_24"]
#: the reference op's wider domain: x's shape and out, in x's dtype, with no
#: bias, a float32 bias (what bundles hold) or a bias of x's dtype
DOMAIN_SHAPES = {"8x1152-100": ((8, 1152), 100), "5x1024-1000": ((5, 1024), 1000),
                 "2x3x64-10": ((2, 3, 64), 10), "3x18432-1024": ((3, 18432), 1024)}
DOMAIN_DTYPES = ("float32", "bfloat16", "float16")
DOMAIN_CASES = {f"{dt}-{shape}-{bias}": (dt, shape, bias) for dt in DOMAIN_DTYPES for shape in DOMAIN_SHAPES
                for bias in (("none", "float32") if dt == "float32" else ("none", "float32", "x"))}


def _domain_case(name):
    """(x, w_q, w_scale, b, act_scale, x's dtype name) of one wider-domain
    case: x drawn in float32 over ±1.3·127·a (past the clip) with half codes
    in its first values, then rounded to x's dtype by each package."""
    dt, shape, bias = DOMAIN_CASES[name]
    x_shape, m = DOMAIN_SHAPES[shape]
    rng = np.random.default_rng(list(DOMAIN_CASES).index(name))
    a = 0.0213
    x = rng.uniform(-1.3, 1.3, x_shape).astype(np.float32) * np.float32(127 * a)
    x.reshape(-1, x_shape[-1])[:, :20] = ((np.arange(20) - 10 + 0.5) * a).astype(np.float32)
    w_q = rng.integers(-127, 128, (x_shape[-1], m)).astype(np.int8)
    w_scale = (rng.random(m).astype(np.float32) + 0.1) * np.float32(0.01)
    b = None if bias == "none" else (rng.standard_normal(m).astype(np.float32), dt if bias == "x" else "float32")
    return x, w_q, w_scale, b, a, dt


def _both(a, dtype: str):
    """A float32 numpy array as (jax array, torch tensor) of ``dtype``."""
    return jnp.asarray(a).astype(jnp.dtype(dtype)), _t(a).to(getattr(torch, dtype))


@pytest.mark.parametrize("name", CASES + list(DOMAIN_CASES))
def test_quant_dense_matches_jax(name):
    if name in DOMAIN_CASES:
        x, w_q, w_scale, b, a, dt = _domain_case(name)
        jx, px = _both(x, dt)
        jb, pb = (None, None) if b is None else _both(*b)
        ref = jax_linear.quant_dense(jx, jnp.asarray(w_q), jnp.asarray(w_scale), jb, a)
        port = pt_linear.quant_dense(px, _t(w_q), _t(w_scale), pb, a)
        plain = pt_linear.quant_dense_plain(px, _t(w_q), _t(w_scale), pb, a)
        assert torch.equal(port, plain)
        want = dt if b is None or b[1] == dt else "float32"
        assert str(ref.dtype) == want and port.dtype == getattr(torch, want)
        assert tuple(port.shape) == tuple(ref.shape) == x.shape[:-1] + (w_q.shape[1],)
        np.testing.assert_array_equal(port.float().numpy(), np.asarray(ref.astype(jnp.float32)))
        return
    x, w_q, w_scale, b, a = _case(name)
    codes = pt_linear.quantize_activations(_t(x), a).numpy()
    np.testing.assert_array_equal(codes, _jax_codes(x, a))
    ref = np.asarray(jax_linear.quant_dense(jnp.asarray(x), jnp.asarray(w_q), jnp.asarray(w_scale),
                                            jnp.asarray(b), a))
    port = pt_linear.quant_dense(_t(x), _t(w_q), _t(w_scale), _t(b), a).numpy()
    assert port.dtype == ref.dtype == np.float32
    np.testing.assert_allclose(port, ref, rtol=Y_REL, atol=Y_REL * np.abs(ref).max())
    if name == "half_points":
        v = x * np.float32(1.0 / a)
        away = np.clip(np.sign(v) * np.floor(np.abs(v) + 0.5), -127, 127)
        assert np.any(away != codes)  # roundf would have missed the reference
    if name == "reciprocal_trap":
        by_division = np.clip(np.round(x / np.float32(a)), -127, 127)
        assert np.all(by_division != codes)  # x / act_scale would have missed
    if name == "past_the_clip":
        assert codes.min() == -127 and codes.max() == 127
    if name == "acc_past_2_24":
        acc = codes.astype(np.int64) @ w_q.astype(np.int64)
        assert np.abs(acc).max() > 2**24


def test_an_fp32_accumulated_product_misses_the_reference_quant_dense():
    """At K = 1152 with codes ±127, |acc| passes 2^24, where float32 spacing
    is 2: a product accumulated in float32 rounds on the way; the exact
    int32 sum (the port's plain version and kernel) does not."""
    a = 0.017
    x = np.full((1, 1152), np.float32(127 * a * 1.3), np.float32)
    x[0, 0] = np.float32(126 * a)
    w_q = np.full((1152, 1), 127, np.int8)
    w_scale, b = np.ones(1, np.float32), np.zeros(1, np.float32)
    ref = np.asarray(jax_linear.quant_dense(jnp.asarray(x), jnp.asarray(w_q), jnp.asarray(w_scale),
                                            jnp.asarray(b), a))
    port = pt_linear.quant_dense(_t(x), _t(w_q), _t(w_scale), _t(b), a).numpy()
    np.testing.assert_array_equal(port, ref)
    codes = pt_linear.quantize_activations(_t(x), a).numpy().astype(np.float32)
    fp32_acc = np.cumsum(codes[0] * np.float32(127), dtype=np.float32)[-1]
    exact = int(codes.astype(np.int64).sum() * 127)
    assert exact > 2**24 and exact % 2 == 1
    missed = fp32_acc * np.float32(a)
    assert missed != ref[0, 0]
    assert abs(float(missed) - float(ref[0, 0])) > 10 * np.spacing(np.float32(ref[0, 0]))


def test_quant_dense_on_a_cpu_tensor_takes_the_plain_version_and_launches_nothing():
    x, w_q, w_scale, b, a = _case("random")
    before = dict(pt_linear.KERNEL_LAUNCHES)
    y = pt_linear.quant_dense(_t(x), _t(w_q), _t(w_scale), None, a)
    plain = pt_linear.quant_dense_plain(_t(x), _t(w_q), _t(w_scale), None, a)
    assert torch.equal(y, plain)
    ref = np.asarray(jax_linear.quant_dense(jnp.asarray(x), jnp.asarray(w_q), jnp.asarray(w_scale),
                                            None, a))
    np.testing.assert_allclose(y.numpy(), ref, rtol=Y_REL, atol=Y_REL * np.abs(ref).max())
    assert pt_linear.KERNEL_LAUNCHES == before


def test_the_kernel_wrapper_refuses_what_the_kernel_does_not_take():
    """The checks run before anything touches CUDA, so they show here:
    what the reference does not take raises, and what it takes (16-bit x,
    any rank, a ragged wide output, a strided W_q) passes every check but
    the last, which finds the operands on the host."""
    x, w_q, w_scale, b, a = (_t(v) if isinstance(v, np.ndarray) else v for v in _case("random"))
    for bad in (x.double(), x.to(torch.int32)):
        with pytest.raises(ValueError, match="float32, bfloat16 or float16"):
            pt_linear._quant_dense_cuda(bad, w_q, w_scale, b, a)
        with pytest.raises(ValueError, match="float32, bfloat16 or float16"):
            pt_linear.quant_dense(bad, w_q, w_scale, b, a)
    with pytest.raises(ValueError, match="do not chain"):
        pt_linear._quant_dense_cuda(x[:, :5], w_q, w_scale, b, a)
    with pytest.raises(ValueError, match="do not chain"):
        pt_linear._quant_dense_cuda(x[0, 0], w_q, w_scale, b, a)
    with pytest.raises(ValueError, match="int8"):
        pt_linear._quant_dense_cuda(x, w_q.float(), w_scale, b, a)
    with pytest.raises(ValueError, match="b must be"):
        pt_linear._quant_dense_cuda(x, w_q, w_scale, b[:3], a)
    with pytest.raises(ValueError, match="b must be float32"):
        pt_linear._quant_dense_cuda(x, w_q, w_scale, b.double(), a)
    wide = torch.zeros((37, 100), dtype=torch.int8)
    taken = [(x.to(torch.bfloat16), w_q, w_scale, b), (x.to(torch.float16), w_q, w_scale, None),
             (x.reshape(3, 3, 37), w_q, w_scale, b), (x.t().contiguous().t(), w_q, w_scale, b),
             (x, w_q.t().contiguous().t(), w_scale, b.to(torch.bfloat16)),
             (x, wide, torch.ones(100), torch.zeros(100))]
    for args in taken:
        with pytest.raises(ValueError, match="x's device"):
            pt_linear._quant_dense_cuda(*args, a)


def test_the_kernel_wrapper_refuses_weights_it_would_misread_before_touching_cuda():
    """A W_q view off the 16-byte alignment the kernel's copies need, or not
    contiguous, is copied once (aligned, contiguous, equal), and the
    caller's tensor is left as it was; weights on the host under a CUDA x
    raise before any build or launch."""
    x, w_q, w_scale, b, a = (_t(v) if isinstance(v, np.ndarray) else v for v in _case("random"))
    k, m = w_q.shape
    flat = torch.zeros(k * m + 1, dtype=torch.int8)
    flat[1:] = w_q.reshape(-1)
    for view in (flat[1:].view(k, m), w_q.t().contiguous().t()):
        before = view.clone()
        w, scale, bias, plan = pt_linear.quant_dense_operands(view, w_scale, b)
        assert w.data_ptr() != view.data_ptr() and w.data_ptr() % 16 == 0 and w.is_contiguous()
        assert torch.equal(w, view) and torch.equal(view, before) and plan.pad_bytes == 0
        assert scale is w_scale and bias is b
    w, scale, bias, _ = pt_linear.quant_dense_operands(w_q, w_scale.double(), b)
    assert w is w_q and scale.dtype == torch.float32 and torch.equal(scale, w_scale.double().float())
    with pytest.raises(ValueError, match="x's device"):
        pt_linear._quant_dense_cuda(x, w_q, w_scale, b, a)


@pytest.mark.parametrize("n", [1, 3, 8, 21, 32, 128, 130, 4_194_305])
@pytest.mark.parametrize("k,m", [(1152, 1024), (1024, 10), (6, 5), (37, 12), (1024, 100), (1024, 1000),
                                 (64, 100), (18432, 1024), (12800, 1024), (2000, 37), (32, 16)])
def test_the_kernel_launch_plan_covers_every_k_row_and_column_once(k, m, n):
    """The plan the wrapper passes the kernel (``quant_dense_plan``), at the
    int8 bundle's two quantized layers, the 100-class head, ragged and
    staged shapes: the K-chunks tile K (each a multiple of 32 long, none
    empty) and each chunk's stages tile the chunk (a multiple of 32, at
    most 256 rows), so every k is summed exactly once; the row tiles and
    strips cover n and N, clusters stay within the portable 8, TMA is the
    route exactly where W_q's rows are (or are padded to) a multiple of 16
    bytes, the padded copy's extra bytes are stated, one stage of a CTA fits
    the H100's 227 KB of shared memory, and the launches' row blocks cover n
    once within grid y's 65,535 row tiles."""
    plan = pt_linear.quant_dense_plan(n, k, m)
    chunks = [(r * plan.k_chunk, min(k, (r + 1) * plan.k_chunk)) for r in range(plan.cluster)]
    covered = np.zeros(k, np.int64)
    for start, stop in chunks:
        assert start < stop <= start + plan.k_chunk
        for s in range(-(-(stop - start) // plan.k_stage)):
            covered[start + s * plan.k_stage:min(stop, start + (s + 1) * plan.k_stage)] += 1
    assert np.all(covered == 1)
    assert plan.k_chunk % 32 == 0 and chunks[-1][1] == k
    assert plan.k_stage % 32 == 0 and plan.k_stage <= min(256, plan.k_chunk)
    assert (plan.stages - 1) * plan.k_stage < plan.k_chunk <= plan.stages * plan.k_stage
    assert 1 <= plan.cluster <= 8
    assert plan.route == ("tma" if m % 16 == 0 or m > 64 else "bulk")
    if plan.route == "tma":
        assert plan.width == -(-m // 16) * 16 and plan.width % 16 == 0
        assert plan.strip <= plan.width
    else:
        assert plan.strips == 1 and plan.width == m
    assert plan.pad_bytes == k * (plan.width - m)
    assert plan.strip in (16, 32, 64) and (plan.strips - 1) * plan.strip < m <= plan.strips * plan.strip
    assert (plan.row_tiles - 1) * 8 * plan.nt < n <= plan.row_tiles * 8 * plan.nt
    assert plan.smem_bytes <= 227 * 1024
    assert plan.ctas == plan.strips * plan.cluster * plan.row_tiles
    blocks = pt_linear.quant_dense_row_blocks(n, plan.nt)
    assert len(blocks) == plan.launches == -(-plan.row_tiles // 65535)
    assert [r0 for r0, _, _ in blocks] == list(np.cumsum([0] + [c for _, c, _ in blocks[:-1]]))
    assert sum(c for _, c, _ in blocks) == n and sum(t for _, _, t in blocks) == plan.row_tiles
    assert all(1 <= t <= 65535 and (t - 1) * 8 * plan.nt < c <= t * 8 * plan.nt for _, c, t in blocks)
    if (k, m) == (1152, 1024):
        assert plan.ctas >= 128


def test_the_kernel_launch_plan_refuses_a_ragged_wide_output():
    """out = 100 (neither a multiple of 16 nor at most 64) is planned, not
    refused: W_q is copied once into 112 zero-padded columns, 12 × in bytes
    more than W_q, so the TMA route's 16-byte row stride holds; the kernel
    stores only the true 100 columns, so w_scale and b are read as they
    are. Only a shape with nothing in it is refused."""
    w_q = _t(np.random.default_rng(9).integers(-127, 128, (1024, 100)).astype(np.int8))
    w_scale, b = torch.ones(100), torch.zeros(100)
    w, scale, bias, plan = pt_linear.quant_dense_operands(w_q, w_scale, b)
    assert (plan.route, plan.width, plan.pad_bytes, plan.strips) == ("tma", 112, 1024 * 12, 2)
    assert w.shape == (1024, 112) and w.data_ptr() % 16 == 0
    assert torch.equal(w[:, :100], w_q) and not w[:, 100:].any()
    assert scale is w_scale and bias is b
    for shape in ((0, 64, 100), (1, 0, 100), (1, 64, 0)):
        with pytest.raises(ValueError, match="must be positive"):
            pt_linear.quant_dense_plan(*shape)


def test_the_kernel_builds_from_the_repo_sources_into_an_ignored_directory(monkeypatch):
    path = _native.library_path()
    assert os.path.dirname(path) == os.path.join(REPO, "gan_deeplearning4j_tpu_torch", "csrc", "build")
    assert os.path.isfile(os.path.join(REPO, "gan_deeplearning4j_tpu_torch", "csrc", "quant_dense.cu"))
    with open(os.path.join(REPO, ".gitignore")) as fh:
        assert "gan_deeplearning4j_tpu_torch/csrc/build/" in fh.read().split()
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setattr(_native.shutil, "which", lambda name: None)
    monkeypatch.setattr(_native.os.path, "isfile", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _native.nvcc_path()


# -- quantized weights, calibration and the layer -----------------------------------

def test_quantize_dense_params_is_bit_equal_to_jax():
    rng = np.random.default_rng(8)
    w = (rng.standard_normal((1152, 64)) * 0.05).astype(np.float32)
    w[:, 3] = 0.0  # a dead column: the amax floor
    w[:, 5] = np.linspace(-2.54, 2.54, 1152, dtype=np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    ref = jax_quantize_params(w, b, act_scale=0.1)
    port = quantize_dense_params(_t(w), _t(b), act_scale=0.1)
    for name in ("W_q", "w_scale", "b"):
        assert port[name].numpy().dtype == np.asarray(ref[name]).dtype
        np.testing.assert_array_equal(port[name].numpy(), np.asarray(ref[name]))
    assert port["w_scale"][3] == np.float32(1e-8 / 127.0) and not port["W_q"][:, 3].any()


def _random_tree(shapes, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for layer, leaves in shapes.items():
        out[layer] = {}
        for name, shape in leaves.items():
            if name == "W":
                fan_in = int(np.prod(shape[:-1]))
                v = rng.standard_normal(shape) * np.sqrt(2.0 / (fan_in + shape[-1]))
            elif name in ("gamma", "var"):
                v = rng.uniform(0.5, 1.5, shape)
            else:
                v = rng.standard_normal(shape) * 0.1
            out[layer][name] = v.astype(np.float32)
    return out


@pytest.fixture(scope="module")
def full_width_cv():
    """The full-width transfer classifier ``cv`` (1,401,614 params) with
    numpy-drawn params, as both packages' graphs."""
    jax_dis = jax_models.build_discriminator()
    jax_cv, _ = jax_models.build_transfer_classifier(jax_dis, jax_dis.init())
    pt_cv = PtGraph.from_dict(json.loads(json.dumps(jax_cv.to_dict())))
    return jax_cv, pt_cv, _random_tree(pt_cv.param_shapes(), 12)


def test_calibration_matches_jax_on_the_full_width_classifier(full_width_cv):
    jax_cv, pt_cv, tree = full_width_cv
    np.testing.assert_array_equal(default_calibration_rows(784, 64), jax_default_rows(784, 64))
    rows = default_calibration_rows(784, 64)
    ref = jax_calibrate(jax_cv, jax.tree_util.tree_map(jnp.asarray, tree), rows)
    port = calibrate_activation_scales(pt_cv, params_from_numpy(tree, "cpu", graph=pt_cv), rows)
    assert set(port) == set(ref) == {"dis_dense_layer_6", "dis_output_layer_7"}
    for name in ref:
        assert port[name] == pytest.approx(ref[name], rel=SCALE_REL)


def test_quant_dense_layer_round_trips_and_matches_the_jax_layer():
    layer = QuantDenseLayer(n_out=10, n_in=1024, act_scale=0.0123, activation="softmax")
    assert pt_layers.layer_from_dict(layer.to_dict()) == layer
    jax_layer = JaxQuantDense(n_out=10, n_in=1024, act_scale=0.0123, activation="softmax")
    assert pt_layers.layer_from_dict(json.loads(json.dumps(jax_layer.to_dict()))) == layer
    assert layer.to_dict() == json.loads(json.dumps(jax_layer.to_dict()))
    assert layer.param_roles() == jax_layer.param_roles()
    shapes = {k: tuple(v.shape) for k, v in jax_layer.init(jax.random.PRNGKey(0), None).items()}
    assert layer.param_shapes(None) == shapes
    init = layer.init(torch.Generator(), None)
    assert init["W_q"].dtype == torch.int8 and init["w_scale"].dtype == torch.float32


def test_an_int8_topology_resolves_quant_dense_lazily(tmp_path):
    jax_cv = JaxBuilder(JaxConfig(seed=2))
    jax_cv.add_inputs("x").set_input_types(JaxInputType.feed_forward(FEAT))
    jax_cv.add_layer("q", JaxQuantDense(n_out=CLASSES, act_scale=0.5, activation="softmax"), "x")
    jax_cv.set_outputs("q")
    graph = jax_cv.build()
    jax_ser.write_model(str(tmp_path / "q.zip"), graph, graph.init(), save_updater=False)
    code = (
        "import sys\n"
        "from gan_deeplearning4j_tpu_torch.utils.serializer import read_model\n"
        "assert 'gan_deeplearning4j_tpu_torch.quant.layers' not in sys.modules\n"
        f"g, p, _, _ = read_model({str(tmp_path / 'q.zip')!r}, device='cpu')\n"
        "assert type(g.vertices[0].layer).__name__ == 'QuantDenseLayer'\n"
        "assert str(p['q']['W_q'].dtype) == 'torch.int8'\n"
        "print('lazy-ok')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=REPO, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "lazy-ok" in proc.stdout


# -- int8 leaves across the boundaries ----------------------------------------------

def test_int8_leaves_round_trip_the_serializer_both_ways(tmp_path):
    graph = PtGraph.from_dict(json.loads(json.dumps(JaxBuilder(JaxConfig()).add_inputs("x")
                                                    .set_input_types(JaxInputType.feed_forward(6))
                                                    .add_layer("q", JaxQuantDense(n_out=3), "x")
                                                    .set_outputs("q").build().to_dict())))
    rng = np.random.default_rng(2)
    tree = {"q": {"W_q": rng.integers(-127, 128, (6, 3)).astype(np.int8),
                  "w_scale": rng.random(3).astype(np.float32),
                  "b": rng.standard_normal(3).astype(np.float32)}}
    params = params_from_numpy(tree, "cpu", graph=graph)
    assert params["q"]["W_q"].dtype == torch.int8
    pt_ser.write_model(str(tmp_path / "pt.zip"), graph, params, save_updater=False)
    _, jparams, _, _ = jax_ser.read_model(str(tmp_path / "pt.zip"), load_updater=False)
    assert np.asarray(jparams["q"]["W_q"]).dtype == np.int8
    jax_graph = jax_ser.read_model(str(tmp_path / "pt.zip"), load_updater=False)[0]
    jax_ser.write_model(str(tmp_path / "jax.zip"), jax_graph, jparams, save_updater=False)
    _, back, _, _ = pt_ser.read_model(str(tmp_path / "jax.zip"), device="cpu")
    for name, value in tree.items():
        for leaf in value:
            assert back[name][leaf].dtype == params[name][leaf].dtype
            np.testing.assert_array_equal(back[name][leaf].numpy(), value[leaf])
            np.testing.assert_array_equal(np.asarray(jparams[name][leaf]), value[leaf])


# -- int8 bundles served across the packages -----------------------------------------

def _tiny_jax_bundle(directory):
    """A tiny fp32 bundle (dense generator and classifier), written by the JAX
    serializer."""
    os.makedirs(directory, exist_ok=True)
    g = JaxBuilder(JaxConfig(seed=1))
    g.add_inputs("z").set_input_types(JaxInputType.feed_forward(Z))
    g.add_layer("g_dense_1", JaxDense(n_out=8, activation="tanh"), "z")
    g.add_layer("g_out", JaxOutput(n_out=FEAT, activation="sigmoid", loss="xent"), "g_dense_1")
    g.set_outputs("g_out")
    gen = g.build()
    c = JaxBuilder(JaxConfig(seed=2))
    c.add_inputs("x").set_input_types(JaxInputType.feed_forward(FEAT))
    c.add_layer("feat_1", JaxDense(n_out=HIDDEN, activation="tanh"), "x")
    c.add_layer("cv_out", JaxOutput(n_out=CLASSES, activation="softmax", loss="mcxent"), "feat_1")
    c.set_outputs("cv_out")
    cv = c.build()
    jax_ser.write_model(os.path.join(directory, "gen.zip"), gen, gen.init(), save_updater=False)
    jax_ser.write_model(os.path.join(directory, "cv.zip"), cv, cv.init(), save_updater=False)
    with open(os.path.join(directory, "serving.json"), "w") as fh:
        json.dump({"format_version": 1, "generator": "gen.zip", "classifier": "cv.zip",
                   "feature_vertex": "feat_1", "generation": 0, "step": 0}, fh)
    return directory


def _quant_layers(bundle):
    """{vertex: (max_j 127·w_scale[j]·act_scale)} of the bundle's classifier:
    what one moved activation code can change a quantized output by."""
    with open(os.path.join(bundle, "serving.json")) as fh:
        cv_zip = json.load(fh)["classifier"]
    graph, params, _, _ = pt_ser.read_model(os.path.join(bundle, cv_zip), device="cpu")
    return {v.name: 127.0 * float(params[v.name]["w_scale"].max()) * v.layer.act_scale
            for v in graph.vertices if isinstance(v.layer, QuantDenseLayer)}


def _code_flip_atol(bundle, ref):
    return 2.0 * max(_quant_layers(bundle).values()) + 1e-5 * float(np.abs(ref).max())


def _serve_both(port, ref, bundle, sizes=(1, 3, 8)):
    rng = np.random.default_rng(5)
    for kind in port.kinds:
        for n in sizes:
            rows = rng.random((n, port.input_width(kind)), dtype=np.float32)
            got, want = port.run(kind, rows), np.asarray(ref.run(kind, rows))
            assert got.shape == want.shape and np.all(np.isfinite(got))
            atol = 1e-5 * float(np.abs(want).max()) if kind == "sample" else _code_flip_atol(bundle, want)
            err = float(np.max(np.abs(got - want)))
            assert err <= atol, f"{kind} n={n}: {err} > {atol}"


@pytest.mark.parametrize("builder", ["jax", "port"])
def test_an_int8_bundle_serves_in_both_engines_alike(tmp_path, builder):
    src = _tiny_jax_bundle(str(tmp_path / "fp32"))
    dst = str(tmp_path / "int8")
    manifest = jax_build_int8(src, dst) if builder == "jax" else build_int8_variant(src, dst, device="cpu")
    assert manifest["precision"] == "int8"
    port = ServingEngine.from_bundle(dst, buckets=(1, 8), device="cpu")
    ref = JaxEngine.from_bundle(dst, buckets=(1, 8))
    assert port.stats()["precision"] == "int8"
    assert port.resident_param_bytes() == ref.resident_param_bytes()
    leaves = port._params["classifier"]["feat_1"]
    assert leaves["W_q"].dtype == torch.int8 and leaves["w_scale"].dtype == torch.float32
    _serve_both(port, ref, dst)


def test_a_100_class_int8_classifier_serves_in_both_engines_alike(tmp_path):
    """The MNIST transfer classifier at full width with a 100-class head
    (``num_classes`` is an experiment flag), from one JAX checkpoint: both
    builders quantize it alike, its head ``dis_output_layer_7`` is 1024 →
    100 (the kernel's padded route on the card), and its int8 bundle serves
    ``classify`` and ``features`` in both engines alike."""
    cfg = jax_models.DcganConfig(num_classes=100)
    jax_dis = jax_models.build_discriminator(cfg)
    jax_cv, _ = jax_models.build_transfer_classifier(jax_dis, jax_dis.init(), cfg)
    pt_cv = PtGraph.from_dict(json.loads(json.dumps(jax_cv.to_dict())))
    tree = _random_tree(pt_cv.param_shapes(), 100)
    src = str(tmp_path / "fp32")
    os.makedirs(src)
    jax_ser.write_model(os.path.join(src, "cv.zip"), jax_cv, jax.tree_util.tree_map(jnp.asarray, tree),
                        save_updater=False)
    with open(os.path.join(src, "serving.json"), "w") as fh:
        json.dump({"format_version": 1, "classifier": "cv.zip", "feature_vertex": "dis_dense_layer_6",
                   "num_classes": 100, "generation": 0, "step": 0}, fh)
    rows = np.random.default_rng(3).random((32, 784), dtype=np.float32)
    dst = str(tmp_path / "pt")
    port_manifest = build_int8_variant(src, dst, calibration_rows=rows, device="cpu")
    jax_manifest = jax_build_int8(src, str(tmp_path / "jax"), calibration_rows=rows)
    for name, scale in jax_manifest["quant"]["calibration"]["activation_scales"].items():
        assert port_manifest["quant"]["calibration"]["activation_scales"][name] == \
            pytest.approx(scale, rel=SCALE_REL)
    _, pp, _, _ = pt_ser.read_model(os.path.join(dst, "cv.zip"), device="cpu")
    _, jp, _, _ = jax_ser.read_model(str(tmp_path / "jax" / "cv.zip"), load_updater=False)
    assert tuple(pp["dis_output_layer_7"]["W_q"].shape) == (1024, 100)
    for layer in ("dis_dense_layer_6", "dis_output_layer_7"):
        for leaf in ("W_q", "w_scale", "b"):
            np.testing.assert_array_equal(pp[layer][leaf].numpy(), np.asarray(jp[layer][leaf]))
    port = ServingEngine.from_bundle(dst, buckets=(8,), device="cpu")
    ref = JaxEngine.from_bundle(dst, buckets=(8,))
    assert set(port.kinds) == {"classify", "features"} and port.input_width("classify") == 784
    _serve_both(port, ref, dst)
    assert port.run("classify", rows[:3]).shape == (3, 100)


def test_both_builders_write_the_same_int8_bundle(tmp_path):
    src = _tiny_jax_bundle(str(tmp_path / "fp32"))
    rows = np.random.default_rng(1).random((32, FEAT), dtype=np.float32)
    ref = jax_build_int8(src, str(tmp_path / "jax"), calibration_rows=rows)
    port = build_int8_variant(src, str(tmp_path / "pt"), calibration_rows=rows, device="cpu")
    for key in ("precision", "generator", "classifier", "feature_vertex"):
        assert port[key] == ref[key]
    pq, rq = port["quant"], ref["quant"]
    assert pq["method"] == rq["method"] and pq["source"] != "" and set(pq) == set(rq)
    pc, rc = pq["calibration"], rq["calibration"]
    assert (pc["seed"], pc["num_rows"], pc["source"]) == (rc["seed"], rc["num_rows"], rc["source"])
    for name, scale in rc["activation_scales"].items():
        assert pc["activation_scales"][name] == pytest.approx(scale, rel=SCALE_REL)
    with open(os.path.join(src, "gen.zip"), "rb") as a, open(str(tmp_path / "pt" / "gen.zip"), "rb") as b:
        assert a.read() == b.read()
    _, pp, _, _ = pt_ser.read_model(str(tmp_path / "pt" / "cv.zip"), device="cpu")
    _, jp, _, _ = jax_ser.read_model(str(tmp_path / "jax" / "cv.zip"), load_updater=False)
    for layer in ("feat_1", "cv_out"):
        for leaf in ("W_q", "w_scale", "b"):
            np.testing.assert_array_equal(pp[layer][leaf].numpy(), np.asarray(jp[layer][leaf]))
    with pytest.raises(ValueError, match="no classifier"):
        os.makedirs(str(tmp_path / "gen_only"))
        with open(str(tmp_path / "gen_only" / "serving.json"), "w") as fh:
            json.dump({"format_version": 1, "generator": "gen.zip"}, fh)
        build_int8_variant(str(tmp_path / "gen_only"), str(tmp_path / "x"), device="cpu")


def test_build_int8_variant_calibrates_on_the_card_unless_asked(tmp_path, monkeypatch):
    """With no ``device`` the builder reads and calibrates the classifier on
    the card; with CUDA absent it raises before writing anything, rather
    than calibrating on the CPU by itself."""
    src = _tiny_jax_bundle(str(tmp_path / "fp32"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_int8_variant(src, str(tmp_path / "int8"))
    assert not os.path.exists(str(tmp_path / "int8" / "serving.json"))


# -- the measured cost block ---------------------------------------------------------

def _keys(block):
    return {k: sorted(v) if isinstance(v, dict) else None for k, v in block.items()}


def test_the_cost_block_has_the_jax_keys(tmp_path):
    src = _tiny_jax_bundle(str(tmp_path / "fp32"))
    dst = str(tmp_path / "int8")
    build_int8_variant(src, dst, device="cpu")
    port = measure_engine_cost(ServingEngine.from_bundle(dst, buckets=(1, 4), device="cpu"), rounds=2)
    ref = jax_measure(JaxEngine.from_bundle(dst, buckets=(1, 4)), rounds=2)
    assert _keys(port) == _keys(ref)
    assert port["per_bucket_s"].keys() == ref["per_bucket_s"].keys()
    for kind in ref["per_bucket_s"]:
        assert sorted(port["per_bucket_s"][kind]) == sorted(ref["per_bucket_s"][kind])
    for key in ("cost_schema", "resident_param_bytes", "staged_widths", "staged_bytes_top_bucket",
                "buckets", "replicas", "precision", "platform", "rounds", "scalar_unit"):
        assert port[key] == ref[key], key
    assert port["cost_schema"] == 1 and port["precision"] == "int8" and port["scalar"] > 0
    written = measure_bundle_cost(dst, buckets=(1, 4), rounds=1, device="cpu")
    assert manifest_cost(dst) == json.loads(json.dumps(written))
    write_cost_block(dst, {**written, "scalar": 0.0})
    assert manifest_cost(dst) is None
    assert manifest_cost(str(tmp_path / "missing")) is None


# -- the slice as a whole ----------------------------------------------------------

def test_publish_int8_variant_engine_cost_and_gate_against_jax(tmp_path):
    """The full-width DCGAN-MNIST bundle published by the port on the CPU →
    ``build_int8_variant`` (port and JAX, same calibration) → both engines
    → the cost block → the canary, in both packages."""
    from gan_deeplearning4j_tpu_torch.harness import ExperimentConfig, GanExperiment

    cfg = ExperimentConfig(batch_size_train=8, batch_size_pred=8, num_iterations=1, latent_grid=2,
                           save_models=False, use_accelerator=False,
                           output_dir=str(tmp_path / "train"))
    src = GanExperiment(cfg).publish_for_serving(str(tmp_path / "fp32"))["directory"]
    port_dir, jax_dir = str(tmp_path / "pt_int8"), str(tmp_path / "jax_int8")
    port_manifest = build_int8_variant(src, port_dir, device="cpu")
    jax_manifest = jax_build_int8(src, jax_dir)
    for name, scale in jax_manifest["quant"]["calibration"]["activation_scales"].items():
        assert port_manifest["quant"]["calibration"]["activation_scales"][name] == \
            pytest.approx(scale, rel=SCALE_REL)
    gen_zip = port_manifest["generator"]
    for d in (port_dir, jax_dir):
        with open(os.path.join(src, gen_zip), "rb") as a, open(os.path.join(d, gen_zip), "rb") as b:
            assert a.read() == b.read()

    fp32 = ServingEngine.from_bundle(src, buckets=(8,), device="cpu")
    port = ServingEngine.from_bundle(port_dir, buckets=(8,), device="cpu")
    ref = JaxEngine.from_bundle(port_dir, buckets=(8,))
    assert fp32.resident_param_bytes() == FP32_BYTES
    assert port.resident_param_bytes() == ref.resident_param_bytes() == INT8_BYTES
    _serve_both(port, ref, port_dir, sizes=(1, 3))
    rows = np.random.default_rng(4).random((5, 784), dtype=np.float32)
    jax_port_built = JaxEngine.from_bundle(jax_dir, buckets=(8,))
    for kind in ("classify", "features"):
        want = np.asarray(jax_port_built.run(kind, rows))
        assert np.max(np.abs(port.run(kind, rows) - want)) <= _code_flip_atol(port_dir, want)

    block = measure_engine_cost(port, rounds=1)
    assert _keys(block) == _keys(jax_measure(ref, rounds=1))
    assert block["resident_param_bytes"] / FP32_BYTES == pytest.approx(0.8894759075799559, rel=1e-15)

    (real, labels), _ = synthetic_mnist(num_train=48, num_test=1, seed=666)
    pt_decision = CanaryGate(real, labels, num_samples=16, seed=666).evaluate(port, fp32)
    jax_decision = JaxGate(real, labels, num_samples=16, seed=666).evaluate(
        ref, JaxEngine.from_bundle(src, buckets=(8,)))
    assert pt_decision.passed and jax_decision.passed
    assert pt_decision.candidate["accuracy"] == jax_decision.candidate["accuracy"]
    assert pt_decision.candidate["fid"] == pytest.approx(jax_decision.candidate["fid"], rel=1e-4)
