"""PyTorch port, the bf16 compute scope and the ops that read it, against
the JAX package inside ``compute_dtype_scope(bfloat16)`` on the CPU.

The reference casts to bf16 only inside ``dense``, ``conv2d`` and
``conv2d_transpose``: ``dense`` keeps the float32 product, and a
convolution's bf16 output is upcast to its input's dtype before the bias.
JAX runs here op by op (no ``jit``), so each op computes what its code
says: inside a jitted program XLA:CPU may keep float32 where the code
rounds to bf16 (``xla_allow_excess_precision``), which the training tests
(``tests/test_torch_bf16_train.py``) account for.

Tolerances, stated per check:
- ``dense``'s float32 output: within 1e-5 of the largest |y| (only the
  float32 summation order differs); a bf16-output matmul, as
  ``torch.autocast`` would run, misses that by two orders of magnitude;
- bf16-rounded values (convolution outputs, gradients of the bf16
  operands): every element within 1 bf16 ulp of the reference or within
  1e-6 of the largest |value| (cancellation), and at least 99% of elements
  bit-equal: the two sides accumulate in float32 in different orders, and
  a sum that lands near a rounding boundary rounds the other way;
- under bf16 storage the updaters: dtypes leaf for leaf (Adam's promotion
  to float32 included), and values within the ulps and equal shares each
  test states.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_deeplearning4j_tpu.models import mlp_gan as jax_mlp
from gan_deeplearning4j_tpu.ops import conv as jax_conv
from gan_deeplearning4j_tpu.ops import linear as jax_linear
from gan_deeplearning4j_tpu.ops import norm as jax_norm
from gan_deeplearning4j_tpu.optim import updaters as jax_upd
from gan_deeplearning4j_tpu.optim.optimizer import GraphOptimizer as JaxGraphOptimizer
from gan_deeplearning4j_tpu.runtime import dtype as jax_dtype
from gan_deeplearning4j_tpu_torch.interop import leaf_to_tensor
from gan_deeplearning4j_tpu_torch.models import mlp_gan as pt_mlp
from gan_deeplearning4j_tpu_torch.ops import conv as pt_conv
from gan_deeplearning4j_tpu_torch.ops import linear as pt_linear
from gan_deeplearning4j_tpu_torch.ops import norm as pt_norm
from gan_deeplearning4j_tpu_torch.optim import GraphOptimizer
from gan_deeplearning4j_tpu_torch.optim import updaters as pt_upd
from gan_deeplearning4j_tpu_torch.runtime import dtype as pt_dtype

BF16 = torch.bfloat16
DENSE_REL = 1e-5
MIN_EQUAL = 0.99


def _rng(seed):
    return np.random.default_rng(seed)


def _np(x):
    """A tensor or JAX array as float64 numpy (bf16 included)."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy().astype(np.float64)
    return np.asarray(jnp.asarray(x).astype(jnp.float32), np.float64)


def _dtype(x) -> str:
    return str(x.dtype).replace("torch.", "")


def _ulps(got, want):
    """Elementwise |got − want| in bf16 ulps of the larger magnitude."""
    mag = np.maximum(np.abs(got), np.abs(want))
    return np.abs(got - want) / np.exp2(np.floor(np.log2(np.maximum(mag, 1e-38))) - 7)


def assert_bf16_close(got, want, *, max_ulps=1, min_equal=MIN_EQUAL, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    diff = np.abs(got - want)
    ok = (_ulps(got, want) <= max_ulps) | (diff <= 1e-6 * np.abs(want).max())
    assert ok.all(), f"{what}: {int((~ok).sum())} elements beyond {max_ulps} ulp, max diff {diff.max()}"
    equal = float((diff == 0).mean())
    assert equal >= min_equal, f"{what}: only {equal:.4f} of elements bit-equal"


def _bf16_exact(x) -> bool:
    a = _np(x)
    return bool(np.array_equal(a, _np(torch.from_numpy(a.astype(np.float32)).to(BF16))))


# -- the scope -------------------------------------------------------------------

def test_dtype_scope_matches_jax_names_errors_and_threads():
    for name in ("bf16", "bfloat16", "BF16", None, "f32", "float32", "none", ""):
        want = jax_dtype.parse_compute_dtype(name)
        got = pt_dtype.parse_compute_dtype(name)
        assert (got is None) == (want is None), name
        if got is not None:
            assert got == BF16 and want == jnp.bfloat16
    for mod in (jax_dtype, pt_dtype):
        with pytest.raises(ValueError, match="unknown compute dtype 'fp8'"):
            mod.parse_compute_dtype("fp8")
    assert pt_dtype.get_default_dtype() == torch.float32
    assert pt_dtype.get_compute_dtype() == torch.float32
    seen = {}
    with pt_dtype.compute_dtype_scope(BF16):
        assert pt_dtype.get_compute_dtype() == BF16
        with pt_dtype.compute_dtype_scope(None):
            assert pt_dtype.get_compute_dtype() == torch.float32
        t = threading.Thread(target=lambda: seen.setdefault("other", pt_dtype.get_compute_dtype()))
        t.start()
        t.join()
        assert pt_dtype.get_compute_dtype() == BF16
    assert seen["other"] == torch.float32  # the scope is per thread
    assert pt_dtype.get_compute_dtype() == torch.float32
    with pt_dtype.default_dtype_scope("bf16"):
        assert pt_dtype.get_compute_dtype() == BF16
    pt_dtype.set_compute_dtype("bf16")
    try:
        assert pt_dtype.get_compute_dtype() == BF16
    finally:
        pt_dtype.set_compute_dtype(None)
    assert pt_dtype.weak_scalar(0.9, BF16) == 0.8984375
    assert pt_dtype.weak_scalar(0.9, torch.float32) == float(np.float32(0.9))


# -- dense ------------------------------------------------------------------------

def _jax_vjp(fn, args, cot):
    with jax_dtype.compute_dtype_scope(jnp.bfloat16):
        y, vjp = jax.vjp(fn, *args)
        return y, vjp(jnp.asarray(cot))


def _port_grads(fn, args, cot):
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in args]
    with pt_dtype.compute_dtype_scope(BF16):
        y = fn(*leaves)
    grads = torch.autograd.grad(y, leaves, torch.from_numpy(cot))
    return y.detach(), grads


@pytest.mark.parametrize("n,k,m", [(16, 2, 256), (16, 192, 300)])
def test_dense_matches_jax_values_and_grads(n, k, m):
    """x/W/b gradients and the float32 product; W's gradient is float32
    holding bf16-exact values on both sides."""
    rng = _rng(n + k + m)
    x = rng.standard_normal((n, k)).astype(np.float32)
    w = (rng.standard_normal((k, m)) / np.sqrt(k)).astype(np.float32)
    b = rng.standard_normal(m).astype(np.float32)
    cot = rng.standard_normal((n, m)).astype(np.float32)
    jy, (jgx, jgw, jgb) = _jax_vjp(jax_linear.dense, (x, w, b), cot)
    py, (pgx, pgw, pgb) = _port_grads(pt_linear.dense, (x, w, b), cot)
    assert _dtype(py) == _dtype(jy) == "float32"
    ref = _np(jy)
    assert np.abs(_np(py) - ref).max() <= DENSE_REL * np.abs(ref).max()
    assert_bf16_close(pgx, jgx, what="dx")
    assert_bf16_close(pgw, jgw, what="dW")
    np.testing.assert_allclose(_np(pgb), _np(jgb), rtol=1e-5, atol=1e-5)
    for g in (jgx, jgw, pgx, pgw):
        assert _dtype(g) == "float32" and _bf16_exact(g)


def test_a_bf16_output_matmul_misses_the_reference_dense():
    """``torch.autocast`` or a plain bf16 matmul rounds the product to
    bf16; the reference keeps it in float32."""
    rng = _rng(3)
    x = rng.standard_normal((64, 512)).astype(np.float32)
    w = (rng.standard_normal((512, 392)) / np.sqrt(512)).astype(np.float32)
    with jax_dtype.compute_dtype_scope(jnp.bfloat16):
        ref = _np(jax_linear.dense(x, w))
    scale = np.abs(ref).max()
    with pt_dtype.compute_dtype_scope(BF16):
        port = _np(pt_linear.dense(torch.from_numpy(x), torch.from_numpy(w)))
    bf16_out = _np(torch.matmul(torch.from_numpy(x).to(BF16), torch.from_numpy(w).to(BF16)))
    assert np.abs(port - ref).max() <= DENSE_REL * scale
    assert np.abs(bf16_out - ref).max() > 100 * DENSE_REL * scale
    assert pt_linear.dense_route("cpu") == "fp32_of_rounded"


def test_dense_in_fp32_serves_bf16_params_as_the_jax_package_does():
    """No scope: a bf16 weight is computed in float32 (a bf16-storage
    bundle served without ``precision``)."""
    rng = _rng(4)
    x = rng.standard_normal((5, 12)).astype(np.float32)
    w = jnp.asarray(rng.standard_normal((12, 7)), jnp.bfloat16)
    b = jnp.asarray(rng.standard_normal(7), jnp.bfloat16)
    ref = jax_linear.dense(x, w, b)
    port = pt_linear.dense(torch.from_numpy(x), leaf_to_tensor(np.asarray(w)), leaf_to_tensor(np.asarray(b)))
    assert _dtype(port) == _dtype(ref) == "float32"
    np.testing.assert_allclose(_np(port), _np(ref), rtol=1e-6, atol=1e-6)


# -- convolutions -------------------------------------------------------------------

_CONVS = [
    # name, op, x shape, kernel shape, stride, padding
    ("5x5_s2_mnist_dis", "conv2d", (4, 28, 28, 1), (5, 5, 1, 16), 2, 0),
    ("5x5_s1_p2_mnist_gen", "conv2d", (4, 14, 14, 16), (5, 5, 16, 8), 1, 2),
    ("5x5_s2_p2_wgan_critic", "conv2d", (4, 8, 8, 3), (5, 5, 3, 16), 2, 2),
    ("k4_s2_p1_image_gen", "conv2d_transpose", (4, 4, 4, 32), (4, 4, 32, 16), 2, 1),
]


def _conv_pair(op, x, w, stride, padding):
    rng = _rng(x.size)
    jfn = getattr(jax_conv, op)
    pfn = getattr(pt_conv, op)
    y_shape = jax.eval_shape(lambda a, b: jfn(a, b, stride=stride, padding=padding), x, w).shape
    cot = rng.standard_normal(y_shape).astype(np.float32)
    jy, jg = _jax_vjp(lambda a, b: jfn(a, b, stride=stride, padding=padding), (x, w), cot)
    py, pg = _port_grads(lambda a, b: pfn(a, b, stride=stride, padding=padding), (x, w), cot)
    return (jy, *jg), (py, *pg)


def _conv_inputs(xs, ws):
    rng = _rng(int(np.prod(xs)))
    x = rng.standard_normal(xs).astype(np.float32)
    w = (rng.standard_normal(ws) / np.sqrt(np.prod(ws[:3]))).astype(np.float32)
    return x, w


@pytest.mark.parametrize("name,op,xs,ws,stride,padding", _CONVS, ids=[c[0] for c in _CONVS])
def test_convolutions_match_jax_values_and_grads(name, op, xs, ws, stride, padding):
    """The bf16-rounded output (upcast to float32) and both gradients."""
    x, w = _conv_inputs(xs, ws)
    ref, port = _conv_pair(op, x, w, stride, padding)
    for what, p, r in zip(("y", "dx", "dW"), port, ref):
        assert _dtype(p) == _dtype(r) == "float32", what
        assert_bf16_close(p, r, what=f"{name} {what}")
    assert _bf16_exact(port[0]) and _bf16_exact(ref[0])  # the output is bf16-rounded


@pytest.mark.parametrize("name,op,xs,ws,stride,padding", _CONVS[1:], ids=[c[0] for c in _CONVS[1:]])
def test_param_gradients_are_float32_holding_bf16_exact_values(name, op, xs, ws, stride, padding):
    """Under mixed precision a float32 param's gradient is rounded
    where the cast is: float32 holding bf16-exact values, in both
    packages (``dense`` is checked in its own test)."""
    x, w = _conv_inputs(xs, ws)
    ref, port = _conv_pair(op, x, w, stride, padding)
    for g in (ref[1], ref[2], port[1], port[2]):
        assert _dtype(g) == "float32" and _bf16_exact(g)


def test_jitted_reference_keeps_float32_where_its_code_rounds():
    """A reference caveat (ROADMAP.md §3): inside ``jax.jit`` XLA:CPU drops
    the bf16 rounding of a convolution's output (excess precision), so the
    port, which rounds as the reference's code says, is compared with the
    reference run op by op; there the two are bit-equal."""
    x, w = _conv_inputs((4, 14, 14, 16), (5, 5, 16, 8))
    with jax_dtype.compute_dtype_scope(jnp.bfloat16):
        eager = jax_conv.conv2d(x, w, padding=2)
        jitted = jax.jit(lambda a, b: jax_conv.conv2d(a, b, padding=2))(x, w)
    with pt_dtype.compute_dtype_scope(BF16):
        port = pt_conv.conv2d(torch.from_numpy(x), torch.from_numpy(w), padding=2)
    assert _bf16_exact(eager) and _bf16_exact(port) and not _bf16_exact(jitted)
    assert_bf16_close(port, eager, what="port vs op by op")


def test_conv_bias_is_added_after_the_upcast():
    rng = _rng(5)
    x, w = _conv_inputs((2, 6, 6, 4), (3, 3, 4, 5))
    b = rng.standard_normal(5).astype(np.float32)
    with jax_dtype.compute_dtype_scope(jnp.bfloat16):
        ref = _np(jax_conv.conv2d(x, w, b, padding=1))
    with pt_dtype.compute_dtype_scope(BF16):
        port = _np(pt_conv.conv2d(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b), padding=1))
    np.testing.assert_allclose(port, ref, rtol=1e-6, atol=1e-6)
    assert not _bf16_exact(port)  # a bf16-rounded sum would be


# -- BatchNorm running statistics under bf16 storage ----------------------------------

def test_batch_norm_train_updates_bf16_running_stats_as_the_reference():
    """Under bf16 storage the batch statistics are float32 and the running
    stats bf16; the update runs in the promoted dtype with the decay
    rounded to bf16 (jnp's weak typing) and is stored back as bf16."""
    rng = _rng(6)
    x = rng.standard_normal((16, 40)).astype(np.float32) * 2 + 0.5
    gamma, beta = (jnp.asarray(rng.uniform(0.5, 1.5, 40), jnp.bfloat16),
                   jnp.asarray(rng.standard_normal(40), jnp.bfloat16))
    rm, rv = (jnp.asarray(rng.standard_normal(40), jnp.bfloat16),
              jnp.asarray(rng.uniform(0.5, 2.0, 40), jnp.bfloat16))
    jy, jm, jv = jax_norm.batch_norm_train(x, gamma, beta, rm, rv)
    t = lambda a: leaf_to_tensor(np.asarray(a))  # noqa: E731
    py, pm, pv = pt_norm.batch_norm_train(torch.from_numpy(x), t(gamma), t(beta), t(rm), t(rv))
    assert (_dtype(py), _dtype(pm), _dtype(pv)) == (_dtype(jy), _dtype(jm), _dtype(jv)) \
        == ("float32", "bfloat16", "bfloat16")
    np.testing.assert_allclose(_np(py), _np(jy), rtol=1e-5, atol=1e-5)
    assert_bf16_close(pm, jm, min_equal=1.0, what="running mean")
    assert_bf16_close(pv, jv, min_equal=1.0, what="running var")
    jy, pyi = jax_norm.batch_norm_inference(x, gamma, beta, rm, rv), \
        pt_norm.batch_norm_inference(torch.from_numpy(x), t(gamma), t(beta), t(rm), t(rv))
    np.testing.assert_allclose(_np(pyi), _np(jy), rtol=1e-5, atol=1e-5)


# -- updaters under bf16 storage -------------------------------------------------------

def _run_updater(spec, param, grads, jit):
    """Three steps of ``spec`` (either package), each gradient in the
    param's current dtype; returns per-step ``(delta, param, state)``."""
    apply = jax.jit(spec.apply) if jit else spec.apply
    state = spec.init_state(param)
    out = []
    for g in grads:
        g = g.astype(param.dtype) if jit else g.to(param.dtype)
        delta, state = apply(state, g, param)
        param = param - delta
        out.append((delta, param, dict(state)))
    return out


@pytest.mark.parametrize("name,make,max_ulps,min_equal", [
    ("rmsprop_reference", lambda m: m.RmsProp(0.002, 1e-8, 1e-8), 1, 0.95),
    ("rmsprop_default", lambda m: m.RmsProp(0.001, 0.95, 1e-8), 2, 0.6),
    ("adam", lambda m: m.Adam(0.01, 0.9, 0.999, 1e-8), 2, 0.6),
    ("adam_wgan", lambda m: m.Adam(2e-4, 0.0, 0.9, 1e-8), 2, 0.6),
])
def test_updaters_under_bf16_storage_match_jax_dtypes_and_values(name, make, max_ulps, min_equal):
    """Three steps from a bf16 param, the reference's rule jitted as its
    trainer runs it. Adam promotes a bf16 param to float32 on its first
    step and its moments on the second, as jnp does. XLA fuses the rule
    and keeps float32 across it where torch rounds each op, so the values
    agree within ``max_ulps`` bf16 ulps, with at least ``min_equal`` of
    the elements bit-equal; a float32 leaf computed from bf16 ones within
    ``max_ulps`` bf16 ulps relative."""
    rng = _rng(11)
    p0 = rng.standard_normal((6, 50)).astype(np.float32)
    grads = [(rng.standard_normal((6, 50)) * s).astype(np.float32) for s in (1.0, 1e-2, 1e-4)]
    jspec, pspec = make(jax_upd), make(pt_upd)
    ref = _run_updater(jspec, jnp.asarray(p0, jnp.bfloat16), [jnp.asarray(g) for g in grads], jit=True)
    port = _run_updater(pspec, torch.from_numpy(p0).to(BF16), [torch.from_numpy(g) for g in grads],
                        jit=False)
    for step, ((jd, jp, js), (pd, pp, ps)) in enumerate(zip(ref, port), 1):
        assert set(js) == set(ps)
        pairs = [("delta", pd, jd), ("param", pp, jp)] + [(s, ps[s], js[s]) for s in js]
        for what, p, r in pairs:
            assert _dtype(p) == _dtype(r), (step, what)
            if what == "t":
                assert int(p) == int(r)
            elif _dtype(r) == "bfloat16":
                assert_bf16_close(p, r, max_ulps=max_ulps, min_equal=min_equal, what=f"{name} {step} {what}")
            else:  # float32 computed from bf16 values: their ulps carry over
                np.testing.assert_allclose(_np(p), _np(r), rtol=max_ulps * 2.0 ** -7, atol=1e-9,
                                           err_msg=f"{step} {what}")
    if name.startswith("adam"):
        dtypes = [(_dtype(p), _dtype(s["m"])) for _, p, s in port]
        assert dtypes == [("float32", "bfloat16"), ("float32", "float32"), ("float32", "float32")]
        # a 0-d float32 tensor does not promote a bf16 one in torch: the
        # port spells the reference's promotion out
        m = torch.ones(3, dtype=BF16)
        assert (m / (1 - torch.pow(0.9, torch.tensor(1.0)))).dtype == BF16
        assert (jnp.ones(3, jnp.bfloat16) / (1 - 0.9 ** jnp.float32(1.0))).dtype == jnp.float32


def test_lr_scale_on_a_bf16_delta_is_cast_to_its_dtype():
    """The dis-LR decay factor multiplies the delta as a scalar of the
    delta's dtype (``optimizer.py:113-116``): bf16 params stay bf16 and
    equal the reference's."""
    cfg = dict(num_features=12, z_size=4, hidden=(16, 16))
    jgraph = jax_mlp.build_discriminator(jax_mlp.MlpGanConfig(**cfg))
    pgraph = pt_mlp.build_discriminator(pt_mlp.MlpGanConfig(**cfg))
    rng = _rng(12)
    params = {layer: {n: rng.standard_normal(s).astype(np.float32) * 0.3 for n, s in shapes.items()}
              for layer, shapes in pgraph.param_shapes().items()}
    jopt, popt = JaxGraphOptimizer(jgraph), GraphOptimizer(pgraph)
    jparams = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    pparams = {layer: {n: torch.from_numpy(a).to(BF16) for n, a in lp.items()} for layer, lp in params.items()}
    keys = popt.trainable_keys(pparams)
    g = {layer: {} for layer, _ in keys}
    for layer, name in keys:
        g[layer][name] = rng.standard_normal(params[layer][name].shape).astype(np.float32)
    jgrads = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), g)
    pgrads = {layer: {n: torch.from_numpy(a).to(BF16) for n, a in lp.items()} for layer, lp in g.items()}
    scale = 0.7  # 0.69921875 in bf16
    jnew, jstate = jax.jit(lambda p, gr, s: jopt.step(p, gr, s, lr_scale=scale))(
        jparams, jgrads, jopt.init(jparams))
    pnew, pstate = popt.step(pparams, pgrads, popt.init(pparams), lr_scale=scale)
    for layer, name in keys:
        assert _dtype(pnew[layer][name]) == _dtype(jnew[layer][name]) == "bfloat16"
        assert _dtype(pstate[layer][name]["cache"]) == "bfloat16"
        assert_bf16_close(pnew[layer][name], jnew[layer][name], what=f"{layer}/{name}")
