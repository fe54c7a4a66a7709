"""PyTorch port, the training ops: BatchNorm in training mode, the XENT /
MCXENT / MSE losses, gradient clipping, every updater's rule and a
max-pool backward with ties, each against its JAX function on the same
numpy inputs drawn from a seed.

Tolerance: 1e-5 absolute and relative (float32 on the CPU on both sides;
only the summation order differs). Where the arithmetic is the same
elementwise sequence, the comparison is exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_deeplearning4j_tpu.ops import clipping as jax_clip
from gan_deeplearning4j_tpu.ops import conv as jax_conv
from gan_deeplearning4j_tpu.ops import losses as jax_losses
from gan_deeplearning4j_tpu.ops import norm as jax_norm
from gan_deeplearning4j_tpu.optim import updaters as jax_upd
from gan_deeplearning4j_tpu_torch.ops import clipping as pt_clip
from gan_deeplearning4j_tpu_torch.ops import conv as pt_conv
from gan_deeplearning4j_tpu_torch.ops import losses as pt_losses
from gan_deeplearning4j_tpu_torch.ops import norm as pt_norm
from gan_deeplearning4j_tpu_torch.optim import updaters as pt_upd

TOL = dict(rtol=1e-5, atol=1e-5)


def _rng(seed):
    return np.random.default_rng(seed)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a, dtype=np.float32)).requires_grad_(grad)


def _close(port, ref, **tol):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape
    np.testing.assert_allclose(port, ref, **(tol or TOL))


# -- batch_norm_train ---------------------------------------------------------

@pytest.mark.parametrize("shape,var_scale", [
    ((8, 2), 1.0),            # gen_batch_1 on z
    ((8, 6272), 1.0),         # gen_batch_4
    ((8, 28, 28, 1), 1.0),    # dis_batch_layer_1 after flat→cnn
    ((5, 7, 7, 3), 3e-3),     # batch variance ≈ eps: eps placement matters
])
def test_batch_norm_train_matches_jax_values_and_grads(shape, var_scale):
    rng = _rng(sum(shape))
    n = shape[-1]
    # centred when the variance is tiny, so that x − mean stays well conditioned
    x = (rng.standard_normal(shape) * var_scale + (0.3 if var_scale == 1.0 else 0.0)).astype(np.float32)
    gamma = rng.uniform(0.5, 1.5, n).astype(np.float32)
    beta = rng.standard_normal(n).astype(np.float32)
    rmean = rng.standard_normal(n).astype(np.float32)
    rvar = rng.uniform(0.5, 1.5, n).astype(np.float32)
    cot = rng.standard_normal(shape).astype(np.float32)

    def jax_fn(x, g, b):
        y, m, v = jax_norm.batch_norm_train(x, g, b, rmean, rvar)
        return jnp.sum(y * cot), (y, m, v)

    (_, (y, m, v)), grads = jax.value_and_grad(jax_fn, argnums=(0, 1, 2), has_aux=True)(x, gamma, beta)
    tx, tg, tb = _t(x, True), _t(gamma, True), _t(beta, True)
    py, pm, pv = pt_norm.batch_norm_train(tx, tg, tb, _t(rmean), _t(rvar))
    pgrads = torch.autograd.grad(torch.sum(py * _t(cot)), (tx, tg, tb))
    _close(py, y)
    _close(pm, m)
    _close(pv, v)
    assert not pm.requires_grad and not pv.requires_grad  # outside autograd
    for pg, jg in zip(pgrads, grads):
        _close(pg, jg)


def test_batch_norm_train_keeps_running_stat_dtype_and_population_variance():
    x = torch.tensor([[1.0], [3.0]])
    ones = torch.ones(1)
    rm = torch.zeros(1, dtype=torch.bfloat16)
    rv = torch.ones(1, dtype=torch.bfloat16)
    _, m, v = pt_norm.batch_norm_train(x, ones, torch.zeros(1), rm, rv)
    assert m.dtype == torch.bfloat16 and v.dtype == torch.bfloat16
    # population variance of {1, 3} is 1 (unbiased would be 2): 0.9 + 0.1·1
    assert float(v) == pytest.approx(1.0, abs=1e-2)
    _, _, v32 = pt_norm.batch_norm_train(x, ones, torch.zeros(1), torch.zeros(1), torch.ones(1))
    assert float(v32) == pytest.approx(0.9 * 1.0 + 0.1 * 1.0, abs=1e-7)


# -- losses -------------------------------------------------------------------

_EPS = np.float32(1e-5)


@pytest.mark.parametrize("name", ["binary_xent", "categorical_xent", "mse"])
@pytest.mark.parametrize("probs_kind", ["interior", "saturated", "on_the_clip_bounds"])
def test_losses_match_jax_values_and_grads(name, probs_kind):
    rng = _rng(7)
    if probs_kind == "interior":
        p = rng.uniform(0.05, 0.95, (6, 10)).astype(np.float32)
    elif probs_kind == "saturated":
        p = rng.choice(np.array([0.0, 1.0], np.float32), (6, 10))
    else:  # exactly on 1e-5 and 1-1e-5: the clip's tie rule decides the grad
        p = rng.choice(np.array([_EPS, np.float32(1.0) - _EPS, 0.5], np.float32), (6, 10))
    if name == "categorical_xent":
        labels = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 6)]
    else:
        labels = rng.uniform(-0.1, 1.1, (6, 10)).astype(np.float32)
    jv, jg = jax.value_and_grad(lambda q: jax_losses.get(name)(q, labels))(p)
    tp = _t(p, True)
    pv = pt_losses.get(name)(tp, _t(labels))
    (pg,) = torch.autograd.grad(pv, tp)
    _close(pv, jv)
    _close(pg, jg)


def test_binary_xent_on_a_1d_output_and_unported_losses():
    p = np.array([0.2, 0.7, 1.0], np.float32)
    y = np.array([1.0, 0.0, 1.0], np.float32)
    _close(pt_losses.binary_xent(_t(p), _t(y)), jax_losses.binary_xent(p, y))
    # the WGAN-GP loss runs now (tests/test_torch_family_ops.py)
    _close(pt_losses.get("wasserstein")(_t(p), _t(2 * y - 1)), jax_losses.wasserstein(p, 2 * y - 1))
    with pytest.raises(KeyError, match="known"):
        pt_losses.get("bogus")


# -- clipping -----------------------------------------------------------------

def _tree(seed):
    rng = _rng(seed)
    return {
        "a": {"W": (rng.standard_normal((5, 4)) * 3).astype(np.float32),
              "b": (rng.standard_normal(4) * 0.5).astype(np.float32)},
        "c": {"W": np.array([1.0, -1.0, 1.5, -0.999], np.float32)},
    }


@pytest.mark.parametrize("fn,arg", [("clip_elementwise", 1.0), ("clip_by_global_norm", 1.0),
                                    ("clip_by_global_norm", 100.0)])
def test_clipping_matches_jax(fn, arg):
    tree = _tree(3)
    ref = getattr(jax_clip, fn)(tree, arg)
    out = getattr(pt_clip, fn)({k: {n: _t(a) for n, a in v.items()} for k, v in tree.items()}, arg)
    for layer in tree:
        for name in tree[layer]:
            _close(out[layer][name], ref[layer][name])


# -- updaters -----------------------------------------------------------------

_UPDATERS = [
    ("rmsprop_reference", lambda m: m.RmsProp(0.002, 1e-8, 1e-8)),
    ("rmsprop_frozen", lambda m: m.RmsProp(0.0, 1e-8, 1e-8)),
    ("rmsprop_default", lambda m: m.RmsProp()),
    ("adam", lambda m: m.Adam(0.01)),
    ("sgd", lambda m: m.Sgd(0.1)),
    ("noop", lambda m: m.NoOp()),
]


@pytest.mark.parametrize("name,make", _UPDATERS, ids=[u[0] for u in _UPDATERS])
def test_updater_apply_matches_jax_over_three_steps(name, make):
    rng = _rng(11)
    param = rng.standard_normal((6, 5)).astype(np.float32)
    grads = [np.clip(rng.standard_normal((6, 5)) * s, -1, 1).astype(np.float32)
             for s in (1.0, 1e-3, 1e-6)]  # incl. |g| ≪ 1e-4, where eps matters
    jspec, pspec = make(jax_upd), make(pt_upd)
    assert jspec.to_dict() == pspec.to_dict()
    js, ps = jspec.init_state(param), pspec.init_state(_t(param))
    jp, pp = param, _t(param)
    for g in grads:
        jd, js = jspec.apply(js, g, jp)
        pd, ps = pspec.apply(ps, _t(g), pp)
        _close(pd, jd)
        jp, pp = jp - jd, pp - pd
        assert set(ps) == set(js)
        for slot in js:
            if slot == "t":
                assert ps["t"].dtype == torch.int32 and int(ps["t"]) == int(js["t"])
            else:
                _close(ps[slot], js[slot])
    _close(pp, jp)
    if name == "rmsprop_frozen":
        # LR 0 freezes the param, but the cache still advances (≈ g² here)
        np.testing.assert_array_equal(pp.numpy(), param)
        assert not np.array_equal(ps["cache"].numpy(), np.full_like(param, 1e-8))


def test_rmsprop_one_minus_decay_rounds_to_one_in_fp32():
    spec = pt_upd.RmsProp(0.002, 1e-8, 1e-8)
    g = torch.tensor([0.5, -0.25])
    delta, state = spec.apply(spec.init_state(g), g, torch.zeros(2))
    # cache = 1e-8·1e-8 + g²·(1 − 1e-8) and 1 − 1e-8 is 1.0 in fp32
    np.testing.assert_array_equal(state["cache"].numpy(), np.float32([0.25, 0.0625]) + np.float32(1e-16))
    np.testing.assert_allclose(delta.numpy(), [0.002, -0.002], rtol=1e-6)


# -- max pooling backward with ties ---------------------------------------------

@pytest.mark.parametrize("h,w,c,k,s", [(12, 12, 64, 2, 1), (4, 4, 128, 2, 1), (6, 6, 3, 3, 2)])
def test_max_pool2d_backward_with_ties_matches_jax(h, w, c, k, s):
    """Inputs from a 3-value set tie in most windows. XLA's
    select-and-scatter gives a window's whole gradient to its first
    maximum in row-major order; ATen's max_pool2d (its argmax keeps the
    first strict maximum) must route it to the same element."""
    rng = _rng(h * c)
    x = rng.choice(np.array([-1.0, 0.0, 1.0], np.float32), (2, h, w, c))
    cot = rng.standard_normal(jax_conv.max_pool2d(x, kernel=k, stride=s).shape).astype(np.float32)
    jg = jax.grad(lambda a: jnp.sum(jax_conv.max_pool2d(a, kernel=k, stride=s) * cot))(x)
    tx = _t(x, True)
    (pg,) = torch.autograd.grad(torch.sum(pt_conv.max_pool2d(tx, kernel=k, stride=s) * _t(cot)), tx)
    np.testing.assert_array_equal(pg.numpy(), np.asarray(jg))
