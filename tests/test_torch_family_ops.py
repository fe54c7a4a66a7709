"""PyTorch port, the ops and layers of the tabular, image and WGAN-GP
families against the JAX package on the same numpy inputs drawn from a
seed: the transposed convolution (values and both gradients; the kernel's
spatial flip), average pooling with padding, the Wasserstein loss, the
gradient penalty and its gradient in a critic's params (a gradient of a
gradient), the four new layers' shapes and ``topology.json`` round trip,
and dropout.

Tolerance: 1e-5 absolute and relative (float32 on the CPU on both sides;
only the summation order differs).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_deeplearning4j_tpu.models import wgan_gp as jax_wgan
from gan_deeplearning4j_tpu.nn import layers as jax_layers
from gan_deeplearning4j_tpu.nn.input_type import InputType as JaxInputType
from gan_deeplearning4j_tpu.ops import conv as jax_conv
from gan_deeplearning4j_tpu.ops import losses as jax_losses
from gan_deeplearning4j_tpu_torch.interop import params_from_numpy
from gan_deeplearning4j_tpu_torch.models import wgan_gp as pt_wgan
from gan_deeplearning4j_tpu_torch.nn import GraphBuilder, GraphConfig
from gan_deeplearning4j_tpu_torch.nn import layers as pt_layers
from gan_deeplearning4j_tpu_torch.nn.input_type import InputType
from gan_deeplearning4j_tpu_torch.ops import conv as pt_conv
from gan_deeplearning4j_tpu_torch.ops import losses as pt_losses

TOL = dict(rtol=1e-5, atol=1e-5)


def _rng(seed):
    return np.random.default_rng(seed)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a, dtype=np.float32)).requires_grad_(grad)


def _close(port, ref):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape
    np.testing.assert_allclose(port, ref, **TOL)


# -- conv2d_transpose -----------------------------------------------------------

@pytest.mark.parametrize("x_shape,k,s,p,c_out", [
    ((2, 4, 4, 8), 4, 2, 1, 5),    # the generators' k4 s2 p1 (exactly ×2)
    ((2, 5, 5, 3), 3, 1, 0, 4),
    ((1, 4, 4, 6), 5, 2, 2, 3),
    ((2, 3, 6, 4), 4, 2, 1, 2),    # non-square
    ((1, 5, 2, 3), 3, 2, 0, 2),    # non-square, odd output
])
def test_conv2d_transpose_matches_jax_values_and_grads(x_shape, k, s, p, c_out):
    rng = _rng(sum(x_shape) + k)
    x = rng.standard_normal(x_shape).astype(np.float32)
    w = rng.standard_normal((k, k, x_shape[3], c_out)).astype(np.float32)
    b = rng.standard_normal(c_out).astype(np.float32)
    jy = jax_conv.conv2d_transpose(x, w, b, stride=s, padding=p)
    assert jy.shape[1:3] == ((x_shape[1] - 1) * s - 2 * p + k, (x_shape[2] - 1) * s - 2 * p + k)
    cot = rng.standard_normal(jy.shape).astype(np.float32)
    jgx, jgw = jax.grad(
        lambda a, v: jnp.sum(jax_conv.conv2d_transpose(a, v, b, stride=s, padding=p) * cot),
        argnums=(0, 1))(x, w)
    tx, tw = _t(x, True), _t(w, True)
    ty = pt_conv.conv2d_transpose(tx, tw, _t(b), stride=s, padding=p)
    _close(ty, jy)
    gx, gw = torch.autograd.grad(torch.sum(ty * _t(cot)), (tx, tw))
    _close(gx, jgx)
    _close(gw, jgw)


def test_conv2d_transpose_needs_the_kernel_flip():
    """The trap: without the spatial flip, ``F.conv_transpose2d`` on the
    stored kernel computes another function (a gap of order 10 here)."""
    rng = _rng(7)
    x = rng.standard_normal((2, 4, 4, 8)).astype(np.float32)
    w = rng.standard_normal((4, 4, 8, 5)).astype(np.float32)
    want = np.asarray(jax_conv.conv2d_transpose(x, w, None, stride=2, padding=1))
    unflipped = torch.nn.functional.conv_transpose2d(
        _t(x).permute(0, 3, 1, 2), _t(w).permute(2, 3, 0, 1), stride=2, padding=1
    ).permute(0, 2, 3, 1).numpy()
    assert np.abs(unflipped - want).max() > 1.0
    _close(pt_conv.conv2d_transpose(_t(x), _t(w), stride=2, padding=1), want)


# -- avg_pool2d -----------------------------------------------------------------

@pytest.mark.parametrize("shape,k,s,p", [
    ((2, 6, 6, 3), 2, 2, 0),
    ((2, 5, 7, 2), 3, 2, 1),   # padded: the divisor counts real cells only
    ((1, 4, 4, 4), 3, 1, 1),
    ((2, 6, 5, 1), 2, 1, 0),
])
def test_avg_pool2d_matches_jax_values_and_grads(shape, k, s, p):
    rng = _rng(sum(shape) + 10 * p)
    x = rng.standard_normal(shape).astype(np.float32)
    jy = jax_conv.avg_pool2d(x, kernel=k, stride=s, padding=p)
    cot = rng.standard_normal(jy.shape).astype(np.float32)
    jg = jax.grad(lambda a: jnp.sum(jax_conv.avg_pool2d(a, kernel=k, stride=s, padding=p) * cot))(x)
    tx = _t(x, True)
    ty = pt_conv.avg_pool2d(tx, kernel=k, stride=s, padding=p)
    _close(ty, jy)
    (gx,) = torch.autograd.grad(torch.sum(ty * _t(cot)), tx)
    _close(gx, jg)
    if p:  # the corner window holds fewer real cells than k²
        assert not np.allclose(
            torch.nn.functional.avg_pool2d(_t(x).permute(0, 3, 1, 2), k, s, p).permute(0, 2, 3, 1).numpy(),
            np.asarray(jy))


# -- wasserstein and gradient_penalty ------------------------------------------

def test_wasserstein_matches_jax_value_and_grad():
    rng = _rng(3)
    scores = rng.standard_normal((6, 1)).astype(np.float32)
    labels = np.where(rng.random((6, 1)) < 0.5, 1.0, -1.0).astype(np.float32)
    jv, jg = jax.value_and_grad(lambda a: jax_losses.wasserstein(a, labels))(scores)
    ts = _t(scores, True)
    pv = pt_losses.get("wasserstein")(ts, _t(labels))
    _close(pv, jv)
    _close(torch.autograd.grad(pv, ts)[0], jg)


def _tiny_critics(seed):
    """The WGAN-GP critic at 8×8×2, base 4, dense 8, in both packages, with
    the JAX params carried into the port."""
    jcfg = jax_wgan.WganGpConfig(height=8, width=8, channels=2, base_filters=4, dense_width=8)
    pcfg = pt_wgan.WganGpConfig(height=8, width=8, channels=2, base_filters=4, dense_width=8)
    jcritic, pcritic = jax_wgan.build_critic(jcfg), pt_wgan.build_critic(pcfg)
    jparams = jcritic.init(seed)
    pparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu", graph=pcritic)
    return jcritic, jparams, pcritic, pparams


def test_gradient_penalty_and_its_param_gradient_match_jax():
    """The penalty at the same ε, and its gradient in every critic param:
    ``autograd.grad`` through ``create_graph=True`` against ``jax.grad``
    over ``jax.grad``."""
    jcritic, jparams, pcritic, pparams = _tiny_critics(1)
    rng = _rng(4)
    real = rng.random((5, 128), dtype=np.float32)
    fake = rng.random((5, 128), dtype=np.float32)
    key = jax.random.PRNGKey(9)
    eps = np.asarray(jax.random.uniform(key, (5, 1), jnp.float32))

    def jgp(p):
        return jax_losses.gradient_penalty(lambda x: jcritic.output(p, x)[:, 0], real, fake, key)

    jv, jg = jax.value_and_grad(jgp)(jparams)
    leaves = [(layer, name) for layer in pparams for name in pparams[layer]]
    for layer, name in leaves:
        pparams[layer][name].requires_grad_(True)
    pv = pt_losses.gradient_penalty(
        lambda x: pcritic.output(pparams, x)[:, 0], _t(real), _t(fake), _t(eps))
    # the score's bias never reaches the input gradient: no gradient (zero in JAX)
    pg = torch.autograd.grad(pv, [pparams[l][n] for l, n in leaves], allow_unused=True)
    _close(pv, jv)
    assert float(pv.detach()) > 0.0
    assert [k for k, g in zip(leaves, pg) if g is None] == [("critic_score", "b")]
    for (layer, name), g in zip(leaves, pg):
        g = torch.zeros_like(pparams[layer][name]) if g is None else g
        np.testing.assert_allclose(g.numpy(), np.asarray(jg[layer][name]),
                                   err_msg=f"{layer}/{name}", **TOL)


def test_gradient_penalty_at_a_zero_input_gradient_has_no_nan():
    """At a zero input gradient the norm's derivative is 0/0; with the
    1e-12 inside the square root it is 0 and the penalty (1e-6 − 1)², as
    in JAX."""
    rng = _rng(5)
    real, fake = rng.random((4, 6), dtype=np.float32), rng.random((4, 6), dtype=np.float32)
    eps = rng.random((4, 1), dtype=np.float32)
    w = torch.zeros(6, requires_grad=True)  # the critic x·w has input gradient w = 0
    pv = pt_losses.gradient_penalty(lambda x: x @ w, _t(real), _t(fake), _t(eps))
    (gw,) = torch.autograd.grad(pv, w)
    key = jax.random.PRNGKey(0)
    jv, jg = jax.value_and_grad(
        lambda v: jax_losses.gradient_penalty(lambda x: x @ v, real, fake, key))(np.zeros(6, np.float32))
    _close(pv, jv)
    _close(gw, jg)
    assert torch.isfinite(gw).all()
    # a critic that does not read its input at all: zero gradient, same penalty
    pv = pt_losses.gradient_penalty(lambda x: w.sum().expand(4), _t(real), _t(fake), _t(eps))
    _close(pv, jv)


def test_gradient_penalty_under_no_grad_still_differentiates_the_critic():
    jcritic, jparams, pcritic, pparams = _tiny_critics(2)
    rng = _rng(6)
    real, fake = rng.random((3, 128), dtype=np.float32), rng.random((3, 128), dtype=np.float32)
    eps = rng.random((3, 1), dtype=np.float32)
    with torch.no_grad():
        pv = pt_losses.gradient_penalty(
            lambda x: pcritic.output(pparams, x)[:, 0], _t(real), _t(fake), _t(eps))
    # the JAX function draws ε itself: rebuild its formula at this ε
    x_hat = eps * real + (1.0 - eps) * fake
    g = jax.grad(lambda x: jnp.sum(jcritic.output(jparams, x)[:, 0]))(x_hat)
    want = np.mean((np.sqrt(np.sum(np.asarray(g) ** 2, axis=1) + 1e-12) - 1.0) ** 2)
    np.testing.assert_allclose(float(pv.detach()), want, **TOL)


# -- the new layers ---------------------------------------------------------------

_NEW_LAYERS = [
    (pt_layers.Deconvolution2D(kernel=4, stride=2, padding=1, n_in=8, n_out=5),
     jax_layers.Deconvolution2D(kernel=4, stride=2, padding=1, n_in=8, n_out=5)),
    (pt_layers.Deconvolution2D(kernel=(3, 5), stride=(1, 2), padding=(0, 2), n_out=3),
     jax_layers.Deconvolution2D(kernel=(3, 5), stride=(1, 2), padding=(0, 2), n_out=3)),
    (pt_layers.SubsamplingLayer(pool="avg", kernel=3, stride=2, padding=1),
     jax_layers.SubsamplingLayer(pool="avg", kernel=3, stride=2, padding=1)),
    (pt_layers.LossLayer(activation="identity", loss="wasserstein"),
     jax_layers.LossLayer(activation="identity", loss="wasserstein")),
    (pt_layers.DropoutLayer(rate=0.3), jax_layers.DropoutLayer(rate=0.3)),
]


@pytest.mark.parametrize("pt_layer,jax_layer", _NEW_LAYERS, ids=lambda l: type(l).__name__)
def test_new_layers_round_trip_and_output_types_match_jax(pt_layer, jax_layer):
    doc = pt_layer.to_dict()
    assert doc == jax_layer.to_dict()
    assert pt_layers.layer_from_dict(jax_layer.to_dict()) == pt_layer
    assert jax_layers.layer_from_dict(doc) == jax_layer
    for h, w, c in ((4, 4, 8), (5, 7, 8)):
        pt_in, jax_in = InputType.convolutional(h, w, c), JaxInputType.convolutional(h, w, c)
        assert pt_layer.output_type(pt_in).to_dict() == jax_layer.output_type(jax_in).to_dict()
        if pt_layer.has_params():
            jparams = jax_layer.init(jax.random.PRNGKey(0), jax_in)
            assert pt_layer.param_shapes(pt_in) == {k: tuple(v.shape) for k, v in jparams.items()}
            assert pt_layer.param_roles() == jax_layer.param_roles()


@pytest.mark.parametrize("pt_layer,jax_layer", _NEW_LAYERS[:4], ids=lambda l: type(l).__name__)
def test_new_layers_apply_matches_jax(pt_layer, jax_layer):
    rng = _rng(11)
    x = rng.standard_normal((2, 4, 4, 8)).astype(np.float32)
    jax_in = JaxInputType.convolutional(4, 4, 8)
    jparams = jax_layer.init(jax.random.PRNGKey(1), jax_in)
    pparams = {k: _t(np.asarray(v)) for k, v in jparams.items()}
    jy, _ = jax_layer.apply(jparams, x, train=True)
    py, upd = pt_layer.apply(pparams, _t(x), train=True)
    assert upd is None
    _close(py, jy)


def test_dropout_is_identity_in_inference_and_scales_what_it_keeps():
    layer = pt_layers.DropoutLayer(rate=0.25)
    x = _t(_rng(12).uniform(0.5, 1.5, (64, 32)))
    assert layer.apply({}, x, train=False)[0] is x
    assert pt_layers.DropoutLayer(rate=0.0).apply({}, x, train=True)[0] is x
    with pytest.raises(ValueError, match="Generator"):
        layer.apply({}, x, train=True)
    y, _ = layer.apply({}, x, train=True, generator=torch.Generator().manual_seed(0))
    kept = y != 0
    torch.testing.assert_close(y[kept], x[kept] / 0.75, rtol=0, atol=0)
    assert 0.65 < float(kept.float().mean()) < 0.85
    again, _ = layer.apply({}, x, train=True, generator=torch.Generator().manual_seed(0))
    assert torch.equal(y, again)  # the mask is the generator's


def test_graph_threads_the_dropout_generator_and_loss_layers():
    b = GraphBuilder(GraphConfig(seed=3))
    b.add_inputs("x").set_input_types(InputType.feed_forward(6))
    b.add_layer("d", pt_layers.DenseLayer(n_out=4), "x")
    b.add_layer("drop", pt_layers.DropoutLayer(rate=0.5), "d")
    b.add_layer("loss", pt_layers.LossLayer(activation="identity", loss="mse"), "drop")
    graph = b.set_outputs("loss").build()
    assert [v.name for v in graph.output_layers()] == ["loss"]
    params = graph.init(device="cpu")
    x = _t(_rng(13).standard_normal((5, 6)))
    y = torch.zeros((5, 4))
    with pytest.raises(ValueError, match="Generator"):
        graph.loss(params, x, y)
    loss_a, _ = graph.loss(params, x, y, generator=torch.Generator().manual_seed(1))
    loss_b, _ = graph.loss(params, x, y, generator=torch.Generator().manual_seed(1))
    assert float(loss_a) == float(loss_b)
    inference, _ = graph.loss(params, x, y, train=False)
    want = pt_losses.mse(graph.feed_forward(params, x)["d"], y)
    assert float(inference) == float(want)
