"""PyTorch port, ops layer: every op of the serving slice against its JAX
function on the same numpy inputs, at shapes that include the DCGAN-MNIST
model's (conv 5x5 s2 and s1 p2, pool 2 s1, up x2, BN on ff and cnn).

Tolerance: 1e-5 absolute and relative. Both sides compute in float32 on
the CPU; only the summation order differs (XLA's against oneDNN's), which
moves conv and GEMM outputs by about 1e-6 at these sizes.
"""

import numpy as np
import pytest
import torch

from gan_deeplearning4j_tpu.nn import preprocessors as jax_pre
from gan_deeplearning4j_tpu.ops import activations as jax_act
from gan_deeplearning4j_tpu.ops import conv as jax_conv
from gan_deeplearning4j_tpu.ops import linear as jax_linear
from gan_deeplearning4j_tpu.ops import norm as jax_norm
from gan_deeplearning4j_tpu_torch.nn import preprocessors as pt_pre
from gan_deeplearning4j_tpu_torch.nn.input_type import InputType
from gan_deeplearning4j_tpu_torch.ops import activations as pt_act
from gan_deeplearning4j_tpu_torch.ops import conv as pt_conv
from gan_deeplearning4j_tpu_torch.ops import initializers as pt_init
from gan_deeplearning4j_tpu_torch.ops import linear as pt_linear
from gan_deeplearning4j_tpu_torch.ops import norm as pt_norm

TOL = dict(rtol=1e-5, atol=1e-5)


def _rng(seed):
    return np.random.default_rng(seed)


def _close(port, ref):
    port = port.detach().numpy() if isinstance(port, torch.Tensor) else port
    ref = np.asarray(ref)
    assert port.shape == ref.shape
    np.testing.assert_allclose(port, ref, **TOL)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("name", ["identity", "linear", "tanh", "sigmoid", "softmax",
                                  "relu", "leakyrelu", "leaky_relu", "elu"])
def test_activation_matches_jax(name):
    x = _rng(1).standard_normal((4, 10)).astype(np.float32) * 3
    _close(pt_act.get(name)(_t(x)), jax_act.get(name)(x))


def test_activation_registry_errors_and_leaky_slope():
    with pytest.raises(KeyError, match="known"):
        pt_act.get("bogus")
    x = np.array([-1.0, 2.0], np.float32)
    # the reference's slope, not torch's 0.01
    _close(pt_act.leaky_relu(_t(x)), np.array([-0.2, 2.0], np.float32))


@pytest.mark.parametrize("batch,n_in,n_out", [(4, 2, 1024), (4, 1024, 6272), (3, 1152, 1024),
                                              (5, 1024, 10), (1, 1024, 1)])
def test_dense_matches_jax(batch, n_in, n_out):
    rng = _rng(n_in + n_out)
    x = rng.standard_normal((batch, n_in)).astype(np.float32)
    w = (rng.standard_normal((n_in, n_out)) / np.sqrt(n_in)).astype(np.float32)
    b = rng.standard_normal(n_out).astype(np.float32)
    _close(pt_linear.dense(_t(x), _t(w), _t(b)), jax_linear.dense(x, w, b))
    _close(pt_linear.dense(_t(x), _t(w)), jax_linear.dense(x, w))


# (h, w, c_in, c_out, kernel, stride, padding): the model's four convs + an
# asymmetric case
CONV_CASES = [
    (28, 28, 1, 64, 5, 2, 0),       # dis_conv2d_layer_2
    (11, 11, 64, 128, 5, 2, 0),     # dis_conv2d_layer_4
    (14, 14, 128, 64, 5, 1, 2),     # gen_conv2d_6
    (28, 28, 64, 1, 5, 1, 2),       # gen_conv2d_8
    (9, 7, 3, 4, (3, 2), (2, 1), (1, 0)),
]


@pytest.mark.parametrize("h,w,cin,cout,k,s,p", CONV_CASES)
def test_conv2d_matches_jax(h, w, cin, cout, k, s, p):
    rng = _rng(h * w + cin)
    kh, kw = pt_conv._pair(k)
    x = rng.standard_normal((3, h, w, cin)).astype(np.float32)
    wt = (rng.standard_normal((kh, kw, cin, cout)) / np.sqrt(kh * kw * cin)).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    ref = jax_conv.conv2d(x, wt, b, stride=s, padding=p)
    out = pt_conv.conv2d(_t(x), _t(wt), _t(b), stride=s, padding=p)
    _close(out, ref)
    sh, sw = pt_conv._pair(s)
    ph, pw = pt_conv._pair(p)
    assert out.shape[1:3] == (pt_conv.conv_out_size(h, kh, sh, ph), pt_conv.conv_out_size(w, kw, sw, pw))
    _close(pt_conv.conv2d(_t(x), _t(wt), stride=s, padding=p), jax_conv.conv2d(x, wt, stride=s, padding=p))


@pytest.mark.parametrize("in_size,k,s,p", [(28, 5, 2, 0), (12, 2, 1, 0), (14, 5, 1, 2), (7, 3, 2, 1)])
def test_conv_out_size_matches_jax(in_size, k, s, p):
    assert pt_conv.conv_out_size(in_size, k, s, p) == jax_conv.conv_out_size(in_size, k, s, p)


@pytest.mark.parametrize("h,w,c,k,s,p", [
    (12, 12, 64, 2, 1, 0),   # dis_maxpool_layer_3
    (4, 4, 128, 2, 1, 0),    # dis_maxpool_layer_5
    (6, 5, 3, 3, 2, 1),      # padded: -inf cells never win
    (8, 8, 2, (2, 3), (2, 1), (1, 0)),
])
def test_max_pool2d_matches_jax(h, w, c, k, s, p):
    # all-negative inputs: a zero-padded pool would return 0 at the border
    x = -np.abs(_rng(h + c).standard_normal((2, h, w, c)).astype(np.float32)) - 0.5
    _close(pt_conv.max_pool2d(_t(x), kernel=k, stride=s, padding=p),
           jax_conv.max_pool2d(x, kernel=k, stride=s, padding=p))


@pytest.mark.parametrize("h,w,c,scale", [(7, 7, 128, 2), (14, 14, 64, 2), (3, 4, 2, (2, 3))])
def test_upsample2d_matches_jax(h, w, c, scale):
    x = _rng(h * c).standard_normal((2, h, w, c)).astype(np.float32)
    out = pt_conv.upsample2d(_t(x), scale=scale)
    ref = np.asarray(jax_conv.upsample2d(x, scale=scale))
    np.testing.assert_array_equal(out.numpy(), ref)  # pure data movement: exact


@pytest.mark.parametrize("shape", [(4, 2), (4, 1024), (4, 6272), (4, 28, 28, 1), (3, 7, 7, 128)])
def test_batch_norm_inference_matches_jax(shape):
    rng = _rng(sum(shape))
    n = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32) * 2 + 0.5
    gamma = rng.uniform(0.5, 1.5, n).astype(np.float32)
    beta = rng.standard_normal(n).astype(np.float32)
    mean = rng.standard_normal(n).astype(np.float32)
    # variances near zero make the eps placement (inside the sqrt) matter
    var = rng.uniform(0.0, 1e-4, n).astype(np.float32)
    ref = jax_norm.batch_norm_inference(x, gamma, beta, mean, var)
    _close(pt_norm.batch_norm_inference(_t(x), _t(gamma), _t(beta), _t(mean), _t(var)), ref)
    assert pt_norm.DEFAULT_EPS == jax_norm.DEFAULT_EPS


@pytest.mark.parametrize("case", ["ff_to_cnn", "cnn_to_ff", "flat_to_cnn"])
def test_preprocessor_flatten_orders_match_jax(case):
    rng = _rng(7)
    if case == "ff_to_cnn":
        x = rng.standard_normal((3, 7 * 7 * 128)).astype(np.float32)
        port, ref = pt_pre.FeedForwardToCnnPreProcessor(7, 7, 128), jax_pre.FeedForwardToCnnPreProcessor(7, 7, 128)
    elif case == "cnn_to_ff":
        x = rng.standard_normal((3, 3, 3, 128)).astype(np.float32)
        port, ref = pt_pre.CnnToFeedForwardPreProcessor(), jax_pre.CnnToFeedForwardPreProcessor()
    else:
        x = rng.standard_normal((3, 28 * 28 * 2)).astype(np.float32)
        port, ref = pt_pre.FlatToCnnPreProcessor(28, 28, 2), jax_pre.FlatToCnnPreProcessor(28, 28, 2)
    np.testing.assert_array_equal(port(_t(x)).numpy(), np.asarray(ref(x)))
    assert port.to_dict() == ref.to_dict()
    assert pt_pre.preprocessor_from_dict(ref.to_dict()) == port


def test_ff_to_cnn_rejects_wrong_width():
    with pytest.raises(ValueError, match="expects 6272"):
        pt_pre.FeedForwardToCnnPreProcessor(7, 7, 128).output_type(InputType.feed_forward(100))


def test_xavier_is_seeded_and_scaled():
    a = pt_init.xavier(torch.Generator().manual_seed(3), (5, 5, 64, 128))
    b = pt_init.xavier(torch.Generator().manual_seed(3), (5, 5, 64, 128))
    assert torch.equal(a, b)
    std = np.sqrt(2.0 / (25 * 64 + 25 * 128))
    assert abs(float(a.std()) - std) / std < 0.02
    with pytest.raises(KeyError, match="known"):
        pt_init.get("bogus")
