"""PyTorch port, the runtime surface: the JAX package's key stream computed on
the host (``runtime/threefry.py``), ``RngStream``, the array factory and
the seven weight initializers, against the JAX package on the CPU.

Tolerances:
- keys, ``split``, ``bits`` and ``uniform`` (float32 and bfloat16):
  bit-equal to jax;
- ``normal`` in float32: 1e-6 relative, elementwise (the port evaluates
  XLA's erfinv polynomial in numpy; ``log1p`` differs by an ulp);
  bfloat16: equal;
- ``RngStream`` keys: bit-equal through ``next_key``, ``next_keys``,
  ``fork`` and ``reset``;
- the factory: value for value under the float32 and the bfloat16 default
  dtype, ``randn`` in float32 to 1e-6 relative;
- initializers: the two packages draw from different generators, so
  ``zeros`` / ``ones`` are compared for equality, ``xavier_uniform`` by
  its bounds, and the Gaussian ones by their std at 256×512 (within 2%).

Run with ``JAX_PLATFORMS=cpu``.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gan_deeplearning4j_tpu.models import registry as jax_registry
from gan_deeplearning4j_tpu.nn import DenseLayer as JaxDense
from gan_deeplearning4j_tpu.nn import GraphBuilder as JaxBuilder
from gan_deeplearning4j_tpu.nn import GraphConfig as JaxConfig
from gan_deeplearning4j_tpu.nn import InputType as JaxInputType
from gan_deeplearning4j_tpu.nn import OutputLayer as JaxOutput
from gan_deeplearning4j_tpu.ops import initializers as jax_init
from gan_deeplearning4j_tpu.runtime import factory as jax_factory
from gan_deeplearning4j_tpu.runtime.dtype import default_dtype_scope as jax_dtype_scope
from gan_deeplearning4j_tpu.runtime.prng import RngStream as JaxStream
import gan_deeplearning4j_tpu_torch as port
from gan_deeplearning4j_tpu_torch.models import registry as pt_registry
from gan_deeplearning4j_tpu_torch.nn import DenseLayer as PtDense
from gan_deeplearning4j_tpu_torch.nn import GraphBuilder as PtBuilder
from gan_deeplearning4j_tpu_torch.nn import GraphConfig as PtConfig
from gan_deeplearning4j_tpu_torch.nn import InputType as PtInputType
from gan_deeplearning4j_tpu_torch.nn import OutputLayer as PtOutput
from gan_deeplearning4j_tpu_torch.ops import initializers as pt_init
from gan_deeplearning4j_tpu_torch.runtime import RngStream, factory, threefry
from gan_deeplearning4j_tpu_torch.runtime.dtype import default_dtype_scope as pt_dtype_scope

SEEDS = [0, 666, 2**40 + 3, -1]
INIT_NAMES = ["xavier", "xavier_uniform", "he", "he_normal", "normal", "zeros", "ones"]


def _jax_host(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x, jnp.float32))


# -- threefry ---------------------------------------------------------------------

@pytest.mark.parametrize("seed", SEEDS)
def test_keys_split_and_bits_are_jax_bit_for_bit(seed):
    key = jax.random.PRNGKey(seed)
    mine = threefry.PRNGKey(seed)
    assert mine.dtype == np.uint32 and mine.shape == (2,)
    np.testing.assert_array_equal(mine, np.asarray(jax.random.key_data(key)))
    for n in (2, 3, 7):
        np.testing.assert_array_equal(threefry.split(mine, n), np.asarray(jax.random.split(key, n)))
    for shape in ((5, 5, 1, 32), (3,), (2, 129)):
        np.testing.assert_array_equal(threefry.bits(mine, shape),
                                      np.asarray(jax.random.bits(key, shape)))


def test_a_seed_outside_int64_raises_as_in_jax():
    with pytest.raises(OverflowError):
        jax.random.PRNGKey(2**64)
    with pytest.raises(OverflowError):
        threefry.PRNGKey(2**64)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bounds", [(0.0, 1.0), (-1.0, 1.0), (-0.3, 0.7)])
@pytest.mark.parametrize("seed", [666, -1])
def test_uniform_is_jax_bit_for_bit(seed, bounds, dtype):
    lo, hi = bounds
    ref = _jax_host(jax.random.uniform(jax.random.PRNGKey(seed), (4096,), jnp.dtype(dtype), lo, hi))
    mine = threefry.uniform(threefry.PRNGKey(seed), (4096,), dtype, lo, hi)
    assert mine.dtype == np.float32
    np.testing.assert_array_equal(mine.view(np.uint32), ref.view(np.uint32))


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_is_within_1e6_of_jax(seed):
    key = jax.random.PRNGKey(seed)
    ref = np.asarray(jax.random.normal(key, (16384,), jnp.float32))
    mine = threefry.normal(threefry.PRNGKey(seed), (16384,), "float32")
    rel = np.abs(mine - ref) / np.abs(ref)
    assert rel.max() <= 1e-6, rel.max()
    # bfloat16 rounds the float32 polynomial's last bits away
    ref16 = _jax_host(jax.random.normal(key, (4096,), jnp.bfloat16))
    np.testing.assert_array_equal(threefry.normal(threefry.PRNGKey(seed), (4096,), "bfloat16"), ref16)


def test_erfinv_is_xla_s_polynomial_not_an_accurate_erfinv():
    """The trap: an accurate erfinv (torch's) differs from jax's by more
    than the normal draw's 1e-6 bound in the tails."""
    u = threefry.uniform(threefry.PRNGKey(0), (1 << 16,), "float32",
                         np.nextafter(np.float32(-1), np.float32(0)), 1.0)
    ref = np.asarray(jax.lax.erf_inv(jnp.asarray(u)))
    accurate = torch.special.erfinv(torch.from_numpy(u)).numpy()
    assert (np.abs(accurate - ref) / np.abs(ref)).max() > 1e-6
    assert (np.abs(threefry.erfinv(u) - ref) / np.abs(ref)).max() <= 1e-6
    np.testing.assert_array_equal(threefry.erfinv(np.float32([1.0, -1.0])), [np.inf, -np.inf])


# -- RngStream --------------------------------------------------------------------

def _walk(stream):
    """A fixed sequence of stream operations; every key it sees."""
    out = [stream.next_key(), *stream.next_keys(3)]
    child = stream.fork()
    out += [child.next_key(), stream.next_key(), *child.next_keys(2)]
    child.reset()
    out += [child.next_key()]
    stream.reset()
    out += [stream.next_key(), *stream.next_keys(1)]
    return [np.asarray(jax.random.key_data(k)) if not isinstance(k, np.ndarray) else k for k in out]


@pytest.mark.parametrize("seed", [666, 1, 2**40 + 3])
def test_rng_stream_keys_are_the_jax_stream_s(seed):
    mine, ref = _walk(RngStream(seed)), _walk(JaxStream(seed))
    assert len(mine) == len(ref) == 11
    for a, b in zip(mine, ref):
        assert a.dtype == np.uint32 and a.shape == (2,)
        np.testing.assert_array_equal(a, b)
    assert RngStream(seed).seed == seed


# -- the factory ------------------------------------------------------------------

DTYPES = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16)]


@pytest.mark.parametrize("dtypes", DTYPES, ids=["fp32", "bf16"])
@pytest.mark.parametrize("fn", ["randn", "rand", "uniform_latent"])
def test_random_factories_match_jax(fn, dtypes):
    jax_dt, pt_dt = dtypes
    with jax_dtype_scope(jax_dt), pt_dtype_scope(pt_dt):
        jax_stream, stream = JaxStream(666), RngStream(666)
        for shape in ((64, 8), ((3, 5),)):
            ref = getattr(jax_factory, fn)(jax_stream, *shape)
            mine = getattr(factory, fn)(stream, *shape, device="cpu")
            assert mine.dtype == pt_dt and tuple(mine.shape) == tuple(ref.shape)
            got, want = factory.to_host(mine), _jax_host(ref)
            if fn == "randn" and pt_dt == torch.float32:
                np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
            else:
                np.testing.assert_array_equal(got, want)
        # a key works as well as a stream
        key = threefry.PRNGKey(3)
        np.testing.assert_array_equal(
            factory.to_host(getattr(factory, "rand")(key, 4, device="cpu")),
            _jax_host(jax_factory.rand(jax.random.PRNGKey(3), 4)))


@pytest.mark.parametrize("dtypes", DTYPES, ids=["fp32", "bf16"])
def test_deterministic_factories_match_jax(dtypes):
    jax_dt, pt_dt = dtypes
    with jax_dtype_scope(jax_dt), pt_dtype_scope(pt_dt):
        for args in ((-1.0, 1.0, 7), (-1.0, 1.0, 10), (0.3, 2.7, 13), (-2.5, 0.7, 33),
                     (1.3, -0.4, 9), (0.0, 1.0, 1), (0.0, 1.0, 0)):
            mine = factory.linspace(*args, device="cpu")
            assert mine.dtype == pt_dt
            np.testing.assert_array_equal(factory.to_host(mine), _jax_host(jax_factory.linspace(*args)))
        for side in (2, 10, 28):
            np.testing.assert_array_equal(factory.to_host(factory.latent_grid(side, device="cpu")),
                                          _jax_host(jax_factory.latent_grid(side)))
        for fn in ("ones", "zeros"):
            mine = getattr(factory, fn)(2, 3, device="cpu")
            assert mine.dtype == pt_dt
            np.testing.assert_array_equal(factory.to_host(mine), _jax_host(getattr(jax_factory, fn)(2, 3)))
        data = [[1.5, 2.0], [3.25, -4.0]]
        np.testing.assert_array_equal(factory.to_host(factory.create(data, device="cpu")),
                                      _jax_host(jax_factory.create(data)))
        stacked = factory.vstack([factory.ones(2, 3, device="cpu"), factory.zeros(3, device="cpu")])
        ref = jax_factory.vstack([jax_factory.ones(2, 3), jax_factory.zeros(3)])
        np.testing.assert_array_equal(factory.to_host(stacked), _jax_host(ref))
        assert tuple(stacked.shape) == (3, 3)


def test_the_factory_runs_on_the_card_unless_asked():
    if torch.cuda.is_available():
        assert factory.zeros(2).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            factory.zeros(2)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            factory.randn(RngStream(1), 2)


def test_the_package_exports_the_factory_lazily():
    assert port.factory is factory
    assert "factory" in dir(port)
    with pytest.raises(AttributeError):
        port.no_such_name


# -- initializers -----------------------------------------------------------------

def test_both_packages_know_the_seven_names():
    assert sorted(pt_init._REGISTRY) == sorted(jax_init._REGISTRY) == sorted(INIT_NAMES)
    with pytest.raises(KeyError, match="he_normal"):
        pt_init.get("bogus")


@pytest.mark.parametrize("name", ["zeros", "ones"])
def test_constant_initializers_are_equal(name):
    shape = (5, 5, 3, 7)
    mine = pt_init.get(name)(torch.Generator().manual_seed(0), shape)
    ref = np.asarray(jax_init.get(name)(jax.random.PRNGKey(0), shape))
    np.testing.assert_array_equal(mine.numpy(), ref)


def test_xavier_uniform_stays_in_its_bounds():
    shape = (256, 512)
    limit = math.sqrt(6.0 / (256 + 512))
    mine = pt_init.get("xavier_uniform")(torch.Generator().manual_seed(0), shape).numpy()
    ref = np.asarray(jax_init.get("xavier_uniform")(jax.random.PRNGKey(0), shape))
    for draw in (mine, ref):
        assert draw.shape == shape and draw.dtype == np.float32
        assert -limit <= draw.min() and draw.max() < limit
        assert draw.std() == pytest.approx(limit / math.sqrt(3.0), rel=0.02)


@pytest.mark.parametrize("name,std", [("xavier", math.sqrt(2.0 / (256 + 512))),
                                      ("he_normal", math.sqrt(2.0 / 256)),
                                      ("he", math.sqrt(2.0 / 256)),
                                      ("normal", 0.01)])
def test_gaussian_initializers_have_the_reference_std(name, std):
    shape = (256, 512)
    mine = pt_init.get(name)(torch.Generator().manual_seed(0), shape).numpy()
    ref = np.asarray(jax_init.get(name)(jax.random.PRNGKey(0), shape))
    for draw in (mine, ref):
        assert draw.shape == shape and draw.dtype == np.float32
        assert draw.std() == pytest.approx(std, rel=0.02)
        assert abs(draw.mean()) < 0.05 * std


def _two_layer(builder, config, dense, output, input_type, weight_init, layer_init=None):
    """The open fault's input: dense 5 → 4, softmax output 3."""
    b = builder(config(seed=3, weight_init=weight_init))
    b.add_inputs("x").set_input_types(input_type.feed_forward(5))
    b.add_layer("d", dense(n_out=4, activation="tanh", weight_init=layer_init), "x")
    b.add_layer("out", output(n_out=3, activation="softmax", loss="mcxent"), "d")
    b.set_outputs("out")
    return b.build()


def _check_init(name, params):
    w = np.asarray(params["d"]["W"])
    assert w.shape == (5, 4) and np.isfinite(w).all()
    if name in ("zeros", "ones"):
        np.testing.assert_array_equal(w, np.full((5, 4), 1.0 if name == "ones" else 0.0))


@pytest.mark.parametrize("name", INIT_NAMES)
def test_every_name_initialises_a_graph_in_both_packages(name):
    # through the graph's config, and through a layer's own weight_init
    for graph_init, layer_init in ((name, None), ("xavier", name)):
        pt = _two_layer(PtBuilder, PtConfig, PtDense, PtOutput, PtInputType, graph_init, layer_init)
        ref = _two_layer(JaxBuilder, JaxConfig, JaxDense, JaxOutput, JaxInputType, graph_init,
                         layer_init)
        _check_init(name, pt.init(device="cpu"))
        _check_init(name, ref.init())
        if name in ("zeros", "ones") and graph_init == name:
            np.testing.assert_array_equal(pt.init(device="cpu")["out"]["W"].numpy(),
                                          np.asarray(ref.init()["out"]["W"]))


@pytest.mark.parametrize("name", ["he_normal", "xavier_uniform", "ones"])
def test_every_name_initialises_a_registered_family(name):
    def family(registry, builder, config, dense, output, input_type):
        base = registry.get("tabular")
        graph = lambda cfg: _two_layer(builder, config, dense, output, input_type, name)  # noqa: E731
        return dataclasses.replace(base, name=f"init_{name}", build_discriminator=graph,
                                   build_generator=graph)

    pt_family = family(pt_registry, PtBuilder, PtConfig, PtDense, PtOutput, PtInputType)
    jax_family = family(jax_registry, JaxBuilder, JaxConfig, JaxDense, JaxOutput, JaxInputType)
    pt_registry.register(pt_family)
    jax_registry.register(jax_family)
    try:
        _check_init(name, pt_registry.get(f"init_{name}").build_discriminator(None).init(device="cpu"))
        _check_init(name, jax_registry.get(f"init_{name}").build_generator(None).init())
    finally:
        pt_registry.unregister(f"init_{name}")
        jax_registry.unregister(f"init_{name}")
