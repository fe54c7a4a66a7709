"""PyTorch port, the tabular, image (CIFAR-10 / CelebA-64) and WGAN-GP
families against the JAX package on the CPU.

Graphs are compared at reduced width (tabular hidden (16, 16); 16×16 images
with base 8 and dense 32, two stages) and, for ``cifar10`` and ``wgan_gp``,
at full width: param names and shapes, summaries, sync maps and forward
outputs within 1e-5. Experiments run at 8×8×3 (one stage, the families'
own widths) and batch 8: one fused iteration of the tabular and image
families and one WGAN-GP round (n_critic 2) from the JAX experiment's
initial states, with the JAX package's own z and ε draws injected, rebuilt
from ``fold_in(PRNGKey(seed + 2), step)`` as each JAX program splits it.

Tolerances, as for the MNIST iteration (``tests/test_torch_train.py``):
losses within 1e-4 relative and every leaf within 5e-3 by
``state_divergence``. RmsProp at decay = eps = 1e-8 and Adam at β1 = 0 both
move a param by about ``lr·sign(g)`` on a first step, so a gradient that
cancels to near zero turns rounding into a sparse update difference.
Inside the port, resume and a window of rounds are bit-exact.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_deeplearning4j_tpu.harness import ExperimentConfig as JaxConfig
from gan_deeplearning4j_tpu.harness import make_experiment as jax_make_experiment
from gan_deeplearning4j_tpu.models import dcgan_image as jax_image
from gan_deeplearning4j_tpu.models import mlp_gan as jax_mlp
from gan_deeplearning4j_tpu.models import registry as jax_registry
from gan_deeplearning4j_tpu.models import wgan_gp as jax_wgan
from gan_deeplearning4j_tpu.utils import serializer as jax_ser
from gan_deeplearning4j_tpu.zoo.manifest import scenario_from_config as jax_scenario
from gan_deeplearning4j_tpu_torch.__main__ import main as pt_main
from gan_deeplearning4j_tpu_torch.harness import ExperimentConfig, GanExperiment, make_experiment
from gan_deeplearning4j_tpu_torch.harness.experiment import (
    flatten_states,
    forward_flops,
    state_divergence,
)
from gan_deeplearning4j_tpu_torch.harness.wgan_experiment import WganGpExperiment
from gan_deeplearning4j_tpu_torch.interop import params_from_numpy, train_state_from_numpy
from gan_deeplearning4j_tpu_torch.models import dcgan_image as pt_image
from gan_deeplearning4j_tpu_torch.models import mlp_gan as pt_mlp
from gan_deeplearning4j_tpu_torch.models import registry
from gan_deeplearning4j_tpu_torch.models import wgan_gp as pt_wgan
from gan_deeplearning4j_tpu_torch.serving import InferenceService, ServingEngine
from gan_deeplearning4j_tpu_torch.telemetry.registry import MetricsRegistry, set_registry
from gan_deeplearning4j_tpu_torch.zoo.manifest import scenario_from_config

B = 8
TOL = dict(rtol=1e-5, atol=1e-5)
EXACT = dict(rtol=0, atol=0)
ITER_LOSS_RTOL, ITER_LEAF_REL = 1e-4, 5e-3
SHAPES = {
    "tabular": dict(model_family="tabular", num_features=32, z_size=8),
    "image": dict(model_family="cifar10", height=8, width=8, channels=3, num_features=192),
    "wgan_gp": dict(model_family="wgan_gp", height=8, width=8, channels=3, num_features=192,
                    z_size=4, n_critic=2),
}


def _config(cls, family, **overrides):
    cfg = dict(SHAPES[family], batch_size_train=B, batch_size_pred=B, latent_grid=2,
               save_models=False)
    if cls is ExperimentConfig:
        cfg["use_accelerator"] = False
    cfg.update(overrides)
    return cls(**cfg)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _reown(tree):
    """Fresh executable-owned JAX buffers (donation-safe) from numpy."""
    return jax.jit(lambda t: jax.tree_util.tree_map(lambda a: a * 1, t))(tree)


def _flat(state, prefix=""):
    """``{path: ndarray}`` of a TrainState (either package) or params tree."""
    out = {}
    if hasattr(state, "opt_state"):
        out.update(_flat(state.params, prefix + "params/"))
        out.update(_flat(state.opt_state, prefix + "opt_state/"))
        out[prefix + "step"] = np.asarray(int(np.asarray(state.step)))
        return out
    for key, value in state.items():
        if isinstance(value, dict):
            out.update(_flat(value, f"{prefix}{key}/"))
        else:
            out[prefix + key] = value.detach().cpu().numpy() if isinstance(value, torch.Tensor) \
                else np.asarray(value)
    return out


def _assert_states_close(port, ref, tol):
    p, r = _flat(port), _flat(ref)
    assert sorted(p) == sorted(r)
    for key in r:
        np.testing.assert_allclose(p[key], r[key], err_msg=key, **tol)


def _divergence(pexp, jax_states):
    port = {f"{m}/{k}": v for m, st in pexp.digest_states().items() for k, v in _flat(st).items()}
    ref = {f"{m}/{k}": v for m, st in jax_states.items() for k, v in _flat(st).items()}
    return state_divergence(port, ref, pexp.rounding_only_keys())


def _assert_bit_equal(a_states, b_states):
    a, b = flatten_states(a_states), flatten_states(b_states)
    assert sorted(a) == sorted(b)
    for key in a:
        if isinstance(a[key], torch.Tensor):
            assert torch.equal(a[key], b[key]), key
        else:
            assert a[key] == b[key], key


def _data(family, n, seed):
    cfg = _config(ExperimentConfig, family)
    fam = registry.get(cfg.model_family)
    x = fam.synthetic_data(n, fam.make_model_config(cfg), seed)
    return x, np.eye(10, dtype=np.float32)[np.arange(n) % 10]


# -- the JAX package's draws, as the port's sources ------------------------------

def jax_z_source(seed, z_size):
    """The JAX fused iteration's z draws (``_build_fused_iteration``)."""
    base = jax.random.PRNGKey(seed + 2)

    def source(dis_step, batch):
        k_fake, k_gan, *_ = jax.random.split(jax.random.fold_in(base, dis_step), 6)
        return np.stack([
            np.array(jax.random.uniform(k, (batch, z_size), jnp.float32, -1.0, 1.0))
            for k in (k_fake, k_gan)
        ])

    return source


def jax_draw_source(seed, z_size):
    """The JAX WGAN-GP round's draws: ``k_c, k_g = split(fold_in(PRNGKey(
    seed + 2), gen_step))``; per critic step ``key, sub = split(key)``,
    ``k_z, k_gp = split(sub)``, z ~ N(0, 1) from ``k_z``, ε ~ U[0, 1) from
    ``k_gp``; the generator step's z from ``k_g``."""
    base = jax.random.PRNGKey(seed + 2)

    def source(gen_step, n_critic, rows):
        key, k_g = jax.random.split(jax.random.fold_in(base, gen_step))
        zs, epsilons = [], []
        for _ in range(n_critic):
            key, sub = jax.random.split(key)
            k_z, k_gp = jax.random.split(sub)
            zs.append(np.array(jax.random.normal(k_z, (rows, z_size), jnp.float32)))
            epsilons.append(np.array(jax.random.uniform(k_gp, (rows, 1), jnp.float32)))
        gen_z = np.array(jax.random.normal(k_g, (rows, z_size), jnp.float32))
        return np.stack(zs), np.stack(epsilons), gen_z

    return source


# -- experiments ------------------------------------------------------------------

def _jax_states(exp):
    if hasattr(exp, "critic_state"):
        return {"critic": _np(exp.critic_state), "gen": _np(exp.gen_state)}
    return {"dis": _np(exp.dis_state), "gan": _np(exp.gan_state), "gen": _np(exp.gen_params)}


def _set_jax_states(exp, states):
    if "critic" in states:
        exp.critic_state, exp.gen_state = _reown(states["critic"]), _reown(states["gen"])
    else:
        exp.dis_state, exp.gan_state = _reown(states["dis"]), _reown(states["gan"])
        exp.gen_params = _reown(states["gen"])
    exp.batch_counter = 0


def _set_port_states(exp, states):
    if "critic" in states:
        exp.critic_state = train_state_from_numpy(states["critic"], "cpu", graph=exp.trainer.critic)
        exp.gen_state = train_state_from_numpy(states["gen"], "cpu", graph=exp.trainer.generator)
    else:
        exp.dis_state = train_state_from_numpy(states["dis"], "cpu", graph=exp.dis)
        exp.gan_state = train_state_from_numpy(states["gan"], "cpu", graph=exp.gan)
        exp.gen_params = params_from_numpy(states["gen"], "cpu", graph=exp.gen)


@pytest.fixture(scope="module")
def jax_exps(tmp_path_factory):
    """One JAX experiment per family (module-scoped, to bound XLA:CPU
    compile time) and its initial states as numpy."""
    cache = {}

    def get(family):
        if family not in cache:
            out = str(tmp_path_factory.mktemp(f"jax_{family}"))
            exp = jax_make_experiment(_config(JaxConfig, family, output_dir=out))
            cache[family] = (exp, _jax_states(exp))
        return cache[family]

    return get


def _port(family, init, jax_draws=True, **overrides):
    """A port experiment on the CPU holding the JAX experiment's initial
    states and, with ``jax_draws``, drawing the JAX package's z (and ε)."""
    exp = make_experiment(_config(ExperimentConfig, family, **overrides))
    _set_port_states(exp, init)
    if not jax_draws:
        return exp
    if family == "wgan_gp":
        exp.draw_source = jax_draw_source(exp.config.seed, exp.model_cfg.z_size)
    else:
        exp.z_source = jax_z_source(exp.config.seed, exp.model_cfg.z_size)
    return exp


# -- registry, config, scenario ---------------------------------------------------

def test_registry_resolves_every_family_and_make_experiment_dispatches():
    assert sorted(registry.names()) == sorted(jax_registry.names())
    for name, want in (("tabular", "tabular"), ("image", "image"), ("cifar10", "image"),
                       ("celeba64", "image"), ("wgan_gp", "wgan_gp"), ("mnist", "mnist")):
        assert registry.get(name).name == want
    with pytest.raises(KeyError, match="unknown model family"):
        registry.get("bogus")
    wgan = make_experiment(_config(ExperimentConfig, "wgan_gp"))
    assert isinstance(wgan, WganGpExperiment) and wgan.cv is None
    for family in ("tabular", "image"):
        exp = make_experiment(_config(ExperimentConfig, family))
        assert type(exp) is GanExperiment and exp.cv is None and exp.cv_state is None
        with pytest.raises(ValueError, match="no transfer classifier"):
            exp.export_predictions(None, 1)
    with pytest.raises(ValueError, match="no transfer classifier"):
        wgan.export_predictions(None, 1)


@pytest.mark.parametrize("overrides", [
    dict(model_family="wgan_gp", height=8, width=8, channels=1, num_features=64,
         batch_size_train=10, n_critic=3),
    dict(model_family="wgan_gp", height=8, width=8, channels=1, num_features=64, n_critic=0),
    dict(model_family="wgan_gp", height=8, width=8, channels=1, num_features=64,
         batch_size_train=10, n_critic=5, distributed="param_averaging"),
    dict(model_family="wgan_gp", height=8, width=8, channels=1, num_features=64,
         batch_size_train=10, n_critic=5, conditioning="class"),
    dict(model_family="image", height=8, width=8, channels=3, num_features=100),
])
def test_validate_makes_the_jax_packages_family_checks(overrides):
    with pytest.raises(ValueError) as ref:
        JaxConfig(**overrides).validate()
    with pytest.raises(ValueError) as port:
        ExperimentConfig(**overrides).validate()
    assert str(port.value) == str(ref.value)


def test_validate_accepts_every_family_and_refuses_class_conditioning():
    for family in ("tabular", "image", "cifar10", "celeba64", "wgan_gp"):
        _config(ExperimentConfig, "image", model_family=family, batch_size_train=10).validate()
    ExperimentConfig(model_family="tabular", num_features=17).validate()  # no h·w·c check
    # class conditioning validates for the image family, as in the JAX
    # package (tests/test_torch_zoo.py trains it); WGAN-GP refuses it with
    # the JAX package's ValueError (test_validate_makes_the_jax_packages_family_checks)
    cfg = _config(ExperimentConfig, "image", conditioning="class").validate()
    _config(JaxConfig, "image", conditioning="class").validate()
    assert cfg.conditioning == "class"


@pytest.mark.parametrize("overrides", [
    dict(),
    dict(model_family="image", height=32, width=32, channels=3, num_features=3072,
         dataset="cifar_shaped"),
    dict(model_family="wgan_gp", height=32, width=32, channels=3, num_features=3072,
         dataset="cifar_shaped", z_size=128),
    dict(model_family="cifar10", height=8, width=8, channels=3, num_features=192),
    dict(model_family="tabular", num_features=32),
    dict(model_family="bogus"),
])
def test_scenario_from_config_matches_jax(overrides):
    want = jax_scenario(JaxConfig(**overrides))
    got = scenario_from_config(ExperimentConfig(**overrides))
    assert (got is None) == (want is None)
    if want is not None:
        assert got.to_dict() == want.to_dict()


# -- graphs -----------------------------------------------------------------------

def _reduced_graphs():
    """(name, jax graph, port graph) at reduced width."""
    mlp = dict(num_features=12, z_size=4, hidden=(16, 16))
    img = dict(height=16, width=16, channels=3, z_size=6, base_filters=8, dense_width=32)
    wg = dict(height=16, width=16, channels=3, z_size=6, base_filters=8, dense_width=32)
    jm, pm = jax_mlp.MlpGanConfig(**mlp), pt_mlp.MlpGanConfig(**mlp)
    ji, pi = jax_image.ImageGanConfig(**img), pt_image.ImageGanConfig(**img)
    jw, pw = jax_wgan.WganGpConfig(**wg), pt_wgan.WganGpConfig(**wg)
    return {
        "tabular": ([(b, getattr(jax_mlp, b)(jm), getattr(pt_mlp, b)(pm))
                     for b in ("build_discriminator", "build_generator", "build_gan")],
                    jax_mlp.sync_maps(jm), pt_mlp.sync_maps(pm)),
        "image": ([(b, getattr(jax_image, b)(ji), getattr(pt_image, b)(pi))
                   for b in ("build_discriminator", "build_generator", "build_gan")],
                  jax_image.sync_maps(ji), pt_image.sync_maps(pi)),
        "wgan_gp": ([(b, getattr(jax_wgan, b)(jw), getattr(pt_wgan, b)(pw))
                     for b in ("build_critic", "build_generator")], None, None),
    }


def _random_params(graph, seed):
    """Seeded numpy params for ``graph`` (scaled by fan-in; BatchNorm
    variances and gains around 1): JAX's eager init compiles a program per
    param shape, which would dominate these tests' time."""
    rng = np.random.default_rng(seed)
    out = {}
    for layer, shapes in graph.param_shapes().items():
        out[layer] = {}
        for name, shape in shapes.items():
            if name in ("var", "gamma"):
                value = rng.uniform(0.5, 1.5, shape)
            elif name == "W":
                value = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
            else:
                value = 0.1 * rng.standard_normal(shape)
            out[layer][name] = value.astype(np.float32)
    return out


def _assert_forward_matches(jgraph, pgraph, batch, seed):
    jparams = _random_params(pgraph, seed)
    pparams = params_from_numpy(jparams, "cpu", graph=pgraph)
    in_type = pgraph.input_types[0]
    x = np.random.default_rng(seed).uniform(0, 1, (batch, in_type.features)).astype(np.float32)
    for train in (False, True):
        jouts, jnew = jgraph.apply(jparams, x, train=train)
        with torch.no_grad():
            pouts, pnew = pgraph.apply(pparams, torch.from_numpy(x), train=train)
        for name in jgraph.output_names:
            np.testing.assert_allclose(pouts[name].numpy(), np.asarray(jouts[name]),
                                       err_msg=name, **TOL)
        _assert_states_close(pnew, _np(jnew), TOL)


@pytest.mark.parametrize("family", ["tabular", "image", "wgan_gp"])
def test_graphs_match_jax_at_reduced_width(family):
    graphs, jmaps, pmaps = _reduced_graphs()[family]
    for builder, jgraph, pgraph in graphs:
        assert pgraph.summary() == jgraph.summary(), builder
        assert pgraph.to_dict() == jgraph.to_dict(), builder
        assert pgraph.param_roles() == jgraph.param_roles()
        want = {layer: {k: tuple(v.shape) for k, v in lp.items()}
                for layer, lp in jax.eval_shape(lambda g=jgraph: g.init(0)).items()}
        assert pgraph.param_shapes() == want
        _assert_forward_matches(jgraph, pgraph, batch=3, seed=5)
    assert pmaps == jmaps
    if pmaps is not None:  # every param layer of dis and gen is synced
        (_, _, pdis), (_, _, pgen), _ = graphs
        assert set(pmaps[0]) == set(pdis.param_shapes())
        assert set(pmaps[1].values()) == set(pgen.param_shapes())


@pytest.mark.parametrize("family", ["cifar10", "wgan_gp"])
def test_full_width_graphs_forward_match_jax(family):
    if family == "cifar10":
        pairs = [(getattr(jax_image, b)(jax_image.CIFAR10), getattr(pt_image, b)(pt_image.CIFAR10))
                 for b in ("build_discriminator", "build_generator", "build_gan")]
    else:
        pairs = [(getattr(jax_wgan, b)(), getattr(pt_wgan, b)())
                 for b in ("build_critic", "build_generator")]
    for jgraph, pgraph in pairs:
        assert pgraph.to_dict() == jgraph.to_dict()
        _assert_forward_matches(jgraph, pgraph, batch=2, seed=6)


def test_forward_flops_counts_deconvolutions_by_input_pixels():
    gen = pt_image.build_generator(pt_image.CIFAR10)
    # z 64 → dense 1024 → dense 4·4·256; deconv 256→128 on 4², 128→64 on 8²,
    # 64→32 on 16² (k4: 16 taps each); conv5 32→3 on 32²
    hand = 2 * (64 * 1024 + 1024 * 4096 + 4 * 4 * 16 * 256 * 128 + 8 * 8 * 16 * 128 * 64
                + 16 * 16 * 16 * 64 * 32 + 32 * 32 * 25 * 32 * 3)
    assert forward_flops(gen, 1) == hand
    exp = make_experiment(_config(ExperimentConfig, "image"))
    b = 3
    assert exp.flops_per_iteration(b) == forward_flops(exp.gen, b) + 3 * (
        2 * forward_flops(exp.dis, b) + forward_flops(exp.gan, b))
    wgan = make_experiment(_config(ExperimentConfig, "wgan_gp"))
    g, c = forward_flops(wgan.trainer.generator, 4), forward_flops(wgan.trainer.critic, 4)
    assert wgan.flops_per_iteration(8) == 2 * (g + 12 * c) + 3 * g + 2 * c


# -- one iteration / one round against JAX ---------------------------------------

@pytest.mark.parametrize("family", ["tabular", "image"])
def test_one_fused_iteration_matches_jax(jax_exps, family):
    """Losses and every state (params, RmsProp caches, BatchNorm running
    stats) after one fused iteration of a family without a classifier."""
    jexp, init = jax_exps(family)
    _set_jax_states(jexp, init)
    x, y = _data(family, B, seed=1)
    jlosses = jexp.train_iteration(x, y)
    pexp = _port(family, init)
    plosses = pexp.train_iteration(x, y)
    for k in ("d_loss", "g_loss"):
        np.testing.assert_allclose(float(plosses[k]), float(jlosses[k]), rtol=ITER_LOSS_RTOL, atol=0)
    assert np.isnan(float(plosses["cv_loss"])) and np.isnan(float(jlosses["cv_loss"]))
    assert _divergence(pexp, _jax_states(jexp))["max_leaf_rel"] <= ITER_LEAF_REL
    assert pexp.dis_state.step == 2 and pexp.gan_state.step == 1


def test_one_wgan_round_matches_jax(jax_exps):
    """Losses, params and Adam state of the critic and the generator (and
    its BatchNorm running stats) after one round: two critic steps with
    the gradient penalty, then the generator step."""
    jexp, init = jax_exps("wgan_gp")
    _set_jax_states(jexp, init)
    x, _ = _data("wgan_gp", B, seed=2)
    jlosses = jexp.train_iteration(x)
    pexp = _port("wgan_gp", init)
    plosses = pexp.train_iteration(x)
    for k in ("d_loss", "g_loss"):
        np.testing.assert_allclose(float(plosses[k]), float(jlosses[k]), rtol=ITER_LOSS_RTOL, atol=0)
    div = _divergence(pexp, _jax_states(jexp))
    assert div["max_leaf_rel"] <= ITER_LEAF_REL
    # gen_dense_1/b feeds gen_batch_2: only rounding reaches it, and one
    # Adam step moves it by at most lr in either package
    assert pexp.rounding_only_keys() == ["gen/params/gen_dense_1/b", "gen/opt_state/gen_dense_1/b/m",
                                         "gen/opt_state/gen_dense_1/b/v"]
    assert div["rounding_only_max_abs"] <= 2 * pexp.model_cfg.gen_learning_rate
    assert pexp.critic_state.step == 2 and pexp.gen_state.step == 1
    assert int(jexp.critic_state.step) == 2


def test_wgan_tail_policy_pads_by_cycling_and_drops_the_remainder(jax_exps):
    _, init = jax_exps("wgan_gp")
    x, _ = _data("wgan_gp", B + 1, seed=3)

    def round_on(rows):
        exp = _port("wgan_gp", init, jax_draws=False)
        losses = exp.train_iteration(rows)
        return losses, exp.digest_states()

    dropped, want = round_on(x), round_on(x[:B])  # 9 rows → 8 at n_critic 2
    _assert_bit_equal(dropped[1], want[1])
    padded, want = round_on(x[:1]), round_on(np.concatenate([x[:1], x[:1]]))
    _assert_bit_equal(padded[1], want[1])
    assert float(padded[0]["d_loss"]) == float(want[0]["d_loss"])
    with pytest.raises(ValueError, match="empty batch"):
        _port("wgan_gp", init, jax_draws=False).train_iteration(x[:0])


def test_wgan_window_equals_single_rounds_bit_for_bit(jax_exps):
    _, init = jax_exps("wgan_gp")
    x, y = _data("wgan_gp", 3 * B, seed=4)
    single = _port("wgan_gp", init, jax_draws=False)
    singles = [single.train_iteration(x[k * B:(k + 1) * B]) for k in range(3)]
    window = _port("wgan_gp", init, jax_draws=False)
    rows = window.train_iterations(x.reshape(3, B, -1), y.reshape(3, B, -1))
    _assert_bit_equal(single.digest_states(), window.digest_states())
    assert rows["d_loss"].tolist() == [float(s["d_loss"]) for s in singles]
    assert rows["g_loss"].tolist() == [float(s["g_loss"]) for s in singles]
    assert np.isnan(rows["cv_loss"].numpy()).all()
    assert window.gen_state.step == 3 and window.critic_state.step == 6


# -- checkpoints, resume, run, CLI, serving ----------------------------------------

@pytest.mark.parametrize("family,files", [
    ("image", ["dis", "gan", "gen"]),
    ("wgan_gp", ["critic", "gen"]),
])
def test_checkpoints_cross_between_the_packages(jax_exps, tmp_path, family, files):
    """A JAX ``save_models`` directory resumes in the port bit for bit, and
    a port one reads in JAX ``read_model`` and resumes in the JAX
    experiment bit for bit."""
    jexp, init = jax_exps(family)
    _set_jax_states(jexp, init)
    x, y = _data(family, B, seed=5)
    jexp.train_iteration(x, y)
    jexp.save_models(str(tmp_path / "from_jax"))
    pexp = _port(family, init)
    assert pexp.load_models(str(tmp_path / "from_jax")) == 1
    for model, state in _jax_states(jexp).items():
        _assert_states_close(pexp.digest_states()[model], state, EXACT)

    pexp.train_iteration(x, y)
    written = pexp.save_models(str(tmp_path / "from_port"))
    assert [os.path.basename(p) for p in written] == [f"mnist_{m}_model.zip" for m in files]
    _, params, opt_state, step = jax_ser.read_model(str(tmp_path / "from_port" / "mnist_gen_model.zip"))
    gen = pexp.digest_states()["gen"]
    _assert_states_close(getattr(gen, "params", gen), _np(params), EXACT)
    assert jexp.load_models(str(tmp_path / "from_port")) == 2
    for model, state in _jax_states(jexp).items():
        _assert_states_close(pexp.digest_states()[model], state, EXACT)


@pytest.mark.parametrize("family", ["image", "wgan_gp"])
def test_resume_inside_the_port_is_bit_exact(tmp_path, family):
    """2 iterations, save, load into a fresh experiment, 2 more: the same
    states as 4 straight iterations, bit for bit (the port's own init and
    draws)."""
    cfg = _config(ExperimentConfig, family)
    x, y = _data(family, 4 * B, seed=6)
    batches = [(x[i * B:(i + 1) * B], y[i * B:(i + 1) * B]) for i in range(4)]
    straight = make_experiment(cfg)
    for xb, yb in batches:
        straight.train_iteration(xb, yb)
    first = make_experiment(cfg)
    for xb, yb in batches[:2]:
        first.train_iteration(xb, yb)
    first.save_models(str(tmp_path))
    resumed = make_experiment(cfg)
    assert resumed.load_models(str(tmp_path)) == 2
    for xb, yb in batches[2:]:
        resumed.train_iteration(xb, yb)
    _assert_bit_equal(straight.digest_states(), resumed.digest_states())


@pytest.mark.parametrize("family,checkpoints", [
    ("cifar10", ["dis", "gan", "gen"]),
    ("wgan_gp", ["critic", "gen"]),
])
def test_cli_trains_the_family_end_to_end_on_the_cpu(tmp_path, capsys, family, checkpoints):
    shape = SHAPES["image" if family == "cifar10" else family]
    args = ["--model-family", family, "--batch-size-train", str(B), "--batch-size-pred", str(B),
            "--num-iterations", "2", "--latent-grid", "2", "--use-accelerator", "false",
            "--data-dir", str(tmp_path / "data"), "--output-dir", str(tmp_path / "out")]
    for key in ("height", "width", "channels", "num_features", "z_size", "n_critic"):
        if key in shape:
            args += ["--" + key.replace("_", "-"), str(shape[key])]
    assert pt_main(args) == 0
    out = capsys.readouterr().out
    assert "generating synthetic data" in out and "Manifold image:" in out
    assert "Transfer-classifier accuracy" not in out
    assert sorted(os.listdir(tmp_path / "data")) == ["mnist_test.csv", "mnist_train.csv"]
    assert sorted(os.listdir(tmp_path / "out")) == sorted(
        ["DCGAN_Generated_Images.png", "mnist_out_1.csv", "mnist_out_2.csv"]
        + [f"mnist_{m}_model.zip" for m in checkpoints])
    manifold = np.loadtxt(tmp_path / "out" / "mnist_out_2.csv", delimiter=",")
    assert manifold.shape == (4, 192) and 0.0 <= manifold.min() and manifold.max() <= 1.0


@pytest.mark.parametrize("family", ["image", "wgan_gp"])
def test_generator_only_bundle_serves_sample_alone(jax_exps, tmp_path, family):
    """``run()`` then ``publish_for_serving``: the manifest key for key as
    the JAX package writes it (``classifier`` and ``feature_vertex`` null),
    and the engine serves what the trainer's generator makes; ``classify``
    and ``features`` answer 404."""
    jexp, init = jax_exps(family)
    x, y = _data(family, 2 * B, seed=7)
    pexp = _port(family, init, num_iterations=2, output_dir=str(tmp_path / "out"))
    from gan_deeplearning4j_tpu_torch.data import ArrayDataSetIterator

    result = pexp.run(ArrayDataSetIterator(x, y, batch_size=B))
    assert result["iterations"] == 2 and np.isnan([h["cv_loss"] for h in result["history"]]).all()
    manifest = pexp.publish_for_serving(str(tmp_path / "port"))
    jexp.publish_for_serving(str(tmp_path / "jax"))
    with open(tmp_path / "port" / "serving.json") as fh:
        port_doc = json.load(fh)
    with open(tmp_path / "jax" / "serving.json") as fh:
        jax_doc = json.load(fh)
    assert {k: v for k, v in port_doc.items() if k != "step"} == \
        {k: v for k, v in jax_doc.items() if k != "step"}
    assert manifest["classifier"] is None and manifest["feature_vertex"] is None
    assert manifest["step"] == 2 and sorted(os.listdir(tmp_path / "port")) == [
        "mnist_gen_serving.zip", "serving.json"]

    previous = set_registry(MetricsRegistry())
    try:
        engine = ServingEngine.from_bundle(str(tmp_path / "port"), device="cpu")
        assert engine.kinds == ("sample",)
        z = np.random.default_rng(8).standard_normal((5, pexp.model_cfg.z_size)).astype(np.float32)
        with torch.no_grad():
            want = pexp.gen.output(pexp.gen_params, torch.from_numpy(z)).reshape(5, -1).numpy()
        got = engine.run("sample", z)
        assert got.shape == (5, 192)
        np.testing.assert_allclose(got, want, **TOL)
        service = InferenceService(engine, warmup="sync")
        try:
            code, body = service.handle("POST", "/v1/sample", {"data": z.tolist()})
            assert code == 200 and np.asarray(body["data"]).shape == (5, 192)
            for kind in ("classify", "features"):
                code, body = service.handle("POST", f"/v1/{kind}", {"data": [[0.0] * 192]})
                assert code == 404 and body["error"] == f"unknown request kind {kind!r}"
        finally:
            service.close()
    finally:
        set_registry(previous)
