"""PyTorch port, bf16 training and bf16 bundles against the JAX package on
the CPU: mixed precision (``compute_dtype="bf16"``, float32 params) and
pure bf16 storage (``param_dtype="bf16"``, which implies bf16 compute).

Shapes: MNIST at the reference's widths; tabular at its own (32 features,
z 8); the image family at 32×32×3 (CIFAR-10's shape, full width); WGAN-GP
at 8×8×3 with n_critic 2; batch 8. Every run starts from the JAX
experiment's initial states and draws the JAX package's own z and ε
(``tests/test_torch_families.py``).

Tolerances. In bf16 the two packages do not compute bit-equal iterations,
for three reasons each test bounds:
- inside a jitted program XLA:CPU keeps float32 where the reference's code
  rounds a convolution's output and its cotangent to bf16
  (``xla_allow_excess_precision``); the port rounds there, as the code
  says and as cuDNN does (``tests/test_torch_bf16_ops.py`` holds each op
  to the reference run op by op);
- a bf16 rounding flips which element of a 2×2 max-pool window wins, which
  moves a whole gradient contribution;
- RmsProp at decay = eps = 1e-8 and Adam at β1 = 0 move a param by about
  ``lr·sign(g)``, so where a gradient cancels, those differences flip the
  step (at most 2·lr an element per step).
So losses are held to stated relative bounds, params
(not updater state, which holds the last gradient squared) to a leafwise
``state_divergence`` bound (leaves of one step's size apart, see
``_compare``) and to 2·lr per element per step, and dtypes leaf for leaf
exactly. Inside the port, resume is bit-exact.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_deeplearning4j_tpu.harness import ExperimentConfig as JaxConfig
from gan_deeplearning4j_tpu.harness import make_experiment as jax_make_experiment
from gan_deeplearning4j_tpu.quant.variants import build_bf16_variant as jax_build_bf16_variant
from gan_deeplearning4j_tpu.runtime.dtype import compute_dtype_scope as jax_scope
from gan_deeplearning4j_tpu.serving.engine import ServingEngine as JaxEngine
from gan_deeplearning4j_tpu.utils import serializer as jax_ser
from gan_deeplearning4j_tpu_torch.harness import ExperimentConfig, make_experiment
from gan_deeplearning4j_tpu_torch.harness.experiment import flatten_states, state_divergence
from gan_deeplearning4j_tpu_torch.interop import params_from_numpy, train_state_from_numpy
from gan_deeplearning4j_tpu_torch.ops import conv as pt_conv
from gan_deeplearning4j_tpu_torch.ops import linear as pt_linear
from gan_deeplearning4j_tpu_torch.quant import build_bf16_variant
from gan_deeplearning4j_tpu_torch.serving import ServingEngine
from gan_deeplearning4j_tpu_torch.telemetry.registry import MetricsRegistry, set_registry
from tests.test_torch_families import jax_draw_source, jax_z_source

B = 8
SHAPES = {
    "mnist": dict(model_family="mnist"),
    "tabular": dict(model_family="tabular", num_features=32, z_size=8),
    "image": dict(model_family="cifar10", height=32, width=32, channels=3, num_features=3072),
    "wgan_gp": dict(model_family="wgan_gp", height=8, width=8, channels=3, num_features=192,
                    z_size=4, n_critic=2),
}
FAMILIES = list(SHAPES)
MODES = {"mixed": {"compute_dtype": "bf16"}, "storage": {"param_dtype": "bf16"}}


@pytest.fixture(autouse=True)
def _port_registry():
    previous = set_registry(MetricsRegistry())
    try:
        yield
    finally:
        set_registry(previous)


def _config(cls, family, mode, **overrides):
    cfg = dict(SHAPES[family], batch_size_train=B, batch_size_pred=B, latent_grid=2,
               save_models=False, **MODES[mode])
    if cls is ExperimentConfig:
        cfg["use_accelerator"] = False
    cfg.update(overrides)
    return cls(**cfg)


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_states(exp):
    if hasattr(exp, "critic_state"):
        return {"critic": _host(exp.critic_state), "gen": _host(exp.gen_state)}
    out = {"dis": _host(exp.dis_state), "gan": _host(exp.gan_state), "gen": _host(exp.gen_params)}
    if exp.cv_state is not None:
        out["CV"] = _host(exp.cv_state)
    return out


def _reown(tree):
    return jax.jit(lambda t: jax.tree_util.tree_map(lambda a: a * 1, t))(tree)


def _set_jax_states(exp, states):
    if "critic" in states:
        exp.critic_state, exp.gen_state = _reown(states["critic"]), _reown(states["gen"])
    else:
        exp.dis_state, exp.gan_state = _reown(states["dis"]), _reown(states["gan"])
        exp.gen_params = _reown(states["gen"])
        if "CV" in states:
            exp.cv_state = _reown(states["CV"])
    exp.batch_counter = 0


def _port(family, mode, init, jax_draws=True, **overrides):
    """A port experiment on the CPU holding the JAX experiment's initial
    states and, with ``jax_draws``, drawing the JAX package's z (and ε)."""
    exp = make_experiment(_config(ExperimentConfig, family, mode, **overrides))
    if "critic" in init:
        exp.critic_state = train_state_from_numpy(init["critic"], "cpu", graph=exp.trainer.critic)
        exp.gen_state = train_state_from_numpy(init["gen"], "cpu", graph=exp.trainer.generator)
        if jax_draws:
            exp.draw_source = jax_draw_source(exp.config.seed, exp.model_cfg.z_size)
        return exp
    exp.dis_state = train_state_from_numpy(init["dis"], "cpu", graph=exp.dis)
    exp.gan_state = train_state_from_numpy(init["gan"], "cpu", graph=exp.gan)
    exp.gen_params = params_from_numpy(init["gen"], "cpu", graph=exp.gen)
    if "CV" in init:
        exp.cv_state = train_state_from_numpy(init["CV"], "cpu", graph=exp.cv)
    if jax_draws:
        exp.z_source = jax_z_source(exp.config.seed, exp.model_cfg.z_size)
    return exp


def _data(family, k, seed):
    """``k`` batches of rows in [0, 1] and one-hot labels."""
    rng = np.random.default_rng(seed)
    nf = SHAPES[family].get("num_features", 784)
    return (rng.random((k, B, nf), dtype=np.float32),
            np.eye(10, dtype=np.float32)[rng.integers(0, 10, (k, B))])


def _flat_np(states):
    """``{model/path: ndarray}`` of either package's states (bf16 leaves as
    ``ml_dtypes`` arrays or tensors)."""
    out = {}

    def walk(prefix, node):
        if hasattr(node, "opt_state"):
            walk(prefix + "/params", node.params)
            walk(prefix + "/opt_state", node.opt_state)
        elif isinstance(node, dict):
            for key, value in node.items():
                walk(f"{prefix}/{key}", value)
        else:
            out[prefix] = node

    for name, state in states.items():
        walk(name, state)
    return out


def _dtype_name(x) -> str:
    return str(x.dtype).replace("torch.", "")


def _as_f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _bf16_ulp(x):
    return np.exp2(np.floor(np.log2(np.maximum(np.abs(x), 1e-38))) - 7)


def _lr(exp) -> float:
    cfg = exp.model_cfg if hasattr(exp, "critic_state") else exp.config
    if hasattr(exp, "critic_state"):
        return max(cfg.critic_learning_rate, cfg.gen_learning_rate)
    return max(cfg.dis_learning_rate, cfg.gen_learning_rate)


def _compare(pexp, ref_states):
    """``(dtype mismatches, params-only divergence)``. Leaves of one step's
    size (``‖p‖ ≤ 2·lr·√n``: zero-initialised biases and BatchNorm shifts
    after their first steps) flip wholesale where their gradients cancel,
    so ``state_divergence`` reports them apart (``rounding_only``); the
    divergence adds ``max_step_excess``, the largest elementwise difference
    of any param left after two bf16 ulps of each bf16 param (what storing
    it rounds)."""
    port, ref = _flat_np(pexp.digest_states()), _flat_np(ref_states)
    assert sorted(port) == sorted(ref)
    mismatched = [k for k in ref if _dtype_name(port[k]) != _dtype_name(ref[k])]
    params = [k for k in ref if "/opt_state/" not in k and np.asarray(ref[k]).ndim > 0]
    p, r = {k: _as_f32(port[k]) for k in params}, {k: _as_f32(ref[k]) for k in params}
    step_sized = [k for k in params if np.linalg.norm(r[k]) <= 2 * _lr(pexp) * np.sqrt(r[k].size)]
    div = state_divergence(p, r, step_sized)
    div["max_abs"] = max(div["max_abs"], div["rounding_only_max_abs"])
    div["max_step_excess"] = max(
        float(np.max(np.abs(p[k] - r[k]) - (2 * _bf16_ulp(r[k]) if _dtype_name(ref[k]) == "bfloat16" else 0)))
        for k in params)
    return mismatched, div


def _step_bound(exp, iterations):
    """Every param moves by about ``lr`` a step at most, in either package:
    two packages that flip a step's sign differ by 2·lr. An iteration takes
    at most two steps of any param (the two dis steps)."""
    return 2 * 2 * iterations * max(exp.config.dis_learning_rate, exp.config.gen_learning_rate)


def _adam_step_bound(exp, steps):
    """Adam at β1 = 0 moves a param by at most ``lr / sqrt(1 − β2)`` a step
    (where the squared-gradient average is bias-corrected after a step of
    small gradients), so two runs differ by at most twice that a step."""
    cfg = exp.model_cfg
    return 2 * steps * cfg.critic_learning_rate / np.sqrt(1.0 - cfg.adam_beta2)


@pytest.fixture(scope="module")
def jax_exps(tmp_path_factory):
    """One JAX experiment per (family, mode), module-scoped to bound
    XLA:CPU compile time, and its initial states."""
    cache = {}

    def get(family, mode):
        if (family, mode) not in cache:
            out = str(tmp_path_factory.mktemp(f"jax_{family}_{mode}"))
            exp = jax_make_experiment(_config(JaxConfig, family, mode, output_dir=out))
            cache[family, mode] = (exp, _jax_states(exp))
        return cache[family, mode]

    return get


# -- config ------------------------------------------------------------------------

@pytest.mark.parametrize("family", FAMILIES)
def test_validate_accepts_bf16_in_both_modes_for_every_family(family):
    for mode, keys in MODES.items():
        port = _config(ExperimentConfig, family, mode).validate()
        ref = _config(JaxConfig, family, mode).validate()
        assert (port.compute_dtype, port.param_dtype) == (ref.compute_dtype, ref.param_dtype)
        assert port.compute_dtype == "bf16"  # storage implies compute
    for bad in (dict(compute_dtype="fp16"), dict(param_dtype="int8")):
        with pytest.raises(ValueError, match="unknown compute dtype"):
            JaxConfig(**SHAPES[family], **bad).validate()
        with pytest.raises(ValueError, match="unknown compute dtype"):
            ExperimentConfig(**SHAPES[family], **bad).validate()


def test_every_pass_runs_in_the_experiment_scope(monkeypatch, tmp_path):
    """The iteration, a window, the exports and WGAN-GP sampling all reach
    ``dense`` and the convolutions inside the experiment's bf16 scope."""
    seen = []
    for mod in (pt_linear, pt_conv):
        real = mod.get_compute_dtype
        monkeypatch.setattr(mod, "get_compute_dtype", lambda real=real: seen.append(real()) or real())
    x, y = _data("mnist", 2, seed=3)
    exp = make_experiment(_config(ExperimentConfig, "mnist", "mixed", output_dir=str(tmp_path)))
    exp.train_iteration(x[0], y[0])
    exp.train_iterations(x, y)
    exp.export_manifold(1)
    from gan_deeplearning4j_tpu_torch.data import ArrayDataSetIterator
    exp.export_predictions(ArrayDataSetIterator(x[0], y[0], batch_size=4), 1)
    wgan = make_experiment(_config(ExperimentConfig, "wgan_gp", "mixed", output_dir=str(tmp_path)))
    wgan.train_iteration(_data("wgan_gp", 1, seed=4)[0][0])
    wgan.sample(3)
    assert seen and set(seen) == {torch.bfloat16}
    seen.clear()
    exp32 = make_experiment(_config(ExperimentConfig, "tabular", "mixed", compute_dtype=None))
    exp32.train_iteration(_data("tabular", 1, seed=5)[0][0], _data("tabular", 1, seed=5)[1][0])
    assert seen and set(seen) == {torch.float32}


# -- one iteration under mixed precision ---------------------------------------------

# per family: (relative bound on each loss, bound on the params' worst
# leaf, leaves of one step's size apart), measured here at most: mnist
# 5.6e-5 / 0 / 4.3e-3 and 0.026 (``dis_conv2d_layer_2/W``), tabular 8e-8 /
# 0 and 1.8e-6, image 3.7e-5 / 1.4e-6 and 0.020
ITER_BOUNDS = {
    "mnist": ({"d_loss": 1e-3, "g_loss": 1e-3, "cv_loss": 3e-2}, 0.1),
    "tabular": ({"d_loss": 1e-5, "g_loss": 1e-5}, 1e-3),
    "image": ({"d_loss": 1e-3, "g_loss": 1e-3}, 0.06),
}


@pytest.mark.parametrize("family", ["mnist", "tabular", "image"])
def test_one_mixed_precision_iteration_matches_jax(jax_exps, family):
    """Losses, dtypes (all float32) and params after one fused iteration
    under ``compute_dtype="bf16"``; every param element within 2·lr per
    step of the reference (two dis steps, one gan and one cv step)."""
    jexp, init = jax_exps(family, "mixed")
    _set_jax_states(jexp, init)
    x, y = _data(family, 1, seed=1)
    jl = jexp.train_iteration(x[0], y[0])
    pexp = _port(family, "mixed", init)
    pl = pexp.train_iteration(x[0], y[0])
    loss_rtol, leaf_rel = ITER_BOUNDS[family]
    for k, rtol in loss_rtol.items():
        np.testing.assert_allclose(float(pl[k]), float(jl[k]), rtol=rtol, atol=0, err_msg=k)
    mismatched, div = _compare(pexp, _jax_states(jexp))
    assert mismatched == []
    assert div["max_leaf_rel"] <= leaf_rel
    assert div["max_abs"] <= _step_bound(pexp, 1)


# measured at most 0.057 (critic_dense/b; the weights' at most 0.009): a
# bias's gradient sums the cotangents of every row and position, and
# cancels
WGAN_GRAD_REL = 0.15


def test_first_wgan_steps_gradients_match_jax_under_mixed_precision(jax_exps):
    """The first critic step (the penalty's double backward through bf16
    convolutions) and a generator step, from the same state: losses and
    every gradient leaf. The round itself is held loosely (Adam at β1 = 0
    amplifies rounding, ``tests/test_torch_families.py``)."""
    jexp, init = jax_exps("wgan_gp", "mixed")
    _set_jax_states(jexp, init)
    x, _ = _data("wgan_gp", 1, seed=2)
    pexp = _port("wgan_gp", "mixed", init)
    jt = jexp.trainer
    real = x[0][: B // 2]
    key, _ = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(pexp.config.seed + 2), 0))
    _, sub = jax.random.split(key)
    zs, eps, gen_z = jax_draw_source(pexp.config.seed, pexp.model_cfg.z_size)(0, 2, B // 2)
    with jax_scope(jnp.bfloat16):
        jc_loss, jc_grads = jax.jit(jax.value_and_grad(jt._critic_loss))(
            jexp.critic_state.params, jexp.gen_state.params, real, sub)

        def gen_loss(gp):
            outs, _ = jt.generator.apply(gp, gen_z, train=True)
            fake = outs["gen_image"].reshape(gen_z.shape[0], -1)
            return -jnp.mean(jt.critic.output(jexp.critic_state.params, fake, train=False)[:, 0])

        jg_loss, jg_grads = jax.jit(jax.value_and_grad(gen_loss))(jexp.gen_state.params)
    from gan_deeplearning4j_tpu_torch.runtime.dtype import compute_dtype_scope

    t = torch.from_numpy
    with compute_dtype_scope(torch.bfloat16):
        pc_loss, pc_grads = pexp.trainer.critic_grads(
            pexp.critic_state.params, pexp.gen_state.params, t(real), t(zs[0]), t(eps[0]))
        pg_loss, pg_grads, _ = pexp.trainer.gen_grads(
            pexp.gen_state.params, pexp.critic_state.params, t(gen_z))
    np.testing.assert_allclose(float(pc_loss), float(jc_loss), rtol=1e-3)
    np.testing.assert_allclose(float(pg_loss), float(jg_loss), rtol=1e-2)
    for port, ref in ((pc_grads, jc_grads), (pg_grads, jg_grads)):
        flat_p = {f"{l}/{n}": g for l, lp in port.items() for n, g in lp.items()}
        flat_r = {f"{l}/{n}": np.asarray(ref[l][n]) for l, n in (k.split("/") for k in flat_p)}
        div = state_divergence(flat_p, flat_r)
        assert div["max_leaf_rel"] <= WGAN_GRAD_REL, div
    jl = jexp.train_iteration(x[0])
    pl = pexp.train_iteration(x[0])
    np.testing.assert_allclose(float(pl["d_loss"]), float(jl["d_loss"]), rtol=1e-2)
    mismatched, div = _compare(pexp, _jax_states(jexp))
    assert mismatched == [] and div["max_abs"] <= _adam_step_bound(pexp, pexp.model_cfg.n_critic)


# -- pure bf16 storage ---------------------------------------------------------------

STORAGE_LOSS_RTOL = 5e-2  # measured at most 1.9e-2 (mnist g_loss, second iteration)


@pytest.mark.parametrize("family", ["mnist", "tabular"])
def test_two_bf16_storage_iterations_match_jax(jax_exps, family):
    """Every leaf's dtype equals JAX's after each of two iterations
    (params, RmsProp caches and BatchNorm stats bf16), the losses are
    float32 and within ``STORAGE_LOSS_RTOL``, and every param element is
    within the step bound plus two bf16 ulps. (bf16 storage rounds each
    updated param to its ulp, which is larger than ``lr`` from |p| ≈ 0.25
    up, and leaves of one step's size flip wholesale: no normwise bound
    holds them.)"""
    jexp, init = jax_exps(family, "storage")
    _set_jax_states(jexp, init)
    x, y = _data(family, 2, seed=6)
    pexp = _port(family, "storage", init)
    for k in range(2):
        jl = jexp.train_iteration(x[k], y[k])
        pl = pexp.train_iteration(x[k], y[k])
        mismatched, div = _compare(pexp, _jax_states(jexp))
        assert mismatched == [], mismatched[:5]
        assert div["max_step_excess"] <= _step_bound(pexp, k + 1)
        for key in ("d_loss", "g_loss"):
            assert _dtype_name(pl[key]) == "float32"
            np.testing.assert_allclose(float(pl[key]), float(jl[key]), rtol=STORAGE_LOSS_RTOL, err_msg=key)
    assert {_dtype_name(v) for v in _flat_np(pexp.digest_states()).values()} == {"bfloat16"}


def _jax_round_unscanned(jexp, x):
    """One round of the JAX package's WGAN-GP, from its own pieces (its
    critic loss, optimizer and generator step, the same keys) with the
    critic steps run one by one: under bf16 storage its ``lax.scan`` critic
    round raises, because Adam changes the carried params' dtype."""
    jt, n = jexp.trainer, jexp.model_cfg.n_critic
    rng = jax.random.fold_in(jax.random.PRNGKey(jexp.config.seed + 2), int(jexp.gen_state.step))
    key, k_g = jax.random.split(rng)
    state = jexp.critic_state
    params, opt_state = state.params, state.opt_state
    with jax_scope(jnp.bfloat16):
        for real in jnp.asarray(x).reshape(n, x.shape[0] // n, -1):
            key, sub = jax.random.split(key)
            _, grads = jax.jit(jax.value_and_grad(jt._critic_loss))(params, jexp.gen_state.params, real, sub)
            params, opt_state = jax.jit(jt.critic_opt.step)(params, grads, opt_state)
        jexp.critic_state = type(state)(params, opt_state, state.step + n)
        z = jax.random.normal(k_g, (x.shape[0] // n, jexp.model_cfg.z_size), jnp.float32)
        jexp.gen_state, _ = jt._gen_step(jexp.gen_state, params, z)


def test_wgan_bf16_storage_dtypes_follow_jax_after_one_and_two_rounds(jax_exps):
    """The reference's Adam divides a bf16 m by a 0-d float32
    array, which jnp promotes: the params leave the first step float32,
    the moments the second. The port reproduces it leaf by leaf. The JAX
    package's own round cannot run it (its scan refuses the dtype change,
    ROADMAP.md §3), so the reference round is rebuilt from its pieces."""
    jexp, init = jax_exps("wgan_gp", "storage")
    _set_jax_states(jexp, init)
    x, _ = _data("wgan_gp", 2, seed=7)
    with pytest.raises(TypeError, match="carry input and carry output must have equal types"):
        jexp.train_iteration(x[0])
    _set_jax_states(jexp, init)
    pexp = _port("wgan_gp", "storage", init)
    want = {0: ("bfloat16", "bfloat16"), 1: ("float32", "float32"), 2: ("float32", "float32")}
    for k in range(3):
        port = _flat_np(pexp.digest_states())
        assert (_dtype_name(port["gen/params/gen_image/W"]),
                _dtype_name(port["critic/opt_state/critic_conv2d_1/W/m"])) == want[k]
        mismatched, div = _compare(pexp, _jax_states(jexp))
        assert mismatched == [], (k, mismatched[:5])
        assert div["max_step_excess"] <= _adam_step_bound(pexp, k * pexp.model_cfg.n_critic)
        if k < 2:
            _jax_round_unscanned(jexp, x[k])
            pexp.train_iteration(x[k])


# -- checkpoints ---------------------------------------------------------------------

def _assert_same_leaves(a, b):
    a, b = _flat_np(a), _flat_np(b)
    assert sorted(a) == sorted(b)
    for key in a:
        assert _dtype_name(a[key]) == _dtype_name(b[key]), key
        np.testing.assert_array_equal(_as_f32(a[key]), _as_f32(b[key]), err_msg=key)


def test_bf16_checkpoints_round_trip_between_the_packages(jax_exps, tmp_path):
    """bf16 leaves travel dtype-tagged both ways; a bf16 checkpoint
    restores as bf16."""
    jexp, init = jax_exps("tabular", "storage")
    _set_jax_states(jexp, init)
    x, y = _data("tabular", 1, seed=8)
    jexp.train_iteration(x[0], y[0])
    jexp.save_models(str(tmp_path / "jax"))
    pexp = _port("tabular", "storage", init)
    pexp.load_models(str(tmp_path / "jax"))
    _assert_same_leaves(pexp.digest_states(), _jax_states(jexp))
    pexp.train_iteration(x[0], y[0])
    pexp.save_models(str(tmp_path / "port"))
    for name, state in (("dis", pexp.dis_state), ("gan", pexp.gan_state)):
        path = tmp_path / "port" / f"{pexp.config.file_prefix}_{name}_model.zip"
        _, params, opt_state, step = jax_ser.read_model(str(path))
        assert step == state.step
        _assert_same_leaves({"m": {"params": params, "opt_state": opt_state}},
                            {"m": {"params": state.params, "opt_state": state.opt_state}})


def test_an_fp32_checkpoint_resumed_under_bf16_storage_is_cast_on_entry(tmp_path):
    x, y = _data("tabular", 1, seed=9)
    fp32 = make_experiment(_config(ExperimentConfig, "tabular", "mixed", compute_dtype=None))
    fp32.train_iteration(x[0], y[0])
    fp32.save_models(str(tmp_path))
    bf16 = make_experiment(_config(ExperimentConfig, "tabular", "storage"))
    assert bf16.load_models(str(tmp_path)) == 1
    got, want = flatten_states(bf16.digest_states()), flatten_states(fp32.digest_states())
    for key, value in want.items():
        if isinstance(value, torch.Tensor):
            assert got[key].dtype == torch.bfloat16, key
            assert torch.equal(got[key], value.to(torch.bfloat16)), key
        else:
            assert got[key] == value


@pytest.mark.parametrize("family,mode", [("tabular", "storage"), ("tabular", "mixed"), ("wgan_gp", "mixed")])
def test_bf16_resume_is_bit_exact(tmp_path, family, mode):
    """1 iteration + save + load + 1 equals 2 iterations, every leaf and
    dtype. (WGAN-GP under bf16 storage is not held to it: a checkpoint
    holds its Adam-promoted float32 params, which the load casts back to
    bf16, in the JAX package as here.)"""
    x, y = _data(family, 2, seed=10)

    def fresh():
        return make_experiment(_config(ExperimentConfig, family, mode, output_dir=str(tmp_path)))

    straight = fresh()
    for k in range(2):
        straight.train_iteration(x[k], y[k])
    first = fresh()
    first.train_iteration(x[0], y[0])
    first.save_models()
    resumed = fresh()
    resumed.load_models()
    resumed.train_iteration(x[1], y[1])
    a, b = flatten_states(straight.digest_states()), flatten_states(resumed.digest_states())
    assert sorted(a) == sorted(b)
    for key in a:
        if isinstance(a[key], torch.Tensor):
            assert a[key].dtype == b[key].dtype and torch.equal(a[key], b[key]), key
        else:
            assert a[key] == b[key], key


@pytest.mark.parametrize("mode", list(MODES))
def test_wgan_gp_saves_loads_and_publishes_in_both_bf16_modes(tmp_path, mode):
    """A round, ``save_models``, ``load_models`` into a fresh experiment
    (under bf16 storage the Adam-promoted float32 params are cast back to
    bf16 on entry), ``publish_for_serving``: the engine's ``sample`` equals
    the loaded generator computed in float32, as the engine computes a
    bundle without ``precision``."""
    x, _ = _data("wgan_gp", 1, seed=14)
    exp = make_experiment(_config(ExperimentConfig, "wgan_gp", mode, output_dir=str(tmp_path)))
    exp.train_iteration(x[0])
    exp.save_models()
    loaded = make_experiment(_config(ExperimentConfig, "wgan_gp", mode, output_dir=str(tmp_path)))
    assert loaded.load_models() == 1
    want_dtype = torch.bfloat16 if mode == "storage" else torch.float32
    assert {t.dtype for lp in loaded.gen_params.values() for t in lp.values()} == {want_dtype}
    manifest = loaded.publish_for_serving()
    engine = ServingEngine.from_bundle(manifest["directory"], buckets=(4,), device="cpu")
    assert engine.kinds == ("sample",)
    z = np.random.default_rng(15).standard_normal((3, loaded.model_cfg.z_size)).astype(np.float32)
    with torch.no_grad():
        want = loaded.gen.output(loaded.gen_params, torch.from_numpy(z)).reshape(3, -1).numpy()
    np.testing.assert_allclose(engine.run("sample", z), want, rtol=1e-6, atol=1e-6)


# -- serving ----------------------------------------------------------------------

# bf16 bundles, relative to the largest |output|: measured at most 1.2e-4
# (sample), 1.0e-3 (classify) and 4.0e-3 (features, the activations of a
# bf16 dense layer); the JAX engine's jitted convolutions keep float32
# where the port rounds to bf16, as the reference's code says
SERVE_REL = {"sample": 1e-3, "classify": 5e-3, "features": 1e-2}


def _serve_both(bundle):
    """``{kind: (port rows, JAX rows)}`` for n = 3, the same rows in."""
    port = ServingEngine.from_bundle(bundle, buckets=(4,), device="cpu")
    ref = JaxEngine.from_bundle(bundle, buckets=(4,))
    rng = np.random.default_rng(11)
    out = {}
    for kind in port.kinds:
        rows = rng.random((3, port.input_width(kind)), dtype=np.float32)
        out[kind] = (port.run(kind, rows), np.asarray(ref.run(kind, rows)))
    return port, out


def _assert_served_close(out, rel):
    for kind, (p, r) in out.items():
        assert p.dtype == np.float32 and np.isfinite(p).all()
        err = np.abs(p - r).max() / max(np.abs(r).max(), 1e-6)
        assert err <= rel[kind], (kind, err)


@pytest.fixture(scope="module")
def fp32_bundle(jax_exps, tmp_path_factory):
    """The MNIST generator and classifier as the JAX package publishes
    them (random init, float32)."""
    jexp, init = jax_exps("mnist", "mixed")
    _set_jax_states(jexp, init)
    directory = str(tmp_path_factory.mktemp("bundle") / "fp32")
    jexp.publish_for_serving(directory)
    return directory


def test_a_jax_bf16_variant_serves_in_the_port_like_the_jax_engine(fp32_bundle, tmp_path):
    jax_build_bf16_variant(fp32_bundle, str(tmp_path / "bf16"))
    port, out = _serve_both(str(tmp_path / "bf16"))
    assert set(out) == {"sample", "classify", "features"}
    assert port.stats()["precision"] == "bf16"
    fp32 = ServingEngine.from_bundle(fp32_bundle, buckets=(4,), device="cpu")
    assert 2 * port.resident_param_bytes() == fp32.resident_param_bytes()
    _assert_served_close(out, SERVE_REL)


def test_the_ports_bf16_variant_loads_in_the_jax_engine(fp32_bundle, tmp_path):
    manifest = build_bf16_variant(fp32_bundle, str(tmp_path / "bf16"))
    assert manifest["precision"] == "bf16" and manifest["quant"]["method"] == "bf16_cast"
    assert manifest["quant"]["source"] == "fp32"
    want = jax_build_bf16_variant(fp32_bundle, str(tmp_path / "jax_bf16"))
    assert {k: v for k, v in manifest.items() if k != "quant"} == \
        {k: v for k, v in want.items() if k != "quant"}
    assert set(manifest["quant"]) == set(want["quant"])
    _, params, _, _ = jax_ser.read_model(str(tmp_path / "bf16" / manifest["generator"]), load_updater=False)
    assert {str(a.dtype) for lp in params.values() for a in lp.values()} == {"bfloat16"}
    _, out = _serve_both(str(tmp_path / "bf16"))
    _assert_served_close(out, SERVE_REL)


def test_a_bf16_storage_runs_bundle_serves_in_fp32_like_the_jax_engine(jax_exps, tmp_path):
    """``publish_for_serving`` of a ``param_dtype="bf16"`` run: bf16 leaves
    and no ``precision``, computed in float32 by both engines."""
    _, init = jax_exps("mnist", "storage")
    pexp = _port("mnist", "storage", init, jax_draws=False)
    x, y = _data("mnist", 1, seed=12)
    pexp.train_iteration(x[0], y[0])
    manifest = pexp.publish_for_serving(str(tmp_path / "bundle"))
    assert "precision" not in manifest
    port, out = _serve_both(str(tmp_path / "bundle"))
    assert port.stats()["precision"] == "fp32"
    # bf16 running stats: BatchNorm inference's var + eps, sqrt and
    # reciprocal run in bf16, rounded per op here and fused by XLA there
    # (measured at most 1.5e-3, classify)
    _assert_served_close(out, {k: 5e-3 for k in out})
    z = np.random.default_rng(13).uniform(-1, 1, (3, 2)).astype(np.float32)
    with torch.no_grad():
        want = pexp.gen.output(pexp.gen_params, torch.from_numpy(z), train=False)
    # the engine pads 3 rows to its bucket of 4: float32 GEMM summation
    # order may differ in the last bit
    np.testing.assert_allclose(port.run("sample", z), want.reshape(3, -1).numpy(), rtol=1e-6, atol=1e-6)


