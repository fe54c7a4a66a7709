"""PyTorch port, the training path at full width (the reference's graphs,
batch 8) against the JAX package on the CPU.

The two packages' RNGs differ, so every random input is carried across:
the initial states of one JAX ``GanExperiment`` (module-scoped, to bound
XLA:CPU compile time) go into the port through ``train_state_from_numpy``,
and the port's ``z_source`` is fed the JAX package's own z draws,
recomputed from ``fold_in(PRNGKey(seed + 2), dis_step)`` split six ways
(``harness/experiment.py:438-458``). The label-softening ε comes from the
same numpy generator in both and is compared bit for bit.

Tolerances. One optimizer step of one graph: 1e-5 absolute and relative,
elementwise (float32 on the CPU on both sides; only summation orders
differ). A fused iteration is five optimizer steps, and RmsProp at
decay = eps = 1e-8 moves each param by about ``lr·sign(g)``: where a
gradient cancels to |g| ≲ 1e-4, a rounding difference becomes an update
difference of up to 2·lr in that element, and the next step's gradients
inherit it. So an iteration is compared leaf by leaf with
``state_divergence``'s normwise relative error, which a wrong rebind, label,
step key or learning rate moves by 1e-2 or more: from the same state in
both packages, losses within 1e-4 relative and every leaf within 5e-3
(measured at most 1.3e-3); two free-running iterations, where the sparse
differences of the first feed the second, losses within 1e-3 and leaves
within 5e-2 (measured 3.5e-4 and 2.3e-2). Inside the port, resume is
bit-exact.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_deeplearning4j_tpu.data import ArrayDataSetIterator as JaxArrayIterator
from gan_deeplearning4j_tpu.data.mnist import synthetic_mnist
from gan_deeplearning4j_tpu.harness import ExperimentConfig as JaxConfig
from gan_deeplearning4j_tpu.harness import GanExperiment as JaxExperiment
from gan_deeplearning4j_tpu.harness.experiment import _dis_lr_scale as jax_dis_lr_scale
from gan_deeplearning4j_tpu.harness.experiment import _one_opt_step as jax_one_opt_step
from gan_deeplearning4j_tpu.utils import serializer as jax_ser
from gan_deeplearning4j_tpu_torch.__main__ import main as pt_main
from gan_deeplearning4j_tpu_torch.data import ArrayDataSetIterator, one_hot_np
from gan_deeplearning4j_tpu_torch.harness import ExperimentConfig, GanExperiment
from gan_deeplearning4j_tpu_torch.harness.experiment import (
    flatten_states,
    forward_flops,
    state_divergence,
)
from gan_deeplearning4j_tpu_torch.interop import params_from_numpy, train_state_from_numpy
from gan_deeplearning4j_tpu_torch.models import registry
from gan_deeplearning4j_tpu_torch.parallel import GraphTrainer
from gan_deeplearning4j_tpu_torch.serving import ServingEngine

B = 8
TOL = dict(rtol=1e-5, atol=1e-5)
ITER_LOSS_RTOL, ITER_LEAF_REL = 1e-4, 5e-3
FREE_LOSS_RTOL, FREE_LEAF_REL = 1e-3, 5e-2


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


def _jax_states(exp):
    return {"dis": _np(exp.dis_state), "gan": _np(exp.gan_state), "CV": _np(exp.cv_state),
            "gen": _np(exp.gen_params)}


def _set_port_states(exp, states):
    exp.dis_state = train_state_from_numpy(states["dis"], "cpu", graph=exp.dis)
    exp.gan_state = train_state_from_numpy(states["gan"], "cpu", graph=exp.gan)
    exp.cv_state = train_state_from_numpy(states["CV"], "cpu", graph=exp.cv)
    exp.gen_params = params_from_numpy(states["gen"], "cpu", graph=exp.gen)


def _divergence(pexp, jstates):
    port = {f"{m}/{k}": v for m, st in pexp.digest_states().items() for k, v in _flat(st).items()}
    ref = {f"{m}/{k}": v for m, st in jstates.items() for k, v in _flat(st).items()}
    return state_divergence(port, ref)


def _assert_losses_close(port, ref, rtol):
    for k in ("d_loss", "g_loss", "cv_loss"):
        np.testing.assert_allclose(float(port[k]), float(ref[k]), rtol=rtol, atol=0, err_msg=k)


def _data(n=4 * B, seed=0):
    (x, y), _ = synthetic_mnist(num_train=n, num_test=1, seed=seed)
    return x, one_hot_np(y, 10)


def jax_z_source(seed, z_size=2):
    """The JAX fused iteration's z draws, as the port's ``z_source``."""
    base = jax.random.PRNGKey(seed + 2)

    def source(dis_step, batch):
        k_fake, k_gan, *_ = jax.random.split(jax.random.fold_in(base, dis_step), 6)
        return np.stack([
            np.asarray(jax.random.uniform(k, (batch, z_size), jnp.float32, -1.0, 1.0))
            for k in (k_fake, k_gan)
        ])

    return source


@pytest.fixture(scope="module")
def jax_exp(tmp_path_factory):
    cfg = JaxConfig(batch_size_train=B, batch_size_pred=16, latent_grid=4, save_models=False,
                    output_dir=str(tmp_path_factory.mktemp("jax_out")))
    exp = JaxExperiment(cfg)
    return exp, _jax_states(exp)


def _reset_jax(exp, init):
    exp.dis_state, exp.gan_state = _reown(init["dis"]), _reown(init["gan"])
    exp.cv_state, exp.gen_params = _reown(init["CV"]), _reown(init["gen"])
    exp.batch_counter = 0


def _port_experiment(init, **overrides):
    """A port experiment on the CPU holding the JAX experiment's initial
    states and drawing the JAX package's z."""
    cfg = dict(batch_size_train=B, batch_size_pred=16, latent_grid=4, save_models=False,
               use_accelerator=False)
    cfg.update(overrides)
    exp = GanExperiment(ExperimentConfig(**cfg))
    _set_port_states(exp, init)
    exp.z_source = jax_z_source(exp.config.seed)
    return exp


def _inputs(name, seed=1):
    x, y = _data(B, seed)
    if name == "dis":
        soft = (1.0 + 0.05 * np.random.default_rng(seed).standard_normal((B, 1))).astype(np.float32)
        return x, soft
    if name == "gan":
        z = np.random.default_rng(seed).uniform(-1, 1, (B, 2)).astype(np.float32)
        return z, np.ones((B, 1), np.float32)
    return x, y


_GRAPHS = {"dis": ("dis", "dis_state"), "gan": ("gan", "gan_state"), "cv": ("cv", "cv_state")}


@pytest.mark.parametrize("name", ["dis", "gan", "cv"])
def test_graph_loss_and_grads_match_jax(jax_exp, name):
    jexp, init = jax_exp
    attr, _ = _GRAPHS[name]
    jgraph = getattr(jexp, attr)
    params = init["CV" if name == "cv" else name].params
    x, y = _inputs(name)
    fn = jax.jit(jax.value_and_grad(lambda p: jgraph.loss(p, x, y, train=True), has_aux=True))
    (jloss, (_, jnew)), jgrads = fn(params)

    pexp = _port_experiment(init)
    graph = getattr(pexp, attr)
    trainer = GraphTrainer(graph)
    pparams = params_from_numpy(params, "cpu", graph=graph)
    keys = trainer.optimizer.trainable_keys(pparams)
    for layer, pname in keys:
        pparams[layer][pname].requires_grad_(True)
    ploss, (_, pnew) = graph.loss(pparams, torch.from_numpy(x), torch.from_numpy(y), train=True)
    pgrads = torch.autograd.grad(ploss, [pparams[l][n] for l, n in keys])
    np.testing.assert_allclose(float(ploss.detach()), float(jloss), **TOL)
    for (layer, pname), g in zip(keys, pgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jgrads[layer][pname]),
                                   err_msg=f"{layer}/{pname}", **TOL)
    # frozen layers (LR 0) get a gradient too: L2 and the chain rule reach them
    roles = graph.param_roles()
    frozen = [k for k in keys if graph.layer_updaters()[k[0]].learning_rate == 0.0]
    assert (name == "dis") == (not frozen)
    assert len(keys) == sum(r != "state" for lr in roles.values() for r in lr.values())
    _assert_states_close({k: {n: t.detach() for n, t in v.items()} for k, v in pnew.items()},
                         _np(jnew), TOL)


@pytest.mark.parametrize("name,lr_scale", [("dis", None), ("dis", 0.5), ("gan", None), ("cv", None)])
def test_one_optimizer_step_matches_jax(jax_exp, name, lr_scale):
    """Loss, params, RmsProp caches and BatchNorm running stats after one
    optimizer step of each graph (JAX ``GraphTrainer.train_step``; with the
    dis-LR decay factor, ``_one_opt_step``, the fused iteration's core)."""
    jexp, init = jax_exp
    attr, state_attr = _GRAPHS[name]
    key = "CV" if name == "cv" else name
    x, y = _inputs(name, seed=2)
    jtrainer = getattr(jexp, f"{attr}_trainer")
    if lr_scale is None:
        jstate, jloss = jtrainer.train_step(_reown(init[key]), x, y)
    else:
        jgraph, jopt = getattr(jexp, attr), jtrainer.optimizer
        jstate, jloss = jax.jit(lambda st: jax_one_opt_step(
            jgraph, jopt, st, x, y, None, lr_scale=jnp.float32(lr_scale)))(_reown(init[key]))

    pexp = _port_experiment(init)
    pstate, ploss = getattr(pexp, f"{attr}_trainer").train_step(
        getattr(pexp, state_attr), torch.from_numpy(x), torch.from_numpy(y), lr_scale)
    np.testing.assert_allclose(float(ploss), float(jloss), **TOL)
    assert pstate.step == 1
    _assert_states_close(pstate, _np(jstate), TOL)


def test_dis_lr_decay_factor_matches_jax(jax_exp):
    _, init = jax_exp
    pexp = _port_experiment(init, dis_lr_decay_every=3, dis_lr_decay_rate=0.9)
    jcfg = JaxConfig(dis_lr_decay_every=3, dis_lr_decay_rate=0.9)
    for step in range(0, 20, 2):
        np.testing.assert_allclose(pexp._dis_lr_scale(step),
                                   float(jax_dis_lr_scale(jcfg, jnp.int32(step))), rtol=1e-6)
    assert _port_experiment(init)._dis_lr_scale(10) is None  # off by default


def test_resampled_label_noise_is_keyed_by_step(jax_exp):
    _, init = jax_exp
    pexp = _port_experiment(init, resample_label_noise=True)
    a1, a0 = pexp._resampled_soft_labels(2, B)
    b1, _ = pexp._resampled_soft_labels(2, B)
    c1, _ = pexp._resampled_soft_labels(4, B)
    assert torch.equal(a1, b1) and not torch.equal(a1, c1)
    assert float((a1 - 1.0).abs().max()) < 0.5 and float(a0.abs().max()) < 0.5
    x, y = _data(B, seed=9)
    losses = pexp.train_iteration(x, y)
    assert np.isfinite([float(v) for v in losses.values()]).all()


def test_run_callbacks_and_metrics_log(jax_exp, tmp_path):
    """``eval_callback`` fires at print boundaries outside the throughput
    window; ``epilogue_callback`` fires after every iteration and a False
    return stops the loop cleanly; every iteration's losses reach the
    JSONL log."""
    _, init = jax_exp
    log = tmp_path / "metrics.jsonl"
    pexp = _port_experiment(init, num_iterations=4, print_every=2, loss_fetch_every=4,
                            output_dir=str(tmp_path / "out"), metrics_jsonl=str(log))
    evals, epilogues = [], []
    x, y = _data(4 * B, seed=10)
    result = pexp.run(
        ArrayDataSetIterator(x, y, batch_size=B),
        eval_callback=lambda exp, index: evals.append((index, exp.batch_counter)),
        epilogue_callback=lambda exp, index: epilogues.append(index) or index < 3,
    )
    pexp.metrics.close()
    assert evals == [(1, 0), (3, 2)]
    assert epilogues == [1, 2, 3] and result["iterations"] == 3
    rows = [json.loads(line) for line in log.read_text().splitlines()]
    assert [r["step"] for r in rows] == [0, 1, 2]
    assert set(rows[0]) == {"step", "time", "d_loss", "g_loss", "cv_loss", "images_per_sec"}


def test_label_softening_noise_is_bit_equal_to_jax(jax_exp):
    jexp, init = jax_exp
    pexp = _port_experiment(init)
    for b in (B, 3 * B):  # an oversized batch extends the noise once, in order
        jr, jf = jexp._soft_labels(b)
        pr, pf = pexp._soft_labels(b)
        np.testing.assert_array_equal(pr.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(pf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(pexp._eps_real, jexp._eps_real)


def test_two_fused_iterations_match_jax(jax_exp):
    """Losses, params, RmsProp caches and BatchNorm running stats of all
    four models over two fused iterations (dis ×2 → rebind → gan → gen
    refresh → cv): each iteration from the same state in both packages,
    then the two iterations free-running."""
    jexp, init = jax_exp
    _reset_jax(jexp, init)
    x, y = _data(2 * B, seed=3)
    batches = [(x[:B], y[:B]), (x[B:], y[B:])]
    jlosses, jstates = [], []
    for xb, yb in batches:
        jlosses.append(jexp.train_iteration(xb, yb))
        jstates.append(_jax_states(jexp))

    pexp = _port_experiment(init)
    for it, (xb, yb) in enumerate(batches):
        _set_port_states(pexp, init if it == 0 else jstates[it - 1])
        _assert_losses_close(pexp.train_iteration(xb, yb), jlosses[it], ITER_LOSS_RTOL)
        assert _divergence(pexp, jstates[it])["max_leaf_rel"] <= ITER_LEAF_REL

    free = _port_experiment(init)
    for it, (xb, yb) in enumerate(batches):
        _assert_losses_close(free.train_iteration(xb, yb), jlosses[it], FREE_LOSS_RTOL)
    assert _divergence(free, jstates[-1])["max_leaf_rel"] <= FREE_LEAF_REL
    assert free.dis_state.step == 4 and free.gan_state.step == 2 and free.cv_state.step == 2


def test_checkpoints_cross_between_the_packages(jax_exp, tmp_path):
    """A JAX ``save_models`` directory resumes in the port bit for bit, and
    a port ``save_models`` directory reads in JAX ``read_model`` and
    resumes in the JAX experiment bit for bit."""
    jexp, init = jax_exp
    _reset_jax(jexp, init)
    x, y = _data(B, seed=4)
    jexp.train_iteration(x, y)
    jexp.save_models(str(tmp_path / "from_jax"))
    pexp = _port_experiment(init)
    assert pexp.load_models(str(tmp_path / "from_jax")) == 1
    jstates = {"dis": jexp.dis_state, "gan": jexp.gan_state, "CV": jexp.cv_state,
               "gen": jexp.gen_params}
    for model, pstate in pexp.digest_states().items():
        _assert_states_close(pstate, _np(jstates[model]), dict(rtol=0, atol=0))

    pexp.train_iteration(x, y)
    written = pexp.save_models(str(tmp_path / "from_port"))
    assert [os.path.basename(p) for p in written] == [
        "mnist_dis_model.zip", "mnist_gan_model.zip", "mnist_gen_model.zip", "mnist_CV_model.zip"]
    _, params, opt_state, step = jax_ser.read_model(str(tmp_path / "from_port" / "mnist_gan_model.zip"))
    assert step == 2
    _assert_states_close(pexp.gan_state.params, _np(params), dict(rtol=0, atol=0))
    _assert_states_close(pexp.gan_state.opt_state, _np(opt_state), dict(rtol=0, atol=0))
    assert jexp.load_models(str(tmp_path / "from_port")) == 2
    for model, pstate in pexp.digest_states().items():
        jstate = {"dis": jexp.dis_state, "gan": jexp.gan_state, "CV": jexp.cv_state,
                  "gen": jexp.gen_params}[model]
        _assert_states_close(pstate, _np(jstate), dict(rtol=0, atol=0))


def test_resume_inside_the_port_is_bit_exact(tmp_path):
    """2 iterations, save, load into a fresh experiment, 2 more: the same
    states as 4 straight iterations, bit for bit (the port's own init and
    z stream)."""
    cfg = ExperimentConfig(batch_size_train=B, save_models=False, use_accelerator=False)
    x, y = _data(4 * B, seed=5)
    straight = GanExperiment(cfg)
    for i in range(4):
        straight.train_iteration(x[i * B:(i + 1) * B], y[i * B:(i + 1) * B])
    first = GanExperiment(cfg)
    for i in range(2):
        first.train_iteration(x[i * B:(i + 1) * B], y[i * B:(i + 1) * B])
    first.save_models(str(tmp_path))
    resumed = GanExperiment(cfg)
    assert resumed.load_models(str(tmp_path)) == 2
    for i in range(2, 4):
        resumed.train_iteration(x[i * B:(i + 1) * B], y[i * B:(i + 1) * B])
    a, b = flatten_states(straight.digest_states()), flatten_states(resumed.digest_states())
    assert sorted(a) == sorted(b)
    for key in a:
        if isinstance(a[key], torch.Tensor):
            assert torch.equal(a[key], b[key]), key
        else:
            assert a[key] == b[key], key


def test_run_matches_jax_files_metrics_and_losses(jax_exp, tmp_path):
    """``run()`` over 3 iterations with a window of 2 (exports at 0 and 2,
    checkpoints at 0 and at the end): the same files and metrics keys as
    the JAX package's run, and the losses of the first iteration and of
    the windowed second within the iteration tolerances (the third is
    free-running chaos and only has to be finite)."""
    jexp, init = jax_exp
    common = dict(batch_size_train=B, batch_size_pred=16, latent_grid=4, num_iterations=3,
                  print_every=2, save_every=2, checkpoint_every=4, loss_fetch_every=2)
    (xtr, ytr), (xte, yte) = synthetic_mnist(4 * B, 32, seed=6)
    ytr, yte = one_hot_np(ytr, 10), one_hot_np(yte, 10)

    jrun = JaxExperiment(JaxConfig(output_dir=str(tmp_path / "jax"), **common))
    _reset_jax(jrun, init)
    jres = jrun.run(JaxArrayIterator(xtr, ytr, batch_size=B), JaxArrayIterator(xte, yte, batch_size=16))

    pexp = _port_experiment(init, output_dir=str(tmp_path / "port"), save_models=True,
                            profile_dir=str(tmp_path / "trace"),
                            **{k: v for k, v in common.items() if k != "batch_size_train"})
    pres = pexp.run(ArrayDataSetIterator(xtr, ytr, batch_size=B), ArrayDataSetIterator(xte, yte, batch_size=16))

    assert pres["iterations"] == jres["iterations"] == 3
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    assert "mnist_out_3.csv" in os.listdir(tmp_path / "port")
    assert [sorted(h) for h in pres["history"]] == [sorted(h) for h in jres["history"]]
    _assert_losses_close(pres["history"][0], jres["history"][0], ITER_LOSS_RTOL)
    _assert_losses_close(pres["history"][1], jres["history"][1], FREE_LOSS_RTOL)
    assert np.isfinite([h[k] for h in pres["history"] for k in h]).all()
    assert set(pres["timings"]) >= {"train_fused", "train_window", "export_manifold", "checkpoint"}
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0  # profile_dir's capture


def test_publish_for_serving_loads_in_the_port_engine(jax_exp, tmp_path):
    jexp, init = jax_exp
    pexp = _port_experiment(init)
    x, y = _data(B, seed=7)
    pexp.train_iteration(x, y)
    manifest = pexp.publish_for_serving(str(tmp_path / "port"))
    jexp.publish_for_serving(str(tmp_path / "jax"))
    with open(tmp_path / "port" / "serving.json") as fh:
        port_doc = json.load(fh)
    with open(tmp_path / "jax" / "serving.json") as fh:
        jax_doc = json.load(fh)
    assert sorted(port_doc) == sorted(jax_doc)
    assert {k: v for k, v in port_doc.items() if k != "step"} == \
        {k: v for k, v in jax_doc.items() if k != "step"}
    assert manifest["step"] == 1 and manifest["zoo"]["dataset"] == "mnist"

    engine = ServingEngine.from_bundle(str(tmp_path / "port"), device="cpu")
    z = np.random.default_rng(8).uniform(-1, 1, (5, 2)).astype(np.float32)
    with torch.no_grad():
        want_sample = pexp.gen.output(pexp.gen_params, torch.from_numpy(z)).reshape(5, -1).numpy()
        want_cls = pexp.cv.output(pexp.cv_state.params, torch.from_numpy(x[:5])).numpy()
    np.testing.assert_allclose(engine.run("sample", z), want_sample, **TOL)
    np.testing.assert_allclose(engine.run("classify", x[:5]), want_cls, **TOL)


def test_cli_trains_on_the_cpu_only_when_asked(tmp_path, capsys):
    args = ["--batch-size-train", "16", "--batch-size-pred", "100", "--num-iterations", "1",
            "--latent-grid", "4", "--data-dir", str(tmp_path / "data"),
            "--output-dir", str(tmp_path / "out")]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pt_main(args)
    assert pt_main(args + ["--use-accelerator", "false"]) == 0
    out = capsys.readouterr().out
    assert "Transfer-classifier accuracy:" in out and "Manifold image:" in out
    assert sorted(os.listdir(tmp_path / "out")) == sorted([
        "DCGAN_Generated_Images.png", "mnist_CV_model.zip", "mnist_dis_model.zip",
        "mnist_gan_model.zip", "mnist_gen_model.zip", "mnist_out_1.csv",
        "mnist_test_predictions_1.csv"])
    assert np.loadtxt(tmp_path / "out" / "mnist_out_1.csv", delimiter=",").shape == (16, 784)


@pytest.mark.parametrize("overrides,item", [
    (dict(distributed="pmean"), None),
    (dict(distributed="pmean", update_sharding=True), None),
    (dict(compute_dtype="bf16"), None),
    (dict(param_dtype="bf16"), None),
    (dict(conditioning="class"), None),
    (dict(model_family="image", height=32, width=32, channels=3, num_features=3072,
          conditioning="class"), None),
    (dict(prefetch=2), None),
])
def test_validate_refuses_what_the_port_lacks(overrides, item):
    """Each case names the ROADMAP.md item the port refuses it for; a case
    with no item is a feature a slice has brought, which validates as it
    does in the JAX package."""
    if item is None:
        cfg = ExperimentConfig(**overrides).validate()
        if "distributed" in overrides:
            JaxConfig(**overrides).validate()
            assert (cfg.distributed, cfg.update_sharding) == (
                "pmean", overrides.get("update_sharding", False))
        elif "prefetch" in overrides:
            assert cfg.prefetch == 2
        elif "conditioning" in overrides:
            JaxConfig(**overrides).validate()
            assert cfg.conditioning == "class"
        else:
            assert cfg.compute_dtype == "bf16"
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md queue 1, '{item}'"):
        ExperimentConfig(**overrides).validate()


def test_config_defaults_and_overrides_match_jax(tmp_path):
    assert ExperimentConfig().__dict__ == JaxConfig().__dict__
    argv = ["--num-iterations", "5", "--seed", "1", "--use-accelerator", "false"]
    assert ExperimentConfig.from_args(argv).__dict__ == JaxConfig.from_args(argv).__dict__
    path = str(tmp_path / "c.json")
    JaxConfig(num_iterations=7).to_json(path)
    assert ExperimentConfig.from_json(path).num_iterations == 7
    with pytest.raises(ValueError):
        ExperimentConfig(distributed="spark").validate()
    with pytest.raises(KeyError, match="unknown model family"):
        registry.get("bogus")


def test_unported_entry_points_raise_and_the_default_device_is_the_card(jax_exp, tmp_path):
    _, init = jax_exp
    pexp = _port_experiment(init)
    with pytest.raises(TypeError, match="DataMesh"):
        GraphTrainer(pexp.dis, mesh=object())
    # publishing into a store is ported: a generation of kind "serving"
    from gan_deeplearning4j_tpu_torch.resilience import CheckpointStore

    store = CheckpointStore(str(tmp_path / "store"))
    published = pexp.publish_for_serving(store=store)
    assert published["generation"] == 0
    assert store.latest_valid().manifest["kind"] == "serving"
    # a mesh-shard directory (here one shard of one) loads
    pexp.train_iteration(*_data(B, seed=5))
    shards = tmp_path / "shards"
    shards.mkdir()
    pexp.save_model_shard(str(shards), 0, 1)
    again = _port_experiment(init)
    assert again.load_models(str(shards)) == 1
    want, got = flatten_states(pexp.digest_states()), flatten_states(again.digest_states())
    assert sorted(got) == sorted(want)
    for key in want:
        assert torch.equal(torch.as_tensor(got[key]), torch.as_tensor(want[key])), key
    if torch.cuda.is_available():
        assert GanExperiment(ExperimentConfig(batch_size_train=B)).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            GanExperiment(ExperimentConfig(batch_size_train=B))


def test_flops_per_iteration_counts_the_dense_and_conv_layers(jax_exp):
    _, init = jax_exp
    pexp = _port_experiment(init)
    # gen at batch 1: dense 2→1024, 1024→6272, conv5 128→64 at 14², conv5 64→1 at 28²
    gen = 2 * (2 * 1024 + 1024 * 6272 + 14 * 14 * 25 * 128 * 64 + 28 * 28 * 25 * 64)
    assert forward_flops(pexp.gen, 1) == gen
    dis = 2 * (12 * 12 * 25 * 64 + 4 * 4 * 25 * 64 * 128 + 3 * 3 * 128 * 1024 + 1024)
    assert forward_flops(pexp.dis, 1) == dis
    cv = dis - 2 * 1024 + 2 * 1024 * 10
    assert pexp.flops_per_iteration(1) == gen + 3 * (2 * dis + (gen + dis) + cv)


@pytest.mark.parametrize("name", ["dis", "gan", "cv"])
def test_summary_and_named_param_protocol_match_jax(jax_exp, name):
    jexp, init = jax_exp
    pexp = _port_experiment(init)
    jgraph, pgraph = getattr(jexp, name), getattr(pexp, name)
    assert pgraph.summary() == jgraph.summary()
    assert {k: u.to_dict() for k, u in pgraph.layer_updaters().items()} == \
        {k: u.to_dict() for k, u in jgraph.layer_updaters().items()}
    assert pgraph.param_roles() == jgraph.param_roles()
    assert [v.name for v in pgraph.output_layers()] == [v.name for v in jgraph.output_layers()]
    params = pexp.digest_states()["CV" if name == "cv" else name].params
    layer = next(iter(params))
    w = next(iter(params[layer]))
    new = pgraph.set_param(params, layer, w, torch.zeros_like(params[layer][w]))
    assert float(pgraph.get_param(new, layer, w).abs().sum()) == 0.0
    assert pgraph.get_param(params, layer, w) is params[layer][w]  # the input is untouched
    with pytest.raises(KeyError, match="unknown layer"):
        pgraph.set_param(params, "bogus", w, params[layer][w])
    with pytest.raises(ValueError, match="shape mismatch"):
        pgraph.set_param(params, layer, w, torch.zeros(3))
    with pytest.raises(KeyError, match="not in params"):
        pgraph.copy_params(params, params, {"bogus": layer})
