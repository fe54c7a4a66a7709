"""PyTorch port, data-parallel training on the CPU: N gloo ranks of the port
against the JAX package on a mesh of N fake CPU devices, N in (2, 4).

The JAX side runs here, on ``jax.sharding.Mesh(devices[:N], ("data",))``
(conftest's 8 fake devices). The port side is N processes spawned once per
N by ``parallel/launch.py::spawn`` (one torch thread each), every rank
running every scenario of ``parallel/drill.py`` (``run_all``); the results
come back as numpy and each check below is a test case of its own.

What is held, and how:
- ``GraphTrainer`` on a mesh (the JAX tests' BN classifier, 3 steps): the
  losses and every leaf against the JAX mesh step within the JAX test's
  tolerance (rtol 1e-4, atol 1e-5), and against one process at the global
  batch (the same thread count: one);
- the fused ``pmean`` iteration (tabular family, batch 16, the JAX
  package's initial states and z injected): losses 1e-4 relative, every
  leaf 5e-3 normwise (``state_divergence``), as one iteration is held in
  ``tests/test_torch_families.py``; and world N against one process;
- ``fit_rounds`` (k = 2 rounds, averaging frequency 3, 4 rows a worker)
  and ``fit`` over a row-major stream (the ``_worker_major`` regroup and the
  tail round) against the JAX trainer, rtol 1e-4, atol 1e-5;
- the per-fit averaging body (``train_iterations``, a window of 2) with
  the JAX package's worker-local z injected, against those iterations
  built from the JAX package's functions worker by worker
  (``_jax_per_fit_averaging`` says why not its shard_map'd body), at the
  one-iteration limits on the first losses and the two-iteration limits
  (1e-3, 5e-2) at the end; the phased averaging iteration
  (``train_iteration``) against the JAX package's, its host z injected, at
  the one-iteration limits;
- the WGAN-GP ``pmean`` round (two critic steps and the generator step,
  the JAX draws injected) at ``test_one_wgan_round_matches_jax``'s limits;
- every rank ends with the same bits; no child has ``jax`` loaded;
- mesh checkpoints: a JAX generation of 4 shards loads in the port at
  world 1, 2 and 4 bit for bit, the port's shards load in the JAX
  ``load_models`` bit for bit, the port writes the JAX package's
  ``arrays.npz`` bytes and ``meta.json`` for the same state, and two
  iterations restored from the port's shards equal the two taken before;
- the JAX package's ``ValueError``s, word for word; a stalled rank makes
  ``spawn`` raise within its timeout.
"""

import json
import os
import time
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gan_deeplearning4j_tpu.data import ArrayDataSetIterator as JaxArrayIterator
from gan_deeplearning4j_tpu.harness import ExperimentConfig as JaxConfig
from gan_deeplearning4j_tpu.harness import make_experiment as jax_make_experiment
from gan_deeplearning4j_tpu.parallel import GraphTrainer as JaxGraphTrainer
from gan_deeplearning4j_tpu.parallel import ParameterAveragingTrainer as JaxAveraging
from gan_deeplearning4j_tpu_torch.harness import ExperimentConfig, make_experiment
from gan_deeplearning4j_tpu_torch.harness.experiment import flatten_states, state_divergence
from gan_deeplearning4j_tpu_torch.parallel import drill
from gan_deeplearning4j_tpu_torch.parallel.launch import spawn
from tests.test_parallel import small_classifier, toy_data
from tests.test_torch_families import jax_draw_source, jax_z_source

WORLDS = (2, 4)
B = 16
TOL = dict(rtol=1e-4, atol=1e-5)
ITER_LOSS_RTOL, ITER_LEAF_REL = 1e-4, 5e-3
FREE_LOSS_RTOL, FREE_LEAF_REL = 1e-3, 5e-2
FREQ, ROUND_B, ROUNDS = 3, 4, 2
SHAPES = {
    "tabular": dict(model_family="tabular", num_features=32, z_size=8),
    "wgan_gp": dict(model_family="wgan_gp", height=8, width=8, channels=3, num_features=192,
                    z_size=4, n_critic=2),
}


def _config(family, **overrides):
    cfg = dict(SHAPES[family], batch_size_train=B, batch_size_pred=B, latent_grid=2,
               save_models=False)
    cfg.update(overrides)
    return cfg


def _mesh(n):
    return jax.sharding.Mesh(np.array(jax.devices()[:n]), ("data",))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_state(state):
    return {"params": _np(state.params), "opt_state": _np(state.opt_state),
            "step": int(np.asarray(state.step))}


def _jax_states(exp):
    if hasattr(exp, "critic_state"):
        return {"critic": _jax_state(exp.critic_state), "gen": _jax_state(exp.gen_state)}
    return {"dis": _jax_state(exp.dis_state), "gan": _jax_state(exp.gan_state),
            "gen": _np(exp.gen_params)}


def _flat_jax(states):
    """``flatten_states`` keys (``<model>/params|opt_state|step``) of JAX
    states as numpy."""
    out = {}

    def walk(prefix, node):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(f"{prefix}/{k}", v)
        else:
            out[prefix] = np.asarray(node)

    for name, st in states.items():
        walk(name, st)
    return out


def _data(n, features, seed):
    rng = np.random.default_rng(seed)
    x = rng.random((n, features), dtype=np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, n)]
    return x, y


def _avg_z_source(seed, z_size, workers, b):
    """The JAX per-fit averaging body's worker-local z, worker-major: for
    worker w, ``uniform(fold_in(k, w))`` of ``k_fake`` and ``k_gan`` split
    from ``fold_in(PRNGKey(seed + 2), dis_step)``."""
    base = jax.random.PRNGKey(seed + 2)

    def draws(dis_step):
        k_fake, k_gan, *_ = jax.random.split(jax.random.fold_in(base, dis_step), 6)
        return np.stack([
            np.concatenate([np.asarray(jax.random.uniform(jax.random.fold_in(k, w), (b, z_size),
                                                          jnp.float32, -1.0, 1.0))
                            for w in range(workers)])
            for k in (k_fake, k_gan)
        ])

    return draws


def _jax_per_fit_averaging(exp, n, windows, z_source):
    """The JAX package's per-fit averaging iterations (``_build_fused_avg_body``
    of a family without a classifier), from its own functions, worker by
    worker: two local ``_one_opt_step`` of the discriminator, the mean of
    params and updater state over the workers, the rebind, a local
    generator step, the mean, the sampler refresh; the losses the workers'
    means. Built by hand because on the installed jax the shard_map'd body
    differentiates the replicated state with its cotangent summed over the
    workers (the transpose of the implicit replicated-to-varying cast), so
    its "local" steps apply the summed gradient; the JAX package's own
    ``ParameterAveragingTrainer`` marks its carry varying first
    (``_to_varying``) and keeps them local, which is the semantics both the
    body's docstring and the port's ``_avg_body`` state."""
    from gan_deeplearning4j_tpu.harness.experiment import _one_opt_step, _rebind
    from gan_deeplearning4j_tpu.nn import ComputationGraph as JaxGraph
    from gan_deeplearning4j_tpu.parallel import TrainState as JaxState

    b = windows.shape[1] // n
    soft1, soft0 = exp._soft_labels(windows.shape[1])
    key = jax.random.PRNGKey(0)
    dis, gan, gen = exp.dis_state, exp.gan_state, exp.gen_params
    dis_opt, gan_opt = exp.dis_trainer.optimizer, exp.gan_trainer.optimizer

    def mean(states):
        params = jax.tree_util.tree_map(lambda *xs: sum(xs) / len(xs), *[s.params for s in states])
        opt = jax.tree_util.tree_map(lambda *xs: sum(xs) / len(xs), *[s.opt_state for s in states])
        return JaxState(params, opt, states[0].step)

    losses = []
    for x in windows:
        z = z_source(int(dis.step))
        workers, d = [], []
        for w in range(n):
            rows = slice(w * b, (w + 1) * b)
            fake = exp.gen.output(gen, jnp.asarray(z[0][rows]), train=False).reshape(b, -1)
            st, d1 = _one_opt_step(exp.dis, dis_opt, dis, jnp.asarray(x[rows]), soft1[rows], key)
            st, d2 = _one_opt_step(exp.dis, dis_opt, st, fake, soft0[rows], key)
            workers.append(st)
            d.append((float(d1) + float(d2)) / 2.0)
        dis = mean(workers)
        gan = _rebind(dis, gan, exp.dis_to_gan)
        workers, g = [], []
        for w in range(n):
            rows = slice(w * b, (w + 1) * b)
            st, gl = _one_opt_step(exp.gan, gan_opt, gan, jnp.asarray(z[1][rows]),
                                   jnp.ones((b, 1), jnp.float32), key)
            workers.append(st)
            g.append(float(gl))
        gan = mean(workers)
        gen = JaxGraph.copy_params(gan.params, gen, exp.gan_to_gen)
        losses.append({"d_loss": float(np.mean(d)), "g_loss": float(np.mean(g)),
                       "cv_loss": float("nan")})
    states = {"dis": _jax_state(dis), "gan": _jax_state(gan), "gen": _np(gen)}
    return {"losses": losses, "states": states}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``{N: (jax results, port results by rank)}``: the JAX package on a
    mesh of N and one spawn of N port ranks running every scenario."""
    graph = small_classifier()
    topology = graph.to_dict()
    params = _np(graph.init())
    gx, gy = toy_data(32)
    out = {}
    for n in WORLDS:
        mesh = _mesh(n)
        ref, scen = {}, {}
        base = str(tmp_path_factory.mktemp(f"world{n}"))

        # GraphTrainer pmean steps
        trainer = JaxGraphTrainer(graph, mesh=mesh, donate=False)
        state = trainer.init_state(params=jax.tree_util.tree_map(jnp.asarray, params))
        losses = []
        for _ in range(3):
            state, loss = trainer.train_step(state, jnp.asarray(gx), jnp.asarray(gy))
            losses.append(float(loss))
        ref["graph"] = {"losses": np.asarray(losses), "state": _jax_state(state)}
        scen["graph"] = ("graph_steps", dict(topology=topology, params=params, features=gx,
                                             labels=gy, steps=3))

        # averaging rounds and fit over a stream
        rx, ry = toy_data(ROUNDS * n * FREQ * ROUND_B, seed=1)
        rx = rx.reshape(ROUNDS, n * FREQ * ROUND_B, -1)
        ry = ry.reshape(ROUNDS, n * FREQ * ROUND_B, -1)
        sx, sy = toy_data(n * FREQ * ROUND_B + 3 * n + 1, seed=2)
        pa = JaxAveraging(graph, mesh, batch_size_per_worker=ROUND_B, averaging_frequency=FREQ)
        st, rl = pa.fit_rounds(pa.init_state(params=jax.tree_util.tree_map(jnp.asarray, params)),
                               jnp.asarray(rx), jnp.asarray(ry), jax.random.PRNGKey(0))
        fst, fl = pa.fit(pa.init_state(params=jax.tree_util.tree_map(jnp.asarray, params)),
                         JaxArrayIterator(sx, sy, batch_size=8))
        ref["avg"] = {"losses": np.asarray(rl), "state": _jax_state(st),
                      "fit": {"losses": np.asarray(fl), "state": _jax_state(fst)}}
        scen["avg"] = ("averaging_rounds", dict(topology=topology, params=params, rounds_x=rx,
                                                rounds_y=ry, freq=FREQ, batch=ROUND_B,
                                                stream_x=sx, stream_y=sy, stream_batch=8))

        # the fused pmean iteration, tabular
        x, y = _data(B, 32, seed=3)
        jexp = jax_make_experiment(JaxConfig(**_config("tabular", distributed="pmean",
                                                       output_dir=base + "/jax_pmean")), mesh=mesh)
        init = _jax_states(jexp)
        zsrc = jax_z_source(jexp.config.seed, jexp.model_cfg.z_size)
        jl = jexp.train_iteration(x, y)
        ref["pmean"] = {"losses": {k: float(v) for k, v in jl.items()}, "states": _jax_states(jexp)}
        # a JAX mesh generation of 4 shards of that state
        jax_gen = os.path.join(base, "jax_gen")
        os.makedirs(jax_gen)
        for k in range(4):
            jexp.save_model_shard(jax_gen, k, 4)
        ref["jax_gen"] = jax_gen
        scen["pmean"] = ("experiment_run", dict(
            config=_config("tabular", distributed="pmean", use_accelerator=False),
            states=init, batches=x[None], labels=y[None], draws={0: zsrc(0, B)}, solo=True))
        scen["load_jax_gen"] = ("load_generation", dict(
            config=_config("tabular", distributed="pmean", use_accelerator=False),
            directory=jax_gen))

        # mesh shards written by the port, restored and replayed
        port_gen = os.path.join(base, "port_gen")
        os.makedirs(port_gen)
        xs, ys = _data(2 * B, 32, seed=4)
        scen["shards"] = ("experiment_run", dict(
            config=_config("tabular", distributed="pmean", use_accelerator=False),
            states=init, batches=xs.reshape(2, B, -1), labels=ys.reshape(2, B, -1),
            draws={s: zsrc(s, B) for s in (0, 2, 4, 6)}, shards_dir=port_gen, restore=True))
        ref["port_gen"] = port_gen

        # the per-fit averaging body, a window of 2
        wx, wy = _data(2 * B, 32, seed=5)
        wx, wy = wx.reshape(2, B, -1), wy.reshape(2, B, -1)
        aexp = jax_make_experiment(JaxConfig(**_config(
            "tabular", distributed="param_averaging", batch_size_per_worker=B // n,
            output_dir=base + "/jax_avg")), mesh=mesh)
        ainit = _jax_states(aexp)
        zavg = _avg_z_source(aexp.config.seed, aexp.model_cfg.z_size, n, B // n)
        ref["avg_body"] = _jax_per_fit_averaging(aexp, n, wx, zavg)
        # the phased averaging iteration (train_iteration): its z comes from
        # the host generator seeded seed + 1, fakes first
        zrng = np.random.default_rng(aexp.config.seed + 1)
        zph = np.stack([zrng.random((B, 8), dtype=np.float32) * 2.0 - 1.0 for _ in range(2)])
        pl = aexp.train_iteration(wx[0], wy[0])
        ref["avg_phased"] = {"losses": {k: float(v) for k, v in pl.items()},
                             "states": _jax_states(aexp)}
        scen["avg_phased"] = ("experiment_run", dict(
            config=_config("tabular", distributed="param_averaging", batch_size_per_worker=B // n,
                           use_accelerator=False),
            states=ainit, batches=wx[:1], labels=wy[:1], draws={0: zph}))
        scen["avg_body"] = ("experiment_run", dict(
            config=_config("tabular", distributed="param_averaging", batch_size_per_worker=B // n,
                           use_accelerator=False),
            states=ainit, batches=wx, labels=wy, draws={0: zavg(0), 2: zavg(2)}, window=True))

        # the WGAN-GP pmean round
        wgx, _ = _data(B, 192, seed=6)
        gexp = jax_make_experiment(JaxConfig(**_config("wgan_gp", distributed="pmean",
                                                       output_dir=base + "/jax_wgan")), mesh=mesh)
        ginit = _jax_states(gexp)
        gl = gexp.train_iteration(wgx)
        ref["wgan"] = {"losses": {k: float(v) for k, v in gl.items()}, "states": _jax_states(gexp)}
        draw = jax_draw_source(gexp.config.seed, gexp.model_cfg.z_size)
        scen["wgan"] = ("experiment_run", dict(
            config=_config("wgan_gp", distributed="pmean", use_accelerator=False),
            states=ginit, batches=wgx[None], draws={0: draw(0, 2, B // 2)}, solo=True))

        t0 = time.perf_counter()
        port = spawn(drill.run_all, n, (scen,), timeout=240, threads=1)
        ref["spawn_seconds"] = time.perf_counter() - t0
        out[n] = (ref, port)
    return out


def _assert_tree_close(port, ref, tol=TOL):
    p, r = _flat_jax(port), _flat_jax(ref)
    assert sorted(p) == sorted(r)
    for key in r:
        np.testing.assert_allclose(p[key], r[key], err_msg=key, **tol)


def _divergence(port_flat, jax_states, rounding_only=()):
    return state_divergence(port_flat, _flat_jax(jax_states), rounding_only)


def _losses_close(port, ref, rtol, keys=("d_loss", "g_loss", "cv_loss")):
    for k in keys:
        if np.isnan(ref[k]):
            assert np.isnan(port[k]), k
        else:
            np.testing.assert_allclose(port[k], ref[k], rtol=rtol, atol=0, err_msg=k)


def _loss_rows(losses):
    return np.asarray([[row[k] for k in sorted(row)] for row in losses])


def _ranks_bit_equal(results, key):
    first = results[0][key]
    for other in results[1:]:
        a, b = _flat_jax(first), _flat_jax(other[key])
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{key}: {k}")


@pytest.mark.parametrize("n", WORLDS)
def test_graph_trainer_pmean_step_matches_jax_mesh(runs, n):
    ref, port = runs[n]
    got = port[0]["graph"]["pmean"]
    np.testing.assert_allclose(got["losses"], ref["graph"]["losses"], rtol=1e-4)
    _assert_tree_close(got["state"], ref["graph"]["state"])


@pytest.mark.parametrize("n", WORLDS)
def test_graph_trainer_world_n_equals_one_process_at_the_global_batch(runs, n):
    _, port = runs[n]
    got, solo = port[0]["graph"]["pmean"], port[0]["graph"]["solo"]
    np.testing.assert_allclose(got["losses"], solo["losses"], rtol=1e-5)
    _assert_tree_close(got["state"], solo["state"])


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("scenario", ["graph", "avg", "pmean", "shards", "avg_body", "avg_phased",
                                      "wgan"])
def test_ranks_end_bit_identical(runs, n, scenario):
    _, port = runs[n]
    ranks = [r[scenario] for r in port]
    if scenario == "graph":
        _ranks_bit_equal([r["pmean"] for r in ranks], "state")
    elif scenario == "avg":
        _ranks_bit_equal(ranks, "state")
        _ranks_bit_equal([r["fit"] for r in ranks], "state")
    else:
        _ranks_bit_equal(ranks, "states")
        for r in ranks:  # NaN (no classifier) equals NaN here
            np.testing.assert_array_equal(_loss_rows(r["losses"]), _loss_rows(ranks[0]["losses"]))


@pytest.mark.parametrize("n", WORLDS)
def test_fused_pmean_iteration_matches_jax(runs, n):
    ref, port = runs[n]
    got = port[0]["pmean"]
    _losses_close(got["losses"][0], ref["pmean"]["losses"], ITER_LOSS_RTOL)
    assert _divergence(got["states"], ref["pmean"]["states"])["max_leaf_rel"] <= ITER_LEAF_REL
    assert got["states"]["dis/step"] == 2 and got["states"]["gan/step"] == 1


@pytest.mark.parametrize("n", WORLDS)
def test_fused_pmean_iteration_world_n_equals_one_process(runs, n):
    _, port = runs[n]
    got = port[0]["pmean"]
    _losses_close(got["losses"][0], got["solo_losses"][0], ITER_LOSS_RTOL)
    assert state_divergence(got["states"], got["solo_states"])["max_leaf_rel"] <= ITER_LEAF_REL


@pytest.mark.parametrize("n", WORLDS)
def test_fit_rounds_match_jax_averaging(runs, n):
    ref, port = runs[n]
    got = port[0]["avg"]
    assert got["losses"].shape == (ROUNDS, FREQ)
    np.testing.assert_allclose(got["losses"], ref["avg"]["losses"], rtol=1e-4)
    _assert_tree_close(got["state"], ref["avg"]["state"])
    assert got["state"]["step"] == ROUNDS * FREQ


@pytest.mark.parametrize("n", WORLDS)
def test_fit_regroups_worker_major_and_trains_the_tail_like_jax(runs, n):
    ref, port = runs[n]
    got = port[0]["avg"]["fit"]
    np.testing.assert_allclose(got["losses"], ref["avg"]["fit"]["losses"], rtol=1e-4)
    _assert_tree_close(got["state"], ref["avg"]["fit"]["state"])
    assert got["state"]["step"] == ref["avg"]["fit"]["state"]["step"]


@pytest.mark.parametrize("n", WORLDS)
def test_per_fit_averaging_body_matches_jax(runs, n):
    ref, port = runs[n]
    got = port[0]["avg_body"]
    _losses_close(got["losses"][0], ref["avg_body"]["losses"][0], ITER_LOSS_RTOL)
    _losses_close(got["losses"][1], ref["avg_body"]["losses"][1], FREE_LOSS_RTOL)
    assert _divergence(got["states"], ref["avg_body"]["states"])["max_leaf_rel"] <= FREE_LEAF_REL
    assert got["states"]["dis/step"] == 4 and got["states"]["gan/step"] == 2


@pytest.mark.parametrize("n", WORLDS)
def test_phased_averaging_iteration_matches_jax(runs, n):
    """``train_iteration`` under ``param_averaging``: each fit a
    ``ParameterAveragingTrainer.fit`` over the global rows (the
    discriminator's real and fake rows as one fit of two minibatches)."""
    ref, port = runs[n]
    got = port[0]["avg_phased"]
    _losses_close(got["losses"][0], ref["avg_phased"]["losses"], ITER_LOSS_RTOL)
    assert _divergence(got["states"], ref["avg_phased"]["states"])["max_leaf_rel"] <= ITER_LEAF_REL
    assert got["states"]["dis/step"] == ref["avg_phased"]["states"]["dis"]["step"]


@pytest.mark.parametrize("n", WORLDS)
def test_wgan_pmean_round_matches_jax(runs, n):
    ref, port = runs[n]
    got = port[0]["wgan"]
    _losses_close(got["losses"][0], ref["wgan"]["losses"], ITER_LOSS_RTOL, ("d_loss", "g_loss"))
    rounding = ["gen/params/gen_dense_1/b", "gen/opt_state/gen_dense_1/b/m",
                "gen/opt_state/gen_dense_1/b/v"]
    div = _divergence(got["states"], ref["wgan"]["states"], rounding)
    assert div["max_leaf_rel"] <= ITER_LEAF_REL
    assert div["rounding_only_max_abs"] <= 2 * 2e-4
    assert got["states"]["critic/step"] == 2 and got["states"]["gen/step"] == 1


@pytest.mark.parametrize("n", WORLDS)
def test_wgan_pmean_round_world_n_equals_one_process(runs, n):
    _, port = runs[n]
    got = port[0]["wgan"]
    _losses_close(got["losses"][0], got["solo_losses"][0], ITER_LOSS_RTOL, ("d_loss", "g_loss"))
    rounding = ["gen/params/gen_dense_1/b", "gen/opt_state/gen_dense_1/b/m",
                "gen/opt_state/gen_dense_1/b/v"]
    div = state_divergence(got["states"], got["solo_states"], rounding)
    assert div["max_leaf_rel"] <= ITER_LEAF_REL


@pytest.mark.parametrize("n", WORLDS)
def test_no_child_loads_jax(runs, n):
    _, port = runs[n]
    assert [r["graph"]["rank"] for r in port] == list(range(n))
    for r in port:
        assert not any(v["jax_loaded"] for v in r.values()), r["graph"]["rank"]


def _port_digest(flat):
    return {k: np.asarray(v) for k, v in flat.items()}


@pytest.mark.parametrize("n", WORLDS)
def test_jax_mesh_generation_loads_in_the_port_bit_for_bit(runs, n):
    ref, port = runs[n]
    want = _flat_jax(ref["pmean"]["states"])
    for r in port:
        got = r["load_jax_gen"]
        assert got["step"] == 1
        assert sorted(got["states"]) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(np.asarray(got["states"][k]), want[k], err_msg=k)


def test_jax_mesh_generation_loads_in_the_port_at_world_one(runs, tmp_path):
    ref, _ = runs[WORLDS[0]]
    exp = make_experiment(ExperimentConfig(**_config("tabular", use_accelerator=False)))
    assert exp.load_models(ref["jax_gen"]) == 1
    got, want = flatten_states(exp.digest_states()), _flat_jax(ref["pmean"]["states"])
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), want[k], err_msg=k)
    # the port rewrites the JAX generation's shards: the same arrays.npz
    # bytes and meta.json
    for k in range(4):
        name = exp.save_model_shard(str(tmp_path), k, 4)[0]
        with zipfile.ZipFile(tmp_path / name) as mine, \
                zipfile.ZipFile(os.path.join(ref["jax_gen"], name)) as theirs:
            assert mine.read("arrays.npz") == theirs.read("arrays.npz")
            assert json.loads(mine.read("meta.json")) == json.loads(theirs.read("meta.json"))


@pytest.mark.parametrize("n", WORLDS)
def test_port_mesh_shards_load_in_jax_bit_for_bit(runs, n, tmp_path):
    ref, port = runs[n]
    jexp = jax_make_experiment(JaxConfig(**_config("tabular", output_dir=str(tmp_path))))
    jexp.load_models(ref["port_gen"])
    got = _flat_jax(_jax_states(jexp))
    want = port[0]["shards"]["states"]
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=k)
    assert sorted(f for r in port for f in r["shards"]["shard_files"]) == sorted(
        os.listdir(ref["port_gen"]))


@pytest.mark.parametrize("n", WORLDS)
def test_restored_mesh_generation_replays_bit_for_bit(runs, n):
    _, port = runs[n]
    for r in port:
        got = r["shards"]
        for k, v in got["states"].items():
            np.testing.assert_array_equal(np.asarray(got["restored"][k]), np.asarray(v), err_msg=k)
        # two more iterations from the restored state equal two more from
        # the state it was saved from
        np.testing.assert_array_equal(_loss_rows(got["restored_losses"]),
                                      _loss_rows(got["continued_losses"]))
        for k, v in got["continued"].items():
            np.testing.assert_array_equal(np.asarray(got["restored_then"][k]), np.asarray(v),
                                          err_msg=k)


@pytest.mark.parametrize("overrides", [
    dict(update_sharding=True),
    dict(update_sharding=True, distributed="param_averaging"),
    dict(model_family="wgan_gp", height=8, width=8, channels=3, num_features=192,
         batch_size_train=10, n_critic=2, distributed="param_averaging"),
    dict(model_family="wgan_gp", height=8, width=8, channels=3, num_features=192,
         batch_size_train=10, n_critic=2, distributed="pmean", update_sharding=True),
    dict(conditioning="class", distributed="param_averaging"),
    dict(distributed="spark"),
])
def test_distributed_validation_errors_are_jax_word_for_word(overrides):
    with pytest.raises(ValueError) as theirs:
        JaxConfig(**overrides).validate()
    with pytest.raises(ValueError) as mine:
        ExperimentConfig(**overrides).validate()
    assert str(mine.value) == str(theirs.value)


@pytest.mark.parametrize("mode", ["pmean", "param_averaging"])
def test_distributed_modes_validate(mode):
    assert ExperimentConfig(distributed=mode).validate().distributed == mode
    JaxConfig(distributed=mode).validate()


def test_a_stalled_rank_fails_within_its_timeout():
    t0 = time.perf_counter()
    with pytest.raises(TimeoutError, match=r"ranks \[0, 1\] did not finish within 8"):
        spawn(drill.stall, 2, timeout=8, threads=1)
    assert time.perf_counter() - t0 < 20
