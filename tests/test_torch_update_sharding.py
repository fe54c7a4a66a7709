"""PyTorch port, cross-replica weight-update sharding on the CPU: the
partition, the row packing and the sharded step of
``parallel/update_sharding.py`` against the JAX package's
``UpdateShardingPlan`` and against the port's replicated per-step sync,
at world 2 and 4 (gloo ranks spawned once per world by
``parallel/launch.py::spawn``, every rank running ``parallel/drill.py``).

What is held, and how:
- ``shard_assignment`` / ``shard_keys`` equal the JAX package's on its
  test key space and on the MNIST experiment's whole flat namespace (whose
  keys, element counts and step leaves the port reproduces);
- the plan: ``describe()`` (groups, widths, rows used, element-split
  keys, padding) equals the JAX plan's over the same graph and mesh size;
  each rank's whole updater keys are its checkpoint shard's updater keys
  (element-split leaves apart), as in the JAX package;
- packing: tree → this rank's rows → tree (an all-gather) is bit-exact,
  Adam's scalar ``t`` included; the fresh rows equal the packed tree init;
- the sharded step against the replicated ``pmean`` step (3 steps of the
  JAX tests' BN classifier, and one tabular ``pmean`` iteration): bit for
  bit with the JAX package's default ``exact_grads`` (the mean gradient
  sliced); with the reduce-scatter (``exact_grads=False``) within 1e-6
  relative, the losses elementwise and the leaves normwise (gloo's
  reduce-scatter may add the ranks' contributions in another order than
  its all-reduce); every rank bit for bit the same, the resident updater bytes per rank at most
  1.35 / N of the replicated run's (the JAX test's bound);
- elastic restores: a sharded generation written at world 2 loads sharded
  at world 4 and replicated at world 1 bit for bit, and a JAX sharded
  generation loads sharded in the port;
- the optimizer's shard-slice init and ``state_structs``, and the JAX
  package's refusals.
"""

import os

import numpy as np
import pytest
import torch

from gan_deeplearning4j_tpu.harness import ExperimentConfig as JaxConfig
from gan_deeplearning4j_tpu.harness import GanExperiment as JaxExperiment
from gan_deeplearning4j_tpu.harness import make_experiment as jax_make_experiment
from gan_deeplearning4j_tpu.optim import GraphOptimizer as JaxOptimizer
from gan_deeplearning4j_tpu.parallel import UpdateShardingPlan as JaxPlan
from gan_deeplearning4j_tpu.utils.serializer import _element_count as jax_element_count
from gan_deeplearning4j_tpu.utils.serializer import shard_assignment as jax_assignment
from gan_deeplearning4j_tpu.utils.serializer import shard_keys as jax_shard_keys
from gan_deeplearning4j_tpu_torch.harness import ExperimentConfig, make_experiment
from gan_deeplearning4j_tpu_torch.harness.experiment import flatten_states, state_divergence
from gan_deeplearning4j_tpu_torch.nn.graph import ComputationGraph
from gan_deeplearning4j_tpu_torch.optim import Adam, GraphOptimizer, RmsProp
from gan_deeplearning4j_tpu_torch.parallel import GraphTrainer, drill
from gan_deeplearning4j_tpu_torch.parallel.launch import spawn
from gan_deeplearning4j_tpu_torch.utils.serializer import (
    _element_count,
    shard_assignment,
    shard_keys,
)
from tests.test_parallel import small_classifier, toy_data
from tests.test_torch_families import jax_z_source
from tests.test_torch_parallel import _config, _data, _flat_jax, _jax_state, _mesh, _np

WORLDS = (2, 4)
B = 16
SIZES = {
    "m/params/a/W": 1000, "m/params/a/b": 10,
    "m/params/c/W": 800, "m/params/c/b": 8,
    "m/updater/a/W/cache": 1000, "m/updater/a/b/cache": 10,
    "m/updater/c/W/cache": 800, "m/updater/c/b/cache": 8,
    "m/step": 1,
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``{N: (reference, port results by rank)}``; the world-2 ranks write a
    sharded generation that the world-4 ranks restore."""
    graph = small_classifier()
    topology = graph.to_dict()
    params = _np(graph.init())
    gx, gy = toy_data(32)
    x, y = _data(B, 32, seed=3)
    base = tmp_path_factory.mktemp("sharding")
    # a JAX sharded generation (mesh 2): the experiment's initial state
    jexp = jax_make_experiment(JaxConfig(**_config(
        "tabular", distributed="pmean", update_sharding=True, output_dir=str(base / "j"))),
        mesh=_mesh(2))
    jax_gen = str(base / "jax_sharded_gen")
    os.makedirs(jax_gen)
    for k in range(2):
        jexp.save_model_shard(jax_gen, k, 2)
    digest = jexp.digest_states()  # the tree form of the packed rows
    init = {"dis": _jax_state(digest["dis"]), "gan": _jax_state(digest["gan"]),
            "gen": _np(digest["gen"])}
    zsrc = jax_z_source(jexp.config.seed, jexp.model_cfg.z_size)
    out = {"jax_gen": jax_gen, "jax_gen_states": _flat_jax(init)}
    written = None
    for n in WORLDS:
        ref = {"plan": JaxPlan(graph, JaxOptimizer(graph), params, _mesh(n)).describe()}
        gen = str(base / f"port_sharded_gen_{n}")
        os.makedirs(gen)
        pmean = _config("tabular", distributed="pmean", use_accelerator=False)
        sharded = dict(pmean, update_sharding=True)
        scen = {
            "graph": ("graph_steps", dict(topology=topology, params=params, features=gx,
                                          labels=gy, steps=3, shard_updates=True)),
            "replicated": ("experiment_run", dict(config=pmean, states=init, batches=x[None],
                                                  labels=y[None], draws={0: zsrc(0, B)})),
            "sharded": ("experiment_run", dict(config=sharded, states=init, batches=x[None],
                                               labels=y[None], draws={0: zsrc(0, B)},
                                               shards_dir=gen)),
            "load_jax": ("load_generation", dict(config=sharded, directory=jax_gen)),
        }
        if written is not None:
            scen["load_written"] = ("load_generation", dict(config=sharded, directory=written))
        out[n] = (ref, spawn(drill.run_all, n, (scen,), timeout=240, threads=1))
        written = written or gen
    out["written"] = written
    return out


# -- the partition --------------------------------------------------------

@pytest.mark.parametrize("count", [1, 2, 3, 4])
def test_shard_assignment_equals_jax(count):
    assert shard_assignment(SIZES, count) == jax_assignment(SIZES, count)
    shuffled = dict(sorted(SIZES.items(), reverse=True))
    assert shard_assignment(shuffled, count) == shard_assignment(SIZES, count)
    for k in range(count):
        assert shard_keys(SIZES, k, count) == jax_shard_keys(SIZES, k, count)
        assert shard_keys(list(SIZES), k, count) == jax_shard_keys(list(SIZES), k, count)


def test_shard_keys_refuse_bad_indices():
    for args in ((0, 0), (2, 2), (-1, 2)):
        with pytest.raises(ValueError):
            shard_keys(SIZES, *args)
        with pytest.raises(ValueError):
            jax_shard_keys(SIZES, *args)


@pytest.fixture(scope="module")
def mnist_namespaces(tmp_path_factory):
    jexp = JaxExperiment(JaxConfig(batch_size_train=8, latent_grid=2, save_models=False,
                                   output_dir=str(tmp_path_factory.mktemp("m"))))
    pexp = make_experiment(ExperimentConfig(batch_size_train=8, latent_grid=2, save_models=False,
                                            use_accelerator=False))
    return ({k: jax_element_count(v) for k, v in jexp._flat_state().items()},
            {k: _element_count(v) for k, v in pexp._flat_state().items()})


def test_mnist_flat_namespace_equals_jax(mnist_namespaces):
    theirs, mine = mnist_namespaces
    assert mine == theirs
    assert mine["dis/step"] == 1 and mine["CV/step"] == 1


@pytest.mark.parametrize("count", [2, 4])
def test_mnist_shard_assignment_equals_jax(mnist_namespaces, count):
    theirs, mine = mnist_namespaces
    assert shard_assignment(mine, count) == jax_assignment(theirs, count)


# -- the plan and the packing -------------------------------------------------

@pytest.mark.parametrize("n", WORLDS)
def test_plan_layout_equals_jax(runs, n):
    ref, port = runs[n]
    mine, theirs = port[0]["graph"]["plan"]["describe"], ref["plan"]
    assert mine["num_shards"] == theirs["num_shards"] == n
    assert mine["model"] == theirs["model"] and mine["data_axis"] == theirs["data_axis"]
    assert len(mine["groups"]) == len(theirs["groups"])
    for g_mine, g_theirs in zip(sorted(mine["groups"].values(), key=lambda g: g["fields"]),
                                sorted(theirs["groups"].values(), key=lambda g: g["fields"])):
        for key in ("kind", "fields", "width", "rows_used", "split_keys"):
            assert g_mine[key] == g_theirs[key], key
        assert g_mine["padding_fraction"] == pytest.approx(g_theirs["padding_fraction"])


@pytest.mark.parametrize("n", WORLDS)
def test_compute_shards_own_their_checkpoint_shards_updater_keys(runs, n):
    _, port = runs[n]
    from gan_deeplearning4j_tpu_torch.parallel.update_sharding import flat_model_keys

    graph = ComputationGraph.from_dict(small_classifier().to_dict())
    keys = flat_model_keys("model", graph.init(0, device="cpu"), GraphOptimizer(graph))
    for r in port:
        plan = r["graph"]["plan"]
        checkpoint = {k for k in shard_keys(keys, r["graph"]["rank"], n)
                      if "/updater/" in k} - set(plan["split_keys"])
        assert set(plan["updater_keys"]) == checkpoint


@pytest.mark.parametrize("n", WORLDS)
def test_packing_round_trips_and_fresh_rows_equal_the_packed_init(runs, n):
    _, port = runs[n]
    for r in port:
        assert r["graph"]["plan"]["round_trip"]
        assert r["graph"]["plan"]["init_packed"]


# -- the sharded step -------------------------------------------------------------

def _close(a, b):
    """Every leaf within 1e-6 normwise (``state_divergence``): the sums of
    a reduce-scatter and of an all-reduce may differ in order."""
    assert state_divergence(_flat_jax(a), _flat_jax(b))["max_leaf_rel"] <= 1e-6


def _bit_equal(a, b):
    fa, fb = _flat_jax(a), _flat_jax(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


@pytest.mark.parametrize("n", WORLDS)
def test_sharded_graph_steps_equal_replicated_bit_for_bit(runs, n):
    _, port = runs[n]
    got = port[0]["graph"]
    np.testing.assert_array_equal(got["sharded"]["losses"], got["pmean"]["losses"])
    _bit_equal(got["sharded"]["state"], got["pmean"]["state"])


@pytest.mark.parametrize("n", WORLDS)
def test_reduce_scatter_graph_steps_equal_replicated_to_rounding(runs, n):
    _, port = runs[n]
    got = port[0]["graph"]
    np.testing.assert_allclose(got["sharded_reduce_scatter"]["losses"], got["pmean"]["losses"],
                               rtol=1e-6)
    _close(got["sharded_reduce_scatter"]["state"], got["pmean"]["state"])


@pytest.mark.parametrize("n", WORLDS)
def test_sharded_iteration_equals_replicated_bit_for_bit(runs, n):
    _, port = runs[n]
    rep, sh = port[0]["replicated"], port[0]["sharded"]
    np.testing.assert_array_equal([sh["losses"][0][k] for k in ("d_loss", "g_loss")],
                                  [rep["losses"][0][k] for k in ("d_loss", "g_loss")])
    _bit_equal(sh["states"], rep["states"])


@pytest.mark.parametrize("n", WORLDS)
def test_sharded_ranks_end_bit_identical(runs, n):
    _, port = runs[n]
    for key in ("sharded",):
        first = _flat_jax(port[0][key]["states"])
        for r in port[1:]:
            other = _flat_jax(r[key]["states"])
            for k in first:
                np.testing.assert_array_equal(other[k], first[k], err_msg=k)


@pytest.mark.parametrize("n", WORLDS)
def test_resident_updater_bytes_per_rank_are_about_one_nth(runs, n):
    _, port = runs[n]
    for r in port:
        assert r["sharded"]["resident_bytes"] <= r["replicated"]["resident_bytes"] * 1.35 / n
        graph = r["graph"]
        assert graph["sharded"]["resident_bytes"] < graph["pmean"]["resident_bytes"]


# -- elastic restores -----------------------------------------------------------

def test_sharded_generation_restores_at_another_world_size(runs):
    want = _flat_jax(runs[WORLDS[0]][1][0]["sharded"]["states"])
    for r in runs[4][1]:
        got = _flat_jax(r["load_written"]["states"])
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_sharded_generation_restores_replicated_at_world_one(runs):
    want = _flat_jax(runs[WORLDS[0]][1][0]["sharded"]["states"])
    exp = make_experiment(ExperimentConfig(**_config("tabular", use_accelerator=False)))
    exp.load_models(runs["written"])
    got = {k: np.asarray(v) for k, v in flatten_states(exp.digest_states()).items()}
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("n", WORLDS)
def test_jax_sharded_generation_loads_sharded_in_the_port(runs, n):
    want = runs["jax_gen_states"]
    for r in runs[n][1]:
        got = _flat_jax(r["load_jax"]["states"])
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# -- optimizer surface and refusals ---------------------------------------------

def test_init_state_packed_broadcasts_scalars():
    flat = torch.ones(7)
    rms = RmsProp(0.01).init_state_packed(flat)
    assert rms["cache"].shape == (7,)
    adam = Adam(0.01).init_state_packed(flat)
    assert adam["m"].shape == (7,) and adam["v"].shape == (7,)
    assert adam["t"].shape == (7,) and adam["t"].dtype == torch.int32


def test_graph_optimizer_init_accepts_key_slice_and_state_structs_match():
    graph = ComputationGraph.from_dict(small_classifier().to_dict())
    opt = GraphOptimizer(graph)
    params = graph.init(0, device="cpu")
    full = opt.init(params)
    keys = [(layer, pname) for layer, d in full.items() for pname in d]
    half = opt.init(params, keys=keys[: len(keys) // 2])
    assert sorted((l, p) for l, d in half.items() for p in d) == sorted(keys[: len(keys) // 2])
    structs = opt.state_structs(params)
    for layer, d in full.items():
        for pname, fields in d.items():
            for f, t in fields.items():
                s = structs[layer][pname][f]
                assert s.device.type == "meta" and s.shape == t.shape and s.dtype == t.dtype


def test_shard_updates_requires_a_mesh_and_a_data_mesh():
    graph = ComputationGraph.from_dict(small_classifier().to_dict())
    with pytest.raises(ValueError, match="shard_updates requires a mesh"):
        GraphTrainer(graph, shard_updates=True)
    with pytest.raises(TypeError, match="DataMesh"):
        GraphTrainer(graph, mesh=object())
