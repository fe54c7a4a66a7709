"""PyTorch port, the update-sharding A/B bench (``parallel/bench.py``)
against the JAX package's ``scripts/update_sharding_bench.py``, on the CPU
(gloo ranks spawned by ``parallel/launch.py::spawn``).

- ``--cpu --smoke --mesh 2`` exits 0: parity within 5e-2 after one
  iteration, the sharded and replicated digests equal (the port's sharded
  step slices the replicated mean gradient), resident updater bytes per
  rank at most 1.35 / 2 of the replicated run's;
- per model (dis, gan, CV), the bench's ``plan`` equals ``describe()`` of
  the JAX package's ``UpdateShardingPlan`` built over the JAX MNIST
  experiment's graphs, params and flat key namespace on a 2-device CPU
  mesh (building a plan compiles nothing): the group ids differ (they
  print each package's updater spec), so groups are matched by kind and
  fields;
- the summary's key tree is the JAX script's (read from its source with
  ``ast``) with the two keys the port adds per mesh entry, at the smoke
  shape and with the timed arms (one round of one iteration at batch 8);
- a global batch that a mesh size does not divide is refused, and
  without a card and without ``--cpu`` the CLI exits 2, spawning nothing.

Run with ``JAX_PLATFORMS=cpu``.
"""

import ast
import json
import os

import jax
import numpy as np
import pytest
import torch

from gan_deeplearning4j_tpu.harness import ExperimentConfig as JaxConfig
from gan_deeplearning4j_tpu.harness import GanExperiment as JaxExperiment
from gan_deeplearning4j_tpu.parallel import UpdateShardingPlan as JaxPlan
from gan_deeplearning4j_tpu.utils.serializer import _element_count as jax_element_count
from gan_deeplearning4j_tpu_torch.parallel import bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_SCRIPT = os.path.join(REPO, "scripts", "update_sharding_bench.py")
#: what the port adds to each mesh entry (the module's docstring)
ADDED_ENTRY = {"backend", "device_name"}
#: entry keys the JAX script writes only with timed arms and the step gate on
STEP_TIME_KEYS = {"step_time_ratio", "step_time_note"}


def _run(tmp_path, name: str, argv: list):
    out = tmp_path / f"{name}.json"
    rc = bench.main(argv + ["--output", str(out)])
    return rc, json.loads(out.read_text())


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("usb")
    return {"smoke": _run(tmp, "smoke", ["--cpu", "--smoke", "--mesh", "2"]),
            "timed": _run(tmp, "timed", ["--cpu", "--mesh", "2", "--iterations", "1",
                                         "--rounds", "1", "--batch", "8"])}


def _jax_source():
    with open(JAX_SCRIPT) as fh:
        return ast.parse(fh.read())


def _jax_keys():
    """``(summary keys, entry keys, collective names, arm keys)`` from the
    JAX script's literals: the summary dict, ``entry``'s literal and every
    ``entry[...] =``, the op tuple of ``collective_counts`` and
    ``timed_arm``'s result."""
    tree = _jax_source()
    main = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == "main")
    summary = entry = None
    for node in ast.walk(main):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict):
            target = node.targets[0]
            if isinstance(target, ast.Name) and target.id == "summary":
                summary = {k.value for k in node.value.keys}
        if isinstance(node, ast.AnnAssign) and getattr(node.target, "id", None) == "entry":
            entry = {k.value for k in node.value.keys}
    entry |= {t.slice.value for node in ast.walk(main) if isinstance(node, ast.Assign)
              for t in node.targets if isinstance(t, ast.Subscript)
              and getattr(t.value, "id", None) == "entry"}
    counts = next(n for n in ast.walk(main)
                  if isinstance(n, ast.FunctionDef) and n.name == "collective_counts")
    ops = next(tuple(e.value for e in n.iter.elts) for n in ast.walk(counts)
               if isinstance(n, ast.comprehension))
    timed = next(n for n in ast.walk(main) if isinstance(n, ast.FunctionDef) and n.name == "timed_arm")
    arm = next({k.value for k in n.keys} for n in ast.walk(timed) if isinstance(n, ast.Dict))
    return summary, entry, ops, arm


def test_smoke_mesh2_exits_0_with_every_invariant_and_an_exact_digest(runs):
    rc, summary = runs["smoke"]
    assert rc == 0
    assert summary["invariants"] == {"parity_tolerance_mesh2": True, "resident_ratio_mesh2": True}
    (entry,) = summary["results"]
    assert entry["backend"] == "gloo" and entry["device_name"] == "cpu"
    assert entry["parity_digest_exact_iter1"] is True
    assert entry["parity_rel_max_iter1"] == 0.0
    assert entry["resident_ratio"] <= 1.35 / 2
    assert entry["arms"] == {}
    assert summary["smoke"] is True and summary["batch"] == 32 and summary["platform"] == "cpu"


def test_collectives_issued_by_one_eager_iteration(runs):
    _, summary = runs["smoke"]
    counts = summary["results"][0]["collectives"]
    # the replicated step all-reduces; the sharded one adds the updated
    # params' all-gather (one per model's dtype) and keeps the all-reduce
    # (the default exact gradients)
    assert counts["replicated"]["all-gather"] == 0 and counts["replicated"]["reduce-scatter"] == 0
    assert counts["sharded"]["all-reduce"] == counts["replicated"]["all-reduce"] > 0
    assert counts["sharded"]["all-gather"] > 0


@pytest.fixture(scope="module")
def jax_plans(tmp_path_factory):
    exp = JaxExperiment(JaxConfig(batch_size_train=32, latent_grid=2, save_models=False,
                                  output_dir=str(tmp_path_factory.mktemp("jax_plans"))))
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:2]), ("data",))
    global_keys = {k: jax_element_count(v) for k, v in exp._flat_state().items()}
    return {name: JaxPlan(trainer.graph, trainer.optimizer, state.params, mesh, model_name=name,
                          global_keys=global_keys).describe()
            for name, trainer, state in (("dis", exp.dis_trainer, exp.dis_state),
                                         ("gan", exp.gan_trainer, exp.gan_state),
                                         ("CV", exp.cv_trainer, exp.cv_state))}


@pytest.mark.parametrize("model", ["dis", "gan", "CV"])
def test_plan_equals_the_jax_plans_describe(runs, jax_plans, model):
    mine, theirs = runs["smoke"][1]["results"][0]["plan"][model], jax_plans[model]
    for key in ("model", "num_shards", "data_axis", "exact_grads"):
        assert mine[key] == theirs[key], key
    assert mine["num_shards"] == 2

    def by_fields(plan):
        return sorted(plan["groups"].values(), key=lambda g: (g["kind"], g["fields"]))

    assert len(mine["groups"]) == len(theirs["groups"])
    for g_mine, g_theirs in zip(by_fields(mine), by_fields(theirs)):
        for key in ("kind", "fields", "width", "rows_used", "split_keys"):
            assert g_mine[key] == g_theirs[key], key
        assert g_mine["padding_fraction"] == pytest.approx(g_theirs["padding_fraction"])


def test_the_key_tree_is_the_jax_scripts(runs):
    summary_keys, entry_keys, ops, arm_keys = _jax_keys()
    for name in ("smoke", "timed"):
        rc, summary = runs[name]
        assert rc == 0, name
        assert set(summary) == summary_keys
        (entry,) = summary["results"]
        want = entry_keys | ADDED_ENTRY
        if name == "smoke":
            want -= STEP_TIME_KEYS  # the timed run has both: on gloo a note beside the ratio
        assert set(entry) == want, name
        assert set(entry["collectives"]) == {"replicated", "sharded"}
        for counts in entry["collectives"].values():
            assert tuple(counts) == ops
    arms = runs["timed"][1]["results"][0]["arms"]
    assert set(arms) == {"replicated", "sharded"}
    for arm in arms.values():
        assert set(arm) == arm_keys and len(arm["step_s_rounds"]) == 1
    entry = runs["timed"][1]["results"][0]
    assert entry["step_time_ratio"] > 0 and "gloo" in entry["step_time_note"]
    assert runs["timed"][1]["invariants"] == {"parity_tolerance_mesh2": True,
                                              "resident_ratio_mesh2": True}


@pytest.mark.parametrize("argv", [["--mesh", "3"], ["--mesh", "2,3", "--batch", "8"],
                                  ["--smoke", "--mesh", "4,3"]])
def test_a_batch_the_mesh_does_not_divide_is_refused(argv, capsys):
    with pytest.raises(SystemExit) as exc:
        bench.parse_args(["--cpu"] + argv)
    assert exc.value.code == 2
    assert "does not split evenly" in capsys.readouterr().err


def test_cli_without_a_card_exits_2(monkeypatch, capsys):
    def refuse(*args, **kwargs):
        raise AssertionError("the bench spawned without a device")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(bench, "run", refuse)
    assert bench.main(["--mesh", "2"]) == 2
    assert "no CUDA device" in capsys.readouterr().err
