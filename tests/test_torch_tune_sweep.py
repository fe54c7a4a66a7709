"""PyTorch port, the tuning sweep (``eval/tune_sweep.py``) against the JAX
package's ``scripts/tune_sweep.py``, on the CPU.

- The arms: the reference point, ``LEVER_ARMS`` (labels and levers) and
  ``_arm_key`` equal the JAX script's, imported by path (its top level
  imports only numpy); the grid's order and labels follow its
  ``itertools.product`` of the two rate lists, then the lever arms.
- A run of one grid arm plus one arm resumed from a partial file written
  here (2 iterations of batch 8, quick FID every iteration, from a
  temporary working directory): the output and the trained arm have the
  JAX script's keys (read from its dict literals with ``ast``), the
  resumed arm is the file's with ``resumed`` set, the curve holds
  iterations 1 and 2, and both rankings order the two arms.
- Without a card and without ``--cpu`` the CLI exits 2, loading nothing.

Run with ``JAX_PLATFORMS=cpu``.
"""

import ast
import importlib.util
import json
import os

import pytest
import torch

from gan_deeplearning4j_tpu_torch.eval import tune_sweep

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_SCRIPT = os.path.join(REPO, "scripts", "tune_sweep.py")
RUN = ["--cpu", "--iterations", "2", "--batch", "8", "--eval-every", "1", "--num-train", "64",
       "--num-test", "16", "--select-samples", "32", "--no-levers", "--dis-lrs", "0.002",
       "--gen-lrs", "0.004,0.008"]


@pytest.fixture(scope="module")
def jax_sweep():
    spec = importlib.util.spec_from_file_location("jax_tune_sweep", JAX_SCRIPT)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _literal_keys() -> tuple:
    """The keys of the JAX script's arm literal and of its output literal."""
    with open(JAX_SCRIPT) as fh:
        tree = ast.parse(fh.read())
    found = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict):
            target = node.targets[0]
            if isinstance(target, ast.Name) and target.id in ("arm", "out"):
                found[target.id] = [k.value for k in node.value.keys]
    return found["arm"], found["out"]


def test_reference_point_levers_and_arm_key_equal_jax(jax_sweep):
    assert (tune_sweep.REF_DIS_LR, tune_sweep.REF_GEN_LR) == (jax_sweep.REF_DIS_LR,
                                                              jax_sweep.REF_GEN_LR)
    assert tune_sweep.LEVER_ARMS == jax_sweep.LEVER_ARMS
    specs = tune_sweep.arm_specs("0.001,0.002,0.004", "0.002,0.004,0.008")
    for spec in specs + [{}, {"dis_lr": 0.004}, {"resample_label_noise": 1},
                         {"dis_lr_decay_every": "200", "dis_lr_decay_rate": 1}]:
        assert tune_sweep._arm_key(spec) == jax_sweep._arm_key(spec)


def test_grid_order_and_labels_follow_the_jax_product(jax_sweep):
    specs = tune_sweep.arm_specs("0.001,0.002,0.004", "0.002,0.004,0.008")
    grid = [(d, g) for d in (0.001, 0.002, 0.004) for g in (0.002, 0.004, 0.008)]
    assert [s["label"] for s in specs[:9]] == [f"lr_{d}x{g}" for d, g in grid]
    assert [(s["dis_lr"], s["gen_lr"]) for s in specs[:9]] == grid
    assert specs[9:] == jax_sweep.LEVER_ARMS
    assert tune_sweep.arm_specs("0.002", "0.004", levers=False) == [
        {"label": "lr_0.002x0.004", "dis_lr": 0.002, "gen_lr": 0.004}]


@pytest.fixture(scope="module")
def resumed_run(tmp_path_factory):
    work = tmp_path_factory.mktemp("sweep")
    arm_keys, _ = _literal_keys()
    earlier = {k: None for k in arm_keys}
    earlier.update(label="lr_0.002x0.008", dis_lr=0.002, gen_lr=0.008, resample_label_noise=False,
                   dis_lr_decay_every=0, dis_lr_decay_rate=1.0, best_quick_fid=0.5,
                   best_at_iteration=1, final_quick_fid=0.75, quick_fid_curve=[[1, 0.5], [2, 0.75]])
    partial = work / "partial.json"
    partial.write_text(json.dumps({"arms": [earlier]}))
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(work)
        rc = tune_sweep.main(RUN + ["--resume-from", str(partial), "--out", str(work / "out.json")])
    return rc, json.loads((work / "out.json").read_text()), earlier, work


def test_one_grid_arm_and_one_resumed_arm_have_the_jax_keys(resumed_run):
    rc, out, earlier, work = resumed_run
    arm_keys, out_keys = _literal_keys()
    assert rc == 0
    assert list(out) == out_keys
    trained, resumed = out["arms"]
    assert list(trained) == arm_keys and "resumed" not in trained
    assert trained["label"] == "lr_0.002x0.004"
    assert resumed == {**earlier, "resumed": True}
    assert [i for i, _ in trained["quick_fid_curve"]] == [1, 2]
    assert trained["best_quick_fid"] == min(f for _, f in trained["quick_fid_curve"])
    assert trained["final_quick_fid"] == trained["quick_fid_curve"][-1][1]
    assert 0.0 <= trained["accuracy"] <= 1.0
    assert out["platform"] == "cpu" and out["iterations"] == 2 and out["batch_size"] == 8
    # the predictions go under the working directory, as in the JAX script
    assert (work / "output" / "tune" / "mnist_test_predictions_2.csv").exists()


def test_both_rankings_order_the_arms(resumed_run):
    _, out, _, _ = resumed_run
    for key, field in (("ranking_by_best_quick_fid", "best_quick_fid"),
                       ("ranking_by_final_quick_fid", "final_quick_fid")):
        want = sorted(([a["label"], a[field]] for a in out["arms"]), key=lambda r: r[1])
        assert out[key] == want
    assert out["ranking_by_best_quick_fid"][0] == ["lr_0.002x0.008", 0.5]


def test_cli_without_a_card_exits_2(monkeypatch, capsys):
    def refuse(*args, **kwargs):
        raise AssertionError("the sweep ran without a device")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(tune_sweep, "run", refuse)
    assert tune_sweep.main([]) == 2
    assert "no CUDA device" in capsys.readouterr().err
