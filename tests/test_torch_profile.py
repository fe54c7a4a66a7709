"""PyTorch port, the profiles (``harness/profile.py``) against the JAX
package's ``scripts/profile_iteration.py`` and ``scripts/profile_wgan.py``,
on the CPU.

- ``iteration``: the summary has the JAX script's keys but for two
  renames (below), and adds the trace's; ``flops_per_iter`` is the port's
  ``flops_per_iteration``. The JAX experiment's ``flops_per_iteration`` is
  XLA's count of the program it compiled: it adds the elementwise work and
  leaves out the passes XLA's optimiser drops (the port counts an input
  gradient for every dense and convolution layer), so the two are held
  within 10% of each other (at batch 8 the port's is 6.1% above).
- ``wgan``: ``FlopCounterMode``'s critic and generator forward counts equal
  the port's analytic ``forward_flops``. The three ratios are held against
  the JAX script's at its ``--cpu`` shapes (batch 8, ``n_critic`` 2,
  8×8×1, z 8), within tolerances set by the counting conventions:
  ``full_over_sum_of_terms`` within 0.02 (both near 1: neither package
  shares work between the two loss terms, and XLA's elementwise work
  moves it by under 1%); ``round_over_ncritic_fullgrad`` is 1 in the port
  at every ``n_critic`` (it runs and counts every critic step), and the
  JAX value times ``n_critic`` within 0.1 of it (XLA counts the round's
  ``scan`` body once); ``gp_grad_over_forward`` between the JAX value and
  1.5 times it (XLA's optimised program counts 4.01), and within one of 6:
  ``FlopCounterMode`` counts the penalty's forward, its input-gradient
  pass and a backward pass through each, six forwards' worth, less what
  autograd prunes and plus what its formulas give the strided
  convolutions' transposed passes (5.74 at these shapes; 6.34 at the
  bench's on the card).
- Fences: the sweep's windows read the last call's output, after the
  last call, and nothing else.

Run with ``JAX_PLATFORMS=cpu``.
"""

import ast
import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

from gan_deeplearning4j_tpu_torch.harness import profile
from gan_deeplearning4j_tpu_torch.harness.experiment import forward_flops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the JAX script's --cpu shapes
WGAN_CPU = ["--cpu", "--height", "8", "--width", "8", "--channels", "1", "--z-size", "8",
            "--batch", "8"]
#: the iteration summary's keys that XLA's cost analysis gives the JAX script
ITERATION_RENAMED = {"bytes_accessed_per_iter": "bytes_lower_bound_per_iter",
                     "arithmetic_intensity_flops_per_byte":
                         "arithmetic_intensity_upper_bound_flops_per_byte"}
#: what the port's iteration summary adds, from its trace
ITERATION_ADDED = {"device_busy_share", "kernels_per_iter", "kernel_ms_per_iter", "top_kernels",
                   "dgrad2d"}


def _dict_keys(path: str, function: str) -> list:
    """The string keys of each dict literal in ``function`` of the script at
    ``path``, in source order."""
    with open(path) as fh:
        tree = ast.parse(fh.read())
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == function)
    return [{k.value for k in node.keys if isinstance(k, ast.Constant)}
            for node in ast.walk(fn) if isinstance(node, ast.Dict) and node.keys]


@pytest.fixture(scope="module")
def iteration():
    args = profile.parse_args(["iteration", "--cpu", "--batch", "8", "--iters", "2", "--sweep", ""])
    return profile.run_iteration(args)


def test_iteration_has_the_jax_keys_with_the_documented_renames(iteration):
    script = os.path.join(REPO, "scripts", "profile_iteration.py")
    (jax_run,) = [keys for keys in _dict_keys(script, "profile_once") if "sec_per_iter" in keys]
    want = {ITERATION_RENAMED.get(k, k) for k in jax_run} | ITERATION_ADDED
    assert [r["compute_dtype"] for r in iteration["runs"]] == ["f32", "bf16"]
    for run in iteration["runs"]:
        assert set(run) == want
        assert run["sec_per_iter"] > 0 and "fused_iteration" in run["phase_report"]
        assert run["device_busy_share"] is None and run["top_kernels"] == []
    (jax_row,) = [keys for keys in _dict_keys(script, "batch_sweep") if "batch" in keys]
    assert set(profile.sweep_row(_StubExperiment([]), None, None, 8, 4)) == jax_row


def test_iteration_flops_are_the_ports_count_and_near_the_jax_experiments(iteration):
    from gan_deeplearning4j_tpu.harness import ExperimentConfig as JaxConfig
    from gan_deeplearning4j_tpu.harness import make_experiment as jax_make
    from gan_deeplearning4j_tpu_torch.harness import ExperimentConfig, make_experiment

    port = make_experiment(ExperimentConfig(batch_size_train=8, batch_size_pred=8,
                                            save_models=False, use_accelerator=False))
    for run in iteration["runs"]:
        assert run["flops_per_iter"] == port.flops_per_iteration(8)
        assert run["achieved_flops_per_sec"] == pytest.approx(
            run["flops_per_iter"] / run["sec_per_iter"])
        assert run["arithmetic_intensity_upper_bound_flops_per_byte"] == pytest.approx(
            run["flops_per_iter"] / run["bytes_lower_bound_per_iter"])
    jax_flops = jax_make(JaxConfig(batch_size_train=8, batch_size_pred=8,
                                   save_models=False)).flops_per_iteration(8)
    assert jax_flops
    assert iteration["runs"][0]["flops_per_iter"] / jax_flops == pytest.approx(1.0, abs=0.1)


def test_bytes_lower_bound_counts_params_gradients_updater_state_and_batch():
    from gan_deeplearning4j_tpu_torch.harness import ExperimentConfig, make_experiment

    exp = make_experiment(ExperimentConfig(batch_size_train=4, batch_size_pred=4,
                                           save_models=False, use_accelerator=False))
    feats, labels = torch.zeros((4, 784)), torch.zeros((4, 10))
    params = sum(4 * t.numel() for tree in (exp.dis_state.params, exp.gan_state.params,
                                            exp.cv_state.params, exp.gen_params)
                 for leaves in tree.values() for t in leaves.values())
    got = profile.bytes_lower_bound(exp, feats, labels)
    # every param once, at least the batch, the updater state and a gradient
    # for each trained leaf on top
    assert got > params + 4 * 4 * (784 + 10)
    assert got - params - 4 * 4 * (784 + 10) == (
        profile._tensor_bytes([exp.dis_state.opt_state, exp.gan_state.opt_state,
                               exp.cv_state.opt_state])
        + sum(profile._tensor_bytes(s.params[layer][p])
              for s, tr in ((exp.dis_state, exp.dis_trainer), (exp.gan_state, exp.gan_trainer),
                            (exp.cv_state, exp.cv_trainer))
              for layer, p in tr.optimizer.trainable_keys(s.params)))


@pytest.fixture(scope="module")
def jax_wgan(tmp_path_factory):
    """The JAX script's output at its --cpu shapes, run once."""
    tmp = tmp_path_factory.mktemp("jax_wgan")
    spec = importlib.util.spec_from_file_location(
        "jax_profile_wgan", os.path.join(REPO, "scripts", "profile_wgan.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    argv = sys.argv
    sys.argv = ["profile_wgan.py", *WGAN_CPU, "--n-critic", "2", "--scan-window", "2",
                "--chunks", "2", "--trace-dir", str(tmp / "trace"), "--out", str(tmp / "out.json")]
    try:
        assert module.main() == 0
    finally:
        sys.argv = argv
    return json.loads((tmp / "out.json").read_text())


@pytest.fixture(scope="module")
def port_wgan():
    args = profile.parse_args(["wgan", *WGAN_CPU, "--n-critic", "2", "--scan-window", "2",
                               "--chunks", "2"])
    return profile.run_wgan(args)


def _narrow_trainer(n_critic: int):
    from gan_deeplearning4j_tpu_torch.models.wgan_gp import WganGpConfig, WganGpTrainer

    return WganGpTrainer(WganGpConfig(height=8, width=8, channels=1, z_size=8, n_critic=n_critic,
                                      base_filters=8, dense_width=32))


def test_wgan_forward_counts_equal_the_analytic_forward_flops(port_wgan):
    tr = _narrow_trainer(2)
    assert port_wgan["costs_flops"]["critic_forward"] == forward_flops(tr.critic, 8)
    assert port_wgan["costs_flops"]["generator_forward"] == forward_flops(tr.generator, 8)


def test_wgan_keys_are_the_jax_scripts_with_costs_flops(port_wgan, jax_wgan):
    assert set(port_wgan) == set(jax_wgan) - {"costs_flops_bytes"} | {"costs_flops", "model"}
    assert port_wgan["model"] == {"height": 8, "width": 8, "channels": 1, "base_filters": 8,
                                  "dense_width": 32}
    assert set(port_wgan["costs_flops"]) == set(jax_wgan["costs_flops_bytes"])
    assert set(port_wgan["analysis"]) == set(jax_wgan["analysis"])
    assert set(port_wgan["wall"]) >= set(jax_wgan["wall"])
    assert port_wgan["shapes"] == jax_wgan["shapes"]
    assert len(port_wgan["wall"]["chunk_seconds"]) == 2


def test_wgan_ratios_against_the_jax_script(port_wgan, jax_wgan):
    pt, jx = port_wgan["analysis"], jax_wgan["analysis"]
    assert pt["full_over_sum_of_terms"] == pytest.approx(jx["full_over_sum_of_terms"], abs=0.02)
    assert jx["gp_grad_over_forward"] <= pt["gp_grad_over_forward"] <= 1.5 * jx["gp_grad_over_forward"]
    assert 5.0 <= pt["gp_grad_over_forward"] <= 7.0
    assert pt["round_over_ncritic_fullgrad"] == pytest.approx(1.0, abs=1e-12)
    assert 2 * jx["round_over_ncritic_fullgrad"] == pytest.approx(1.0, abs=0.1)


@pytest.mark.parametrize("n_critic", [2, 4])
def test_wgan_round_counts_every_critic_step(n_critic):
    tr = _narrow_trainer(n_critic)
    critic, gen = tr.init_states(seed=0, device="cpu")
    g = torch.Generator().manual_seed(1)
    real = torch.rand((8, 64), generator=g)
    costs = profile.wgan_costs(tr, critic, gen, real, torch.randn((8, 8), generator=g),
                               torch.rand((8, 1), generator=g))
    assert costs["critic_round"] == n_critic * costs["full_loss_grad"]
    assert profile.wgan_analysis(costs, n_critic)["round_over_ncritic_fullgrad"] == 1.0


class _Loss:
    """A loss that records when it is read."""

    def __init__(self, log: list, index: int):
        self.log, self.index = log, index

    def reshape(self, *shape):
        return self

    def __getitem__(self, item):
        return self

    def __float__(self):
        self.log.append(("read", self.index))
        return 0.0


class _StubExperiment:
    def __init__(self, log: list):
        self.log, self.calls = log, 0

    def train_iteration(self, feats, labels):
        self.log.append(("call", self.calls))
        self.calls += 1
        return {"d_loss": _Loss(self.log, self.calls - 1)}

    def flops_per_iteration(self, batch):
        return 1


def test_the_sweeps_windows_fence_on_their_last_call():
    log = []
    profile.sweep_row(_StubExperiment(log), None, None, 8, 8)
    reads = [i for i, ev in enumerate(log) if ev[0] == "read"]
    # three windows: a settling one of 10, then 2 and 8 calls
    assert len(reads) == 3
    start = 0
    for at, n in zip(reads, (10, 2, 8)):
        calls = log[start:at]
        assert [ev[0] for ev in calls] == ["call"] * n
        assert log[at] == ("read", calls[-1][1])
        start = at + 1
    assert start == len(log)


def test_cli_without_a_card_exits_2(monkeypatch, capsys):
    def refuse(*args, **kwargs):
        raise AssertionError("the profile ran without a device")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(profile, "run_iteration", refuse)
    monkeypatch.setattr(profile, "run_wgan", refuse)
    assert profile.main(["iteration"]) == 2
    assert profile.main(["wgan"]) == 2
    assert "no CUDA device" in capsys.readouterr().err


def test_fence_reads_the_newest_value():
    out = {"d_loss": torch.tensor([1.0, 2.0, 3.0]), "g_loss": torch.tensor([9.0])}
    assert profile.fence(out) == 3.0
    assert np.isfinite(profile.timed_window(lambda: out, 3))
