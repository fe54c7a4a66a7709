"""PyTorch port, the multi-host smoke on the CPU: ``parallel/multihost.py``
(the counterpart of ``scripts/multihost_smoke.py``) and the launcher in
``entry.py`` (of ``__graft_entry__.spawn_multihost``), at the JAX smoke's
own sizes.

What is held, and how:
- ``spawn_multihost(N)`` for N in 2 and 4: N OS processes meet at a real
  ``TCPStore`` coordinator on ``127.0.0.1`` behind the file barriers, and
  each prints 3 checksums, equal across the processes. The children run
  with torchrun's variables set to another group (the coordinator must
  win) and with a ``jax`` on their path that raises when imported (no
  child may load it);
- a process 0 whose peer never launched exits 3 within its barrier
  timeout; a process that exits 0 without its checksum lines, or without
  its ``OK`` line, or with a nonzero code, is refused;
- ``run_modes`` through ``parallel/launch.py::spawn`` at worlds 2 and 4,
  from the JAX package's init carried by ``interop.py``, against the JAX
  smoke's three modes run here on a mesh of N of conftest's 8 CPU devices
  with the same global rows and the ``PRNGKey(7)`` round: the ``pmean``
  step and the averaging round at ``TOL`` (rtol 1e-4, atol 1e-5, the JAX
  trainer tests' tolerance, ``tests/test_torch_parallel.py``); the WGAN-GP
  round at that file's WGAN-GP limits (losses 1e-4 relative, every
  params leaf 5e-3 by ``state_divergence``, the rounding-only generator
  bias within 2 steps of Adam's 2e-4). One port process at N ranks stands
  for the JAX smoke's N processes at ``--local-devices 1``, which is the
  same program as one JAX process with a mesh of N devices.
"""

import concurrent.futures
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from gan_deeplearning4j_tpu.models import mlp_gan as jax_mlp
from gan_deeplearning4j_tpu.models.wgan_gp import WganGpConfig as JaxWganConfig
from gan_deeplearning4j_tpu.models.wgan_gp import WganGpTrainer as JaxWganTrainer
from gan_deeplearning4j_tpu.parallel import GraphTrainer as JaxGraphTrainer
from gan_deeplearning4j_tpu.parallel import ParameterAveragingTrainer as JaxAveraging
from gan_deeplearning4j_tpu_torch import entry
from gan_deeplearning4j_tpu_torch.harness.experiment import state_divergence
from gan_deeplearning4j_tpu_torch.parallel import multihost
from gan_deeplearning4j_tpu_torch.parallel.launch import spawn
from gan_deeplearning4j_tpu_torch.runtime import environment

WORLDS = (2, 4)
TOL = dict(rtol=1e-4, atol=1e-5)
ITER_LOSS_RTOL, ITER_LEAF_REL = 1e-4, 5e-3
#: the generator's dense bias feeds its BatchNorm: rounding alone moves it
WGAN_ROUNDING_ONLY = ("gen/gen_dense_1/b",)
ADAM_LR = 2e-4
#: the barrier timeout of the never-launched-peer case, and its slack for a
#: process's start (interpreter and torch import) before the barrier
LONE_BARRIER_S, LONE_START_S = 3.0, 30.0


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_flat(value, f"{prefix}{key}/"))
        else:
            out[f"{prefix}{key}"] = np.asarray(value)
    return out


@pytest.fixture
def child_env(tmp_path, monkeypatch):
    """The children's environment: torchrun's variables of another group
    (a local port nothing listens on) and a ``jax`` that raises on import."""
    stub = tmp_path / "stub" / "jax"
    stub.mkdir(parents=True)
    (stub / "__init__.py").write_text("raise ImportError('the port must not import jax')\n")
    monkeypatch.setenv("PYTHONPATH", str(stub.parent))
    for name, value in (("RANK", "5"), ("WORLD_SIZE", "7"), ("LOCAL_RANK", "5"),
                        ("LOCAL_WORLD_SIZE", "7"), ("MASTER_ADDR", "127.0.0.1"),
                        ("MASTER_PORT", "1")):
        monkeypatch.setenv(name, value)


@pytest.mark.parametrize("n_processes", WORLDS)
def test_processes_agree_through_the_tcp_coordinator(child_env, tmp_path, capsys, n_processes):
    states = tmp_path / "states"
    states.mkdir()
    checksums = entry.spawn_multihost(n_processes, timeout=120, echo=True, platform="cpu",
                                      states_dir=str(states))
    assert len(checksums) == n_processes
    assert all(len(c) == 3 for c in checksums)
    assert all(c == checksums[0] for c in checksums[1:]), checksums
    assert all(len(s) == multihost.CHECKSUM_HEX for s in checksums[0])
    shown = capsys.readouterr().out
    for i in range(n_processes):
        assert (f"[multihost] process {i}/{n_processes} up: 1 local / {n_processes} global "
                f"devices, platform=cpu backend=gloo device=cpu") in shown
    files = [np.load(states / f"process{i}.npz") for i in range(n_processes)]
    for other in files[1:]:
        assert sorted(other.files) == sorted(files[0].files)
        for key in files[0].files:
            np.testing.assert_array_equal(other[key], files[0][key], err_msg=key)


def test_a_peer_that_never_launched_is_exit_3_within_the_barrier_timeout():
    t0 = time.monotonic()
    [(rc, out, _)] = entry.run_multihost(2, platform="cpu", timeout=120,
                                         barrier_timeout=LONE_BARRIER_S, process_ids=[0])
    assert rc == 3, out
    assert "BARRIER TIMEOUT at 'boot'" in out
    assert "up:" not in out  # the store was never made
    assert time.monotonic() - t0 < LONE_BARRIER_S + LONE_START_S


_OK = "[multihost] process 0 OK\n"
_SUMS = "".join(f"[multihost] mode={m} loss=0.1 checksum=00000000000000{k}0\n"
                for k, m in enumerate(entry.SMOKE_MODES))


@pytest.mark.parametrize("result, message", [
    ((0, _OK, ""), "expected 3 checksums"),
    ((0, _SUMS, ""), "never reported OK"),
    ((1, _SUMS + _OK, "boom"), "rc=1"),
    ((0, _SUMS.splitlines(keepends=True)[0] + _OK, ""), "expected 3 checksums"),
])
def test_a_process_without_its_checksums_ok_line_or_exit_0_is_refused(result, message):
    with pytest.raises(RuntimeError, match=message):
        entry.checksums_of([result])


def test_checksums_of_reads_one_per_mode():
    assert entry.checksums_of([(0, _SUMS + _OK, "")]) == [
        ["0000000000000000", "0000000000000010", "0000000000000020"]]


def test_local_devices_other_than_one_are_refused(capsys):
    with pytest.raises(SystemExit):
        multihost.parse_args(["--coordinator", "127.0.0.1:1", "--num-processes", "2",
                              "--process-id", "0", "--local-devices", "2"])
    assert "a process is one rank" in capsys.readouterr().err


@pytest.mark.parametrize("address, processes, process_id, message", [
    ("127.0.0.1", 2, 0, "host:port"),
    (":29500", 2, 0, "host:port"),
    ("localhost:port", 2, 0, "host:port"),
    ("127.0.0.1:1", 2, 2, "outside 2 processes"),
])
def test_a_malformed_coordinator_is_refused_before_any_wait(address, processes, process_id,
                                                            message):
    with pytest.raises(ValueError, match=message):
        environment._coordinator_store(address, processes, process_id, 1.0)


def test_backend_for_takes_nccl_only_with_a_card_per_rank(monkeypatch):
    monkeypatch.setattr(environment.torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(environment.torch.cuda, "device_count", lambda: 2)
    assert [environment.backend_for(n) for n in (1, 2, 3, 4)] == ["nccl", "nccl", "gloo", "gloo"]
    assert environment.backend_for(1, use_accelerator=False) == "gloo"
    monkeypatch.setattr(environment.torch.cuda, "is_available", lambda: False)
    assert environment.backend_for(1) == "gloo"


def test_wgan_draws_are_the_jax_rounds():
    """``wgan_draws`` against ``WganGpTrainer.train_round``'s own splits."""
    rows, z_size, n_critic = 4, 4, 2
    zs, eps, gen_z = multihost.wgan_draws(rows, z_size, n_critic)
    k_c, k_g = jax.random.split(jax.random.PRNGKey(7))
    key = k_c
    for k in range(n_critic):
        key, sub = jax.random.split(key)
        k_z, k_gp = jax.random.split(sub)
        np.testing.assert_allclose(zs[k], jax.random.normal(k_z, (rows, z_size)), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_array_equal(eps[k], jax.random.uniform(k_gp, (rows, 1)))
    np.testing.assert_allclose(gen_z, jax.random.normal(k_g, (rows, z_size)), rtol=1e-6,
                               atol=1e-6)


# -- run_modes against the JAX smoke's modes -------------------------------------

def _jax_smoke(n, dis_graph, params, wcfg, wstates):
    """The JAX smoke's three modes on a mesh of ``n`` CPU devices in this
    process, from the given states, on the smoke's global rows."""
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:n]), ("data",))
    out = {}
    trainer = JaxGraphTrainer(dis_graph, mesh=mesh)
    state = trainer.init_state(params=jax.tree_util.tree_map(jnp.asarray, params))
    feats, labels = multihost.global_batch(2 * n, 8, seed=1)
    state, loss = trainer.train_step(state, jnp.asarray(feats), jnp.asarray(labels))
    out["pmean"] = {"losses": {"loss": float(loss)}, "params": _np(state.params)}
    pa = JaxAveraging(dis_graph, mesh, batch_size_per_worker=multihost.PER_WORKER,
                      averaging_frequency=multihost.FREQ)
    pa_state = pa.init_state(params=jax.tree_util.tree_map(jnp.asarray, params))
    feats, labels = multihost.global_batch(n * multihost.FREQ * multihost.PER_WORKER, 8, seed=2)
    pa_state, losses = pa.fit_round(pa_state, jnp.asarray(feats), jnp.asarray(labels))
    out["param_averaging"] = {"losses": {"mean_loss": float(jnp.mean(losses))},
                              "params": _np(pa_state.params)}
    real = np.random.default_rng(3).random((2, n, 64), dtype=np.float32)
    cs, gs = (jax.tree_util.tree_map(jnp.asarray, s) for s in wstates)  # fresh: donated
    cs, gs, c_loss, g_loss = JaxWganTrainer(wcfg, mesh=mesh).train_round(
        cs, gs, real, jax.random.PRNGKey(7))
    out["wgan_gp"] = {"losses": {"c_loss": float(c_loss), "g_loss": float(g_loss)},
                      "params": {"critic": _np(cs.params), "gen": _np(gs.params)}}
    return out


@pytest.fixture(scope="module")
def smoke_runs():
    """``{N: (JAX modes, port ranks)}``: the port's spawns start first and
    run beside the JAX side."""
    dis_graph = jax_mlp.build_discriminator(jax_mlp.MlpGanConfig(**multihost.MLP_SHAPES))
    params = _np(dis_graph.init())
    wcfg = JaxWganConfig(**multihost.WGAN_SHAPES)
    wstates = [_np(s) for s in JaxWganTrainer(wcfg).init_states(seed=0)]
    init = {"dis": params, "critic": wstates[0].params, "gen": wstates[1].params}
    with concurrent.futures.ThreadPoolExecutor(len(WORLDS)) as pool:
        ports = {n: pool.submit(spawn, multihost.run_modes, n, kwargs={"init": init},
                                timeout=240, threads=1) for n in WORLDS}
        refs = {n: _jax_smoke(n, dis_graph, params, wcfg, wstates) for n in WORLDS}
        return {n: (refs[n], ports[n].result()) for n in WORLDS}


@pytest.mark.parametrize("n", WORLDS)
@pytest.mark.parametrize("mode", ["pmean", "param_averaging"])
def test_run_modes_match_the_jax_smoke(smoke_runs, n, mode):
    ref, ranks = smoke_runs[n]
    got = ranks[0][mode]
    for key, value in ref[mode]["losses"].items():
        np.testing.assert_allclose(got["losses"][key], value, rtol=1e-4, err_msg=key)
    p, r = _flat(got["params"]), _flat(ref[mode]["params"])
    assert sorted(p) == sorted(r)
    for key in r:
        np.testing.assert_allclose(p[key], r[key], err_msg=key, **TOL)


@pytest.mark.parametrize("n", WORLDS)
def test_run_modes_wgan_round_matches_the_jax_smoke(smoke_runs, n):
    ref, ranks = smoke_runs[n]
    got = ranks[0]["wgan_gp"]
    for key, value in ref["wgan_gp"]["losses"].items():
        np.testing.assert_allclose(got["losses"][key], value, rtol=ITER_LOSS_RTOL, err_msg=key)
    div = state_divergence(_flat(got["params"]), _flat(ref["wgan_gp"]["params"]),
                           WGAN_ROUNDING_ONLY)
    assert div["max_leaf_rel"] <= ITER_LEAF_REL, div
    assert div["rounding_only_max_abs"] <= 2 * ADAM_LR, div


@pytest.mark.parametrize("n", WORLDS)
def test_run_modes_ranks_are_bit_identical_and_load_no_jax(smoke_runs, n):
    _, ranks = smoke_runs[n]
    assert [r["rank"] for r in ranks] == list(range(n))
    assert not any(r["jax_loaded"] for r in ranks)
    for mode in entry.SMOKE_MODES:
        digests = ranks[0][mode]["digests"]
        assert len(digests) == n and len(set(digests)) == 1
        assert {r[mode]["checksum"] for r in ranks} == {digests[0][:multihost.CHECKSUM_HEX]}
        for r in ranks[1:]:
            a, b = _flat(r[mode]["params"]), _flat(ranks[0][mode]["params"])
            for key in a:
                np.testing.assert_array_equal(a[key], b[key], err_msg=f"{mode}: {key}")
