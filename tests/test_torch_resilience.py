"""The port's operations planes, first half: ``resilience/`` (fault
injection, the supervisor, the mesh two-phase commit, the worker CLI and
its drill) and ``publish_for_serving(store=)``.

- the cases of ``tests/test_resilience.py`` run on the port at the drill's
  tabular toy size on the CPU (the store's own cases are in
  ``test_torch_deploy.py``): faults, the supervisor on a fake and on the
  real experiment (bit-exact resume), serving generations, the drill smoke
  through real processes, the mesh barrier, publish, commit window,
  supervisor and reshard parity, and the step timeline;
- held against the JAX package on the same inputs: seeded schedules and
  their files; one fake experiment and one schedule through both
  supervisors (statuses, events without their seconds, retry delays,
  summary keys, exception types); stores written by one package's
  supervisor restored by the other's, with equal ``state_digests``; a mesh
  generation committed by port workers is the JAX store's
  ``latest_valid()`` with an equal ``mesh_digest``, and a half-committed
  round is invisible to both; a ``publish_for_serving(store=)`` generation
  served by the JAX engine; the refused ``param_averaging`` config; the
  CLIs' option sets.

Tolerances: every comparison here is exact (digests, events, rows of the
tabular generator within the serving tests' 1e-5).
"""

import dataclasses
import json
import os
import signal
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from gan_deeplearning4j_tpu import resilience as jax_res
from gan_deeplearning4j_tpu_torch import resilience as pt_res
from gan_deeplearning4j_tpu_torch.resilience import (
    CheckpointStore,
    FaultInjector,
    FaultSchedule,
    FaultSpec,
    InjectedFault,
    MeshCoordinator,
    MeshTimeout,
    RetryBudgetExceeded,
    SupervisorConfig,
    TrainingSupervisor,
    UnsupportedExperimentError,
    corrupt_generation,
    mesh_digest,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERVE_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def _no_persistent_compile_cache():
    """The JAX experiments of the parity tests are built and torn down
    serially, the write-then-load pattern that the XLA:CPU persistent
    cache's AOT loader turns into heap corruption (``tests/
    test_resilience.py``): run the module with that cache off."""
    import jax
    from jax._src import compilation_cache as _cc

    old = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", False)
    _cc.reset_cache()
    yield
    jax.config.update("jax_enable_compilation_cache", old)
    _cc.reset_cache()


@pytest.fixture(autouse=True)
def _port_registry():
    """A fresh port metrics registry and tracer state per test
    (tests/conftest.py resets only the JAX package's)."""
    from gan_deeplearning4j_tpu_torch.telemetry.registry import MetricsRegistry, set_registry
    from gan_deeplearning4j_tpu_torch.telemetry.trace import TRACER

    previous = set_registry(MetricsRegistry())
    try:
        yield
    finally:
        set_registry(previous)
        TRACER.disable()
        TRACER.clear()


def write_files(payload):
    """A store writer callback that writes a dict of name -> bytes."""
    def writer(directory):
        for name, data in payload.items():
            with open(os.path.join(directory, name), "wb") as fh:
                fh.write(data)
    return writer


# ===========================================================================
# faults
# ===========================================================================

class TestFaults:
    def test_seeded_schedule_is_deterministic(self):
        a = FaultSchedule.seeded(42, 100, kinds=("raise", "kill"), n_faults=3)
        b = FaultSchedule.seeded(42, 100, kinds=("raise", "kill"), n_faults=3)
        assert a == b
        assert len(a.specs) == 3
        assert all(1 <= s.step < 100 for s in a.specs)
        assert a != FaultSchedule.seeded(43, 100, kinds=("raise", "kill"), n_faults=3)

    def test_schedule_json_round_trip(self, tmp_path):
        sched = FaultSchedule([FaultSpec(kind="kill", step=5),
                               FaultSpec(kind="slow_write", step=2, args={"seconds": 0.5})])
        path = os.path.join(tmp_path, "f.json")
        sched.to_json(path)
        assert FaultSchedule.from_json(path) == sched

    def test_unknown_kind_rejected(self):
        with pytest.raises(ValueError, match="unknown fault kind"):
            FaultSpec(kind="meteor", step=1)

    def test_raise_fires_once_at_exact_step(self):
        inj = FaultInjector(FaultSchedule([FaultSpec(kind="raise", step=3)]))
        inj.on_step(2)
        with pytest.raises(InjectedFault):
            inj.on_step(3)
        inj.on_step(3)  # already fired — never twice
        assert [e["kind"] for e in inj.log] == ["raise"]

    def test_slow_and_failed_write(self, tmp_path):
        sleeps = []
        inj = FaultInjector(FaultSchedule([
            FaultSpec(kind="slow_write", step=2, args={"seconds": 1.5}),
            FaultSpec(kind="fail_write", step=4)]), sleep=sleeps.append)
        store = CheckpointStore(str(tmp_path), fault_injector=inj)
        store.publish(write_files({"m.bin": b"a"}), step=0)
        store.publish(write_files({"m.bin": b"b"}), step=3)
        assert sleeps == [1.5]
        with pytest.raises(OSError, match="injected"):
            store.publish(write_files({"m.bin": b"c"}), step=5)
        assert store.published() == [0, 1]
        assert store.latest_valid().number == 1

    def test_corrupt_on_published(self, tmp_path):
        inj = FaultInjector(FaultSchedule([FaultSpec(kind="corrupt", step=1)]))
        store = CheckpointStore(str(tmp_path))
        g = store.publish(write_files({"m.bin": b"q" * 64}), step=2)
        inj.on_published(store, g)
        assert store.verify(g.number) is not None
        assert inj.log[-1]["member"] == "m.bin"

    def test_worker_targeted_specs(self):
        sched = FaultSchedule([FaultSpec(kind="raise", step=1, args={"worker": 1})])
        FaultInjector(sched, worker_id=0).on_step(1)  # aimed elsewhere
        with pytest.raises(InjectedFault):
            FaultInjector(sched, worker_id=1).on_step(1)


@pytest.mark.parametrize("seed", [0, 1, 7, 42, 1234])
@pytest.mark.parametrize("kinds", [("raise",), ("kill",), ("raise", "preempt", "kill")])
def test_seeded_schedules_equal_jax(seed, kinds):
    pt = FaultSchedule.seeded(seed, 40, kinds=kinds, n_faults=3)
    jx = jax_res.FaultSchedule.seeded(seed, 40, kinds=kinds, n_faults=3)
    assert [(s.kind, s.step, s.args) for s in pt.specs] == \
        [(s.kind, s.step, s.args) for s in jx.specs]


def test_schedule_files_read_in_both_packages(tmp_path):
    specs = [("kill", 5, {}), ("slow_write", 2, {"seconds": 0.5}),
             ("straggler", 3, {"seconds": 0.3, "worker": 1}), ("kill_committed", 6, {})]
    pt = FaultSchedule([FaultSpec(kind=k, step=s, args=a) for k, s, a in specs])
    jx = jax_res.FaultSchedule([jax_res.FaultSpec(kind=k, step=s, args=a) for k, s, a in specs])
    pt.to_json(str(tmp_path / "pt.json"))
    jx.to_json(str(tmp_path / "jax.json"))
    assert (tmp_path / "pt.json").read_bytes() == (tmp_path / "jax.json").read_bytes()
    assert FaultSchedule.from_json(str(tmp_path / "jax.json")) == pt
    assert jax_res.FaultSchedule.from_json(str(tmp_path / "pt.json")) == jx


# ===========================================================================
# supervisor — fast paths with a fake experiment
# ===========================================================================

class FakeExperiment:
    """Counts steps; save/load shuttle the counter through a text file so
    restore semantics are exercised for real."""

    instances = []

    def __init__(self, config):
        self.config = config
        self.batch_counter = 0
        self.trained = []
        FakeExperiment.instances.append(self)
        self.dis_state = self.gan_state = None
        self.cv_state = None
        self.gen_params = None

    def train_iteration(self, feats, labels):
        self.trained.append(self.batch_counter)

    def save_models(self, directory=None):
        with open(os.path.join(directory, "state.txt"), "w") as fh:
            fh.write(str(self.batch_counter))

    def save_model_shard(self, directory, shard_index, shard_count):
        name = f"state_shard-{shard_index:04d}-of-{shard_count:04d}.txt"
        with open(os.path.join(directory, name), "w") as fh:
            fh.write(str(self.batch_counter))
        return [name]

    def load_models(self, directory=None):
        names = sorted(n for n in os.listdir(directory)
                       if n.startswith("state") and n.endswith(".txt"))
        with open(os.path.join(directory, names[0])) as fh:
            self.batch_counter = int(fh.read())
        return self.batch_counter


@pytest.fixture(autouse=True)
def _reset_fakes():
    FakeExperiment.instances = []
    yield


@dataclasses.dataclass
class FakeCfg:
    batch_size_train: int = 4
    distributed: str = "none"


def fake_supervisor(tmp_path, sup_cfg, faults=None, sleeps=None, module=pt_res,
                    cfg=None, store_dir="store"):
    feats = np.zeros((16, 3), np.float32)
    labels = np.zeros((16, 2), np.float32)
    sup = module.TrainingSupervisor(
        cfg or FakeCfg(), sup_cfg, feats, labels,
        store_root=os.path.join(str(tmp_path), store_dir), faults=faults,
        sleep=(sleeps.append if sleeps is not None else (lambda s: None)),
        experiment_factory=FakeExperiment)
    # the fake has no states to digest — bypass the digest hook
    sup.state_digests = lambda exp: {"fake": str(exp.batch_counter)}
    return sup


class TestSupervisorFast:
    def test_segments_and_publish_cadence(self, tmp_path):
        sup = fake_supervisor(tmp_path, SupervisorConfig(total_steps=10, publish_every=4))
        out = sup.run()
        assert out["status"] == "completed" and out["steps"] == 10
        assert [e["step"] for e in sup.events if e["event"] == "publish"] == [4, 8, 10]
        assert sup.store.latest_valid().step == 10

    def test_fault_retry_restores_from_newest_valid(self, tmp_path):
        inj = FaultInjector(FaultSchedule([FaultSpec(kind="raise", step=6)]))
        sup = fake_supervisor(tmp_path, SupervisorConfig(total_steps=10, publish_every=4),
                              faults=inj)
        out = sup.run()
        assert out["status"] == "completed" and out["attempts_used"] == 1
        assert [r["step"] for r in sup.events if r["event"] == "restore"] == [4]
        assert FakeExperiment.instances[-1].trained[:3] == [4, 5, 6]

    def test_retry_budget_exhaustion_is_terminal(self, tmp_path):
        inj = FaultInjector(FaultSchedule([FaultSpec(kind="raise", step=0) for _ in range(10)]))
        sleeps = []
        sup = fake_supervisor(
            tmp_path, SupervisorConfig(total_steps=5, publish_every=2, max_retries=3,
                                       backoff_base_s=0.5, backoff_max_s=1.5),
            faults=inj, sleeps=sleeps)
        with pytest.raises(RetryBudgetExceeded, match="injected"):
            sup.run()
        assert sleeps == [0.5, 1.0, 1.5]
        assert len([e for e in sup.events if e["event"] == "fault"]) == 4

    def test_preemption_checkpoints_then_exits_cleanly(self, tmp_path):
        sup = fake_supervisor(tmp_path, SupervisorConfig(total_steps=100, publish_every=50))

        class PreemptAt:
            def on_step(self, step):
                if step == 7:
                    sup.request_preemption()

            def on_published(self, store, generation):
                pass

        sup.faults = PreemptAt()
        out = sup.run()
        assert out["status"] == "preempted" and out["steps"] == 8
        assert sup.store.latest_valid().step == 8

    def test_sigterm_preemption_via_real_signal(self, tmp_path):
        sup = fake_supervisor(tmp_path, SupervisorConfig(total_steps=100, publish_every=50))
        sup.faults = FaultInjector(FaultSchedule([FaultSpec(kind="preempt", step=5)]))
        old = signal.getsignal(signal.SIGTERM)
        try:
            sup.install_signal_handlers()
            out = sup.run()
        finally:
            signal.signal(signal.SIGTERM, old)
        assert out["status"] == "preempted" and out["steps"] == 6
        assert sup.store.latest_valid().step == 6

    def test_phased_experiment_rejected_terminally(self, tmp_path):
        sleeps = []
        sup = fake_supervisor(tmp_path, SupervisorConfig(total_steps=5, max_retries=3),
                              sleeps=sleeps, cfg=FakeCfg(distributed="param_averaging"))
        with pytest.raises(UnsupportedExperimentError, match="phased"):
            sup.run()
        assert sleeps == [] and FakeExperiment.instances == []

    def test_preempt_flag_resets_between_runs(self, tmp_path):
        sup = fake_supervisor(tmp_path, SupervisorConfig(total_steps=6, publish_every=3))
        sup.request_preemption()
        out = sup.run()
        assert out["status"] == "completed" and out["steps"] == 6

    def test_resume_skips_when_nothing_remains(self, tmp_path):
        out = fake_supervisor(tmp_path, SupervisorConfig(total_steps=6, publish_every=3)).run()
        out2 = fake_supervisor(tmp_path, SupervisorConfig(total_steps=6, publish_every=3)).run()
        assert out2["status"] == "completed" and out2["start_step"] == 6
        assert out2["final_generation"] == out["final_generation"]

    def test_batch_schedule_is_pure_function_of_step(self, tmp_path):
        sup = fake_supervisor(tmp_path, SupervisorConfig(total_steps=4, publish_every=4))
        f0, _ = sup.batch_at(0)
        np.testing.assert_array_equal(f0, sup.batch_at(4)[0])  # 16 rows / 4 → wraps
        assert sup.batch_at(1)[0].shape == f0.shape

    def test_config_validation(self):
        with pytest.raises(ValueError):
            SupervisorConfig(total_steps=0).validate()
        with pytest.raises(ValueError):
            SupervisorConfig(total_steps=1, publish_every=0).validate()
        with pytest.raises(ValueError):
            SupervisorConfig(total_steps=1, backoff_base_s=2.0, backoff_max_s=1.0).validate()

    def test_every_attempt_releases_its_experiment(self, tmp_path):
        closed = []

        class Closing(FakeExperiment):
            def close(self):
                closed.append(self.batch_counter)

        inj = FaultInjector(FaultSchedule([FaultSpec(kind="raise", step=6)]))
        sup = fake_supervisor(tmp_path, SupervisorConfig(total_steps=10, publish_every=4),
                              faults=inj)
        sup._experiment_factory = Closing
        sup.run()
        assert closed == [6, 10]  # the failed attempt's and the final one's


def _strip_seconds(events):
    return [{k: v for k, v in e.items() if k != "seconds"} for e in events]


def _drive_fake(module, tmp_path, name, specs, **sup_kwargs):
    inj = module.FaultInjector(module.FaultSchedule(
        [module.FaultSpec(kind=k, step=s, args=a) for k, s, a in specs]))
    sleeps = []
    sup = fake_supervisor(tmp_path, module.SupervisorConfig(**sup_kwargs), faults=inj,
                          sleeps=sleeps, module=module, store_dir=name)
    try:
        out, error = sup.run(), None
    except Exception as exc:  # compared across packages
        out, error = None, (type(exc).__name__, str(exc))
    return {"status": out and out["status"], "steps": out and out["steps"],
            "keys": sorted(out) if out else None, "events": _strip_seconds(sup.events),
            "retry_delays": list(sup.retry_delays), "sleeps": sleeps, "error": error,
            "published": CheckpointStore(os.path.join(str(tmp_path), name)).published()}


@pytest.mark.parametrize("case", [
    ("clean", [], dict(total_steps=10, publish_every=4)),
    ("raise_and_failed_write", [("raise", 6, {}), ("fail_write", 8, {}),
                                ("slow_write", 2, {"seconds": 0.25})],
     dict(total_steps=12, publish_every=4, backoff_base_s=0.5)),
    ("corrupt_then_raise", [("corrupt", 3, {}), ("raise", 6, {})],
     dict(total_steps=10, publish_every=4)),
    ("budget_spent", [("raise", 0, {})] * 6,
     dict(total_steps=5, publish_every=2, max_retries=3, backoff_base_s=0.5, backoff_max_s=1.5)),
], ids=lambda c: c[0])
def test_supervisors_agree_on_one_fake_and_schedule(tmp_path, case):
    _, specs, kwargs = case
    pt = _drive_fake(pt_res, tmp_path, "pt", specs, **kwargs)
    jx = _drive_fake(jax_res, tmp_path, "jax", specs, **kwargs)
    assert pt == jx


# ===========================================================================
# supervisor — the real experiment (tabular toy): the bit-exact contract
# ===========================================================================

TABULAR = dict(model_family="tabular", num_features=16, z_size=4, batch_size_train=8,
               batch_size_pred=8, height=1, width=1, channels=1, save_models=False)


def tabular_cfg(tmp_path, **overrides):
    from gan_deeplearning4j_tpu_torch.harness import ExperimentConfig

    return ExperimentConfig(**TABULAR, output_dir=os.path.join(str(tmp_path), "out"),
                            use_accelerator=False, **overrides)


def jax_tabular_cfg(tmp_path, **overrides):
    from gan_deeplearning4j_tpu.harness import ExperimentConfig

    return ExperimentConfig(**TABULAR, output_dir=os.path.join(str(tmp_path), "jout"),
                            **overrides)


def tabular_data(n=32, seed=0):
    rng = np.random.default_rng(seed)
    feats = rng.random((n, 16), dtype=np.float32)
    labels = np.eye(10, dtype=np.float32)[np.arange(n) % 10]
    return feats, labels


class TestSupervisorBitExact:
    def test_interrupted_resume_is_bit_exact(self, tmp_path):
        feats, labels = tabular_data()
        cfg = tabular_cfg(tmp_path)
        r1 = TrainingSupervisor(cfg, SupervisorConfig(total_steps=8, publish_every=4), feats,
                                labels, store_root=os.path.join(str(tmp_path), "s_oracle")).run()
        assert r1["status"] == "completed"
        inj = FaultInjector(FaultSchedule([FaultSpec(kind="raise", step=6)]))
        r2 = TrainingSupervisor(cfg, SupervisorConfig(total_steps=8, publish_every=4,
                                                      backoff_base_s=0.0),
                                feats, labels, store_root=os.path.join(str(tmp_path), "s_fault"),
                                faults=inj, sleep=lambda s: None).run()
        assert r2["status"] == "completed" and r2["attempts_used"] == 1
        assert r1["state_digests"] == r2["state_digests"]
        assert set(r1["state_digests"]) == {"dis", "gan", "gen"}

    def test_corrupt_generation_falls_back_and_still_completes(self, tmp_path):
        feats, labels = tabular_data()
        cfg = tabular_cfg(tmp_path)
        root = os.path.join(str(tmp_path), "s")
        TrainingSupervisor(cfg, SupervisorConfig(total_steps=6, publish_every=3), feats, labels,
                           store_root=root).run()
        store = CheckpointStore(root)
        newest = store.published()[-1]
        corrupt_generation(store, newest)
        resumed = TrainingSupervisor(cfg, SupervisorConfig(total_steps=9, publish_every=3),
                                     feats, labels, store=CheckpointStore(root))
        out = resumed.run()
        assert out["status"] == "completed" and out["steps"] == 9
        restores = [e for e in resumed.events if e["event"] == "restore"]
        assert restores and restores[0]["generation"] != newest
        assert CheckpointStore(root).entry(newest)["status"] == "quarantined"

    def test_preempted_then_relaunched_is_bit_exact(self, tmp_path):
        feats, labels = tabular_data()
        cfg = tabular_cfg(tmp_path)
        want = TrainingSupervisor(cfg, SupervisorConfig(total_steps=8, publish_every=4), feats,
                                  labels, store_root=os.path.join(str(tmp_path), "a")).run()
        root = os.path.join(str(tmp_path), "b")
        sup = TrainingSupervisor(cfg, SupervisorConfig(total_steps=8, publish_every=4), feats,
                                 labels, store_root=root)

        class PreemptAt:
            def on_step(self, step):
                if step == 4:
                    sup.request_preemption()

            def on_published(self, store, generation):
                pass

        sup.faults = PreemptAt()
        first = sup.run()
        assert first["status"] == "preempted" and first["steps"] == 5
        again = TrainingSupervisor(cfg, SupervisorConfig(total_steps=8, publish_every=4), feats,
                                   labels, store_root=root).run()
        assert again["start_step"] == 5 and again["state_digests"] == want["state_digests"]

    def test_close_releases_graphs_and_training_goes_on(self, tmp_path):
        from gan_deeplearning4j_tpu_torch.harness import GanExperiment

        feats, labels = tabular_data()
        exp = GanExperiment(tabular_cfg(tmp_path))
        exp.train_iteration(feats[:8], labels[:8])
        assert exp.graphs._entries
        exp.close()
        assert not exp.graphs._entries and exp.graphs.capture_counts == {}
        exp.train_iteration(feats[8:16], labels[8:16])
        assert exp.graphs.runs == 2

    def test_param_averaging_refused_by_both_packages_without_retry(self, tmp_path):
        feats, labels = tabular_data()
        for module, cfg in ((pt_res, tabular_cfg(tmp_path, distributed="param_averaging")),
                            (jax_res, jax_tabular_cfg(tmp_path, distributed="param_averaging",
                                                      batch_size_per_worker=2))):
            sleeps = []
            sup = module.TrainingSupervisor(
                cfg, module.SupervisorConfig(total_steps=4, max_retries=3), feats, labels,
                store_root=os.path.join(str(tmp_path), module.__name__), sleep=sleeps.append)
            with pytest.raises(module.UnsupportedExperimentError, match="phased"):
                sup.run()
            assert sleeps == [] and sup.events == [], module.__name__


class TestCrossPackageStores:
    """Stores published by one package's supervisor restore in the
    other's: the restored step and ``state_digests`` equal the manifest's."""

    def test_jax_store_restores_in_the_port(self, tmp_path):
        from gan_deeplearning4j_tpu_torch.harness import GanExperiment

        feats, labels = tabular_data()
        root = os.path.join(str(tmp_path), "store")
        jax_res.TrainingSupervisor(jax_tabular_cfg(tmp_path),
                                   jax_res.SupervisorConfig(total_steps=4, publish_every=2),
                                   feats, labels, store_root=root).run()
        gen = CheckpointStore(root).latest_valid()
        assert gen.step == 4
        exp = GanExperiment(tabular_cfg(tmp_path))
        assert exp.load_models(directory=gen.path) == 4
        assert TrainingSupervisor.state_digests(exp) == gen.manifest["state_digests"]
        sup = TrainingSupervisor(tabular_cfg(tmp_path),
                                 SupervisorConfig(total_steps=6, publish_every=2),
                                 feats, labels, store_root=root)
        out = sup.run()
        restores = [e for e in sup.events if e["event"] == "restore"]
        assert [(r["generation"], r["step"]) for r in restores] == [(gen.number, 4)]
        assert out["status"] == "completed" and out["steps"] == 6

    def test_port_store_restores_in_jax(self, tmp_path):
        from gan_deeplearning4j_tpu.harness import GanExperiment as JaxExperiment

        feats, labels = tabular_data()
        root = os.path.join(str(tmp_path), "store")
        TrainingSupervisor(tabular_cfg(tmp_path), SupervisorConfig(total_steps=4, publish_every=2),
                           feats, labels, store_root=root).run()
        gen = jax_res.CheckpointStore(root).latest_valid()
        assert gen.step == 4
        exp = JaxExperiment(jax_tabular_cfg(tmp_path))
        assert exp.load_models(directory=gen.path) == 4
        assert jax_res.TrainingSupervisor.state_digests(exp) == gen.manifest["state_digests"]
        sup = jax_res.TrainingSupervisor(jax_tabular_cfg(tmp_path),
                                         jax_res.SupervisorConfig(total_steps=6, publish_every=2),
                                         feats, labels, store_root=root)
        out = sup.run()
        assert [e["step"] for e in sup.events if e["event"] == "restore"] == [4]
        assert out["status"] == "completed" and out["steps"] == 6


# ===========================================================================
# publish_for_serving into a store generation
# ===========================================================================

class TestServingGeneration:
    def test_bundle_publishes_as_generation(self, tmp_path):
        from gan_deeplearning4j_tpu_torch.harness import GanExperiment

        exp = GanExperiment(tabular_cfg(tmp_path))
        store = CheckpointStore(os.path.join(str(tmp_path), "store"))
        out = exp.publish_for_serving(store=store)
        assert out["generation"] == 0
        gen = store.latest_valid()
        assert gen is not None and gen.manifest["kind"] == "serving"
        with open(gen.file("serving.json")) as fh:
            manifest = json.load(fh)
        assert manifest["generation"] == 0
        assert manifest["generator"] in gen.manifest["files"]
        assert exp.publish_for_serving(store=store)["generation"] == 1

    def test_directory_publish_is_unversioned(self, tmp_path):
        from gan_deeplearning4j_tpu_torch.harness import GanExperiment

        exp = GanExperiment(tabular_cfg(tmp_path))
        out = exp.publish_for_serving(directory=os.path.join(str(tmp_path), "serving"))
        assert out["generation"] is None
        with open(os.path.join(out["directory"], "serving.json")) as fh:
            assert json.load(fh)["generation"] is None

    def test_store_generation_serves_in_the_jax_engine(self, tmp_path):
        import torch

        from gan_deeplearning4j_tpu.serving import ServingEngine as JaxEngine
        from gan_deeplearning4j_tpu_torch.harness import GanExperiment

        feats, labels = tabular_data()
        exp = GanExperiment(tabular_cfg(tmp_path))
        exp.train_iteration(feats[:8], labels[:8])
        exp.batch_counter += 1
        store = CheckpointStore(os.path.join(str(tmp_path), "store"))
        exp.publish_for_serving(store=store)
        gen = jax_res.CheckpointStore(store.root).latest_valid()
        assert gen.manifest["kind"] == "serving"
        engine = JaxEngine.from_bundle(gen.path, buckets=(1, 4))
        assert engine.generation == 0
        z = np.random.default_rng(3).uniform(-1, 1, (3, 4)).astype(np.float32)
        with torch.no_grad():
            want = exp.gen.output(exp.gen_params, torch.from_numpy(z)).reshape(3, -1).numpy()
        np.testing.assert_allclose(engine.run("sample", z), want, **SERVE_TOL)


# ===========================================================================
# the drill smoke — a real kill at step N
# ===========================================================================

class TestDrillSmoke:
    def test_drill_smoke_with_injected_kill(self, tmp_path):
        out_json = os.path.join(str(tmp_path), "drill.json")
        proc = subprocess.run(
            [sys.executable, "-m", "gan_deeplearning4j_tpu_torch.resilience.drill", "--smoke",
             "--cpu", "--workdir", os.path.join(str(tmp_path), "work"), "--output", out_json],
            capture_output=True, text=True, cwd=REPO, timeout=300)
        assert proc.returncode == 0, (proc.stdout[-3000:], proc.stderr[-2000:])
        with open(out_json) as fh:
            payload = json.load(fh)
        assert payload["ok"] is True and payload["config"]["platform"] == "cpu"
        inv = payload["invariants"]
        assert inv["kill_observed"] and inv["bit_exact_resume"]
        assert inv["corrupt_never_selected"] and inv["recovered_within_budget"]
        results = payload["results"]
        assert results["kill_recover"]["completed"]
        assert results["oracle"]["publish_count"] >= 3
        assert results["oracle"]["checkpoint_overhead_frac"] < 1.0
        # the summaries carry the port's registry series
        series = payload["telemetry"]["recovered"]
        assert series["resilience_restores_total"]["series"][0]["value"] >= 1


    def test_the_overlapped_drill_holds_every_invariant(self, tmp_path):
        """``overlap=True`` (what ``chip_smoke.py`` (x2) passes) runs the
        oracle beside the kill/relaunch chain: the same invariants hold, and
        the payload has the sequential run's keys."""
        from gan_deeplearning4j_tpu_torch.resilience import drill

        workdir = str(tmp_path / "work")
        os.makedirs(workdir)
        workload = drill.make_workload(workdir, 1, use_accelerator=False)
        payload = drill.run_single_host_drill(workload, workdir, 12, 3, 1, smoke=True,
                                              timeout_s=240.0, overlap=True)
        assert set(payload["results"]) >= {"oracle", "kill_recover", "bit_exact", "corruption"}
        assert payload["results"]["kill_recover"]["relaunches"] >= 1
        assert payload["ok"] is True, payload["invariants"]


class TestMultihostDrill:
    @pytest.mark.slow
    def test_the_overlapped_multihost_drill_holds_every_invariant(self, tmp_path):
        """``overlap=True`` (what ``chip_smoke.py`` (x3) passes) runs the
        oracles, the kill and commit-window gangs, the recovering gangs and
        the elastic resumes in pairs: every invariant holds."""
        from gan_deeplearning4j_tpu_torch.resilience import drill

        workdir = str(tmp_path / "work")
        os.makedirs(workdir)
        workload = drill.make_workload(workdir, 1, use_accelerator=False)
        payload = drill.run_multihost_drill(workload, workdir, 2, 6, 2, 1, mesh_timeout=30.0,
                                            smoke=True, timeout_s=240.0, overlap=True)
        assert set(payload["results"]) >= {"oracle", "kill_recover", "commit_window", "elastic"}
        assert payload["ok"] is True, payload["invariants"]

    @pytest.mark.slow
    def test_multihost_drill_smoke(self, tmp_path):
        out_json = os.path.join(str(tmp_path), "drill_mh.json")
        proc = subprocess.run(
            [sys.executable, "-m", "gan_deeplearning4j_tpu_torch.resilience.drill", "--smoke",
             "--cpu", "--multihost", "2", "--workdir", os.path.join(str(tmp_path), "work"),
             "--output", out_json],
            capture_output=True, text=True, cwd=REPO, timeout=900)
        assert proc.returncode == 0, (proc.stdout[-3000:], proc.stderr[-2000:])
        with open(out_json) as fh:
            payload = json.load(fh)
        assert payload["ok"] is True
        inv = payload["invariants"]
        for name in ("mh_kill_observed", "mh_gang_aborted", "mh_no_partial_generation",
                     "mh_bit_exact_resume", "mh_workers_agree",
                     "mh_commit_window_all_or_nothing", "mh_commit_window_recovered",
                     "mh_elastic_mesh_to_single", "mh_elastic_mesh_to_mesh"):
            assert inv[name], name
        assert payload["results"]["kill_recover"]["lost_steps"] >= 0
        assert payload["results"]["commit_window"]["stage_leftovers"]


# ===========================================================================
# the mesh plane
# ===========================================================================

def shard_writer(payload):
    """A mesh shard writer: writes a dict of name -> bytes, returns the names."""
    def writer(directory):
        for name, data in payload.items():
            with open(os.path.join(directory, name), "wb") as fh:
                fh.write(data)
        return list(payload)
    return writer


def run_mesh(root, world_size, publish_args, token="t1", timeout_s=10.0, faults_by_worker=None,
             store=None):
    """One coordinated publish across ``world_size`` worker threads:
    per-worker results (a Generation or the raised exception)."""
    store = store or CheckpointStore(root)
    coords = [MeshCoordinator(root, worker=k, world_size=world_size, token=token,
                              timeout_s=timeout_s, faults=(faults_by_worker or {}).get(k))
              for k in range(world_size)]

    def one(k):
        writer, step = publish_args(k)
        try:
            return coords[k].publish(store, writer, step=step)
        except Exception as exc:  # collected, asserted by the caller
            return exc

    with ThreadPoolExecutor(world_size) as pool:
        return list(pool.map(one, range(world_size))), store


class HookRaise:
    """A fault injector that raises at ONE named mesh hook."""

    def __init__(self, hook):
        self.hook = hook

    def _fire(self, name):
        if name == self.hook:
            raise RuntimeError(f"injected death at {name}")

    def on_shard_write(self, step):
        self._fire("on_shard_write")

    def on_shard_staged(self, step):
        self._fire("on_shard_staged")

    def on_mesh_commit(self, step):
        self._fire("on_mesh_commit")

    def on_mesh_committed(self, step):
        self._fire("on_mesh_committed")


def _stage_dirs(root):
    from gan_deeplearning4j_tpu_torch.resilience.mesh import MESH_STAGE_PREFIX

    return sorted(d for d in os.listdir(root) if d.startswith(MESH_STAGE_PREFIX))


class TestMeshBarrier:
    def test_barrier_meets_across_workers(self, tmp_path):
        coords = [MeshCoordinator(str(tmp_path), worker=k, world_size=3, timeout_s=10.0)
                  for k in range(3)]
        with ThreadPoolExecutor(3) as pool:
            list(pool.map(lambda c: c.barrier("up"), coords))

    def test_barrier_timeout_is_loud(self, tmp_path):
        coord = MeshCoordinator(str(tmp_path), worker=0, world_size=2, timeout_s=0.2)
        with pytest.raises(MeshTimeout, match="gang abort"):
            coord.barrier("up")

    def test_validation(self, tmp_path):
        with pytest.raises(ValueError):
            MeshCoordinator(str(tmp_path), worker=2, world_size=2)
        with pytest.raises(ValueError):
            MeshCoordinator(str(tmp_path), worker=0, world_size=0)
        with pytest.raises(ValueError):
            MeshCoordinator(str(tmp_path), worker=0, world_size=1, token="no/slashes")


class TestMeshPublish:
    def test_two_phase_publish_round_trip(self, tmp_path):
        root = os.path.join(str(tmp_path), "store")
        results, store = run_mesh(root, 2, lambda k: (shard_writer({f"shard{k}.bin": bytes([k]) * 64}), 5))
        assert all(not isinstance(r, Exception) for r in results), results
        assert [g.number for g in results] == [0, 0]
        gen = store.latest_valid()
        assert gen is not None and gen.step == 5
        assert {"shard0.bin", "shard1.bin"} <= set(gen.manifest["files"])
        assert store.verify(0) is None
        mesh = gen.manifest["mesh"]
        assert mesh["world_size"] == 2
        assert mesh["shards"] == ["SHARD-00000.json", "SHARD-00001.json"]
        assert mesh["mesh_digest"] == mesh_digest(gen.manifest["files"])
        assert store.entry(0)["status"] == "published"

    def test_second_round_gets_next_number(self, tmp_path):
        root = os.path.join(str(tmp_path), "store")
        _, store = run_mesh(root, 2, lambda k: (shard_writer({f"a{k}.bin": b"x" * 8}), 3))
        results, _ = run_mesh(root, 2, lambda k: (shard_writer({f"b{k}.bin": b"y" * 8}), 6),
                              store=store)
        assert [g.number for g in results] == [1, 1]
        assert store.published() == [0, 1]

    def test_empty_shard_rejected(self, tmp_path):
        results, _ = run_mesh(os.path.join(str(tmp_path), "store"), 1,
                              lambda k: (shard_writer({}), 1), timeout_s=1.0)
        assert isinstance(results[0], Exception) and "empty shard" in str(results[0])

    def test_colliding_shard_files_rejected(self, tmp_path):
        results, store = run_mesh(os.path.join(str(tmp_path), "store"), 2,
                                  lambda k: (shard_writer({"same.bin": bytes([k]) * 8}), 1),
                                  timeout_s=2.0)
        assert any(isinstance(r, pt_res.MeshProtocolError) for r in results)
        assert store.latest_valid() is None


class TestMeshCommitWindow:
    def _prior_generation(self, root):
        store = CheckpointStore(root)
        store.publish(write_files({"prior.bin": b"prior"}), step=1)
        return store

    @pytest.mark.parametrize("hook,marker_expected", [("on_mesh_commit", False),
                                                      ("on_mesh_committed", True)])
    def test_coordinator_killed_in_commit_window(self, tmp_path, hook, marker_expected):
        root = os.path.join(str(tmp_path), "store")
        store = self._prior_generation(root)
        results, _ = run_mesh(root, 2, lambda k: (shard_writer({f"s{k}.bin": b"z" * 16}), 4),
                              timeout_s=1.5, store=store, faults_by_worker={0: HookRaise(hook)})
        assert isinstance(results[0], RuntimeError)
        assert isinstance(results[1], MeshTimeout)
        leftovers = _stage_dirs(root)
        assert len(leftovers) == 1
        assert os.path.exists(os.path.join(root, leftovers[0], "MANIFEST.json")) == marker_expected
        latest = store.latest_valid()
        assert latest is not None and latest.number == 0 and latest.step == 1
        assert store.entry(1) == {}
        MeshCoordinator(root, worker=0, world_size=2, token="t2")
        assert _stage_dirs(root) == []
        results, _ = run_mesh(root, 2, lambda k: (shard_writer({f"n{k}.bin": b"n"}), 4),
                              token="t2", store=store)
        assert [g.number for g in results] == [1, 1]
        assert store.latest_valid().number == 1

    def test_worker_killed_before_vote_aborts_commit(self, tmp_path):
        root = os.path.join(str(tmp_path), "store")
        store = self._prior_generation(root)
        results, _ = run_mesh(root, 2, lambda k: (shard_writer({f"s{k}.bin": b"z" * 16}), 4),
                              timeout_s=1.5, store=store,
                              faults_by_worker={1: HookRaise("on_shard_write")})
        assert isinstance(results[1], RuntimeError)
        assert isinstance(results[0], MeshTimeout)
        assert store.latest_valid().number == 0

    def test_straggler_shard_writer_still_commits(self, tmp_path):
        class SleepAt:
            def on_shard_write(self, step):
                time.sleep(0.3)

            def on_shard_staged(self, step):
                pass

        results, store = run_mesh(os.path.join(str(tmp_path), "store"), 2,
                                  lambda k: (shard_writer({f"s{k}.bin": b"z" * 16}), 4),
                                  timeout_s=5.0, faults_by_worker={1: SleepAt()})
        assert all(not isinstance(r, Exception) for r in results), results
        assert store.latest_valid().number == 0


def test_port_mesh_generations_are_jax_generations(tmp_path):
    """A round committed by port workers is ``latest_valid()`` in the JAX
    store with an equal whole-mesh digest; a half-committed round (marker
    written, never renamed) is invisible to both packages."""
    root = os.path.join(str(tmp_path), "store")
    results, store = run_mesh(root, 2, lambda k: (shard_writer({f"w{k}.bin": bytes([k + 1]) * 96}), 3))
    assert [g.number for g in results] == [0, 0]
    jgen = jax_res.CheckpointStore(root).latest_valid()
    assert jgen.number == 0 and jgen.step == 3
    assert jgen.manifest["mesh"]["mesh_digest"] == jax_res.mesh_digest(jgen.manifest["files"])
    assert jgen.manifest["mesh"]["mesh_digest"] == results[0].manifest["mesh"]["mesh_digest"]
    results, _ = run_mesh(root, 2, lambda k: (shard_writer({f"h{k}.bin": b"h" * 8}), 6),
                          token="t2", timeout_s=1.5, store=store,
                          faults_by_worker={0: HookRaise("on_mesh_committed")})
    assert isinstance(results[1], MeshTimeout)
    assert os.path.exists(os.path.join(root, _stage_dirs(root)[0], "MANIFEST.json"))
    for reader in (jax_res.CheckpointStore(root), CheckpointStore(root)):
        latest = reader.latest_valid()
        assert latest.number == 0 and latest.step == 3
        assert reader.entry(1) == {}


class TestMeshSupervisor:
    def _run_gang(self, tmp_path, total, token, world=2, dead=()):
        root = os.path.join(str(tmp_path), "store")

        def one(k):
            if k in dead:
                return None  # never launched — peers must gang-abort
            coord = MeshCoordinator(root, worker=k, world_size=world, token=token,
                                    timeout_s=1.5, boot_timeout_s=1.5)
            sup = fake_supervisor(tmp_path, SupervisorConfig(total_steps=total, publish_every=4))
            sup.store = CheckpointStore(root)
            sup.mesh = coord
            try:
                return sup.run()
            except MeshTimeout as exc:
                return exc

        with ThreadPoolExecutor(world) as pool:
            return list(pool.map(one, range(world)))

    def test_coordinated_cadence_and_elastic_restore(self, tmp_path):
        out = self._run_gang(tmp_path, total=10, token="tA")
        assert all(o["status"] == "completed" for o in out)
        store = CheckpointStore(os.path.join(str(tmp_path), "store"))
        gen = store.latest_valid()
        assert gen.step == 10 and gen.manifest["mesh"]["world_size"] == 2
        assert len([n for n in gen.manifest["files"] if "state_shard" in n]) == 2
        out2 = self._run_gang(tmp_path, total=16, token="tB")
        assert all(o["status"] == "completed" for o in out2)
        for o in out2:
            assert [r["step"] for r in o["events"] if r["event"] == "restore"] == [10]
        assert store.latest_valid().step == 16

    def test_dead_peer_gang_aborts_both_phases(self, tmp_path):
        out = self._run_gang(tmp_path, total=10, token="tC", dead=(1,))
        assert out[1] is None and isinstance(out[0], MeshTimeout)
        assert CheckpointStore(os.path.join(str(tmp_path), "store")).latest_valid() is None


class TestMeshReshardParity:
    def test_generation_written_by_m_workers_restores_bit_exact(self, tmp_path):
        from gan_deeplearning4j_tpu_torch.harness import GanExperiment

        feats, labels = tabular_data()
        cfg = tabular_cfg(tmp_path)
        exp = GanExperiment(cfg)
        for _ in range(2):
            exp.train_iteration(feats[:8], labels[:8])
            exp.batch_counter += 1
        want = TrainingSupervisor.state_digests(exp)
        root = os.path.join(str(tmp_path), "store")
        store = CheckpointStore(root)
        by_m = {}
        for m in (1, 2, 4):
            coords = [MeshCoordinator(root, worker=k, world_size=m, token=f"m{m}", timeout_s=20.0)
                      for k in range(m)]

            def publish(k, m=m, coords=coords):
                return coords[k].publish(store, lambda d: exp.save_model_shard(d, k, m), step=2)

            with ThreadPoolExecutor(m) as pool:
                by_m[m] = list(pool.map(publish, range(m)))[0]
        for m, gen in by_m.items():
            fresh = GanExperiment(cfg)
            assert fresh.load_models(directory=gen.path) == 2
            assert TrainingSupervisor.state_digests(fresh) == want, f"M={m} restore diverged"

    def test_partial_mesh_generation_refused(self, tmp_path):
        from gan_deeplearning4j_tpu_torch.harness import GanExperiment

        cfg = tabular_cfg(tmp_path)
        d = os.path.join(str(tmp_path), "gen")
        os.makedirs(d)
        GanExperiment(cfg).save_model_shard(d, 0, 2)  # shard 1 of 2 never lands
        with pytest.raises(ValueError, match="incomplete"):
            GanExperiment(cfg).load_models(directory=d)


# ===========================================================================
# step timelines and mesh publish phases
# ===========================================================================

class TestStepTimeline:
    def test_summary_carries_per_phase_timeline(self, tmp_path):
        out = fake_supervisor(tmp_path, SupervisorConfig(total_steps=6, publish_every=3)).run()
        timeline = out["step_timeline"]
        steps = [e for e in timeline if e["phase"] == "step"]
        publishes = [e for e in timeline if e["phase"] == "publish"]
        assert [e["step"] for e in steps] == list(range(6))
        assert [e["step"] for e in publishes] == [3, 6]
        assert all(e["start_unix_s"] > 0 and e["seconds"] >= 0 for e in timeline)
        assert [e["generation"] for e in publishes] == [0, 1]
        assert out["worker"] is None and out["world_size"] is None

    def test_timeline_is_bounded(self, tmp_path):
        sup = fake_supervisor(tmp_path, SupervisorConfig(total_steps=2, publish_every=2))
        assert sup._timeline.maxlen == 4096

    def test_mesh_publish_stamps_phases(self, tmp_path):
        root = os.path.join(str(tmp_path), "store")
        results, _ = run_mesh(root, 2, lambda k: (shard_writer({f"s{k}.bin": bytes([k]) * 32}), 1),
                              token="tl")
        assert all(not isinstance(r, Exception) for r in results)
        coord = MeshCoordinator(root, worker=1, world_size=2, token="tl2", timeout_s=10.0)
        assert coord.last_phases is None  # none until a publish lands

    def test_mesh_phase_spans_feed_the_barrier_table(self, tmp_path):
        from gan_deeplearning4j_tpu_torch.telemetry.trace import TRACER

        TRACER.enable()
        root = os.path.join(str(tmp_path), "store")
        store = CheckpointStore(root)
        coords = [MeshCoordinator(root, worker=k, world_size=2, token="tb", timeout_s=10.0)
                  for k in range(2)]

        def one(k):
            if k == 1:
                time.sleep(0.05)  # worker 1 is the deliberate straggler
            return coords[k].publish(store, shard_writer({f"s{k}.bin": bytes([k]) * 32}), step=1)

        with ThreadPoolExecutor(2) as pool:
            list(pool.map(one, range(2)))
        for coord in coords:
            assert set(coord.last_phases) == {"announce_s", "stage_s", "commit_wait_s"}
            assert all(v >= 0 for v in coord.last_phases.values())
        events = TRACER.events()
        for name in ("resilience.mesh_stage", "resilience.mesh_commit_wait"):
            assert {e["args"]["worker"] for e in events if e["name"] == name} == {0, 1}
        sys.path.insert(0, os.path.join(REPO, "scripts"))
        try:
            import trace_report

            spans = [{"name": e["name"], "ts": e["ts"], "dur": e.get("dur", 0.0), "pid": e["pid"],
                      "args": e.get("args") or {}} for e in events if e.get("ph") == "X"]
            [entry] = trace_report._barrier_table(spans)
        finally:
            sys.path.remove(os.path.join(REPO, "scripts"))
        assert set(entry["workers"]) == {"0", "1"}
        assert entry["straggler"] in (0, 1)


# ===========================================================================
# the CLIs, and the WGAN-GP resume the reference digests
# ===========================================================================

def _options(main, argv=()):
    """The option strings of the parser ``main`` builds."""
    import argparse

    seen = {}
    real = argparse.ArgumentParser.parse_args

    def capture(self, args=None, namespace=None):
        seen["parser"] = self
        raise SystemExit(0)

    argparse.ArgumentParser.parse_args = capture
    try:
        with pytest.raises(SystemExit):
            main(list(argv))
    finally:
        argparse.ArgumentParser.parse_args = real
    return {s for a in seen["parser"]._actions for s in a.option_strings}


def test_worker_and_drill_clis_match_jax():
    from gan_deeplearning4j_tpu.resilience.__main__ import main as jax_worker
    from gan_deeplearning4j_tpu_torch.resilience.__main__ import main as pt_worker
    from gan_deeplearning4j_tpu_torch.resilience.drill import main as pt_drill

    assert _options(pt_worker) == _options(jax_worker)
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import resilience_drill
    finally:
        sys.path.remove(os.path.join(REPO, "scripts"))
    assert _options(pt_drill) == _options(resilience_drill.main) | {"--cpu"}


def test_worker_cli_exit_codes(tmp_path):
    """0 completed; 75 preempted; 70 retry budget spent; the summary holds
    the registry snapshot."""
    from gan_deeplearning4j_tpu_torch.resilience.drill import make_workload

    workload = make_workload(str(tmp_path), seed=3, use_accelerator=False)
    base = [sys.executable, "-m", "gan_deeplearning4j_tpu_torch.resilience", "--config",
            workload["config"], "--data", workload["data"], "--total-steps", "4",
            "--publish-every", "2"]
    runs = {}
    for name, specs in (("done", []), ("preempt", [("preempt", 2)]),
                        ("terminal", [("raise", 0)] * 3)):
        sched = str(tmp_path / f"{name}.json")
        FaultSchedule([FaultSpec(kind=k, step=s) for k, s in specs]).to_json(sched)
        summary = str(tmp_path / f"{name}_summary.json")
        proc = subprocess.run(base + ["--store", str(tmp_path / name), "--fault-schedule", sched,
                                      "--max-retries", "1", "--backoff-base", "0",
                                      "--summary", summary],
                              capture_output=True, text=True, cwd=REPO, timeout=300)
        with open(summary) as fh:
            runs[name] = (proc.returncode, json.load(fh))
    assert runs["done"][0] == 0 and runs["done"][1]["status"] == "completed"
    assert "resilience_steps_total" in runs["done"][1]["telemetry"]
    assert runs["preempt"][0] == 75 and runs["preempt"][1]["status"] == "preempted"
    assert runs["terminal"][0] == 70 and runs["terminal"][1]["status"] == "terminal"


def _wgan_config(tmp_path, module):
    import importlib

    cfg = importlib.import_module(f"{module}.harness").ExperimentConfig
    extra = {"use_accelerator": False} if module.endswith("_torch") else {}
    return cfg(model_family="wgan_gp", height=8, width=8, channels=1, num_features=64, z_size=4,
               batch_size_train=8, batch_size_pred=8, n_critic=2, num_iterations=1,
               latent_grid=2, data_dir=str(tmp_path / "data"), output_dir=str(tmp_path / module),
               save_models=True, **extra)


class TestWganSupervisorResume:
    def test_resume_is_bit_exact(self, tmp_path):
        """A WGAN-GP checkpoint after round 1, restored and replayed for
        rounds 2-3, digests as the uninterrupted run (the reference's
        ``tests/test_zoo.py::TestWganSupervisorResume``)."""
        from gan_deeplearning4j_tpu_torch.harness.wgan_experiment import WganGpExperiment

        rng = np.random.default_rng(17)
        rounds = [rng.random((8, 64), dtype=np.float32) for _ in range(3)]
        cfg = _wgan_config(tmp_path, "gan_deeplearning4j_tpu_torch")
        exp = WganGpExperiment(cfg)
        exp.train_iteration(rounds[0])
        exp.save_models()
        for feats in rounds[1:]:
            exp.train_iteration(feats)
        want = TrainingSupervisor.state_digests(exp)
        exp2 = WganGpExperiment(cfg)
        assert exp2.load_models() == 1
        for feats in rounds[1:]:
            exp2.train_iteration(feats)
        assert TrainingSupervisor.state_digests(exp2) == want
        assert int(exp2.gen_state.step) == int(exp.gen_state.step) == 3

    def test_divergent_replay_changes_digest(self, tmp_path):
        from gan_deeplearning4j_tpu_torch.harness.wgan_experiment import WganGpExperiment

        rng = np.random.default_rng(18)
        a, b = (rng.random((8, 64), dtype=np.float32) for _ in range(2))
        cfg = _wgan_config(tmp_path, "gan_deeplearning4j_tpu_torch")
        exp = WganGpExperiment(cfg)
        exp.train_iteration(a)
        exp.save_models()
        exp.train_iteration(a)
        want = TrainingSupervisor.state_digests(exp)
        exp2 = WganGpExperiment(cfg)
        exp2.load_models()
        exp2.train_iteration(b)
        assert TrainingSupervisor.state_digests(exp2) != want


def test_worker_sigusr2_capture_lands_before_exit(tmp_path):
    """SIGUSR2 once the worker's first generation lands: its capture is
    joined before the process exits (an exit mid-capture killed a worker on
    the card), the trace is written and the run completes."""
    from gan_deeplearning4j_tpu_torch.resilience import drill

    workload = drill.make_workload(str(tmp_path), seed=5, use_accelerator=False)
    traces = str(tmp_path / "traces")
    rc, summary, _ = drill.run_worker(workload, str(tmp_path / "store"), 12, 3,
                                      str(tmp_path / "summary.json"), timeout_s=300,
                                      trace_dir=traces)
    assert rc == 0 and summary["status"] == "completed"
    report = drill.trace_report(traces)
    assert len(report["traces"]) == 1 and report["events"] > 0
