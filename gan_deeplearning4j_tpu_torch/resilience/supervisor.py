"""TrainingSupervisor — runs ``GanExperiment`` in resumable segments.

The PyTorch port's counterpart of
``gan_deeplearning4j_tpu/resilience/supervisor.py``: the same contract,
events, summary and registry series, driving the port's experiment. What
differs, and why:

- **the refused configs.** The JAX supervisor refuses an experiment whose
  ``_fused`` is None, which is exactly ``distributed="param_averaging"``.
  The port's experiment has no ``_fused``, so the same configs are refused
  by name (:func:`phased_config`), before an experiment is built;
- **the step counters in digests.** A JAX state carries its step as a 0-d
  int32 array, the port's as a Python int: :meth:`state_digests` digests
  it as int32, so a manifest's ``state_digests`` mean the same in both
  packages and a store either one wrote restores in the other;
- **the card's memory across retries.** On the card each attempt's
  experiment captures CUDA graphs into private memory pools
  (``harness/graphs.py``). Every attempt releases its experiment's graphs
  when it ends (:meth:`_release`, the experiment's ``close()``), so a
  failed attempt's pools are returned before the retry and the card's
  reserved memory does not grow with ``max_retries``.

The contract (docs/RESILIENCE.md):

- **restore**: every attempt starts from the newest *valid* generation in
  the :class:`~.store.CheckpointStore` — params, updater state, and the
  step counter all come back (``GanExperiment.load_models``), and the PRNG
  stream needs no side file because every per-step draw is derived from the
  carried step counter (CPU generators keyed by ``(seed + 2, dis_step)``)
  and the label-noise
  draws replay deterministically from the config seed at construction;
- **deterministic data schedule**: the batch for step *i* is a pure
  function of *i* (sequential slices of the training arrays, wrapping at
  the epoch boundary) — the property that makes an interrupted-and-resumed
  run replay the exact minibatch sequence of an uninterrupted one;
- **bit-exact resume**: the two properties above make resume exact — an
  interrupted run resumed from any generation produces bit-identical final
  params to an uninterrupted run of equal total steps (the drill's first
  invariant, enforced by digest comparison);
- **fault trapping**: a worker fault (any ``Exception`` out of the training
  step — including :class:`~.faults.InjectedFault`) abandons the attempt
  and retries from the newest valid generation with bounded exponential
  backoff; the retry budget exhausting raises
  :class:`RetryBudgetExceeded` — a *terminal* error, never a silent loop;
- **preemption**: SIGTERM (or :meth:`request_preemption`) is honored at
  the next step boundary by publishing a checkpoint and returning cleanly
  with ``status="preempted"`` — the worker loses at most the in-flight
  step;
- **hard kills** (SIGKILL, machine loss) cannot be trapped in-process; the
  supervisor's contribution is that the store always holds a consistent
  generation at most ``publish_every`` steps old, so the *relauncher* (the
  drill, an orchestrator, a human) recovers by simply starting a new
  supervisor on the same store.
"""

from __future__ import annotations

import dataclasses
import gc
import logging
import signal
import time
from collections import deque
from typing import Callable, List, Optional

import numpy as np

from gan_deeplearning4j_tpu_torch.resilience.store import CheckpointStore, tree_digest
from gan_deeplearning4j_tpu_torch.telemetry.registry import get_registry
from gan_deeplearning4j_tpu_torch.telemetry.trace import TRACER

logger = logging.getLogger(__name__)


class RetryBudgetExceeded(RuntimeError):
    """Terminal: the configured retries are spent. Carries the last worker
    fault as ``__cause__``."""


class UnsupportedExperimentError(RuntimeError):
    """Terminal, never retried: the experiment config cannot honor the
    bit-exact resume contract. The reference refuses the phased
    parameter-averaging path (``distributed="param_averaging"``), whose
    z/label draws it takes from host-side *sequential* RNGs that a
    relaunched process cannot fast-forward; the port refuses the same
    configs (:func:`phased_config`)."""


def phased_config(exp_config) -> bool:
    """Whether ``exp_config`` trains on the phased parameter-averaging path
    the supervisor refuses (the JAX experiment's ``_fused is None``)."""
    return getattr(exp_config, "distributed", "none") == "param_averaging"


@dataclasses.dataclass
class SupervisorConfig:
    """Knobs of the resumable-segment loop (experiment knobs stay on
    ``ExperimentConfig``)."""

    total_steps: int
    publish_every: int = 10        # checkpoint cadence, in steps
    max_retries: int = 3           # worker-fault retries before terminal
    backoff_base_s: float = 0.5    # retry n sleeps min(base·2^(n-1), max)
    backoff_max_s: float = 30.0
    keep_last: int = 3             # store retention: newest K generations
    keep_every: int = 0            # plus every N-th generation (0 = off)
    serve_publish_every: int = 0   # serving-bundle cadence when a serve
    # store is wired (deploy/ reload plane); 0 = follow publish_every

    def validate(self) -> "SupervisorConfig":
        if self.total_steps < 1:
            raise ValueError("total_steps must be >= 1")
        if self.publish_every < 1:
            raise ValueError("publish_every must be >= 1")
        if self.max_retries < 0:
            raise ValueError("max_retries must be >= 0")
        if self.backoff_base_s < 0 or self.backoff_max_s < self.backoff_base_s:
            raise ValueError("need 0 <= backoff_base_s <= backoff_max_s")
        if self.serve_publish_every < 0:
            raise ValueError("serve_publish_every must be >= 0 (0 = follow "
                             "publish_every)")
        return self


class TrainingSupervisor:
    """Drives a :class:`GanExperiment` step by step under the fault
    contract above. ``features``/``labels`` are the full training arrays
    (the deterministic schedule slices them); ``sleep`` is injectable so
    tests assert backoff without wall-clock waits; ``experiment_factory``
    is injectable for fakes."""

    def __init__(self, exp_config, sup_config: SupervisorConfig,
                 features: np.ndarray, labels: np.ndarray,
                 store: Optional[CheckpointStore] = None,
                 store_root: Optional[str] = None,
                 faults=None,
                 sleep: Callable[[float], None] = time.sleep,
                 experiment_factory=None,
                 serve_store: Optional[CheckpointStore] = None,
                 serve_store_root: Optional[str] = None,
                 mesh=None) -> None:
        self.exp_config = exp_config
        self.sup = sup_config.validate()
        self.features = np.asarray(features)
        self.labels = np.asarray(labels)
        b = exp_config.batch_size_train
        if self.features.shape[0] < b:
            raise ValueError(
                f"need at least one full batch: {self.features.shape[0]} "
                f"rows < batch_size_train {b}")
        self.batches_per_epoch = self.features.shape[0] // b
        if store is None:
            if store_root is None:
                raise ValueError("pass store= or store_root=")
            store = CheckpointStore(store_root, keep_last=self.sup.keep_last,
                                    keep_every=self.sup.keep_every,
                                    fault_injector=faults)
        self.store = store
        # the OTHER store: inference bundles for a live server's reload
        # plane (deploy/). Kept separate from the training store so
        # checkpoint retention and bundle retention never fight, and a
        # serving watcher never scans past training generations.
        if serve_store is None and serve_store_root is not None:
            serve_store = CheckpointStore(
                serve_store_root, keep_last=self.sup.keep_last,
                keep_every=self.sup.keep_every)
        self.serve_store = serve_store
        self._serve_every = (self.sup.serve_publish_every
                             or self.sup.publish_every)
        # mesh-coordinated mode (resilience/mesh.py): this worker is one
        # of N sharded checkpoint writers; restores are resolved once for
        # the gang and publishes go through the two-phase commit
        self.mesh = mesh
        self.faults = faults
        self._sleep = sleep
        if experiment_factory is None:
            from gan_deeplearning4j_tpu_torch.harness import GanExperiment

            experiment_factory = GanExperiment
        self._experiment_factory = experiment_factory
        self._preempt = False
        self.retry_delays: List[float] = []
        self.events: List[dict] = []
        # mesh mode: the updater shard this worker last wrote (index,
        # count, files) — surfaced in the summary so drill invariant
        # messages can name the owning worker on a shard mismatch
        self._last_shard: Optional[dict] = None
        # per-phase step timeline (bounded: newest entries win) — one
        # record per train step and per publish, stamped with wall-epoch
        # start times so N workers' summaries line up on one clock for
        # straggler attribution (scripts/trace_report.py folds the same
        # story from merged traces; the summary is the trace-free form)
        self._timeline: deque = deque(maxlen=4096)
        # telemetry registry series (docs/OBSERVABILITY.md); the events
        # list above remains the drill's per-run record
        registry = get_registry()
        self._c_steps = registry.counter(
            "resilience_steps_total", "training steps completed")
        self._c_restores = registry.counter(
            "resilience_restores_total", "restores from a store generation")
        self._c_faults = registry.counter(
            "resilience_faults_total", "trapped worker faults (retried)")
        self._c_serve_publishes = registry.counter(
            "resilience_serve_publishes_total",
            "serving bundles published for the reload plane")

    # -- preemption -----------------------------------------------------
    def request_preemption(self) -> None:
        """Checkpoint and exit cleanly at the next step boundary."""
        self._preempt = True

    def install_signal_handlers(self) -> None:
        """SIGTERM-style preemption: the scheduler's grace signal becomes a
        clean checkpoint-and-exit instead of a dead worker."""
        def handler(signum, frame):
            logger.info("signal %d — preemption requested", signum)
            self.request_preemption()

        signal.signal(signal.SIGTERM, handler)

    # -- deterministic data schedule -------------------------------------
    def batch_at(self, step: int):
        """The minibatch for step ``step`` — a pure function of the step
        counter (sequential full batches, wrapping at the epoch boundary),
        so resumed and uninterrupted runs replay the same data stream."""
        b = self.exp_config.batch_size_train
        p = (step % self.batches_per_epoch) * b
        return self.features[p:p + b], self.labels[p:p + b]

    # -- state digests ---------------------------------------------------
    @staticmethod
    def state_digests(exp) -> dict:
        """Canonical content digests of every trained state — reproducible
        across processes (unlike zip bytes), the currency of the drill's
        bit-exactness check. Experiments expose ``digest_states()`` for
        the canonical tree-form view (under update sharding the packed
        updater rows are unpacked first, so replicated and sharded runs
        digest identically when the math agrees); fakes without it are
        digested as-is. A state's step is digested as a 0-d int32 array,
        as the JAX package holds it."""
        if hasattr(exp, "digest_states"):
            states = exp.digest_states()
        else:
            states = {"dis": exp.dis_state, "gan": exp.gan_state,
                      "gen": exp.gen_params}
            if exp.cv_state is not None:
                states["CV"] = exp.cv_state
        return {name: tree_digest(_int32_step(state))
                for name, state in states.items()}

    # -- publish ---------------------------------------------------------
    def _publish(self, exp) -> dict:
        t0 = time.perf_counter()
        digests = self.state_digests(exp)
        extra = {"kind": "training", "state_digests": digests}
        shard_files: List[str] = []
        if self.mesh is not None:
            # coordinated mesh publish: THIS worker stages only its shard;
            # worker 0's two-phase commit makes the generation visible for
            # everyone (every worker blocks until publication or timeout)
            def shard_writer(d: str) -> List[str]:
                files = exp.save_model_shard(
                    d, self.mesh.worker, self.mesh.world_size)
                shard_files.extend(files)
                return files

            generation = self.mesh.publish(
                self.store, shard_writer, step=exp.batch_counter,
                extra=extra,
            )
        else:
            generation = self.store.publish(
                lambda d: exp.save_models(directory=d),
                step=exp.batch_counter,
                extra=extra,
            )
        seconds = time.perf_counter() - t0
        event = {
            "event": "publish", "generation": generation.number,
            "step": exp.batch_counter, "seconds": seconds,
        }
        phases = (getattr(self.mesh, "last_phases", None)
                  if self.mesh is not None else None)
        if phases is not None:
            # announce/stage/commit_wait breakdown (resilience/mesh.py):
            # names whether THIS worker was the slow shard writer or the
            # one waiting at the publication barrier
            event["phases"] = dict(phases)
        self._timeline.append({
            "phase": "publish", "step": exp.batch_counter,
            "start_unix_s": round(time.time() - seconds, 6),
            "seconds": round(seconds, 6),
            "generation": generation.number,
            **({"phases": {k: round(v, 6) for k, v in phases.items()}}
               if phases is not None else {}),
        })
        if self.mesh is not None:
            # surface which updater shard this worker wrote — until now
            # only the file names encoded it, so a drill shard mismatch
            # could not name the owning worker
            event.update({
                "shard_index": self.mesh.worker,
                "shard_count": self.mesh.world_size,
                "shard_files": sorted(shard_files),
            })
            self._last_shard = {
                "worker": self.mesh.worker,
                "shard_index": self.mesh.worker,
                "shard_count": self.mesh.world_size,
                "files": sorted(shard_files),
            }
        self.events.append(event)
        if self.faults is not None and (self.mesh is None
                                        or self.mesh.is_coordinator):
            # post-publish faults (corrupt) mutate the published bytes —
            # exactly one worker may fire them, or double byte-flips on
            # one member would cancel back to valid bytes
            self.faults.on_published(self.store, generation)
        return {"generation": generation.number, "seconds": seconds,
                "digests": digests}

    def _publish_serving(self, exp) -> dict:
        """Publish the inference bundle (generator + classifier, no
        updater state) as a digest-verified generation of the SERVE
        store — what a live server's reload plane (deploy/) watches. Pure
        observation of the current state: training is unaffected, and the
        bit-exact-resume contract never depends on these bundles."""
        t0 = time.perf_counter()
        info = exp.publish_for_serving(store=self.serve_store)
        seconds = time.perf_counter() - t0
        self._c_serve_publishes.inc()
        self.events.append({
            "event": "serve_publish", "generation": info.get("generation"),
            "step": exp.batch_counter, "seconds": seconds,
        })
        return info

    # -- the loop ---------------------------------------------------------
    def run(self) -> dict:
        """Run to ``total_steps``, surviving trappable faults. Returns a
        summary dict (status ``completed`` or ``preempted``); raises
        :class:`RetryBudgetExceeded` when retries are spent."""
        attempt = 0
        self._preempt = False  # a prior preempted run() must not poison this one
        if self.mesh is not None:
            # gang semantics (docs/RESILIENCE.md multi-host): an in-process
            # retry would rejoin barriers its peers are not at — any fault
            # propagates out, and the RELAUNCHER restarts the whole mesh
            # with a fresh token
            return self._run_attempt(0)
        while True:
            try:
                return self._run_attempt(attempt)
            except UnsupportedExperimentError:
                raise  # a config error retries into the same wall — terminal
            except Exception as exc:  # worker fault — retry from the store
                attempt += 1
                self._c_faults.inc()
                TRACER.instant("resilience.fault", {
                    "attempt": attempt,
                    "error": f"{type(exc).__name__}: {exc}",
                })
                self.events.append({
                    "event": "fault", "attempt": attempt,
                    "error": f"{type(exc).__name__}: {exc}",
                })
                if attempt > self.sup.max_retries:
                    raise RetryBudgetExceeded(
                        f"retry budget ({self.sup.max_retries}) exhausted; "
                        f"last fault: {type(exc).__name__}: {exc}"
                    ) from exc
                delay = min(self.sup.backoff_max_s,
                            self.sup.backoff_base_s * 2 ** (attempt - 1))
                self.retry_delays.append(delay)
                self.events.append({"event": "retry", "attempt": attempt,
                                    "backoff_s": delay})
                logger.warning("worker fault (%s) — retry %d/%d after %.2fs",
                               exc, attempt, self.sup.max_retries, delay)
            # the failed attempt's experiment (a reference cycle) became
            # garbage with ``exc``: collect it before the next one is built
            gc.collect()
            self._sleep(delay)

    def _run_attempt(self, attempt: int) -> dict:
        # the reference refuses the phased (parameter-averaging) path: its
        # z/ε come from host-side sequential RNGs there, which restart from
        # the seed in every relaunched process
        if phased_config(self.exp_config):
            raise UnsupportedExperimentError(
                "this experiment config trains on the phased "
                "(parameter-averaging) path, whose host-side sequential RNG "
                "draws cannot be reconstructed from the step counter — "
                "bit-exact resume is impossible; use a fused-path config "
                "(distributed='none' or 'pmean')"
            )
        t0 = time.perf_counter()
        exp = self._experiment_factory(self.exp_config)
        try:
            return self._segment(exp, attempt, t0)
        finally:
            self._release(exp)

    @staticmethod
    def _release(exp) -> None:
        """Release what an attempt's experiment holds on the card (its
        captured graphs and their pools): ``exp.close()`` where it has one."""
        close = getattr(exp, "close", None)
        if close is not None:
            close()

    def _segment(self, exp, attempt: int, t0: float) -> dict:
        if self.mesh is not None:
            # ONE restore decision for the gang: worker 0 walks
            # latest_valid() (performing any quarantines exactly once) and
            # the peers load its published choice — N concurrent quarantine
            # renames racing each other's digest walks would be chaos
            generation = self.mesh.resolve_restore(self.store, attempt)
        else:
            generation = self.store.latest_valid()
        if generation is not None:
            with TRACER.span("resilience.restore", gen=generation.number,
                             attempt=attempt):
                exp.load_models(directory=generation.path)
            self._c_restores.inc()
            self.events.append({
                "event": "restore", "generation": generation.number,
                "step": exp.batch_counter, "attempt": attempt,
            })
        restore_s = time.perf_counter() - t0
        start_step = exp.batch_counter
        last_publish_step = exp.batch_counter if generation is not None else -1
        train_s = publish_s = 0.0
        publish_count = 0
        first_step_s: Optional[float] = None
        final_publish: Optional[dict] = None
        if generation is not None:
            # if nothing remains to train, the restored generation IS final
            final_publish = {
                "generation": generation.number, "seconds": 0.0,
                "digests": generation.manifest.get("state_digests"),
            }

        def publish() -> None:
            nonlocal publish_s, publish_count, last_publish_step, final_publish
            if exp.batch_counter == last_publish_step:
                return  # this boundary already holds a generation
            info = self._publish(exp)
            publish_s += info["seconds"]
            publish_count += 1
            last_publish_step = exp.batch_counter
            final_publish = info

        # serve-bundle cadence (deploy/ reload plane), attempt-local dedup
        # like the checkpoint cadence above
        serve = {"count": 0, "generation": None, "last_step": -1}

        def serve_publish() -> None:
            if (self.serve_store is None
                    or exp.batch_counter == serve["last_step"]):
                return
            if self.mesh is not None and not self.mesh.is_coordinator:
                return  # one serving bundle per mesh, from worker 0
            info = self._publish_serving(exp)
            serve["count"] += 1
            serve["generation"] = info.get("generation")
            serve["last_step"] = exp.batch_counter

        t_segment = time.perf_counter()

        def segment_span(status: str) -> None:
            TRACER.complete(
                "resilience.segment", t_segment, time.perf_counter(),
                {"attempt": attempt, "start_step": start_step,
                 "end_step": exp.batch_counter, "status": status})

        while exp.batch_counter < self.sup.total_steps:
            if self._preempt:
                if self.mesh is None:
                    publish()
                    serve_publish()  # a preempted trainer leaves its newest
                    # weights for the fleet, not just for its own resume
                # mesh mode: a preemption publish would need every worker
                # to reach this exact step — but SIGTERM lands mid-skew, so
                # the gang exits WITHOUT a boundary publish and resumes
                # from the last coordinated generation (≤ publish_every
                # steps old, the same bound a hard kill already has)
                segment_span("preempted")
                return self._summary(
                    "preempted", exp, attempt, start_step, restore_s,
                    first_step_s, train_s, publish_s, publish_count,
                    final_publish, serve)
            if self.faults is not None:
                self.faults.on_step(exp.batch_counter)
            feats, labels = self.batch_at(exp.batch_counter)
            t_wall = time.time()
            t = time.perf_counter()
            exp.train_iteration(feats, labels)
            t_end = time.perf_counter()
            train_s += t_end - t
            self._timeline.append({
                "phase": "step", "step": exp.batch_counter,
                "start_unix_s": round(t_wall, 6),
                "seconds": round(t_end - t, 6),
            })
            if TRACER.enabled:  # don't build per-step args when off
                TRACER.complete(
                    "resilience.step", t, t_end,
                    {"step": exp.batch_counter, "attempt": attempt})
            self._c_steps.inc()
            if first_step_s is None:
                first_step_s = time.perf_counter() - t0
            exp.batch_counter += 1
            if exp.batch_counter % self.sup.publish_every == 0:
                publish()
            if exp.batch_counter % self._serve_every == 0:
                serve_publish()
        publish()  # final state, even off-cadence
        serve_publish()  # the live fleet converges to the final weights
        segment_span("completed")
        return self._summary("completed", exp, attempt, start_step,
                             restore_s, first_step_s, train_s, publish_s,
                             publish_count, final_publish, serve)

    def _summary(self, status, exp, attempt, start_step, restore_s,
                 first_step_s, train_s, publish_s, publish_count,
                 final_publish, serve=None) -> dict:
        return {
            "status": status,
            "steps": exp.batch_counter,
            "total_steps": self.sup.total_steps,
            "start_step": start_step,
            "attempts_used": attempt,
            "retry_delays": list(self.retry_delays),
            "restore_s": restore_s,
            "time_to_first_step_s": first_step_s,
            "train_s": train_s,
            "publish_s": publish_s,
            "publish_count": publish_count,
            "final_generation": (final_publish or {}).get("generation"),
            "state_digests": (final_publish or {}).get("digests"),
            "serve_publish_count": (serve or {}).get("count", 0),
            "final_serve_generation": (serve or {}).get("generation"),
            "updater_shard": self._last_shard,
            # per-phase step/publish timeline on the wall clock — mesh
            # workers' summaries line up into one cross-worker story
            # (worker identity travels alongside, in the CLI's summary
            # envelope); bounded to the newest 4096 records
            "step_timeline": list(self._timeline),
            "worker": getattr(self.mesh, "worker", None),
            "world_size": getattr(self.mesh, "world_size", None),
            "events": list(self.events),
        }


def _int32_step(state):
    """``state`` with a train state's step as a 0-d int32 array (the JAX
    package's form); params trees pass through."""
    if isinstance(state, dict) or not hasattr(state, "step"):
        return state
    return dataclasses.replace(state, step=np.asarray(state.step, np.int32))
