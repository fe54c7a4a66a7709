"""FleetManager — worker process lifecycle and rolling generation upgrades.

The manager owns what the router must not: processes and model versions.

- **spawn/supervise** — each worker slot runs ``python -m
  gan_deeplearning4j_tpu_torch.serving --bundle <generation dir>`` on its own
  port. A dead process (SIGKILL, OOM, crash) is relaunched on the same
  port with the fleet's current bundle; a worker whose breaker stays open
  while its process is alive (a SIGSTOP-style hang) is force-restarted
  after ``hang_restart_after`` — long enough that a transient stall gets
  its half-open re-admission chance first. A live worker that never
  reaches its FIRST admission (hung mid-warmup, where init probe failures
  cannot trip the breaker) is force-restarted after ``warm_timeout``; a
  worker that DIES before its first admission relaunches on a capped
  exponential backoff (``spawn_backoff_base``/``spawn_backoff_max``,
  ``fleet_spawn_failures_total``) — a bundle that kills every boot must
  not turn supervision into a fork loop (lint rule JG021).
- **elastic resize** — with an :class:`~.autoscaler.AutoscalerConfig`
  the supervise loop ticks the SLO-driven control loop
  (fleet/autoscaler.py): :meth:`FleetManager.scale_up_one` spawns a new
  slot from the current bundle (it re-earns admission before counting
  as capacity), :meth:`FleetManager.scale_down_one` retires the
  least-loaded routable worker through the drain path. Resizes take the
  same cycle lock as rolling upgrades — they queue behind a roll,
  never interleave with it.
- **draining restart** — the zero-lost worker rotation (docs/FLEET.md):
  mark draining at the router (no new requests), ``POST /admin/drain`` on
  the worker (its ``/healthz`` leaves the admittable set), watch its
  ``/metrics`` until queue and pipeline are empty (bounded by
  ``drain_timeout`` — a stuck in-flight forces the restart anyway),
  SIGTERM → relaunch → re-admit only after the health loop sees a warm
  ``"ok"``.
- **rolling upgrades, one canary decision per fleet** — a
  :class:`~deploy.watcher.StoreWatcher` polls the checkpoint store for a
  newer digest-valid serving generation. Admission is decided ONCE,
  before any worker is touched: quality probes run in a sidecar
  subprocess (``python -m gan_deeplearning4j_tpu_torch.deploy probe``) against
  the candidate and incumbent bundles, compared under the same
  :class:`~deploy.canary.CanaryThresholds` the in-process gate uses
  (``compare_probes``). A pass rolls workers one at a time through
  draining restarts; a fail quarantines the generation through the store
  — fleet-wide, permanently, without restarting anything. A probe that
  *dies* (timeout, prober crash) is infrastructure failure, not a
  verdict: the decision is deferred to the next poll, and only
  ``probe_retries`` consecutive candidate-probe failures quarantine. If a
  rolled worker fails to come back healthy the roll HALTS: that worker is
  rolled back to the incumbent bundle and the candidate is quarantined (a
  generation that kills workers is worse than a canary miss).

Incumbent probes are cached per generation, so steady-state upgrades cost
one sidecar probe each.

The PyTorch port's copy of ``gan_deeplearning4j_tpu/fleet/manager.py``,
imports rewritten, with these adaptations:

- ``SERVING_CLI`` / ``PROBE_CLI`` are the port's serving and deploy CLIs.
- ``device`` (default ``"cuda"``) reaches every worker (``_worker_cmd``)
  and every sidecar probe (``_probe_cmd``) as ``--device``: the CPU tests
  run both on the CPU, and nothing falls back to the CPU on its own.
- ``compilation_cache`` and its worker flag are dropped, as the port's
  serving CLI dropped ``--compilation-cache``: a CUDA graph is not cached
  across processes, so every spawned worker (a relaunch, a scale-up, a
  roll) pays its boot and its warmup captures, and ``routable_s`` is that
  whole cost.
- every sidecar probe is recorded (generation, seconds, the platform its
  engine ran on, its FID and accuracy) in a bounded ``probes`` list that ``status()`` shows: what
  a candidate's admission cost and where it ran.
- the cycle lock is only ever tried, never waited for. The JAX file runs
  a whole watch→admit→roll cycle (sidecar probes, drains, routable waits:
  minutes) inside ``with self._cycle_lock``, and a forced
  ``poll_now(wait=True)`` or the supervise loop's poll blocks behind a
  roll for its whole length (the three JG026 findings the JAX lint
  baseline justifies). Here every taker acquires ``_cycle_lock``
  non-blocking, as the autoscaler's resizes already did: the supervise
  loop retries its poll on its next turn (0.2 s), and a forced blocking
  poll that finds a cycle running answers at once with ``"busy": true``
  in its status (the router's ``POST /admin/poll?block=1`` body) instead
  of waiting the roll out. No thread ever waits on the lock, so holding
  it across a roll stalls nobody. ``start()`` writes ``generation`` and
  ``bundle_path`` under ``_lock`` instead, where every reader reads the
  pair (``_current``, ``status()``).
- each recorded sidecar probe also carries its ``fid`` and ``accuracy``.
"""

from __future__ import annotations

import json
import logging
import os
import subprocess
import sys
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from gan_deeplearning4j_tpu_torch.deploy.canary import CanaryThresholds, compare_probes
from gan_deeplearning4j_tpu_torch.deploy.watcher import BundleCandidate, StoreWatcher
from gan_deeplearning4j_tpu_torch.fleet.health import http_json
from gan_deeplearning4j_tpu_torch.fleet.router import FleetRouter, scrape_metrics
from gan_deeplearning4j_tpu_torch.telemetry.registry import get_registry
from gan_deeplearning4j_tpu_torch.telemetry.trace import TRACER

logger = logging.getLogger(__name__)

SERVING_CLI = [sys.executable, "-m", "gan_deeplearning4j_tpu_torch.serving"]
PROBE_CLI = [sys.executable, "-m", "gan_deeplearning4j_tpu_torch.deploy"]

#: sidecar probes remembered in ``status()["probes"]``
PROBE_HISTORY = 32


class WorkerProcess:
    """One spawned serving worker subprocess (stdout+stderr to a log
    file, so a crash is diagnosable after the fact)."""

    def __init__(self, cmd: List[str], log_path: str,
                 env: Optional[dict] = None, cwd: Optional[str] = None):
        self.cmd = list(cmd)
        self.log_path = log_path
        self._log = open(log_path, "a")
        self.proc = subprocess.Popen(cmd, stdout=self._log,
                                     stderr=self._log, env=env, cwd=cwd)

    @property
    def pid(self) -> int:
        return self.proc.pid

    def alive(self) -> bool:
        return self.proc.poll() is None

    def stop(self, grace: float = 10.0) -> None:
        """SIGTERM, bounded wait, then SIGKILL — a hung worker cannot
        stall a rotation forever."""
        if self.alive():
            self.proc.terminate()
            try:
                self.proc.wait(timeout=grace)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                try:
                    self.proc.wait(timeout=grace)
                except subprocess.TimeoutExpired:
                    pass
        try:
            self._log.close()
        except OSError:
            pass


class WorkerSlot:
    """One position in the fleet: a stable id + port whose process comes
    and goes across restarts."""

    def __init__(self, worker_id: str, port: int, host: str = "127.0.0.1"):
        self.id = worker_id
        self.host = host
        self.port = port
        self.base_url = f"http://{host}:{port}"
        self.process: Optional[WorkerProcess] = None
        self.bundle_path: Optional[str] = None
        self.restarts = 0
        self.open_since: Optional[float] = None  # breaker-open watermark
        self.launched_at: Optional[float] = None  # init-hang watermark
        # launch-to-first-admission seconds of the CURRENT process — the
        # elasticity number ("capacity means routable, not spawned"):
        # what a scale-up or restart actually costs before the router
        # sends this worker traffic. None until admission.
        self.routable_s: Optional[float] = None
        # spawn-failure backoff state: a process that dies before EVER
        # earning router admission relaunches on a capped exponential
        # schedule, not in a tight loop (docs/FLEET.md)
        self.ever_routable = False
        self.spawn_failures = 0
        self.next_launch_at: Optional[float] = None


class FleetManager:
    """Drives N :class:`WorkerSlot` behind a :class:`FleetRouter`.

    ``worker_args`` are extra CLI flags every worker gets (buckets,
    replicas, latency knobs). ``canary_data`` (an npz path) enables the
    fleet-level admission gate; without it a digest-valid newer
    generation rolls ungated. ``spawn`` is injectable for tests:
    ``(slot, bundle_path) -> WorkerProcess-like``.
    """

    def __init__(self, router: FleetRouter, store_root: str, *,
                 num_workers: int = 2, ports: Optional[List[int]] = None,
                 host: str = "127.0.0.1",
                 worker_args: Optional[List[str]] = None,
                 log_dir: str = ".",
                 poll_interval: float = 2.0,
                 drain_timeout: float = 30.0,
                 warm_timeout: float = 300.0,
                 hang_restart_after: float = 20.0,
                 canary_data: Optional[str] = None,
                 canary_samples: int = 256, canary_seed: int = 666,
                 canary_feature: str = "raw",
                 thresholds: Optional[CanaryThresholds] = None,
                 probe_timeout_s: float = 600.0, probe_retries: int = 3,
                 spawn=None, env: Optional[dict] = None,
                 telemetry: bool = False,
                 autoscale=None,
                 spawn_backoff_base: float = 0.5,
                 spawn_backoff_max: float = 30.0,
                 device: str = "cuda"):
        if num_workers < 1:
            raise ValueError("num_workers must be >= 1")
        if spawn_backoff_base <= 0 or spawn_backoff_max < spawn_backoff_base:
            raise ValueError("need 0 < spawn_backoff_base <= "
                             "spawn_backoff_max")
        from gan_deeplearning4j_tpu_torch.resilience.store import CheckpointStore

        self.router = router
        self.store = CheckpointStore(store_root)
        self.watcher = StoreWatcher(store=self.store)
        self.host = host
        self.worker_args = list(worker_args or [])
        self.log_dir = log_dir
        self.poll_interval = poll_interval
        self.drain_timeout = drain_timeout
        self.warm_timeout = warm_timeout
        self.hang_restart_after = hang_restart_after
        self.canary_data = canary_data
        self.canary_samples = canary_samples
        self.canary_seed = canary_seed
        self.canary_feature = canary_feature
        self.thresholds = thresholds or CanaryThresholds()
        self.probe_timeout_s = probe_timeout_s
        self.probe_retries = probe_retries
        # span tracing on every WORKER process too (--telemetry on the
        # fleet CLI): without it the router's /debug/trace merge would
        # hold router spans only — trace propagation needs both ends
        self.telemetry = telemetry
        # the torch device of every worker and sidecar probe
        self.device = device
        self._spawn = spawn or self._spawn_process
        self._env = env
        self.spawn_backoff_base = spawn_backoff_base
        self.spawn_backoff_max = spawn_backoff_max
        if ports is None:
            ports = [_free_port(host) for _ in range(num_workers)]
        self.slots = [WorkerSlot(f"w{i}", p, host)
                      for i, p in enumerate(ports)]
        # monotonic id allocator: a scaled-down slot's id is never reused
        # (its counters, logs, and events stay unambiguous)
        self._next_slot_idx = len(self.slots)
        self.generation: Optional[int] = None
        self.bundle_path: Optional[str] = None
        # dis-feature probes are pinned to ONE classifier for the fleet's
        # lifetime (the boot incumbent's): cached incumbent probes stay
        # comparable with every later candidate probe — re-pinning per
        # roll would compare FIDs measured in two different embedding
        # spaces
        self._feature_bundle: Optional[str] = None
        self._incumbent_probes: Dict[int, dict] = {}
        # candidate-probe failures by candidate token: an infrastructure
        # failure (timeout, prober OOM) defers the decision to the next
        # poll; only probe_retries consecutive failures on the SAME
        # candidate quarantine it (a bundle that reliably kills the
        # prober is evidence about the bundle)
        self._probe_failures: Dict[str, int] = {}
        self._state = "idle"  # idle|canary|rolling|halted
        # slot ids currently owned by roll machinery (rotation or halt
        # rollback): supervision must not touch them, but it keeps running
        # for every OTHER slot — a SIGKILL elsewhere in the fleet is
        # relaunched immediately, not after the roll finishes
        self._busy_slots: set = set()
        self._rolls = 0
        self._rejected = 0
        self._last_error: Optional[str] = None
        # bounded: a crash-looping worker appends one event per supervise
        # cycle — an unbounded list would leak for the manager's lifetime
        self.events: deque = deque(maxlen=256)
        self.probes: deque = deque(maxlen=PROBE_HISTORY)
        self._lock = threading.Lock()
        # one watch→admit→roll cycle or resize at a time; only ever
        # acquired non-blocking, so nobody waits behind a roll
        self._cycle_lock = threading.Lock()
        # serializes _supervise_once across the loop thread and a roll's
        # in-wait supervision ticks — two threads must not both relaunch
        # the same dead worker
        self._supervise_lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        registry = get_registry()
        self._c_rolls = registry.counter(
            "fleet_rolling_upgrades_total",
            "rolling generation upgrades completed fleet-wide")
        self._c_rejects = registry.counter(
            "fleet_canary_rejects_total",
            "candidate generations rejected by the fleet admission gate")
        self._c_restarts = registry.counter(
            "fleet_worker_restarts_total",
            "worker processes relaunched (crash, hang, or rotation)")
        self._g_generation = registry.gauge(
            "fleet_generation",
            "store generation the fleet is converged on (-1 = mid-roll)")
        self._c_spawn_failures = registry.counter(
            "fleet_spawn_failures_total",
            "worker processes that died before ever becoming routable "
            "(each schedules a backed-off relaunch, never a hot loop)")
        self._h_routable = registry.histogram(
            "fleet_scaleup_routable_seconds",
            "seconds from worker launch to first router admission — the "
            "autoscaler's real reaction time (capacity means routable, "
            "not spawned; docs/FLEET.md)")
        # the SLO-driven elastic control loop (fleet/autoscaler.py):
        # ticked by the supervise loop, resizes through scale_up_one /
        # scale_down_one under the same cycle lock rolling upgrades hold
        self.autoscaler = None
        if autoscale is not None:
            from gan_deeplearning4j_tpu_torch.fleet.autoscaler import Autoscaler

            if not (autoscale.min_workers <= num_workers
                    <= autoscale.max_workers):
                raise ValueError(
                    f"num_workers={num_workers} outside the autoscaler's "
                    f"{autoscale.min_workers}..{autoscale.max_workers}")
            self.autoscaler = Autoscaler(self, autoscale)
        router.manager = self

    # -- lifecycle -------------------------------------------------------
    def start(self, boot_wait: float = 120.0) -> None:
        """Resolve the initial generation (waiting for a trainer's first
        publish, bounded), spawn every worker, start the router's health
        loop and the supervise thread."""
        deadline = time.monotonic() + boot_wait
        candidate = None
        while candidate is None:
            candidate = self.watcher.poll_once()
            if candidate is None:
                if time.monotonic() >= deadline:
                    raise RuntimeError(
                        f"no valid serving generation appeared in "
                        f"{self.store.root} within {boot_wait:.0f}s")
                time.sleep(0.25)
        # one guarded write even though the supervise thread starts
        # below: a concurrently-forced poll_now(wait=True) from another
        # thread must never observe generation set but bundle_path not
        with self._lock:
            self.generation = candidate.generation
            self.bundle_path = candidate.path
        self._feature_bundle = candidate.path
        self._g_generation.set(-1 if candidate.generation is None
                               else candidate.generation)
        for slot in self.slots:
            self._launch(slot, candidate.path)
        self.router.start_health_loop()
        self._stop.clear()
        t = threading.Thread(target=self._loop, name="fleet-manager",
                             daemon=True)
        self._thread = t
        t.start()

    def stop(self, timeout: float = 15.0) -> None:
        self._stop.set()
        self._wake.set()
        t = self._thread
        if t is not None:
            t.join(timeout)
        self.router.stop()
        for slot in list(self.slots):
            if slot.process is not None:
                slot.process.stop()

    def status(self) -> dict:
        with self._lock:
            body = {
                "state": self._state,
                # the generation a roll converged on (a roll in flight
                # shows as state "rolling"): status() never waits for it
                "generation": self.generation,
                "rolls": self._rolls,
                "rejected": self._rejected,
                "last_error": self._last_error,
                "workers": [
                    {
                        "id": s.id, "port": s.port,
                        "pid": (s.process.pid if s.process is not None
                                else None),
                        "alive": (s.process is not None
                                  and s.process.alive()),
                        "restarts": s.restarts,
                        "spawn_failures": s.spawn_failures,
                        "routable_s": (None if s.routable_s is None
                                       else round(s.routable_s, 3)),
                        "bundle": s.bundle_path,
                    }
                    for s in self.slots
                ],
                "device": self.device,
                "probes": list(self.probes),
            }
        if self.autoscaler is not None:
            body["autoscaler"] = self.autoscaler.status()
        return body

    def poll_now(self, wait: bool = True) -> dict:
        """Force a store poll (POST /admin/poll on the router). With
        ``wait`` the full cycle — canary and roll included — runs on the
        caller's thread, unless a cycle or resize is already running: then
        the answer comes at once with ``"busy": true``. Otherwise the
        supervise loop is woken."""
        busy = False
        if wait:
            if self._cycle_lock.acquire(blocking=False):
                try:
                    self._poll_cycle()
                except Exception as exc:
                    with self._lock:
                        self._last_error = f"{type(exc).__name__}: {exc}"
                finally:
                    self._cycle_lock.release()
            else:
                busy = True
        else:
            self._wake.set()
        return {**self.status(), "busy": busy}

    def _current(self):
        """``(generation, bundle_path)``, read together under ``_lock``."""
        with self._lock:
            return self.generation, self.bundle_path

    # -- process control -------------------------------------------------
    def _worker_cmd(self, slot: WorkerSlot, bundle_path: str) -> List[str]:
        cmd = SERVING_CLI + [
            "--bundle", bundle_path,
            "--host", slot.host, "--port", str(slot.port),
            "--warmup", "eager",
        ]
        if self.telemetry:
            cmd.append("--telemetry")
        cmd += ["--device", self.device]
        return cmd + self.worker_args

    def _spawn_process(self, slot: WorkerSlot, bundle_path: str
                       ) -> WorkerProcess:
        log_path = os.path.join(self.log_dir, f"worker-{slot.id}.log")
        return WorkerProcess(self._worker_cmd(slot, bundle_path), log_path,
                             env=self._env)

    def _launch(self, slot: WorkerSlot, bundle_path: str) -> None:
        slot.process = self._spawn(slot, bundle_path)
        slot.bundle_path = bundle_path
        slot.open_since = None
        slot.launched_at = time.monotonic()
        slot.routable_s = None  # the NEW process re-earns its timing
        # the NEW process has not earned admission yet: if it dies before
        # it does, the relaunch goes through the spawn-failure backoff
        slot.ever_routable = False
        slot.next_launch_at = None
        try:
            ref = self.router.worker(slot.id)
        except KeyError:
            self.router.add_worker(slot.id, slot.base_url,
                                   pid=slot.process.pid)
        else:
            ref.pid = slot.process.pid
            ref.breaker.reset()  # a new process must re-earn admission
            # drop the dead process's /metrics snapshot: a stale
            # draining=True from the pre-restart worker must not keep the
            # fresh one out of the pool until the next scrape
            ref.update_scrape({})

    def _restart(self, slot: WorkerSlot, bundle_path: str,
                 reason: str) -> None:
        logger.warning("restarting worker %s (%s)", slot.id, reason)
        if slot.process is not None:
            slot.process.stop()
        slot.restarts += 1
        self._c_restarts.inc()
        self._launch(slot, bundle_path)
        with self._lock:
            self.events.append({"event": "restart", "worker": slot.id,
                                "reason": reason})

    def _wait_routable(self, slot: WorkerSlot, timeout: float) -> bool:
        """Wait for the router's health loop to admit the slot's worker
        (its /healthz must reach "ok" — warmup done)."""
        deadline = time.monotonic() + timeout
        ref = self.router.worker(slot.id)
        last_tick = time.monotonic()
        while time.monotonic() < deadline:
            if self._stop.is_set():
                return False  # shutting down — don't hold stop() hostage
            if ref.routable:
                return True
            if slot.process is not None and not slot.process.alive():
                return False  # died while warming — the caller decides
            last_tick = self._supervise_tick(last_tick)
            time.sleep(0.1)
        return False

    # -- draining restart -------------------------------------------------
    def drain_worker(self, slot: WorkerSlot) -> bool:
        """The drain half of a rotation: unroute, mark the worker
        draining, and wait (bounded) for its pipeline to empty. True when
        it fully drained; False means ``drain_timeout`` expired with work
        stuck in flight and the restart proceeds as a forced one."""
        self.router.mark_draining(slot.id, True)
        # best-effort: the worker may be dying anyway; failure means the
        # drain watch below sees an unscrapable worker and forces through
        http_json(f"{slot.base_url}/admin/drain", timeout=2.0,
                  method="POST", data=b"{}")
        deadline = time.monotonic() + self.drain_timeout
        last_tick = time.monotonic()
        while time.monotonic() < deadline:
            if self._stop.is_set():
                return False  # shutting down — don't hold stop() hostage
            m = scrape_metrics(slot.base_url, timeout=2.0)
            if m is None:
                return False  # unscrapable mid-drain: treat as stuck
            if (int(m.get("queue_depth", 0)) == 0
                    and int(m.get("pipeline", {}).get("in_flight", 0)) == 0):
                return True
            last_tick = self._supervise_tick(last_tick)
            time.sleep(0.05)
        return False

    def rotate_worker(self, slot: WorkerSlot, bundle_path: str) -> bool:
        """One draining restart onto ``bundle_path``. True when the
        relaunched worker came back healthy within ``warm_timeout``."""
        with self._lock:
            self._busy_slots.add(slot.id)
        try:
            with TRACER.span("fleet.rotate", worker=slot.id):
                drained = self.drain_worker(slot)
                self._restart(slot, bundle_path,
                              "rotation" if drained else "forced rotation "
                              "(drain timeout)")
                self.router.mark_draining(slot.id, False)
                return self._wait_routable(slot, self.warm_timeout)
        finally:
            with self._lock:
                self._busy_slots.discard(slot.id)

    # -- elastic resize (fleet/autoscaler.py drives these) ----------------
    def scale_up_one(self):
        """Add one worker slot spawned from the fleet's current bundle.
        The new worker re-earns router admission through the normal
        init-probe path before it ever counts as capacity; a boot that
        wedges is bounded by ``warm_timeout`` supervision and a boot
        that dies goes through the spawn-failure backoff. Returns the
        new slot, or None when there is no bundle to spawn from."""
        # one guarded snapshot: Autoscaler._apply holds the cycle lock for
        # every resize, so the bundle cannot roll mid-call, and the single
        # read also kills the check-then-use window for any other caller
        _, bundle = self._current()
        if self._stop.is_set() or bundle is None:
            return None
        with self._lock:
            idx = self._next_slot_idx
            self._next_slot_idx += 1
        slot = WorkerSlot(f"w{idx}", _free_port(self.host), self.host)
        self._launch(slot, bundle)
        with self._lock:
            self.slots.append(slot)
            self.events.append({"event": "scale_up", "worker": slot.id,
                                "workers": len(self.slots)})
        logger.info("scale-up: spawned worker %s on port %d (%d slots)",
                    slot.id, slot.port, len(self.slots))
        return slot

    def scale_down_one(self) -> bool:
        """Retire the LEAST-LOADED routable worker through the drain
        path: unroute -> POST /admin/drain -> bounded drain watch ->
        SIGTERM -> remove from router and slot list. Never drops an
        in-flight request (a drain that times out forces through, the
        same bounded-beats-graceful trade a rotation makes). False when
        no routable worker exists to retire."""
        candidates = []
        for slot in list(self.slots):
            try:
                ref = self.router.worker(slot.id)
            except KeyError:
                continue
            if ref.routable:
                candidates.append((ref.load, slot))
        if not candidates:
            return False  # nothing safely retirable — hold instead
        _, slot = min(candidates, key=lambda pair: pair[0])
        with self._lock:
            self._busy_slots.add(slot.id)
        try:
            with TRACER.span("fleet.retire", worker=slot.id):
                drained = self.drain_worker(slot)
                if slot.process is not None:
                    slot.process.stop()
                self.router.remove_worker(slot.id)
                with self._lock:
                    if slot in self.slots:
                        self.slots.remove(slot)
                    self.events.append({"event": "scale_down",
                                        "worker": slot.id,
                                        "drained": drained,
                                        "workers": len(self.slots)})
        finally:
            with self._lock:
                self._busy_slots.discard(slot.id)
        logger.info("scale-down: retired worker %s (drained=%s, %d slots)",
                    slot.id, drained, len(self.slots))
        return True

    # -- the supervise loop ----------------------------------------------
    def _loop(self) -> None:
        next_poll = time.monotonic()
        while not self._stop.is_set():
            try:
                # supervision runs OUTSIDE the cycle lock: a rolling upgrade
                # (minutes) must not block the relaunch of
                # a crashed worker elsewhere in the fleet. The slot being
                # rotated is skipped via _rotating instead.
                self._supervise_once()
                if self.autoscaler is not None:
                    # throttled internally; resize actions take the
                    # cycle lock non-blocking so a roll in flight defers
                    # the resize instead of interleaving with it
                    self.autoscaler.tick()
                # a forced poll holding the cycle lock: poll on a later turn
                if (time.monotonic() >= next_poll
                        and self._cycle_lock.acquire(blocking=False)):
                    next_poll = time.monotonic() + self.poll_interval
                    try:
                        self._poll_cycle()
                    finally:
                        self._cycle_lock.release()
            except Exception as exc:  # supervision must outlive any bug
                logger.exception("fleet supervise cycle failed")
                with self._lock:
                    self._last_error = f"{type(exc).__name__}: {exc}"
            self._wake.wait(0.2)
            self._wake.clear()

    def _supervise_tick(self, last: float, every: float = 1.0) -> float:
        """Supervision from inside a rotation's bounded waits: the roll
        runs ON the supervise thread, so without these ticks a worker
        SIGKILLed elsewhere in the fleet would stay down for the whole
        rotation (minutes). Throttled; never lets a supervise bug break
        the rotation that hosts it."""
        now = time.monotonic()
        if now - last < every:
            return last
        try:
            self._supervise_once()
        except Exception:
            logger.exception("in-rotation supervise tick failed")
        return now

    def _supervise_once(self) -> None:
        if self._stop.is_set():
            return  # stop() owns the processes now
        with self._supervise_lock:
            self._supervise_locked()

    def _supervise_locked(self) -> None:
        now = time.monotonic()
        with self._lock:
            busy = set(self._busy_slots)
            slots = list(self.slots)  # the autoscaler resizes this list
            fleet_bundle = self.bundle_path
        for slot in slots:
            if slot.id in busy:
                continue  # a rotation/rollback owns this slot's process
            if slot.process is not None and not slot.process.alive():
                rc = getattr(getattr(slot.process, "proc", None),
                             "returncode", None)
                if not slot.ever_routable:
                    # died before EVER earning admission: a bundle or
                    # environment that kills every boot would otherwise
                    # relaunch in a tight loop. Capped exponential
                    # backoff per consecutive failure; the counter makes
                    # the loop's absence observable.
                    if slot.next_launch_at is None:
                        slot.spawn_failures += 1
                        self._c_spawn_failures.inc()
                        delay = min(self.spawn_backoff_max,
                                    self.spawn_backoff_base
                                    * (2 ** (slot.spawn_failures - 1)))
                        slot.next_launch_at = now + delay
                        with self._lock:
                            self.events.append({
                                "event": "spawn_failure",
                                "worker": slot.id,
                                "failures": slot.spawn_failures,
                                "retry_in_s": round(delay, 3)})
                        logger.warning(
                            "worker %s died before becoming routable "
                            "(rc=%s, failure %d) — relaunch in %.2fs",
                            slot.id, rc, slot.spawn_failures, delay)
                        continue
                    if now < slot.next_launch_at:
                        continue  # still backing off
                # SIGKILL/crash: relaunch with the bundle this slot was
                # last launched on (mid-roll, an already-rotated slot must
                # come back on the candidate, not the fleet's pre-roll
                # bundle — a halted roll rolls it back by bundle_path)
                self._restart(slot, slot.bundle_path or fleet_bundle,
                              f"process died (rc={rc})")
                continue
            # hang detection: breaker open while the process is alive —
            # give the half-open path its chance first, then force it
            try:
                ref = self.router.worker(slot.id)
            except KeyError:
                continue
            state = ref.breaker.snapshot()["state"]
            if state in ("open", "half_open"):
                if slot.open_since is None:
                    slot.open_since = now
                elif now - slot.open_since >= self.hang_restart_after:
                    self._restart(slot,
                                  slot.bundle_path or fleet_bundle,
                                  "hung (breaker open past "
                                  f"{self.hang_restart_after:.0f}s)")
            elif state == "init":
                # a live process stuck BEFORE its first admission (SIGSTOP
                # or a wedged warmup): init probe failures never trip the
                # breaker — "not ready yet" is not "failing" — so the
                # open-watermark path above can never see this worker.
                # Bound it by warm_timeout, the same allowance a rotation
                # gets, then force the restart (which re-arms the clock).
                slot.open_since = None
                if (slot.launched_at is not None
                        and now - slot.launched_at >= self.warm_timeout):
                    self._restart(slot,
                                  slot.bundle_path or fleet_bundle,
                                  "never became healthy within "
                                  f"{self.warm_timeout:.0f}s of launch")
            else:
                slot.open_since = None
                if state == "closed":
                    if not slot.ever_routable:
                        # FIRST admission of this process: record
                        # launch-to-routable seconds: a worker's boot plus
                        # its warmup captures, what the autoscaler's
                        # reaction time is made of
                        if slot.launched_at is not None:
                            slot.routable_s = now - slot.launched_at
                            self._h_routable.observe(slot.routable_s)
                            with self._lock:
                                self.events.append({
                                    "event": "routable",
                                    "worker": slot.id,
                                    "seconds": round(slot.routable_s, 3)})
                    # admission earned: this process is no longer a spawn
                    # failure candidate, and the backoff ladder resets
                    slot.ever_routable = True
                    slot.spawn_failures = 0
                    slot.next_launch_at = None

    # -- rolling upgrades -------------------------------------------------
    def _poll_cycle(self) -> bool:
        """One watch→admit→roll pass. True when a candidate was handled."""
        generation, _ = self._current()
        candidate = self.watcher.poll_once(current_generation=generation)
        if candidate is None:
            return False
        return self._admit_and_roll(candidate)

    def _admit_and_roll(self, candidate: BundleCandidate) -> bool:
        gen = candidate.generation
        admitted_probe: Optional[dict] = None
        if self.canary_data is not None:
            if (self.canary_feature != "raw"
                    and self._feature_bundle is not None
                    and not os.path.isdir(self._feature_bundle)):
                # the pinned feature bundle was GC'd by store retention:
                # re-pin to the current incumbent and drop the cached
                # probe so both sides are re-measured in the new space.
                # If the incumbent is gone too, pin to the CANDIDATE —
                # the only embedding space still on disk; a missing pin
                # would fail every candidate probe and quarantine good
                # generations forever, when the documented behavior for
                # a GC'd incumbent is an ungated roll
                _, repin = self._current()
                if repin is None or not os.path.isdir(repin):
                    repin = candidate.path
                self._feature_bundle = repin
                self._incumbent_probes = {}
            with self._lock:
                self._state = "canary"
            with TRACER.span("fleet.canary", generation=gen):
                try:
                    cand_probe = self._sidecar_probe(candidate.path)
                except Exception as exc:
                    return self._probe_failed(candidate, "candidate", exc)
                self._probe_failures.pop(candidate.token, None)
                try:
                    inc_probe = self._incumbent_probe()
                except Exception as exc:
                    return self._probe_failed(candidate, "incumbent", exc)
            if inc_probe is None:
                # the incumbent bundle was GC'd by store retention before
                # its probe was ever cached: no baseline exists, and none
                # ever will — roll ungated (logged) rather than wedging
                # every future upgrade behind a probe that cannot run
                with self._lock:
                    self.events.append({
                        "event": "ungated_roll", "generation": gen,
                        "reason": "incumbent bundle GC'd before its "
                                  "baseline probe was cached"})
                logger.warning(
                    "fleet candidate generation %s admitted UNGATED: "
                    "incumbent bundle is gone and no probe was cached", gen)
            else:
                decision = compare_probes(cand_probe, inc_probe,
                                          self.thresholds)
                if not decision.passed:
                    self._reject(candidate, f"canary: {decision.reason}",
                                 extra={"candidate_probe": decision.candidate,
                                        "incumbent_probe": decision.incumbent})
                    return True
            # remembered, but NOT cached as the baseline yet: the cache
            # rolls forward only after the roll completes — a halted roll
            # reverts to the incumbent, whose baseline must survive
            admitted_probe = cand_probe
        with self._lock:
            self._state = "rolling"
        self._g_generation.set(-1)
        old_generation, old_bundle = self._current()
        with TRACER.span("fleet.roll", generation=gen):
            for idx, slot in enumerate(self.slots):
                if self._stop.is_set() or not self.rotate_worker(
                        slot, candidate.path):
                    if self._stop.is_set():
                        # shutdown interrupted the roll (stop() kills the
                        # worker mid-rotation, making it LOOK unhealthy):
                        # that is infrastructure, not a verdict — do not
                        # quarantine the candidate, do not respawn workers
                        # the exiting process would orphan, and do not
                        # claim the fleet converged to gen
                        with self._lock:
                            self._state = "halted"
                            self.events.append({
                                "event": "roll_interrupted",
                                "generation": gen, "reason": "shutdown"})
                        return True
                    # HALT: a generation that cannot boot a healthy worker
                    # is quarantined fleet-wide, the failed slot is forced
                    # back to the incumbent, and every already-rotated
                    # slot rolls back too — no worker may keep serving a
                    # quarantined generation
                    self._reject(candidate,
                                 f"worker {slot.id} failed to come back "
                                 f"healthy on generation {gen} — roll "
                                 f"halted", state="halted")
                    with self._lock:
                        self._busy_slots.add(slot.id)
                    try:
                        self._restart(slot, old_bundle,
                                      "rollback to incumbent after halted "
                                      "roll")
                        self.router.mark_draining(slot.id, False)
                        self._wait_routable(slot, self.warm_timeout)
                    finally:
                        with self._lock:
                            self._busy_slots.discard(slot.id)
                    for done in self.slots[:idx]:
                        if done.bundle_path == candidate.path:
                            self.rotate_worker(done, old_bundle)
                    self._g_generation.set(
                        -1 if old_generation is None else old_generation)
                    return True
        with self._lock:
            self.generation = gen
            self.bundle_path = candidate.path
        if gen is not None and admitted_probe is not None:
            # the candidate IS the incumbent now: its probe is the next
            # comparison's baseline (one sidecar probe per roll)
            self._incumbent_probes = {gen: admitted_probe}
        self._g_generation.set(-1 if gen is None else gen)
        self._c_rolls.inc()
        with self._lock:
            self._rolls += 1
            self._state = "idle"
            self._last_error = None
            self.events.append({"event": "roll", "from": old_generation,
                                "to": gen})
        logger.info("fleet rolled: generation %s -> %s", old_generation, gen)
        return True

    def _probe_failed(self, candidate: BundleCandidate, which: str,
                      exc: Exception) -> bool:
        """A sidecar probe that DIED (timeout, OOM, prober crash) is an
        infrastructure signal, not a canary verdict — quarantining on it
        would permanently reject a possibly-good generation. Defer: the
        candidate is not discarded, so the next poll retries it. Only a
        candidate whose own probe fails ``probe_retries`` consecutive
        times is rejected; an incumbent-probe failure never is (it says
        nothing about the candidate)."""
        err = f"{which} probe failed: {type(exc).__name__}: {exc}"
        if which == "candidate":
            n = self._probe_failures.get(candidate.token, 0) + 1
            self._probe_failures[candidate.token] = n
            if n >= self.probe_retries:
                self._probe_failures.pop(candidate.token, None)
                self._reject(candidate,
                             f"{err} ({n} consecutive attempts)")
                return True
            err = f"{err} (attempt {n}/{self.probe_retries})"
        with self._lock:
            self._state = "idle"
            self._last_error = err
            self.events.append({"event": "probe_deferred",
                                "generation": candidate.generation,
                                "reason": err})
        logger.warning("fleet candidate generation %s deferred: %s",
                       candidate.generation, err)
        return True

    def _reject(self, candidate: BundleCandidate, reason: str,
                extra: Optional[dict] = None, state: str = "idle") -> None:
        # ONE fleet-wide decision: quarantine through the store so the
        # generation is invisible to every future reader — no worker ever
        # sees it
        self.watcher.discard(candidate, reason, quarantine=True)
        self._c_rejects.inc()
        with self._lock:
            self._rejected += 1
            self._state = state
            self._last_error = reason
            self.events.append({"event": "reject",
                                "generation": candidate.generation,
                                "reason": reason, **(extra or {})})
        logger.warning("fleet candidate generation %s rejected: %s",
                       candidate.generation, reason)

    # -- the sidecar canary ----------------------------------------------
    def _probe_cmd(self, bundle_path: str) -> List[str]:
        cmd = PROBE_CLI + [
            "probe", "--bundle", bundle_path,
            "--data", self.canary_data,
            "--samples", str(self.canary_samples),
            "--seed", str(self.canary_seed),
            "--device", self.device,
        ]
        if self.canary_feature != "raw":
            # the feature space is pinned to the boot incumbent's bundle
            # (NOT the rolling self.bundle_path): cached incumbent probes
            # stay comparable with every later candidate probe
            cmd += ["--feature", self.canary_feature,
                    "--feature-bundle",
                    self._feature_bundle or self._current()[1]]
        return cmd

    def _sidecar_probe(self, bundle_path: str) -> dict:
        """Probe a bundle's quality in a sidecar subprocess — the serving
        workers never pay the probe's compiles or its device time."""
        t0 = time.monotonic()
        out = subprocess.run(
            self._probe_cmd(bundle_path), capture_output=True, text=True,
            timeout=self.probe_timeout_s, env=self._env,
        )
        if out.returncode != 0:
            raise RuntimeError(
                f"probe exited rc={out.returncode}: "
                f"{(out.stderr or out.stdout).strip()[-500:]}")
        try:
            probe = json.loads(out.stdout.strip().splitlines()[-1])
        except (ValueError, IndexError) as exc:
            raise RuntimeError(
                f"probe wrote no JSON: {exc}; stdout={out.stdout[-500:]!r}")
        with self._lock:
            self.probes.append({
                "bundle": bundle_path, "generation": probe.get("generation"),
                "seconds": round(time.monotonic() - t0, 3),
                "platform": probe.get("platform"), "fid": probe.get("fid"),
                "accuracy": probe.get("accuracy")})
        return probe

    def _incumbent_probe(self) -> Optional[dict]:
        """The baseline probe, cached per generation. None means the
        incumbent bundle no longer exists on disk AND no probe was ever
        cached — there is no baseline and never will be (the caller rolls
        ungated rather than wedging the fleet)."""
        gen, bundle = self._current()
        probe = self._incumbent_probes.get(gen)
        if probe is None:
            if bundle is None or not os.path.isdir(bundle):
                return None
            probe = self._sidecar_probe(bundle)
            self._incumbent_probes = {gen: probe}
        return probe


def _free_port(host: str = "127.0.0.1") -> int:
    import socket

    with socket.socket() as s:
        s.bind((host, 0))
        return s.getsockname()[1]
