"""ReloadController — the zero-downtime generation-reload control plane.

The PyTorch port's copy of ``gan_deeplearning4j_tpu/deploy/reloader.py`` (plain
Python, no JAX), kept inside the port so that it imports nothing of the
JAX package. One addition: :meth:`ReloadController.status` (the
``/healthz`` "reload" block) carries the last canary decision's
``canary`` record (generation, verdict, both probes' FID and accuracy), so
a drill can log what the gate saw at each swap.

One background thread runs the reload cycle against a live
``serving.InferenceService``:

1. **watch** — :class:`~.watcher.StoreWatcher` finds a digest-valid
   serving bundle newer than the served generation (corrupt generations
   are quarantined and skipped; poll errors back off exponentially up to
   ``backoff_max``).
2. **warm** — the candidate :class:`~serving.engine.ServingEngine` is
   constructed and warmed OFF-THREAD (this thread), against the live
   engine's bucket ladder and replica devices (its device tuple), with
   ``export_gauge=False`` so a warming candidate never claims the
   process-wide ``serving_generation`` gauge. On the card warming
   captures every (kind, bucket) graph, so the new engine makes no
   capture after the swap (``serve_compile_counts`` stays 0). The live
   engine keeps replaying its graphs throughout — a capture runs on the
   candidate's own side stream, under the process-wide capture lock in
   ``"thread_local"`` mode, never on the live engine's stream.
3. **canary** — the :class:`~.canary.CanaryGate` (when configured) probes
   candidate and incumbent with the same fixed seeded batch; a failing
   candidate is quarantined through the store's machinery and NEVER
   served.
4. **swap** — ``MicroBatcher.swap_engine`` atomically routes future
   flushes to the candidate under the batcher lock. In-flight flights
   finalize on the old engine (they carry it on the flight record), new
   flushes dispatch on the new one, and nothing is shed or lost in
   between. The old engine is retired once its last flight drains
   (``flights_on(old) == 0``): its graphs are released (``close()``)
   and it is dropped.

Candidate state (``idle``/``warming``/``canary``/``swapping``/
``rejected``), swap and rejection counts, and the active generation are
exported through the telemetry registry and surfaced in ``/healthz``
(docs/DEPLOY.md); ``POST /admin/reload`` forces an immediate poll via
:meth:`poll_now`.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Optional

from gan_deeplearning4j_tpu_torch.deploy.watcher import BundleCandidate, StoreWatcher
from gan_deeplearning4j_tpu_torch.telemetry.registry import get_registry
from gan_deeplearning4j_tpu_torch.telemetry.trace import TRACER

logger = logging.getLogger(__name__)

#: candidate states, in gauge order (deploy_candidate_state exports the
#: index: idle=0, warming=1, canary=2, swapping=3, rejected=4)
STATES = ("idle", "warming", "canary", "swapping", "rejected")
_STATE_CODE = {name: i for i, name in enumerate(STATES)}


class ReloadBusy(RuntimeError):
    """A forced poll arrived while a reload cycle is already running —
    the /admin/reload 409, mirroring /debug/trace's CaptureBusy."""


def _default_build(candidate: BundleCandidate, live):
    """Construct the candidate engine against the LIVE engine's shape:
    same bucket ladder, same replica devices (the live engine's device
    tuple, so a swap on a repeated-device engine keeps its placement) — so
    its warmup captures exactly the graphs the batcher will route to after
    the swap."""
    from gan_deeplearning4j_tpu_torch.serving.engine import ServingEngine

    return ServingEngine.from_bundle(
        candidate.path,
        buckets=live.buckets,
        replicas=live.replica_count,
        devices=live.devices,
        export_gauge=False,
    )


def _ladder_priority(manifest_buckets, learned, incumbent):
    """The candidate-build bucket resolution order (docs/SERVING.md):
    a ladder the bundle's own manifest carries (per-variant, persisted
    at publish time) > one solved live from the incumbent's recorded
    traffic > the incumbent's ladder itself."""
    return manifest_buckets or learned or incumbent


class ReloadController:
    """Drives watch → warm → canary → swap against one service.

    ``build`` is injectable for tests: ``(BundleCandidate, live_engine) ->
    engine``; the default loads a ``ServingEngine`` from the candidate
    bundle. ``canary=None`` disables the quality gate (digest verification
    still applies — the watcher never offers a corrupt bundle)."""

    def __init__(self, service, watcher: StoreWatcher, *,
                 canary=None, poll_interval: float = 2.0,
                 backoff_max: float = 30.0, drain_timeout: float = 30.0,
                 build: Optional[Callable] = None,
                 registry=None, adopt_weight: float = 0.0,
                 adopt_cost: float = 1.0,
                 adopt_name: str = "gen-{generation}"):
        """``registry`` switches the controller into MUX mode
        (docs/MULTIPLEX.md): an admitted candidate is not swapped into a
        singleton engine but ADOPTED into the
        :class:`~serving.mux.MuxRegistry` as a new named variant —
        ``adopt_name`` formatted with the store generation, at
        ``adopt_weight`` (default 0: no traffic until a ramp admits it)
        and ``adopt_cost`` (the brownout shed order). The candidate is
        built against the registry's bucket ladder/replicas with the
        shared staging pool, the watcher polls against the registry's
        newest variant generation, and the compatibility + canary gates
        compare against the registry's primary (highest-weighted
        resident) engine. ``service`` may be None in this mode."""
        if poll_interval <= 0:
            raise ValueError("poll_interval must be > 0")
        if service is None and registry is None:
            raise ValueError("need a service (singleton mode) or a "
                             "registry (mux mode)")
        self.service = service
        self.watcher = watcher
        self.canary = canary
        self.poll_interval = poll_interval
        self.backoff_max = backoff_max
        self.drain_timeout = drain_timeout
        self.registry = registry
        self.adopt_weight = adopt_weight
        self.adopt_cost = adopt_cost
        self.adopt_name = adopt_name
        if build is None:
            build = (self._registry_build if registry is not None
                     else self._singleton_build)
        self._build = build
        self._lock = threading.Lock()
        self._cond = threading.Condition(self._lock)
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # forced-poll sequencing: poll_now(wait=True) must return the
        # outcome of a cycle that STARTED after the request — _force_seq
        # is the request counter, _done_seq the newest request a finished
        # cycle had seen at its start
        self._force_seq = 0
        self._done_seq = 0
        self._busy = False
        self._state = "idle"
        self._candidate_generation: Optional[int] = None
        # directory-mode watchers are primed with the CURRENT manifest
        # token, so the bundle the server already serves is never
        # re-offered as a "new" candidate on the first poll
        self._current_token: Optional[str] = (
            None if watcher.path is None
            else StoreWatcher.dir_token(watcher.path))
        self._swaps = 0
        self._adopted = 0
        self._rejected = 0
        self._last_error: Optional[str] = None
        self._last_canary: Optional[dict] = None
        self.events: list = []  # swap/adopt/reject records, newest last
        registry = get_registry()
        self._c_adoptions = registry.counter(
            "deploy_adoptions_total",
            "candidate generations adopted into the mux registry "
            "(registry-mode reloads; docs/MULTIPLEX.md)")
        self._c_swaps = registry.counter(
            "deploy_swaps_total",
            "zero-downtime engine swaps completed by the reload plane")
        self._c_rejects = registry.counter(
            "deploy_rejects_total",
            "candidate generations rejected (canary failure, construction "
            "failure, kind mismatch)")
        self._h_swap = registry.histogram(
            "deploy_swap_seconds",
            "wall seconds per swap (atomic switch + old-engine drain)")
        self._g_state = registry.gauge(
            "deploy_candidate_state",
            "reload candidate state: 0=idle 1=warming 2=canary 3=swapping "
            "4=rejected")
        self._g_state.set(0)

    # -- lifecycle ------------------------------------------------------
    def start(self) -> threading.Thread:
        with self._lock:
            if self._thread is not None and self._thread.is_alive():
                return self._thread
            self._stop.clear()
            t = threading.Thread(target=self._loop, name="deploy-reloader",
                                 daemon=True)
            self._thread = t
        t.start()
        return t

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        self._wake.set()
        t = self._thread
        if t is not None:
            t.join(timeout)

    # -- observability --------------------------------------------------
    def status(self) -> dict:
        """The /healthz "reload" block."""
        with self._lock:
            return {
                "state": self._state,
                "mode": "registry" if self.registry is not None else "swap",
                "candidate_generation": self._candidate_generation,
                "swaps": self._swaps,
                "adopted": self._adopted,
                "rejected": self._rejected,
                "last_error": self._last_error,
                "canary": self._last_canary,
            }

    def _transition(self, state: str, candidate_generation) -> None:
        with self._lock:
            self._state = state
            self._candidate_generation = candidate_generation
        self._g_state.set(_STATE_CODE[state])

    def _learned_buckets(self, live):
        """Solve a ladder from the INCUMBENT's recorded request sizes
        (serving/ladder.py) under the incumbent's capture budget and top
        bucket — the carry-forward that lets a new generation boot with
        buckets shaped by the traffic it is about to inherit. None when
        nothing was recorded yet (or on any solver hiccup: a reload must
        never fail over ladder learning). The solve is in-memory on
        purpose — a published generation's bytes are digest-immutable
        (resilience store) and the directory-mode watcher tokens hash
        ``serving.json``, so the reload plane never writes the block
        into a candidate bundle; ``write_ladder_block`` is for
        publishers, BEFORE the bundle is digested."""
        if live is None:
            return None
        try:
            if self.registry is not None:
                name = self.registry.primary_name()
                if name is None:
                    return None
                hist = self.registry.variant(name).histogram
            else:
                hist = getattr(self.service.batcher, "size_histogram", None)
            if hist is None:
                return None
            counts = hist.merged()
            if not counts:
                return None
            from gan_deeplearning4j_tpu_torch.serving.ladder import solve_ladder

            return solve_ladder(counts, len(live.buckets),
                                top=live.buckets[-1])
        except Exception:
            logger.exception("learned-ladder solve failed — candidate "
                             "keeps the incumbent ladder")
            return None

    def _singleton_build(self, candidate: BundleCandidate, live):
        """Singleton-mode candidate construction: the bundle's own
        manifest ladder > a ladder solved from the incumbent batcher's
        histogram > the live ladder (same top + budget either way, so
        the batcher's ``max_batch`` and chunking contract carry across
        the swap); replica devices always the live engine's (its device
        tuple)."""
        from gan_deeplearning4j_tpu_torch.serving.engine import ServingEngine
        from gan_deeplearning4j_tpu_torch.serving.ladder import manifest_ladder

        buckets = _ladder_priority(manifest_ladder(candidate.path),
                                   self._learned_buckets(live),
                                   live.buckets)
        return ServingEngine.from_bundle(
            candidate.path,
            buckets=buckets,
            replicas=live.replica_count,
            devices=live.devices,
            export_gauge=False,
        )

    def _registry_build(self, candidate: BundleCandidate, live):
        """Mux-mode candidate construction: the registry's ONE build
        recipe (ladder + replicas + shared staging pool), so adopted
        candidates and budget re-warms can never diverge in config. The
        incumbent-traffic solve rides along as the fallback for bundles
        with no manifest ladder of their own."""
        return self.registry.build_engine(
            candidate.path, fallback_buckets=self._learned_buckets(live))

    # -- forced polls (POST /admin/reload) ------------------------------
    def poll_now(self, wait: bool = False, timeout: float = 60.0) -> dict:
        """Skip the remainder of the watcher interval and poll NOW.
        ``wait=True`` blocks until a cycle that STARTED after this request
        finishes (the /admin/reload ``block=1`` path — a cycle already
        winding down when the request lands does not count as its
        outcome); raises :class:`ReloadBusy` when a cycle is already in
        progress."""
        with self._lock:
            if self._busy:
                raise ReloadBusy("a reload cycle is already in progress")
            running = self._thread is not None and self._thread.is_alive()
            if running:
                self._force_seq += 1
                target = self._force_seq
        if not running:
            # no loop thread (tests, or a stopped controller): run one
            # cycle synchronously — same code path, caller's thread
            self._cycle()
            return self.status()
        self._wake.set()
        if wait:
            with self._cond:
                self._cond.wait_for(lambda: self._done_seq >= target,
                                    timeout=timeout)
        return self.status()

    # -- the loop --------------------------------------------------------
    def _loop(self) -> None:
        delay = self.poll_interval
        while not self._stop.is_set():
            with self._lock:
                seen = self._force_seq  # requests this cycle will cover
            try:
                self._cycle()
                delay = self.poll_interval
            except Exception as exc:  # store unreachable etc. — back off
                with self._lock:
                    self._last_error = f"{type(exc).__name__}: {exc}"
                self._transition("idle", None)
                delay = min(self.backoff_max,
                            max(self.poll_interval, delay * 2))
                logger.warning("reload poll failed (%s) — backing off %.1fs",
                               exc, delay)
            with self._cond:
                self._done_seq = seen
                self._cond.notify_all()
            if self._stop.is_set():
                return
            self._wake.wait(delay)
            self._wake.clear()

    def _cycle(self) -> bool:
        """One watch→warm→canary→swap pass. True when a candidate was
        handled (swapped or rejected), False when nothing newer exists."""
        with self._lock:
            self._busy = True
        try:
            if self.registry is not None:
                # mux mode: "newer" means newer than ANY adopted variant,
                # and the compatibility/canary reference is the registry's
                # primary (None while the registry bootstraps — the first
                # adopted generation then lands ungated-by-comparison)
                live = self.registry.reference_engine()
                current_generation = self.registry.max_generation()
            else:
                live = self.service.engine
                current_generation = live.generation
            candidate = self.watcher.poll_once(
                current_generation=current_generation,
                current_token=self._current_token,
            )
            if candidate is None:
                self._transition("idle", None)
                return False
            return self._process(candidate, live)
        finally:
            with self._lock:
                self._busy = False

    def _process(self, candidate: BundleCandidate, live) -> bool:
        gen = candidate.generation
        self._transition("warming", gen)
        try:
            with TRACER.span("deploy.warm", generation=gen):
                engine = self._build(candidate, live)
                engine.warmup()  # sync: every (kind, bucket) captured
        except Exception as exc:
            # unbuildable = unservable: discard (and quarantine, when the
            # generation still exists — a GC'd-underneath read is just
            # skipped, not flagged)
            self._reject(candidate,
                         f"engine construction failed: "
                         f"{type(exc).__name__}: {exc}", quarantine=True)
            return True
        if live is None:
            # mux bootstrap: nothing to compare kinds/widths/quality
            # against — the first variant defines the reference
            return self._adopt(candidate, engine)
        missing = set(live.kinds) - set(engine.kinds)
        if missing:
            # a bundle that dropped request kinds would 404 live traffic
            # mid-flight — config mismatch, not corruption: skip it without
            # quarantining the bytes
            self._reject(candidate,
                         f"candidate serves no {sorted(missing)} but the "
                         f"live engine does", quarantine=False)
            return True
        mismatched = [
            k for k in live.kinds
            if engine.input_width(k) != live.input_width(k)
        ]
        if mismatched:
            # same kinds, different request shapes (a changed z_size or
            # feature width): rows validated against the live engine would
            # error the flush they ride after the swap — config mismatch
            self._reject(candidate,
                         f"candidate input width differs for {mismatched} "
                         f"(live: {[live.input_width(k) for k in mismatched]}"
                         f", candidate: "
                         f"{[engine.input_width(k) for k in mismatched]})",
                         quarantine=False)
            return True
        if self.canary is not None:
            self._transition("canary", gen)
            with TRACER.span("deploy.canary", generation=gen):
                decision = self.canary.evaluate(engine, live)
            cand, inc = decision.candidate or {}, decision.incumbent or {}
            with self._lock:
                self._last_canary = {
                    "generation": gen, "passed": decision.passed,
                    "fid": cand.get("fid"), "accuracy": cand.get("accuracy"),
                    "incumbent_fid": inc.get("fid"),
                    "incumbent_accuracy": inc.get("accuracy")}
            if not decision.passed:
                TRACER.instant("deploy.canary_reject", {
                    "generation": gen, "reason": decision.reason})
                self._reject(candidate, f"canary: {decision.reason}",
                             quarantine=True,
                             extra={"candidate_probe": decision.candidate,
                                    "incumbent_probe": decision.incumbent})
                return True
        if self.registry is not None:
            return self._adopt(candidate, engine)
        self._transition("swapping", gen)
        t0 = time.perf_counter()
        old = self.service.batcher.swap_engine(engine)
        engine.export_generation()  # the gauge follows the SERVED engine
        drained = self._drain(old)
        if drained:
            old.close()  # its graphs, under the process-wide capture lock
        t1 = time.perf_counter()
        TRACER.complete("deploy.swap", t0, t1, {
            "from_generation": old.generation,
            "to_generation": engine.generation,
            "drained": drained,
        })
        self._c_swaps.inc()
        self._h_swap.observe(t1 - t0)
        with self._lock:
            self._swaps += 1
            self._current_token = candidate.token
            self._last_error = None
            self.events.append({
                "event": "swap", "from": old.generation,
                "to": engine.generation, "seconds": t1 - t0,
                "drained": drained,
            })
        self._transition("idle", None)
        logger.info("swapped serving engine: generation %s -> %s (%.3fs)",
                    old.generation, engine.generation, t1 - t0)
        return True

    def _adopt(self, candidate: BundleCandidate, engine) -> bool:
        """Mux-mode admission: the warmed (and canaried) candidate joins
        the registry as a new variant instead of replacing a singleton —
        at ``adopt_weight`` (default 0: resident and warm, serving
        nothing until a ramp or an operator gives it weight). Nothing
        drains: every incumbent variant keeps serving untouched."""
        gen = candidate.generation
        name = self.adopt_name.format(generation=gen)
        self._transition("swapping", gen)
        try:
            with TRACER.span("deploy.adopt", generation=gen):
                self.registry.adopt(
                    name, engine, bundle_path=candidate.path,
                    cost=self.adopt_cost, weight=self.adopt_weight,
                    generation=gen)
        except ValueError as exc:
            # a name collision is a config problem, not corruption
            self._reject(candidate, f"adopt failed: {exc}",
                         quarantine=False)
            return True
        self._c_adoptions.inc()
        with self._lock:
            self._adopted += 1
            self._current_token = candidate.token
            self._last_error = None
            self.events.append({
                "event": "adopt", "generation": gen, "variant": name,
                "weight": self.adopt_weight,
            })
        self._transition("idle", None)
        logger.info("adopted serving generation %s as mux variant %r "
                    "(weight %.3f)", gen, name, self.adopt_weight)
        return True

    def _drain(self, old) -> bool:
        """Wait for the old engine's last flight: the batcher stops
        routing to it at the swap, so its pipeline count only falls. True
        when fully drained within ``drain_timeout`` (the engine is then
        retired — its graphs released, dropped, its buffers freed with
        it)."""
        deadline = time.monotonic() + self.drain_timeout
        while (self.service.batcher.flights_on(old) > 0
               or old.in_flight > 0):
            if time.monotonic() >= deadline:
                logger.warning(
                    "old engine still has flights after %.1fs drain window",
                    self.drain_timeout)
                return False
            time.sleep(0.005)
        return True

    def _reject(self, candidate: BundleCandidate, reason: str,
                quarantine: bool, extra: Optional[dict] = None) -> None:
        self.watcher.discard(candidate, reason, quarantine=quarantine)
        self._c_rejects.inc()
        with self._lock:
            self._rejected += 1
            self._last_error = reason
            self.events.append({
                "event": "reject", "generation": candidate.generation,
                "reason": reason, "quarantined": quarantine,
                **(extra or {}),
            })
        self._transition("rejected", candidate.generation)
        logger.warning("candidate generation %s rejected: %s",
                       candidate.generation, reason)
