"""MuxService — the multi-model request surface over a MuxRegistry.

The PyTorch port's copy of ``gan_deeplearning4j_tpu/serving/mux/service.py`` (plain
Python, no JAX), kept inside the port so that it imports nothing of the
JAX package.

Duck-types :class:`~..service.InferenceService`'s handler contract, so
the same stdlib HTTP front end (``serving.service.make_server``) serves
it. What changes is WHO answers: every ``/v1/*`` request carries a
routing key (``"key"`` in the payload — a user/session id — or a minted
one when absent), the :class:`~.splitter.WeightedSplitter` resolves it
to a variant, and that variant's micro-batcher runs the batch. The
response names the serving ``model``, so a client can see which side of
a ramp it landed on.

Per-model degradation (docs/MULTIPLEX.md "Brownout tiering"): under
overload the fleet router sheds *work shapes* (oversized slabs); the mux
plane sheds *models*, most expensive first. Brownout level L sheds new
traffic of the L highest-``cost`` variants with honest 503s while the
cheap (bf16) variants keep answering — degradation follows the cost
gradient instead of hitting every model equally. The built-in
:class:`BrownoutController` drives the level from aggregate queue
pressure with enter/exit hysteresis (the same fail-safe shape as the
autoscaler's brownout: pressure alone, never latched by its own sheds);
``POST /mux/brownout`` overrides it manually.

Observability: every outcome lands in per-model registry series
(``mux_requests_total{model,kind,status}``,
``mux_request_latency_seconds{model}``) AND a per-variant
:class:`~...telemetry.slo.SLOTracker` (``mux_slo_*{model,...}``) — the
per-variant burn rate is what the ramp controller's auto-rollback reads.
The ``/metrics`` payload keeps the single-model worker's top-level
``queue_depth`` and ``pipeline.in_flight`` keys (summed across
variants), so the fleet autoscaler's pressure signal reads a mux worker
exactly like a singleton one (docs/FLEET.md "Autoscaling")."""

from __future__ import annotations

import logging
import threading
import uuid
from typing import Dict, Optional, Tuple

import numpy as np

from gan_deeplearning4j_tpu_torch.serving.mux.ramp import (
    RampController,
    health_from_tracker,
)
from gan_deeplearning4j_tpu_torch.serving.mux.registry import MuxRegistry
from gan_deeplearning4j_tpu_torch.telemetry.registry import get_registry
from gan_deeplearning4j_tpu_torch.telemetry.slo import SLOConfig, SLOTracker
from gan_deeplearning4j_tpu_torch.telemetry.trace import (
    TRACER,
    bind_trace_id,
    new_trace_id,
    sanitize_trace_id,
    unbind_trace_id,
)
from urllib.parse import parse_qs

logger = logging.getLogger(__name__)

_STATUS_HTTP = {"ok": 200, "overloaded": 503, "deadline": 503, "error": 500}


class BrownoutController:
    """Pressure-driven per-model brownout tiers with hysteresis.

    ``tick(pressure)``: pressure at/over ``threshold`` for
    ``enter_ticks`` consecutive ticks raises the level (one more —
    the next most expensive — variant sheds); calm for ``exit_ticks``
    lowers it tier-by-tier. The level never reaches the variant count —
    the cheapest variant always serves (shedding everything is an
    outage, not a degradation)."""

    def __init__(self, *, threshold: float = 0.8, enter_ticks: int = 2,
                 exit_ticks: int = 4):
        if threshold <= 0:
            raise ValueError("threshold must be > 0")
        if enter_ticks < 1 or exit_ticks < 1:
            raise ValueError("enter_ticks and exit_ticks must be >= 1")
        self.threshold = threshold
        self.enter_ticks = enter_ticks
        self.exit_ticks = exit_ticks
        self._hot = 0
        self._calm = 0

    def tick(self, pressure: float, level: int, max_level: int) -> int:
        """The next level given current ``pressure`` (NaN fails closed:
        evidence of neither overload nor calm — hold the level)."""
        if not np.isfinite(pressure):
            self._hot = self._calm = 0
            return level
        if pressure >= self.threshold:
            self._hot += 1
            self._calm = 0
            if self._hot >= self.enter_ticks and level < max_level:
                self._hot = 0
                return level + 1
        else:
            self._calm += 1
            self._hot = 0
            if self._calm >= self.exit_ticks and level > 0:
                self._calm = 0
                return level - 1
        return level


class MuxService:
    """The in-process multi-model serving API (module docstring)."""

    def __init__(self, registry: MuxRegistry, *,
                 slo_config: Optional[SLOConfig] = None,
                 brownout: Optional[BrownoutController] = None,
                 alerts=None):
        """``alerts`` is an optional
        :class:`~...telemetry.alerts.AlertManager` — typically over
        :func:`~...telemetry.alerts.default_mux_rules`, whose burn and
        queue rules read the per-model labeled families and therefore
        fan out into one alert instance per variant (per-model scoping;
        docs/MULTIPLEX.md "Alerting"). The control loop ticks its
        evaluation over this process's registry snapshot; ``GET
        /alerts`` serves it. None = zero alerting cost."""
        self.registry = registry
        self.alerts = alerts
        self.draining = False
        self._slo_config = slo_config
        self._lock = threading.Lock()
        self._trackers: Dict[str, SLOTracker] = {}
        self._brownout_level = 0
        self._brownout_auto = brownout or BrownoutController()
        self._ramp: Optional[RampController] = None
        self._loop_stop = threading.Event()
        self._loop_thread: Optional[threading.Thread] = None
        metrics = get_registry()
        requests = metrics.counter(
            "mux_requests_total", "mux request outcomes per variant",
            labelnames=("model", "kind", "status"))
        self._c_requests = requests.labels
        self._h_latency = metrics.histogram(
            "mux_request_latency_seconds",
            "submit-to-result latency per serving variant",
            labelnames=("model",))
        self._g_queue = metrics.gauge(
            "mux_queue_depth", "queued requests per resident variant",
            labelnames=("model",))
        self._g_brownout = metrics.gauge(
            "mux_brownout_level",
            "per-model brownout tier: the L most expensive variants shed "
            "(0 = off)")
        self._g_brownout.set(0.0)
        self._c_brownout_sheds = metrics.counter(
            "mux_brownout_sheds_total",
            "requests shed because their variant is browned out",
            labelnames=("model",))

    # -- per-variant SLO --------------------------------------------------
    def tracker_for(self, name: str) -> SLOTracker:
        with self._lock:
            tracker = self._trackers.get(name)
            if tracker is None:
                tracker = SLOTracker(self._slo_config,
                                     metric_prefix="mux",
                                     labels={"model": name})
                self._trackers[name] = tracker
        return tracker

    def _trackers_snapshot(self) -> list:
        """Sorted (name, tracker) pairs, snapshotted under the lock so
        healthz never iterates the dict while tracker_for is inserting."""
        with self._lock:
            return sorted(self._trackers.items())

    # -- brownout ---------------------------------------------------------
    @property
    def brownout_level(self) -> int:
        with self._lock:
            return self._brownout_level

    def _ranked_weighted(self) -> list:
        """Traffic-carrying variants (positive weight), most expensive
        first (ties by name — deterministic). Zero-weight variants are
        excluded: shedding a variant that serves nothing relieves
        nothing, and counting them toward the tier ceiling could let a
        tier silence EVERY weighted variant — a total outage dressed as
        degradation."""
        weights = self.registry.splitter.weights()
        return sorted(
            ((n, c) for n, c in self.registry.costs().items()
             if weights.get(n, 0.0) > 0.0),
            key=lambda kv: (-kv[1], kv[0]))

    def _max_level(self) -> int:
        return max(0, len(self._ranked_weighted()) - 1)

    def set_brownout(self, level: int) -> int:
        """Clamp + set the per-model brownout tier. Level L sheds the L
        most expensive traffic-carrying variants' new traffic; the
        cheapest weighted variant never sheds (and :meth:`_shed_set`
        re-clamps per request, so a weight change after the level was
        set can never silence the whole pool)."""
        level = max(0, min(self._max_level(), int(level)))
        with self._lock:
            changed = level != self._brownout_level
            self._brownout_level = level
        self._g_brownout.set(float(level))
        if changed:
            logger.warning("mux brownout level set to %d", level)
        return level

    def _shed_set(self) -> set:
        """The variants whose traffic the current tier sheds: the
        ``level`` most expensive *weighted* variants — clamped against
        the CURRENT weights, so the cheapest traffic-carrying variant
        always serves no matter how the weights moved since the level
        was set."""
        with self._lock:
            level = self._brownout_level
        if level < 1:
            return set()
        ranked = self._ranked_weighted()
        level = min(level, max(0, len(ranked) - 1))
        return {name for name, _ in ranked[:level]}

    def _pressure(self) -> float:
        """Aggregate queue pressure across resident variants: total
        queued / total queue capacity. NaN when nothing is resident.
        Non-resident variants' queue gauges are zeroed here — a demoted
        variant has no queue, and a gauge frozen at its last pre-demote
        value would read as phantom pressure on a dashboard."""
        total = capacity = 0
        resident = set(self.registry.resident_names())
        for name in self.registry.names():
            batcher = (self.registry.batcher_for(name)
                       if name in resident else None)
            if batcher is None:
                self._g_queue.labels(model=name).set(0.0)
                continue
            depth = batcher.queue_depth
            total += depth
            capacity += batcher.max_queue
            self._g_queue.labels(model=name).set(float(depth))
        return (total / capacity) if capacity else float("nan")

    # -- ramp -------------------------------------------------------------
    def start_ramp(self, candidate: str, *, stages=None,
                   hold_ticks: int = 2, health=None,
                   rollback_threshold: float = 1.0) -> RampController:
        """Start a continuous canary ramp for ``candidate``; the health
        signal defaults to the candidate's own per-variant SLO burn
        (:func:`~.ramp.health_from_tracker`)."""
        if health is None:
            health = health_from_tracker(self.tracker_for(candidate),
                                         threshold=rollback_threshold)
        kwargs = {"hold_ticks": hold_ticks, "health": health}
        if stages is not None:
            kwargs["stages"] = stages
        ramp = RampController(self.registry, candidate, **kwargs)
        with self._lock:
            if self._ramp is not None and self._ramp.state == "ramping":
                raise RuntimeError(
                    f"a ramp for {self._ramp.candidate!r} is already "
                    f"running")
            self._ramp = ramp
        ramp.start()
        return ramp

    @property
    def ramp(self) -> Optional[RampController]:
        with self._lock:
            return self._ramp

    # -- control loop -----------------------------------------------------
    def control_tick(self) -> None:
        """One control step: advance/rollback the active ramp, and walk
        the brownout tier from queue pressure. Driven by
        :meth:`start_control_loop` or directly (tests, the drill)."""
        ramp = self.ramp
        if ramp is not None:
            ramp.tick()
        pressure = self._pressure()
        level = self._brownout_auto.tick(
            pressure, self.brownout_level, self._max_level())
        if level != self.brownout_level:
            self.set_brownout(level)
        if self.alerts is not None:
            # per-model alerting rides the control tick the service
            # already runs — same no-extra-scrape contract as the fleet
            # plane (the per-model families are in THIS registry). The
            # burn-rate gauges only move when a tracker snapshots, so
            # refresh every variant's stream first.
            try:
                with self._lock:
                    trackers = list(self._trackers.values())
                for tracker in trackers:
                    tracker.snapshot()
                self.alerts.evaluate(
                    get_registry().snapshot(include_samples=True))
            except Exception:
                logger.exception("mux alert evaluation failed")

    def start_control_loop(self, interval: float = 0.25) -> threading.Thread:
        with self._lock:
            if self._loop_thread is not None and self._loop_thread.is_alive():
                return self._loop_thread
            self._loop_stop.clear()
            t = threading.Thread(target=self._control_loop,
                                 args=(interval,), name="mux-control",
                                 daemon=True)
            self._loop_thread = t
        t.start()
        return t

    def _control_loop(self, interval: float) -> None:
        while not self._loop_stop.is_set():
            try:
                self.control_tick()
            except Exception:  # a control bug must not kill the loop
                logger.exception("mux control tick failed")
            self._loop_stop.wait(interval)

    # -- observability ----------------------------------------------------
    def healthz(self) -> dict:
        snap = self.registry.snapshot()
        resident = [v for v in snap["variants"].values() if v["resident"]]
        if self.draining:
            status = "draining"
        elif not resident:
            status = "down"
        elif all(v["warm"] for v in resident):
            status = "ok"
        else:
            status = "warming"
        kinds: set = set()
        for name in self.registry.resident_names():
            engine = self.registry.engine_for(name)
            if engine is not None:
                kinds.update(engine.kinds)
        level = self.brownout_level
        primary = self.registry.primary_name()
        ramp = self.ramp
        body = {
            "status": status,
            "role": "mux",
            "kinds": sorted(kinds),
            "generation": (snap["variants"][primary]["generation"]
                           if primary else None),
            "primary": primary,
            "variants": snap["variants"],
            "shares": snap["shares"],
            "brownout": {"active": level > 0, "level": level,
                         "shedding": sorted(self._shed_set())},
            # the economics the shed/evict order runs on, with provenance:
            # "measured" = live-ladder quant/cost.py block, "declared" =
            # operator bootstrap (docs/QUANT.md)
            "costs": {
                name: {
                    "cost": v["cost"],
                    "cost_source": v["cost_source"],
                    "declared_cost": v["declared_cost"],
                    "measured_cost": v["measured_cost"],
                    "resident_param_bytes": v["resident_param_bytes"],
                    "precision": v["precision"],
                }
                for name, v in sorted(snap["variants"].items())
            },
            "ramp": None if ramp is None else ramp.snapshot(),
            "slo": {name: tracker.snapshot()
                    for name, tracker in self._trackers_snapshot()},
        }
        if self.alerts is not None:
            body["alerts"] = self.alerts.health_block()
        return body

    def metrics(self) -> dict:
        """Aggregate + per-variant metrics. Top-level ``queue_depth`` /
        ``pipeline.in_flight`` keep the single-model schema summed
        across variants, so the fleet router's scrape and the
        autoscaler's pressure math work unchanged over a mux worker."""
        per_variant: Dict[str, dict] = {}
        queue_depth = in_flight = 0
        depth_total = 0
        for name in self.registry.resident_names():
            batcher = self.registry.batcher_for(name)
            if batcher is None:
                continue
            m = batcher.metrics()
            per_variant[name] = m
            queue_depth += m["queue_depth"]
            in_flight += m["pipeline"]["in_flight"]
            depth_total += m["pipeline"]["depth"]
            self._g_queue.labels(model=name).set(float(m["queue_depth"]))
        primary = self.registry.primary_name()
        primary_gen = (self.registry.variant(primary).generation
                       if primary else None)
        return {
            "queue_depth": queue_depth,
            "generation": primary_gen,
            "draining": self.draining,
            "pipeline": {"in_flight": in_flight, "depth": depth_total},
            "brownout_level": self.brownout_level,
            "mux": {
                "registry": self.registry.snapshot(),
                "per_variant": per_variant,
                "costs": self.registry.costs(),
                "cost_sources": self.registry.cost_sources(),
                "ramp": (None if self.ramp is None
                         else self.ramp.snapshot()),
            },
        }

    def metrics_text(self) -> str:
        return get_registry().to_prometheus()

    # -- request handling -------------------------------------------------
    def _serve(self, kind: str, payload: Optional[dict],
               trace_id: Optional[str]) -> Tuple[int, dict]:
        payload = payload or {}
        # the routing key: sticky per user/session when the client sends
        # one; otherwise minted per request (weight-proportional split,
        # no stickiness to honor). "model" pins a variant outright —
        # probes and drills, not the normal path.
        pinned = payload.get("model")
        key = payload.get("key")
        if key is not None and not isinstance(key, str):
            return 400, {"status": "error",
                         "error": f"bad 'key': {key!r} (want a string)"}
        if pinned is not None:
            if not isinstance(pinned, str):
                return 400, {"status": "error",
                             "error": f"bad 'model': {pinned!r}"}
            try:
                variant = self.registry.variant(pinned)
            except KeyError:
                return 404, {"status": "error",
                             "error": f"unknown model {pinned!r}"}
            if variant.state != "resident":
                return 503, {"status": "overloaded", "model": pinned,
                             "error": f"model {pinned!r} is not resident"}
            name, batcher = pinned, self.registry.batcher_for(pinned)
        else:
            try:
                name, batcher = self.registry.route(
                    key if key is not None else uuid.uuid4().hex)
            except LookupError as exc:
                return 503, {"status": "overloaded", "error": str(exc)}
        if name in self._shed_set():
            # the per-model brownout: honest 503, counted per variant,
            # and fed into the variant's availability SLI (a brownout
            # IS an availability event for the model it silences)
            self._c_brownout_sheds.labels(model=name).inc()
            self._c_requests(model=name, kind=kind,
                             status="brownout_shed").inc()
            self.tracker_for(name).record(False)
            return 503, {
                "status": "overloaded", "model": name,
                "error": f"brownout: model {name!r} is shed until the "
                         f"fleet recovers (tier {self.brownout_level})"}
        engine = self.registry.engine_for(name)
        if engine is None or batcher is None:
            return 503, {"status": "overloaded", "model": name,
                         "error": f"model {name!r} was demoted mid-route"}
        if kind not in engine.kinds:
            return 404, {"status": "error", "model": name,
                         "error": f"unknown request kind {kind!r}"}
        data = payload.get("data")
        if data is None:
            return 400, {"status": "error", "error": "missing 'data'"}
        try:
            rows = np.asarray(data, dtype=np.float32)
        except (TypeError, ValueError) as exc:
            return 400, {"status": "error", "error": f"bad 'data': {exc}"}
        if rows.ndim == 1:
            rows = rows[None, :]
        width = engine.input_width(kind)
        if rows.ndim != 2 or rows.shape[0] < 1 or rows.shape[1] != width:
            return 400, {
                "status": "error",
                "error": f"{kind}: expected (n >= 1, {width}) rows, "
                         f"got {tuple(rows.shape)}"}
        timeout = payload.get("timeout")
        if timeout is not None:
            try:
                timeout = float(timeout)
            except (TypeError, ValueError):
                return 400, {"status": "error",
                             "error": f"bad 'timeout': {timeout!r}"}
        if TRACER.enabled:
            token = bind_trace_id(
                sanitize_trace_id(trace_id) or new_trace_id())
            try:
                with TRACER.span("mux.request", kind=kind, model=name,
                                 rows=int(rows.shape[0])):
                    result = batcher.submit(kind, rows, timeout=timeout)
            finally:
                unbind_trace_id(token)
        else:
            result = batcher.submit(kind, rows, timeout=timeout)
        self._c_requests(model=name, kind=kind, status=result.status).inc()
        self.tracker_for(name).record(
            result.ok, result.latency_s if result.ok else None)
        if result.ok:
            self._h_latency.labels(model=name).observe(result.latency_s)
        body = {"status": result.status, "model": name,
                "latency_ms": result.latency_s * 1e3}
        if result.ok:
            body["data"] = np.asarray(result.data).tolist()
        elif result.error:
            body["error"] = result.error
        return _STATUS_HTTP.get(result.status, 500), body

    def _mux_admin(self, path: str, payload: Optional[dict]
                   ) -> Tuple[int, dict]:
        payload = payload or {}
        if path == "/mux/weights":
            weights = payload.get("weights")
            if not isinstance(weights, dict) or not weights:
                return 400, {"status": "error",
                             "error": "need {'weights': {model: weight}}"}
            try:
                self.registry.set_weights(
                    {str(n): float(w) for n, w in weights.items()})
            except (KeyError, ValueError, TypeError) as exc:
                return 400, {"status": "error",
                             "error": f"{type(exc).__name__}: {exc}"}
            return 200, {"status": "ok",
                         "shares": self.registry.splitter.shares()}
        if path == "/mux/brownout":
            level = payload.get("level")
            if not isinstance(level, int):
                return 400, {"status": "error",
                             "error": f"need an integer 'level', "
                                      f"got {level!r}"}
            return 200, {"status": "ok",
                         "level": self.set_brownout(level)}
        if path == "/mux/ramp":
            candidate = payload.get("candidate")
            if not isinstance(candidate, str):
                return 400, {"status": "error",
                             "error": "need {'candidate': model}"}
            if candidate not in self.registry.names():
                return 404, {"status": "error",
                             "error": f"unknown model {candidate!r}"}
            try:
                ramp = self.start_ramp(
                    candidate,
                    stages=payload.get("stages"),
                    hold_ticks=int(payload.get("hold_ticks", 2)))
            except (RuntimeError, ValueError) as exc:
                return 409, {"status": "error", "error": str(exc)}
            return 200, {"status": "ok", "ramp": ramp.snapshot()}
        return 404, {"status": "error", "error": f"no route POST {path}"}

    def handle(self, method: str, path: str, payload: Optional[dict] = None,
               trace_id: Optional[str] = None) -> Tuple[int, dict]:
        """The single routing table (the same contract the single-model
        ``InferenceService.handle`` exposes, so ``make_server`` fronts
        either)."""
        path, _, query = path.partition("?")
        params = parse_qs(query) if query else {}
        if method == "GET" and path == "/healthz":
            return 200, self.healthz()
        if method == "GET" and path == "/metrics":
            if params.get("scope", [""])[0] == "registry":
                return 200, get_registry().snapshot(include_samples=True)
            return 200, self.metrics()
        if method == "GET" and path == "/mux/status":
            return 200, self.healthz()
        if method == "GET" and path == "/alerts":
            if self.alerts is None:
                return 404, {"status": "error",
                             "error": "no alert plane attached"}
            return 200, self.alerts.snapshot()
        if method == "GET" and path == "/debug/spans":
            return 200, TRACER.chrome_trace(
                {"source": "gan_deeplearning4j_tpu_torch.serving.mux"})
        if method == "POST" and path == "/admin/drain":
            self.draining = params.get("off", ["0"])[0] in ("0", "", "false")
            return 200, {"status": "ok", "draining": self.draining}
        if method == "POST" and path.startswith("/mux/"):
            return self._mux_admin(path, payload)
        if method == "POST" and path.startswith("/v1/"):
            return self._serve(path[len("/v1/"):], payload, trace_id)
        return 404, {"status": "error", "error": f"no route {method} {path}"}

    def close(self) -> None:
        self._loop_stop.set()
        t = self._loop_thread
        if t is not None:
            t.join(timeout=5.0)
        self.registry.close()
