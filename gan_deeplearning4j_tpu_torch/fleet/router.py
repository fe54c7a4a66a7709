"""FleetRouter — the multi-process serving front end.

One stdlib ``ThreadingHTTPServer`` proxies ``/v1/*`` to N serving worker
processes. Three mechanisms make the fleet tolerate what a single process
cannot (docs/FLEET.md):

- **power-of-two-choices routing** — each request picks two random
  routable workers and takes the less loaded one (local in-flight count
  plus the queue depth scraped from the worker's ``/metrics``). P2C gets
  most of the benefit of full least-loaded routing without herding every
  request onto one briefly-idle worker between scrapes.
- **retry budget** — a shed (worker 503) or connect-failed attempt is
  retried on a *different* worker with exponential backoff + jitter, but
  only while the token bucket holds a token (deposits accrue per proxied
  request at ``retry_ratio``, capped at ``retry_burst``). Budget
  exhausted ⇒ an honest 503 — under a fleet-wide brownout the router
  amplifies load by at most ``1 + retry_ratio``, never a retry storm.
- **health ejection** — every proxied outcome feeds the worker's
  :class:`~.health.CircuitBreaker` (passive), and a health loop probes
  ``/healthz`` actively (admission, half-open re-admission) and scrapes
  ``/metrics`` (load + liveness). A SIGKILLed, hung, warming, or
  draining worker silently leaves the pool and rejoins when healthy.
- **brownout admission control** — at the autoscaler's max size under
  sustained overload (docs/FLEET.md "Brownout") the router degrades in
  a chosen order instead of collapsing: tier 1 sheds oversized
  ``sample`` slabs with an honest 503, tier 2 additionally caps
  effective deadlines; the state is explicit in ``/healthz``
  (``"brownout"``) and the ``fleet_brownout`` gauge.

Exactly-one-answer is the router's contract: every accepted request gets
exactly one HTTP response — success, the worker's own non-retryable
answer, or an honest 503. A timed-out attempt may still execute on the
worker (inference is idempotent; the client gets the retry's answer).

The router never touches model bytes and adds no serve-time compiles —
the bounded-compile invariant is per worker and re-routing cannot break
it (the drill asserts each worker's ``serve_compile_counts`` stays 0).
Every network call here carries an explicit timeout — lint rule JG017
polices that on this path.

The router is also the fleet's observability edge (docs/OBSERVABILITY.md
"Fleet observability"): it stamps/adopts an ``X-Trace-Id`` per request
and forwards it on every worker attempt (one causal chain across
retries), serves the merged fleet registry at ``GET /metrics?scope=fleet``
(JSON + Prometheus) and the merged fleet span trace at
``GET /debug/trace``, and feeds every routed outcome into the SLO
burn-rate tracker surfaced in ``/healthz``.

The PyTorch port's copy of ``gan_deeplearning4j_tpu/fleet/router.py``
(plain Python), imports rewritten and nothing adapted: the picks are drawn
from ``random.Random(seed)`` as there, so one seed gives one pick sequence
in both packages. ``serve_compile_counts`` is what a port worker calls its
captures after warmup.
"""

from __future__ import annotations

import http.client
import json
import logging
import random
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple
from urllib.parse import parse_qs

from gan_deeplearning4j_tpu_torch.fleet.health import (
    CircuitBreaker,
    http_json,
    probe_worker,
)
from gan_deeplearning4j_tpu_torch.telemetry.aggregate import (
    json_sanitize,
    merge_snapshots,
    merge_traces,
    snapshot_to_prometheus,
)
from gan_deeplearning4j_tpu_torch.telemetry.registry import get_registry
from gan_deeplearning4j_tpu_torch.telemetry.slo import SLOConfig, SLOTracker
from gan_deeplearning4j_tpu_torch.telemetry.trace import (
    TRACER,
    bind_trace_id,
    current_trace_id,
    new_trace_id,
    sanitize_trace_id,
    unbind_trace_id,
)

logger = logging.getLogger(__name__)


class RetryBudget:
    """Token bucket bounding fleet-wide retry amplification. Each proxied
    request deposits ``ratio`` tokens (capped at ``burst``); each retry
    spends one. Starts full so a cold router can absorb a worker death
    immediately."""

    def __init__(self, ratio: float = 0.2, burst: float = 10.0):
        if ratio < 0 or burst < 1:
            raise ValueError("retry ratio must be >= 0 and burst >= 1")
        self.ratio = ratio
        self.burst = float(burst)
        self._tokens = float(burst)
        self._lock = threading.Lock()

    def deposit(self) -> None:
        with self._lock:
            self._tokens = min(self.burst, self._tokens + self.ratio)

    def spend(self) -> bool:
        """Take one token; False means the budget is exhausted and the
        caller must answer 503 instead of retrying."""
        with self._lock:
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                return True
            return False

    def refund(self) -> None:
        """Return a spent token (capped at burst): a retry that found no
        worker to land on never amplified load, so it must not count
        against requests whose retry WOULD reach a live worker."""
        with self._lock:
            self._tokens = min(self.burst, self._tokens + 1.0)

    @property
    def tokens(self) -> float:
        with self._lock:
            return self._tokens


class WorkerRef:
    """The router's view of one worker process."""

    def __init__(self, worker_id: str, base_url: str, *, pid=None,
                 breaker: Optional[CircuitBreaker] = None):
        self.id = worker_id
        self.base_url = base_url.rstrip("/")
        self.pid = pid
        self.breaker = breaker or CircuitBreaker()
        self.draining = False
        self._lock = threading.Lock()
        self._inflight = 0  # requests this router is running there NOW
        self._scraped: dict = {}  # last /metrics snapshot (queue, gen, ...)
        self.counts = {"ok": 0, "shed": 0, "failed": 0}

    # -- load accounting (p2c input) -------------------------------------
    def begin(self) -> None:
        with self._lock:
            self._inflight += 1

    def end(self) -> None:
        with self._lock:
            self._inflight -= 1

    def count(self, outcome: str) -> None:
        """Record one proxied-attempt outcome ("ok"/"shed"/"failed")."""
        with self._lock:
            self.counts[outcome] += 1

    @property
    def load(self) -> int:
        with self._lock:
            scraped = self._scraped
            return (self._inflight
                    + int(scraped.get("queue_depth", 0))
                    + int(scraped.get("in_flight", 0)))

    def update_scrape(self, metrics: dict) -> None:
        with self._lock:
            self._scraped = {
                "queue_depth": metrics.get("queue_depth", 0),
                "in_flight": metrics.get("pipeline", {}).get("in_flight", 0),
                "generation": metrics.get("generation"),
                "draining": metrics.get("draining", False),
                "serve_compile_counts": metrics.get("engine", {}).get(
                    "serve_compile_counts", {}),
                "at": time.monotonic(),
            }

    @property
    def generation(self):
        with self._lock:
            return self._scraped.get("generation")

    @property
    def routable(self) -> bool:
        with self._lock:
            # the worker's own /metrics "draining" flag: a worker drained
            # directly (POST /admin/drain, not through the manager) must
            # leave the pool too, not keep receiving /v1 traffic its
            # pipeline will never empty of
            self_drained = bool(self._scraped.get("draining", False))
        return (self.breaker.routable and not self.draining
                and not self_drained)

    def snapshot(self) -> dict:
        with self._lock:
            scraped = dict(self._scraped)
            inflight = self._inflight
            counts = dict(self.counts)
        scraped_at = scraped.get("at")
        return {
            "id": self.id,
            "base_url": self.base_url,
            "pid": self.pid,
            "draining": self.draining,
            "breaker": self.breaker.snapshot(),
            "routable": self.routable,
            "inflight": inflight,
            "generation": scraped.get("generation"),
            "queue_depth": scraped.get("queue_depth"),
            # scrape staleness: a wedged /metrics endpoint shows up HERE
            # (the age climbing past the probe interval) before the
            # breaker's failure streak ever trips; None = never scraped
            # since (re)launch
            "last_scrape_age_s": (
                round(time.monotonic() - scraped_at, 3)
                if scraped_at is not None else None),
            "counts": counts,
        }


class NoWorkerAvailable(RuntimeError):
    """Every worker is ejected, draining, or already tried."""


class FleetRouter:
    """Routing + health state over a set of :class:`WorkerRef`. The HTTP
    front end (:func:`make_router_server`) and the drill both drive
    :meth:`handle`; the manager registers/ejects/drains workers."""

    def __init__(self, *, request_timeout: float = 10.0,
                 probe_timeout: float = 2.0, probe_interval: float = 0.25,
                 retry_ratio: float = 0.2, retry_burst: float = 10.0,
                 max_attempts: int = 3, backoff_base: float = 0.02,
                 backoff_max: float = 0.25, seed: int = 0,
                 breaker_kwargs: Optional[dict] = None,
                 slo_config: Optional[SLOConfig] = None):
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        self.request_timeout = request_timeout
        self.probe_timeout = probe_timeout
        self.probe_interval = probe_interval
        self.max_attempts = max_attempts
        self.backoff_base = backoff_base
        self.backoff_max = backoff_max
        self.budget = RetryBudget(retry_ratio, retry_burst)
        self._breaker_kwargs = breaker_kwargs or {}
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._workers: Dict[str, WorkerRef] = {}
        self._stop = threading.Event()
        self._health_thread: Optional[threading.Thread] = None
        self.manager = None  # FleetManager, when attached (POST /admin/poll)
        self.started_at = time.time()
        # brownout: tiered admission control the autoscaler engages when
        # the fleet is at max size and still overloaded (docs/FLEET.md
        # "Brownout"). 0 = off, 1 = shed oversized sample slabs, 2 = also
        # cap effective deadlines.
        self._brownout_level = 0
        self._brownout_max_rows = 32
        self._brownout_deadline_s = 1.0
        # -- counters ----------------------------------------------------
        self._counts = {"proxied": 0, "ok": 0, "error": 0, "retries": 0,
                        "budget_exhausted": 0, "no_worker": 0,
                        "attempts_exhausted": 0, "ejections": 0,
                        "brownout_shed": 0}
        registry = get_registry()
        self._c_requests = registry.counter(
            "fleet_requests_total", "router request outcomes",
            labelnames=("outcome",))
        self._c_retries = registry.counter(
            "fleet_retries_total", "attempts re-routed to another worker")
        self._c_exhausted = registry.counter(
            "fleet_retry_budget_exhausted_total",
            "requests answered 503 because the retry budget was empty")
        self._c_ejections = registry.counter(
            "fleet_ejections_total", "circuit-breaker trips across workers")
        self._g_routable = registry.gauge(
            "fleet_workers_routable", "workers currently in the routable pool")
        self._g_brownout = registry.gauge(
            "fleet_brownout",
            "brownout tier (0 = off, 1 = large sample slabs shed, "
            "2 = + effective deadlines capped)")
        self._g_brownout.set(0.0)
        self._c_brownout_sheds = registry.counter(
            "fleet_brownout_sheds_total",
            "requests shed by brownout admission control",
            labelnames=("tier",))
        self._c_brownout_clamps = registry.counter(
            "fleet_brownout_deadline_clamps_total",
            "admitted requests whose effective deadline was capped by "
            "tier-2 brownout")
        # per-member liveness/staleness as REAL gauge families (not just
        # /healthz JSON): what the prom surface scrapes and the alert
        # rules evaluate. Families cost nothing until labeled; the
        # health loop materializes one series per registered member and
        # remove_worker drops it (a retired member is not a down member)
        self._g_member_routable = registry.gauge(
            "fleet_member_routable",
            "1 when the member is in the routable pool, 0 when ejected, "
            "draining, or dead",
            labelnames=("worker",))
        self._g_member_scrape_age = registry.gauge(
            "fleet_member_scrape_age_seconds",
            "age of the member's last successful /metrics scrape "
            "(NaN until the first lands)",
            labelnames=("worker",))
        # alert plane (telemetry/alerts.py) — None until attach_alerts;
        # disabled it allocates zero series and zero per-request work
        # (the telemetry-off contract)
        self.alerts = None
        self._exemplars = None
        self._h_latency: Optional[object] = None
        self._g_pressure: Optional[object] = None
        # SLO burn-rate tracking over every routed outcome — the healthz
        # block and the admission signal (telemetry/slo.py)
        self.slo = SLOTracker(slo_config)

    # -- worker registry -------------------------------------------------
    def add_worker(self, worker_id: str, base_url: str, pid=None
                   ) -> WorkerRef:
        ref = WorkerRef(worker_id, base_url, pid=pid,
                        breaker=CircuitBreaker(**self._breaker_kwargs))
        with self._lock:
            self._workers[worker_id] = ref
        return ref

    def remove_worker(self, worker_id: str) -> None:
        with self._lock:
            self._workers.pop(worker_id, None)
        # a retired member must not linger as a zero-valued "down" fact
        # (the worker_down rule would page forever on a scale-down)
        self._g_member_routable.remove(worker=worker_id)
        self._g_member_scrape_age.remove(worker=worker_id)

    def worker(self, worker_id: str) -> WorkerRef:
        with self._lock:
            return self._workers[worker_id]

    def workers(self) -> List[WorkerRef]:
        with self._lock:
            return list(self._workers.values())

    def mark_draining(self, worker_id: str, draining: bool = True) -> None:
        """Manager-side drain mark: the worker leaves the routable pool
        immediately; in-flight proxied requests still finish."""
        self.worker(worker_id).draining = draining

    # -- selection -------------------------------------------------------
    def _pick(self, exclude: set) -> WorkerRef:
        candidates = [w for w in self.workers()
                      if w.routable and w.id not in exclude]
        if not candidates:
            raise NoWorkerAvailable(
                "no routable worker (all ejected, draining, or tried)")
        if len(candidates) == 1:
            return candidates[0]
        with self._lock:  # Random() is not thread-safe
            a, b = self._rng.sample(candidates, 2)
        return a if a.load <= b.load else b

    # -- brownout admission control --------------------------------------
    @property
    def brownout_level(self) -> int:
        with self._lock:
            return self._brownout_level

    def set_brownout(self, level: int, max_rows: Optional[int] = None,
                     deadline_s: Optional[float] = None) -> None:
        """Set the brownout tier (clamped to 0..2); ``max_rows`` /
        ``deadline_s`` override the admission parameters when given.
        Driven by the autoscaler at max size under sustained overload —
        degradation becomes ordered and observable (``/healthz``
        ``brownout`` block, ``fleet_brownout`` gauge) instead of
        emergent queue collapse."""
        level = max(0, min(2, int(level)))
        with self._lock:
            self._brownout_level = level
            if max_rows is not None:
                self._brownout_max_rows = int(max_rows)
            if deadline_s is not None:
                self._brownout_deadline_s = float(deadline_s)
        self._g_brownout.set(float(level))
        logger.warning("brownout tier set to %d", level)

    def _brownout_admit(self, path: str, body: Optional[bytes]
                        ) -> Tuple[Optional[bytes], Optional[bytes]]:
        """Tiered admission under brownout: ``(body, shed)``. A non-None
        ``shed`` is the 503 payload for a tier-1 rejection (oversized
        ``sample`` slab — the largest single cost one request can
        impose); otherwise ``body`` may come back rewritten with a
        tier-2 effective-deadline cap. Malformed bodies pass through
        untouched — the worker's 400 is the client's answer, not ours."""
        with self._lock:
            level = self._brownout_level
            max_rows = self._brownout_max_rows
            deadline = self._brownout_deadline_s
        if level < 1 or body is None or not path.startswith("/v1/"):
            return body, None
        try:
            payload = json.loads(body)
        except ValueError:
            return body, None
        if not isinstance(payload, dict):
            return body, None
        data = payload.get("data")
        # row counting mirrors the worker's shape rules: a flat 1-D list
        # is ONE row (service.py reshapes it), not len(data) rows — a
        # single wide sample must never be shed as a slab
        if not isinstance(data, list) or not data:
            rows = 0
        elif isinstance(data[0], (list, tuple)):
            rows = len(data)
        else:
            rows = 1
        if path.startswith("/v1/sample") and rows > max_rows:
            self._c_brownout_sheds.labels(tier="large_slab").inc()
            return body, _json_body(
                "overloaded",
                f"brownout: sample slabs over {max_rows} rows are shed "
                f"until the fleet recovers (got {rows})")
        if level >= 2:
            timeout = payload.get("timeout")
            if timeout is not None and not isinstance(timeout, (int, float)):
                return body, None  # let the worker reject it with a 400
            if timeout is None or timeout > deadline:
                payload["timeout"] = deadline
                self._c_brownout_clamps.inc()
                body = json.dumps(payload).encode()
        return body, None

    # -- the proxy -------------------------------------------------------
    def _attempt(self, ref: WorkerRef, method: str, path: str,
                 body: Optional[bytes]) -> Tuple[int, bytes]:
        """One proxied attempt. Raises OSError-family on connection-level
        failure (dead/hung worker); returns the worker's (status, body)
        otherwise."""
        host, _, port = ref.base_url.rpartition("//")[2].partition(":")
        conn = http.client.HTTPConnection(host, int(port),
                                          timeout=self.request_timeout)
        headers = {"Content-Type": "application/json"}
        trace_id = current_trace_id()
        if trace_id is not None:
            # the propagation header: the worker's HTTP handler adopts it
            # into ITS correlation contextvar, so worker-side spans carry
            # the router's id — including a retry's second worker
            headers["X-Trace-Id"] = trace_id
        try:
            conn.request(method, path, body=body, headers=headers)
            resp = conn.getresponse()
            return resp.status, resp.read()
        finally:
            conn.close()

    def handle(self, method: str, path: str, body: Optional[bytes],
               trace_id: Optional[str] = None) -> Tuple[int, bytes]:
        """Route one ``/v1/*`` request: p2c pick, proxy, retry shed and
        connect-failed attempts on a different worker under the budget.
        Always returns exactly one response.

        ``trace_id`` is the client's ``X-Trace-Id`` (adopted when valid,
        else a fresh id is minted). The id is bound to this thread's
        correlation contextvar — the router's own route/attempt/retry
        spans pick it up — and forwarded to every worker attempt, so one
        request's spans merge into one causal chain across the router and
        every worker it was tried on, retries included. The final outcome
        and latency also feed the SLO tracker (5xx = availability
        failure; latency is measured on answered requests only)."""
        tid = sanitize_trace_id(trace_id) or new_trace_id()
        token = bind_trace_id(tid)
        t0 = time.perf_counter()
        status = 500  # an exception out of _route IS a 500 for the SLO:
        # the HTTP front end's catch-all answers the client 500, and the
        # burn rate must see it — a router-side 500-storm that bypassed
        # the tracker would leave fleet_slo_ok reporting healthy
        try:
            if TRACER.enabled:
                with TRACER.span("fleet.route", path=path):
                    status, payload = self._route(method, path, body)
            else:
                status, payload = self._route(method, path, body)
            return status, payload
        finally:
            unbind_trace_id(token)
            latency = time.perf_counter() - t0
            self.slo.record(status < 500,
                            latency if status < 500 else None)
            if self._exemplars is not None:
                # evidence for the alert plane: the trace ids of concrete
                # requests that crossed a bad threshold, linkable into
                # the merged GET /debug/trace chain
                if status >= 500:
                    self._exemplars.record("availability", tid,
                                           status=status)
                else:
                    self._h_latency.observe(latency)
                    if latency > self.slo.config.latency_threshold_s:
                        self._exemplars.record(
                            "latency", tid, status=status,
                            latency_ms=round(latency * 1e3, 3))

    def _route(self, method: str, path: str, body: Optional[bytes]
               ) -> Tuple[int, bytes]:
        self.budget.deposit()
        with self._lock:
            self._counts["proxied"] += 1
        body, shed = self._brownout_admit(path, body)
        if shed is not None:
            # an ordered, honest 503 — observable in the counters and in
            # the SLO burn (handle() records every 5xx), never a retry
            with self._lock:
                self._counts["brownout_shed"] += 1
                self._counts["error"] += 1
            self._c_requests.labels(outcome="brownout_shed").inc()
            return 503, shed
        tried: set = set()
        retryable: Optional[str] = None
        for attempt in range(self.max_attempts):
            if attempt > 0:
                if not self.budget.spend():
                    with self._lock:
                        self._counts["budget_exhausted"] += 1
                        self._counts["error"] += 1
                    self._c_exhausted.inc()
                    self._c_requests.labels(outcome="budget_exhausted").inc()
                    return 503, _json_body(
                        "overloaded",
                        f"retry budget exhausted after {retryable}")
                with self._lock:
                    self._counts["retries"] += 1
                    jitter = 0.5 + self._rng.random() * 0.5
                self._c_retries.inc()
                if TRACER.enabled:
                    TRACER.instant("fleet.retry", {
                        "attempt": attempt, "reason": retryable})
                delay = min(self.backoff_max,
                            self.backoff_base * (2 ** (attempt - 1)))
                time.sleep(delay * jitter)
            try:
                ref = self._pick(tried)
            except NoWorkerAvailable as exc:
                # fast 503, never a hang: an all-ejected fleet answers in
                # O(1) instead of blocking clients on dead sockets
                if attempt > 0:
                    # the spent token bought no retry — refund it, or a
                    # brownout with one survivor drains the shared bucket
                    # on retries that never happen
                    self.budget.refund()
                with self._lock:
                    self._counts["no_worker"] += 1
                    self._counts["error"] += 1
                self._c_requests.labels(outcome="no_worker").inc()
                return 503, _json_body("overloaded", str(exc))
            tried.add(ref.id)
            ref.begin()
            t0 = time.perf_counter()
            try:
                status, payload = self._attempt(ref, method, path, body)
            except (OSError, http.client.HTTPException) as exc:
                # connection-level failure: the worker is gone or hung —
                # passive ejection signal, retryable on another worker
                retryable = f"{type(exc).__name__}: {exc}"
                if self._exemplars is not None:
                    # ref.pid is still the DEAD process here (the manager
                    # rebinds it at relaunch): the worker_down alert's
                    # exemplars name the pid that actually failed
                    self._exemplars.record(
                        "worker_failure", current_trace_id(),
                        worker=ref.id, pid=ref.pid,
                        error=type(exc).__name__)
                ref.count("failed")
                if ref.breaker.record(False) == "tripped":
                    self._note_ejection(ref, retryable)
                continue
            finally:
                ref.end()
                if TRACER.enabled:
                    TRACER.complete("fleet.attempt", t0, time.perf_counter(),
                                    {"worker": ref.id, "path": path,
                                     "attempt": attempt})
            if status == 503:
                # the worker answered but shed (overloaded/deadline):
                # alive for the breaker, retryable for the client
                retryable = f"worker {ref.id} shed (503)"
                ref.breaker.record(True)
                ref.count("shed")
                continue
            ref.breaker.record(True)
            ref.count("ok")
            with self._lock:
                self._counts["ok" if status < 400 else "error"] += 1
            self._c_requests.labels(
                outcome="ok" if status < 400 else "worker_error").inc()
            return status, payload
        # attempts exhausted on retryable failures
        with self._lock:
            self._counts["attempts_exhausted"] += 1
            self._counts["error"] += 1
        self._c_requests.labels(outcome="attempts_exhausted").inc()
        return 503, _json_body(
            "overloaded",
            f"all {self.max_attempts} attempts failed ({retryable})")

    def _note_ejection(self, ref: WorkerRef, reason: str) -> None:
        with self._lock:
            self._counts["ejections"] += 1
        self._c_ejections.inc()
        logger.warning("worker %s ejected: %s", ref.id, reason)

    # -- the health loop -------------------------------------------------
    def start_health_loop(self) -> threading.Thread:
        with self._lock:
            if (self._health_thread is not None
                    and self._health_thread.is_alive()):
                return self._health_thread
            self._stop.clear()
            t = threading.Thread(target=self._health_loop,
                                 name="fleet-health", daemon=True)
            self._health_thread = t
        t.start()
        return t

    def stop(self, timeout: float = 5.0) -> None:
        self._stop.set()
        t = self._health_thread
        if t is not None:
            t.join(timeout)

    def health_pass(self) -> None:
        """One probe/scrape sweep over every worker (the loop body, also
        driven directly by tests and the manager's wait paths)."""
        for ref in self.workers():
            if ref.breaker.probe_due():
                ok, _ = probe_worker(ref.base_url, timeout=self.probe_timeout)
                if ref.breaker.probe_result(ok) == "admitted":
                    logger.info("worker %s admitted to the pool", ref.id)
                continue
            if not ref.breaker.routable:
                continue  # open: wait out the backoff, probe when half-open
            metrics = scrape_metrics(ref.base_url, timeout=self.probe_timeout)
            if metrics is None:
                # a hung worker with no traffic still gets ejected: the
                # scrape IS the passive signal then
                if ref.breaker.record(False) == "tripped":
                    self._note_ejection(ref, "metrics scrape failed")
            else:
                # a successful scrape is NOT recorded as a passive
                # success: a worker whose /v1 path is wedged but whose
                # HTTP server still answers /metrics must not have its
                # proxied-failure streak washed out by scrape successes
                ref.update_scrape(metrics)
        self._g_routable.set(sum(1 for w in self.workers() if w.routable))
        if self.alerts is not None:
            # the evaluation tick rides the sweep this loop already ran —
            # alerting shares the scrape, it never adds one
            try:
                self.alerts.evaluate(self.alert_view())
            except Exception:
                logger.exception("alert evaluation failed")
        else:
            self.member_signals()  # keep the member gauges fresh anyway

    def _health_loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.health_pass()
            except Exception:  # a probe bug must not kill the loop
                logger.exception("health pass failed")
            self._stop.wait(self.probe_interval)

    # -- the alert plane (telemetry/alerts.py) ----------------------------
    def attach_alerts(self, manager) -> None:
        """Attach an :class:`~...telemetry.alerts.AlertManager`: the
        health loop ticks its evaluation over :meth:`alert_view`, the
        request path starts feeding the latency histogram and exemplar
        store, and ``GET /alerts`` + the ``/healthz`` block go live.
        Never attached, none of those series or ring buffers exist."""
        registry = get_registry()
        self._h_latency = registry.histogram(
            "fleet_request_latency_seconds",
            "client-visible latency of answered (non-5xx) routed "
            "requests — the latency-anomaly rule's input (bounded "
            "samples, so the p99 tracks recent behavior)",
            max_samples=512)
        self._g_pressure = registry.gauge(
            "fleet_pressure",
            "queue+in-flight per routable worker (NaN when none is "
            "routable — fail closed)")
        self._exemplars = manager.exemplars
        self.alerts = manager

    def annotate_member(self, labels: dict) -> dict:
        """Annotation hook for member-scoped rules: worker id -> the
        facts an operator reaches for first (pid, url, breaker state)."""
        try:
            ref = self.worker(str(labels.get("worker")))
        except KeyError:
            return {}
        return {"pid": ref.pid, "base_url": ref.base_url,
                "breaker": ref.breaker.snapshot().get("state")}

    def member_signals(self) -> dict:
        """One pass over the health loop's already-scraped worker state:
        routable/queue/in-flight totals plus per-member staleness — and
        the refresh of the ``fleet_member_*`` (and, with the alert plane
        attached, ``fleet_pressure``) gauges. THE shared seam: the
        autoscaler's tick and the alert evaluator both read this instead
        of paying a second per-worker HTTP fan-out."""
        routable = queue = inflight = 0
        ages: Dict[str, Optional[float]] = {}
        for ref in self.workers():
            snap = ref.snapshot()
            up = bool(snap["routable"])
            if up:
                routable += 1
            queue += int(snap.get("queue_depth") or 0)
            inflight += int(snap.get("inflight") or 0)
            age = snap.get("last_scrape_age_s")
            ages[ref.id] = age
            self._g_member_routable.labels(worker=ref.id).set(
                1.0 if up else 0.0)
            self._g_member_scrape_age.labels(worker=ref.id).set(
                float("nan") if age is None else float(age))
        # reconcile: a tick racing remove_worker can re-create a retired
        # member's series AFTER the removal (list snapshotted above) —
        # and with the ref gone, nothing would ever touch it again, so
        # worker_down would page forever on a scale-down. Prune any
        # series whose member is no longer registered.
        for fam in (self._g_member_routable, self._g_member_scrape_age):
            for labels, _ in fam.series():
                if labels.get("worker") not in ages:
                    fam.remove(**labels)
        if self._g_pressure is not None:
            self._g_pressure.set(
                ((queue + inflight) / routable) if routable
                else float("nan"))
        return {"routable": routable, "queue_depth": queue,
                "in_flight": inflight, "scrape_age_s": ages}

    def alert_view(self) -> dict:
        """The alert evaluator's input: the same snapshot-shaped payload
        ``GET /metrics?scope=fleet`` is built from, assembled purely
        from signals already in this process (the router/manager/
        autoscaler registry plus the health loop's member scrapes,
        refreshed through :meth:`member_signals`) — evaluation adds no
        second per-worker HTTP fan-out. The evaluator is snapshot-shape
        generic, so it also consumes an actual merged fleet snapshot
        unchanged (tested)."""
        self.slo.snapshot()  # refresh the burn-rate gauges
        self.member_signals()
        return get_registry().snapshot(include_samples=True)

    # -- fleet-scale observability ---------------------------------------
    def fleet_metrics_snapshot(self) -> dict:
        """``GET /metrics?scope=fleet`` — fan out to every registered
        worker's ``/metrics?scope=registry`` (samples included, so merged
        histogram percentiles keep the nearest-rank contract), merge with
        this router process's own registry, and return ONE snapshot.
        A worker that fails to answer becomes a labeled gap
        (``fleet_member_up{worker=...} 0``), never an error."""
        self.slo.snapshot()  # refresh the burn-rate gauges into the scrape
        parts: Dict[str, dict] = {}
        gaps: List[str] = []
        member_labels: Dict[str, dict] = {}
        for ref, snap in self._fan_out("/metrics?scope=registry"):
            if isinstance(snap, dict) and snap:
                parts[ref.id] = snap
                # the model/generation dimension: two workers serving
                # different generations (mid-roll, or a mux fleet) must
                # not have their per-model counter series summed into
                # one — the worker's scraped generation labels every
                # series it contributes (docs/MULTIPLEX.md)
                gen = ref.generation
                if gen is not None:
                    member_labels[ref.id] = {"generation": str(gen)}
            else:
                gaps.append(ref.id)
        parts["router"] = get_registry().snapshot(include_samples=True)
        return merge_snapshots(parts, gaps=gaps,
                               member_labels=member_labels)

    def _fan_out(self, path: str):
        """Concurrent bounded GETs of ``path`` on every registered worker:
        [(ref, json_or_None)]. Concurrency matters — sequentially, K
        unreachable workers would cost K × probe_timeout per fleet scrape;
        fanned out the whole sweep is bounded by ~one probe_timeout."""
        refs = self.workers()
        if not refs:
            return []
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(min(8, len(refs))) as pool:
            return list(zip(refs, pool.map(
                lambda ref: http_json(f"{ref.base_url}{path}",
                                      timeout=self.probe_timeout),
                refs)))

    def fleet_trace(self) -> dict:
        """``GET /debug/trace`` — ONE Chrome/Perfetto trace for the whole
        fleet: this process's spans plus every worker's ``/debug/spans``,
        concatenated (valid because every tracer pins timestamps to the
        wall epoch and stamps its own pid — each process renders as its
        own track, and one trace id threads a request across them)."""
        docs: Dict[str, Optional[dict]] = {
            "router": TRACER.chrome_trace({"source": "fleet.router"}),
        }
        for ref, doc in self._fan_out("/debug/spans"):
            docs[ref.id] = doc
        return merge_traces(docs, metadata={"source": "fleet"})

    # -- observability ---------------------------------------------------
    def healthz(self) -> dict:
        workers = [w.snapshot() for w in self.workers()]
        routable = [w for w in workers if w["routable"]]
        generations = sorted({w["generation"] for w in routable
                              if w["generation"] is not None})
        with self._lock:
            level = self._brownout_level
            max_rows = self._brownout_max_rows
            deadline = self._brownout_deadline_s
        # "brownout" outranks "ok": the fleet is serving, but degraded —
        # by design, not by accident — and a dashboard must say so
        status = ("down" if not routable
                  else "brownout" if level > 0 else "ok")
        body = {
            "status": status,
            "brownout": {"active": level > 0, "level": level,
                         "max_sample_rows": max_rows,
                         "deadline_cap_s": deadline},
            "role": "router",
            "workers": workers,
            "routable": len(routable),
            # the fleet generation: the one every routable worker agrees
            # on, else None (mid-roll)
            "generation": generations[0] if len(generations) == 1 else None,
            "generations": generations,
            # burn rates + the fail-closed admission signal — informational
            # here ("status" stays routability-driven); the autoscaler and
            # upgrade gate read slo["ok"]
            "slo": self.slo.snapshot(),
        }
        if self.alerts is not None:
            # the compact "is anything firing" block; GET /alerts has the
            # full instances/exemplars/incidents payload
            body["alerts"] = self.alerts.health_block()
        if self.manager is not None:
            body["fleet"] = self.manager.status()
        return body

    def metrics(self) -> dict:
        with self._lock:
            counts = dict(self._counts)
            level = self._brownout_level
        return {
            **counts,
            "retry_budget_tokens": self.budget.tokens,
            "brownout_level": level,
            "slo": self.slo.snapshot(),
            "workers": [w.snapshot() for w in self.workers()],
        }


def _json_body(status: str, error: str) -> bytes:
    return json.dumps({"status": status, "error": error}).encode()


def scrape_metrics(base_url: str, timeout: float = 2.0) -> Optional[dict]:
    """One bounded ``GET /metrics`` scrape; None on any failure."""
    return http_json(f"{base_url}/metrics", timeout=timeout)


# -- HTTP front end ---------------------------------------------------------

class _RouterHandler(BaseHTTPRequestHandler):
    router: FleetRouter = None  # bound by make_router_server

    def _respond(self, status: int, body: bytes,
                 content_type: str = "application/json",
                 extra_headers: Optional[dict] = None) -> None:
        self.send_response(status)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(body)))
        for name, value in (extra_headers or {}).items():
            self.send_header(name, value)
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):  # noqa: N802 (http.server naming contract)
        try:
            route, _, query = self.path.partition("?")
            params = parse_qs(query) if query else {}
            if route == "/healthz":
                self._respond(200, json.dumps(self.router.healthz()).encode())
            elif route == "/metrics":
                if params.get("scope", [""])[0] == "fleet":
                    snap = self.router.fleet_metrics_snapshot()
                    if "prom" in params.get("format", []):
                        self._respond(
                            200, snapshot_to_prometheus(snap).encode(),
                            content_type="text/plain; version=0.0.4; "
                                         "charset=utf-8")
                    else:
                        # NaN (empty-window SLO gauges) → null: strict
                        # JSON parsers reject a literal NaN token
                        self._respond(200, json.dumps(
                            json_sanitize(snap)).encode())
                else:
                    self._respond(200,
                                  json.dumps(self.router.metrics()).encode())
            elif route == "/debug/trace":
                # the merged fleet trace (router spans + every worker's
                # /debug/spans) as one Perfetto-loadable document
                self._respond(200,
                              json.dumps(self.router.fleet_trace()).encode())
            elif route == "/alerts":
                if self.router.alerts is None:
                    self._respond(404, _json_body(
                        "error", "no alert plane (start with --alerts)"))
                elif "prom" in params.get("format", []):
                    self._respond(
                        200, self.router.alerts.to_prometheus().encode(),
                        content_type="text/plain; version=0.0.4; "
                                     "charset=utf-8")
                else:
                    self._respond(200, json.dumps(json_sanitize(
                        self.router.alerts.snapshot())).encode())
            else:
                self._respond(404, _json_body("error",
                                              f"no route GET {route}"))
        except Exception as exc:  # a handler bug must answer, not reset
            logger.exception("GET %s failed", self.path)
            self._respond(500, _json_body(
                "error", f"{type(exc).__name__}: {exc}"))

    def do_POST(self):  # noqa: N802
        try:
            route, _, query = self.path.partition("?")
            length = int(self.headers.get("Content-Length") or 0)
            body = self.rfile.read(length) if length else None
            if route.startswith("/v1/"):
                # adopt the client's trace id (sanitized) or mint one HERE
                # so the response can echo the id the spans carry
                tid = (sanitize_trace_id(self.headers.get("X-Trace-Id"))
                       or new_trace_id())
                status, payload = self.router.handle(
                    "POST", self.path, body, trace_id=tid)
                self._respond(status, payload,
                              extra_headers={"X-Trace-Id": tid})
                return
            if route == "/admin/poll" and self.router.manager is not None:
                params = parse_qs(query) if query else {}
                wait = params.get("block", ["0"])[0] not in ("0", "",
                                                             "false")
                state = self.router.manager.poll_now(wait=wait)
                self._respond(200 if wait else 202, json.dumps(
                    {"status": "ok", "fleet": state}).encode())
                return
            self._respond(404, _json_body("error", f"no route POST {route}"))
        except Exception as exc:
            logger.exception("POST %s failed", self.path)
            self._respond(500, _json_body(
                "error", f"{type(exc).__name__}: {exc}"))

    def log_message(self, fmt, *args):  # route to logging, not stderr
        logger.debug("%s - %s", self.address_string(), fmt % args)


def make_router_server(router: FleetRouter, host: str = "127.0.0.1",
                       port: int = 8100) -> ThreadingHTTPServer:
    """Bind (but do not start) the router's HTTP front end; ``port=0``
    picks a free port (tests)."""
    handler = type("BoundRouterHandler", (_RouterHandler,),
                   {"router": router})
    return ThreadingHTTPServer((host, port), handler)
