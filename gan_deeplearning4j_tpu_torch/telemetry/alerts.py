"""Fleet alerting & anomaly detection — the plane that tells a human.

The PyTorch port's copy of ``gan_deeplearning4j_tpu/telemetry/alerts.py`` (plain
Python, no JAX), kept inside the port so that it imports nothing of the
JAX package.

The registry measures, the aggregate merges fleet-wide, and the control
loops act on it — but every one of those consumers is a machine. This
module is the third leg of the observability plane
(tracing, metrics, **alerting**): a declarative rule engine evaluated
over the SAME snapshot-shaped payload ``GET /metrics?scope=fleet``
serves, with a full alert lifecycle, hysteresis, trace exemplars, and
pluggable delivery (docs/OBSERVABILITY.md "Alerting").

**Rule kinds** (:class:`AlertRule.kind`):

- ``threshold`` — a gauge value (or a counter's per-second rate with
  ``rate=True``) compared against a bound. One alert *instance* per
  matching labeled series, so ``fleet_member_routable < 1`` fans out
  into one ``worker_down{worker=...}`` per member.
- ``absence`` — the expected series is missing from the snapshot. The
  silent failure mode: a subsystem that stops reporting looks exactly
  like a subsystem with nothing to report, unless absence itself alarms.
- ``burn`` — the multi-window SLO semantics of :mod:`.slo`, read back
  off the exported ``*_slo_burn_rate{...,window}`` gauges: an objective
  breaches only when BOTH its fast and slow windows are at/over the
  threshold; NaN (empty window) qualifies nothing. Series group by
  their non-window labels, so one rule over ``mux_slo_burn_rate``
  yields one instance per model (the mux plane's per-model scoping).
- ``anomaly`` — a rolling median+MAD robust z-score over a histogram
  percentile (or a gauge), catching the drift no static threshold
  names: p99 latency creeping from 8 ms to 80 ms is invisible to a
  500 ms bound and obvious to a baseline. MAD (not stddev) so the
  baseline survives its own outliers; breached observations are NOT
  absorbed into the baseline (an incident must not normalize itself).

**Fail-closed three-valued evaluation**: every evaluation yields breach,
clear, or *undefined* (NaN value, empty window, not enough baseline
points, series temporarily unscraped). Undefined can move an alert to
``pending`` — "cannot prove healthy" — but never to ``firing``, and it
never RESOLVES a firing alert either: no data is not evidence in either
direction (the same stance :mod:`.slo` and the autoscaler take).

**Lifecycle with per-direction hysteresis**::

    inactive -> pending(for_ticks) -> firing
    firing   -> resolved(keep_firing_ticks) -> inactive

Entering ``firing`` takes ``for_ticks`` consecutive breaches; leaving it
takes ``keep_firing_ticks`` consecutive clears; ``resolved`` stays
visible for ``resolved_hold_ticks`` so a dashboard shows what just
happened. A flapping signal therefore costs at most one transition per
full hysteresis window — it cannot page-storm. ``arm_on_first_clear``
holds a rule's breaches until the series has been healthy once (a
booting fleet is not a down fleet).

**Exemplars**: a firing alert captures up to ``exemplar_k`` recent
entries from its :class:`ExemplarStore` category — the trace ids (and
labels) of concrete requests that crossed the bad threshold, recorded by
the router on failed attempts, 5xx answers, and slow answers. An alert
is then one click from evidence: the ids link straight into the merged
``GET /debug/trace`` chain.

**Surfaces**: ``GET /alerts`` (JSON, and ``?format=prom`` rendering the
Prometheus-convention ``ALERTS{alertname,severity,state}`` series),
an ``alerts`` block in ``/healthz``, ``fleet_alerts_total
{alertname,state}`` transition counters in the process registry, a
bounded JSON incident ring, and pluggable sinks — :func:`log_sink`
(structured log line) and :class:`WebhookSink` (bounded-timeout,
bounded-retry POST from its own thread, never the evaluation path).

**Cost contract**: the evaluator reads snapshots it is handed — it owns
no scrape and adds no per-worker fan-out (the router ticks it from the
health loop it already runs). A process that never constructs an
:class:`AlertManager` allocates zero new metric series — the
telemetry-off contract.

Stdlib-only, like the rest of the metrics plane.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import math
import threading
import time
import urllib.request
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from gan_deeplearning4j_tpu_torch.telemetry.registry import get_registry

logger = logging.getLogger(__name__)

#: lifecycle states, in escalation order
STATES = ("inactive", "pending", "firing", "resolved")

KINDS = ("threshold", "absence", "burn", "anomaly")

_OPS = {
    ">": lambda v, b: v > b,
    ">=": lambda v, b: v >= b,
    "<": lambda v, b: v < b,
    "<=": lambda v, b: v <= b,
}

#: the scale factor making the MAD a consistent estimator of the
#: standard deviation under normality — the conventional robust-z form
_MAD_K = 0.6745


def _to_float(value) -> float:
    """Snapshot values as floats; ``None`` (a JSON-sanitized NaN) and
    anything non-numeric read as NaN — undefined, never a crash."""
    if isinstance(value, bool) or not isinstance(value, (int, float)):
        return float("nan")
    return float(value)


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in (labels or {}).items()))


@dataclasses.dataclass
class AlertRule:
    """One declarative rule (module docstring for the kinds)."""

    name: str
    kind: str
    #: metric family the rule reads (every kind reads exactly one; the
    #: jaxlint JG023 rule cross-checks literal names against the
    #: families the tree actually creates)
    metric: str = ""
    #: label filter: only series carrying these labels participate
    labels: dict = dataclasses.field(default_factory=dict)
    severity: str = "page"  # "page" | "warn"
    description: str = ""
    # -- threshold ----------------------------------------------------
    op: str = ">"
    bound: float = float("nan")
    #: compare the per-second counter rate instead of the raw value
    rate: bool = False
    # -- burn ---------------------------------------------------------
    objective: str = "availability"
    burn_threshold: float = 1.0
    # -- anomaly ------------------------------------------------------
    #: histogram percentile key ("p50"/"p95"/"p99"); None = gauge value
    field: Optional[str] = "p99"
    window: int = 120        # rolling baseline observations kept
    min_points: int = 16     # baseline size below which eval is undefined
    z_max: float = 8.0       # robust z bound
    direction: str = "above"  # "above" | "below" | "both"
    #: MAD floor as a fraction of |median|: a near-constant baseline has
    #: MAD ~0, which would turn ordinary jitter into an infinite z —
    #: the floor means a breach needs a shift of at least
    #: ~z_max * mad_floor_frac / 0.6745 relative to the baseline
    mad_floor_frac: float = 0.05
    #: absolute MAD floor, for series whose healthy median is ~0 (queue
    #: depths, pressure): with median 0 the relative floor vanishes and
    #: a blip of 1 would z to infinity — the absolute floor states the
    #: smallest deviation worth a standard unit
    mad_floor_abs: float = 0.0
    # -- lifecycle ----------------------------------------------------
    for_ticks: int = 2
    keep_firing_ticks: int = 3
    resolved_hold_ticks: int = 8
    #: hold breaches until the series has evaluated clear once — a
    #: booting worker is not a down worker
    arm_on_first_clear: bool = False
    # -- evidence -----------------------------------------------------
    exemplar_category: Optional[str] = None
    exemplar_k: int = 4
    #: optional enrichment hook: instance labels -> extra annotations,
    #: called at the pending transition (the router maps a worker id to
    #: its pid here). Excluded from serialization.
    annotate: Optional[Callable[[dict], dict]] = None

    def validate(self) -> "AlertRule":
        if not self.name:
            raise ValueError("rule needs a name")
        if self.kind not in KINDS:
            raise ValueError(f"{self.name}: unknown kind {self.kind!r} "
                             f"(want one of {KINDS})")
        if not self.metric:
            raise ValueError(f"{self.name}: needs a metric family name")
        if self.kind == "threshold":
            if self.op not in _OPS:
                raise ValueError(f"{self.name}: unknown op {self.op!r}")
            if math.isnan(self.bound):
                raise ValueError(f"{self.name}: threshold needs a bound")
        if self.kind == "anomaly":
            if self.direction not in ("above", "below", "both"):
                raise ValueError(
                    f"{self.name}: direction {self.direction!r}")
            if self.window < self.min_points or self.min_points < 2:
                raise ValueError(
                    f"{self.name}: need window >= min_points >= 2")
            if self.z_max <= 0:
                raise ValueError(f"{self.name}: z_max must be > 0")
            if self.mad_floor_frac < 0 or self.mad_floor_abs < 0:
                raise ValueError(
                    f"{self.name}: mad floors must be >= 0")
        if self.for_ticks < 1 or self.keep_firing_ticks < 1:
            raise ValueError(
                f"{self.name}: for_ticks and keep_firing_ticks must be "
                f">= 1 (the hysteresis)")
        if self.resolved_hold_ticks < 0:
            raise ValueError(f"{self.name}: resolved_hold_ticks >= 0")
        if self.severity not in ("page", "warn"):
            raise ValueError(f"{self.name}: severity {self.severity!r}")
        return self

    def describe(self) -> dict:
        body = {
            "name": self.name, "kind": self.kind, "metric": self.metric,
            "labels": dict(self.labels), "severity": self.severity,
            "for_ticks": self.for_ticks,
            "keep_firing_ticks": self.keep_firing_ticks,
        }
        if self.kind == "threshold":
            body.update(op=self.op, bound=self.bound, rate=self.rate)
        elif self.kind == "burn":
            body.update(objective=self.objective,
                        burn_threshold=self.burn_threshold)
        elif self.kind == "anomaly":
            body.update(field=self.field, window=self.window,
                        min_points=self.min_points, z_max=self.z_max,
                        direction=self.direction)
        if self.description:
            body["description"] = self.description
        return body


class ExemplarStore:
    """Bounded per-category ring of bad-request evidence. ``record`` is
    hot-path adjacent (the router calls it on failures/slow answers) —
    one lock, one append; everything is dropped-oldest bounded."""

    def __init__(self, per_category: int = 128,
                 wall_clock: Callable[[], float] = time.time):
        self._per_category = per_category
        self._wall = wall_clock
        self._lock = threading.Lock()
        self._categories: Dict[str, deque] = {}

    def record(self, category: str, trace_id: Optional[str],
               **labels) -> None:
        entry = {"trace_id": trace_id, "t": self._wall(),
                 **{k: v for k, v in labels.items() if v is not None}}
        with self._lock:
            ring = self._categories.get(category)
            if ring is None:
                ring = self._categories[category] = deque(
                    maxlen=self._per_category)
            ring.append(entry)

    def recent(self, category: str, k: int = 4,
               match: Optional[dict] = None) -> List[dict]:
        """Newest-first entries of ``category`` whose labels carry every
        ``match`` pair (compared as strings — instance labels are)."""
        with self._lock:
            entries = list(self._categories.get(category, ()))
        out = []
        for entry in reversed(entries):
            if match and any(str(entry.get(mk)) != str(mv)
                             for mk, mv in match.items()):
                continue
            out.append(dict(entry))
            if len(out) >= k:
                break
        return out

    def snapshot(self) -> dict:
        with self._lock:
            return {cat: list(ring)
                    for cat, ring in sorted(self._categories.items())}


# -- sinks -------------------------------------------------------------------

def log_sink(record: dict) -> None:
    """Structured one-line delivery: greppable, machine-parseable, and
    present even when no webhook is configured."""
    level = (logging.WARNING if record.get("to") in ("pending", "firing")
             else logging.INFO)
    logger.log(level, "ALERT %s", json.dumps(record, sort_keys=True,
                                             default=str))


class WebhookSink:
    """POST each transition to ``url`` as JSON — from a daemon thread
    over a bounded drop-oldest queue, with a bounded timeout and bounded
    retries, so a dead receiver can neither stall alert evaluation nor
    accumulate unbounded state (jaxlint JG017 polices the timeout)."""

    def __init__(self, url: str, *, timeout: float = 2.0, retries: int = 2,
                 backoff_s: float = 0.5, max_queue: int = 64):
        if timeout <= 0 or retries < 0 or backoff_s < 0:
            raise ValueError("need timeout > 0, retries >= 0, backoff >= 0")
        self.url = url
        self.timeout = timeout
        self.retries = retries
        self.backoff_s = backoff_s
        self.sent = 0
        self.failed = 0
        self._queue: deque = deque(maxlen=max_queue)
        self._event = threading.Event()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run,
                                        name="alert-webhook", daemon=True)
        self._thread.start()

    def __call__(self, record: dict) -> None:
        self._queue.append(record)
        self._event.set()

    def _run(self) -> None:
        while not self._stop.is_set():
            self._event.wait(0.5)
            self._event.clear()
            while True:
                try:
                    record = self._queue.popleft()
                except IndexError:
                    break
                self._deliver(record)

    def _deliver(self, record: dict) -> None:
        body = json.dumps(record, default=str).encode()
        for attempt in range(self.retries + 1):
            try:
                req = urllib.request.Request(
                    self.url, data=body,
                    headers={"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=self.timeout):
                    self.sent += 1
                    return
            except Exception:
                # OSError is the common case, but a malformed URL
                # (ValueError) or a garbage status line (HTTPException)
                # must not kill the delivery thread — a dead thread
                # silently drops every FUTURE page while evaluation
                # keeps running
                if attempt < self.retries:
                    self._stop.wait(self.backoff_s * (2 ** attempt))
        self.failed += 1

    def close(self, timeout: float = 2.0) -> None:
        self._stop.set()
        self._event.set()
        self._thread.join(timeout)


# -- snapshot reading --------------------------------------------------------

def _matching_series(snapshot: dict, metric: str, match: dict) -> list:
    fam = snapshot.get(metric)
    if not isinstance(fam, dict):
        return []
    series = fam.get("series")
    if not isinstance(series, list):
        return []
    out = []
    for s in series:
        if not isinstance(s, dict):
            continue
        labels = s.get("labels") or {}
        if all(str(labels.get(k)) == str(v) for k, v in match.items()):
            out.append(s)
    return out


class _InstanceState:
    """Lifecycle state of one (rule, labeled series) alert instance."""

    __slots__ = ("labels", "state", "since_wall", "pending", "clears",
                 "hold", "armed", "value", "annotations", "exemplars",
                 "unobserved", "baseline", "last_counter")

    def __init__(self, labels: dict):
        self.labels = dict(labels)
        self.state = "inactive"
        self.since_wall: Optional[float] = None
        self.pending = 0        # consecutive breaches toward firing
        self.clears = 0         # consecutive clears toward resolved
        self.hold = 0           # resolved-visibility countdown
        self.armed = False
        self.value: float = float("nan")
        self.annotations: dict = {}
        self.exemplars: List[dict] = []
        self.unobserved = 0
        self.baseline: Optional[deque] = None   # anomaly rolling window
        self.last_counter: Optional[Tuple[float, float]] = None  # (v, t)


class AlertManager:
    """The evaluator: rules in, transitions out (module docstring).

    ``evaluate(snapshot)`` is the tick — the router drives it from the
    health loop it already runs, handing it the same snapshot-shaped
    dict ``GET /metrics?scope=fleet`` is built from. ``clock`` feeds the
    rate rules (monotonic), ``wall_clock`` stamps incidents (the trace
    overlay in ``scripts/trace_report.py --alerts`` joins them to the
    wall-epoch span timeline)."""

    def __init__(self, rules: List[AlertRule], *,
                 clock: Callable[[], float] = time.monotonic,
                 wall_clock: Callable[[], float] = time.time,
                 exemplars: Optional[ExemplarStore] = None,
                 sinks: Tuple[Callable[[dict], None], ...] = (),
                 max_incidents: int = 256):
        names = [r.name for r in rules]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate rule names in {sorted(names)}")
        self.rules = [r.validate() for r in rules]
        self._clock = clock
        self._wall = wall_clock
        self.exemplars = exemplars or ExemplarStore(wall_clock=wall_clock)
        self.sinks = tuple(sinks)
        self._lock = threading.Lock()
        self._states: Dict[str, Dict[tuple, _InstanceState]] = {
            r.name: {} for r in self.rules}
        self.incidents: deque = deque(maxlen=max_incidents)
        self._ticks = 0
        self._c_transitions = get_registry().counter(
            "fleet_alerts_total",
            "alert lifecycle transitions by alertname and entered state",
            labelnames=("alertname", "state"))

    # -- evaluation ------------------------------------------------------
    def evaluate(self, snapshot: dict) -> List[dict]:
        """One tick over a snapshot-shaped dict; returns the transition
        records emitted (also appended to the incident ring, counted in
        ``fleet_alerts_total``, and delivered to every sink)."""
        now = self._clock()
        transitions: List[dict] = []
        with self._lock:
            self._ticks += 1
            for rule in self.rules:
                states = self._states[rule.name]
                observed = self._observe(rule, snapshot, states, now)
                for key, (labels, value, verdict) in observed.items():
                    st = states.get(key)
                    if st is None:
                        st = states[key] = _InstanceState(labels)
                    st.unobserved = 0
                    st.value = value
                    self._step(rule, st, verdict, transitions)
                # series that vanished from the snapshot: undefined — a
                # firing alert holds briefly, then resolves (the series
                # being GONE is no longer evidence of an ongoing breach:
                # a retired worker must not page forever); idle states GC
                for key in list(states):
                    if key in observed:
                        continue
                    st = states[key]
                    st.unobserved += 1
                    if (st.state == "firing"
                            and st.unobserved >= rule.keep_firing_ticks):
                        self._transition(rule, st, "resolved", transitions,
                                         reason="series gone")
                    elif st.state == "resolved":
                        st.hold += 1
                        if st.hold >= rule.resolved_hold_ticks:
                            self._transition(rule, st, "inactive",
                                             transitions)
                    elif (st.state in ("inactive", "pending")
                          and st.unobserved >= 64):
                        del states[key]
        for record in transitions:
            for sink in self.sinks:
                try:
                    sink(record)
                except Exception:  # a sink bug must not kill evaluation
                    logger.exception("alert sink failed")
        return transitions

    # -- per-kind observation: key -> (labels, value, verdict) -----------
    def _observe(self, rule: AlertRule, snapshot: dict, states, now
                 ) -> Dict[tuple, tuple]:
        if rule.kind == "absence":
            present = bool(_matching_series(snapshot, rule.metric,
                                            rule.labels))
            # one instance, keyed by the rule's own filter; missing IS
            # the breach
            return {_label_key(rule.labels):
                    (dict(rule.labels), 0.0 if present else float("nan"),
                     not present)}
        if rule.kind == "burn":
            return self._observe_burn(rule, snapshot)
        out: Dict[tuple, tuple] = {}
        for s in _matching_series(snapshot, rule.metric, rule.labels):
            labels = dict(s.get("labels") or {})
            key = _label_key(labels)
            st = states.setdefault(key, _InstanceState(labels))
            if rule.kind == "threshold":
                value, verdict = self._eval_threshold(rule, s, st, now)
            else:  # anomaly
                value, verdict = self._eval_anomaly(rule, s, st)
            out[key] = (labels, value, verdict)
        return out

    def _eval_threshold(self, rule: AlertRule, series: dict,
                        st: _InstanceState, now: float):
        value = _to_float(series.get("value"))
        if rule.rate:
            if st.last_counter is None:
                rate = float("nan")  # no previous point yet
            else:
                prev_v, prev_t = st.last_counter
                dt = now - prev_t
                dv = value - prev_v
                # a counter that went DOWN restarted; the interval is
                # undefined, not negative traffic
                rate = (dv / dt) if (dt > 0 and dv >= 0) else float("nan")
            if not math.isnan(value):
                st.last_counter = (value, now)
            value = rate
        if math.isnan(value):
            return value, None
        return value, _OPS[rule.op](value, rule.bound)

    def _eval_anomaly(self, rule: AlertRule, series: dict,
                      st: _InstanceState):
        value = _to_float(series.get(rule.field)
                          if rule.field else series.get("value"))
        if st.baseline is None:
            st.baseline = deque(maxlen=rule.window)
        if math.isnan(value):
            return value, None  # undefined; baseline untouched
        verdict: Optional[bool] = None
        if len(st.baseline) >= rule.min_points:
            data = sorted(st.baseline)
            median = data[len(data) // 2]
            mad = sorted(abs(x - median) for x in data)[len(data) // 2]
            # MAD floors: a near-flat baseline must not turn ordinary
            # jitter into an infinite z (mad_floor_* docstrings)
            mad = max(mad, abs(median) * rule.mad_floor_frac,
                      rule.mad_floor_abs, 1e-9)
            z = _MAD_K * (value - median) / mad
            if rule.direction == "above":
                verdict = z > rule.z_max
            elif rule.direction == "below":
                verdict = -z > rule.z_max
            else:
                verdict = abs(z) > rule.z_max
        if verdict is not True:
            # breached observations never join the baseline — an
            # incident must not normalize itself into the new normal
            st.baseline.append(value)
        return value, verdict

    def _observe_burn(self, rule: AlertRule, snapshot: dict
                      ) -> Dict[tuple, tuple]:
        """Group the burn-rate gauge's series by their non-window labels
        (one instance per model/tracker), require the rule's objective,
        and breach only when BOTH windows are at/over the threshold —
        the :mod:`.slo` multi-window semantics, read back off the
        exported gauges. Any NaN or missing window is undefined."""
        match = {**rule.labels, "objective": rule.objective}
        groups: Dict[tuple, Dict[str, float]] = {}
        group_labels: Dict[tuple, dict] = {}
        for s in _matching_series(snapshot, rule.metric, match):
            labels = dict(s.get("labels") or {})
            window = labels.pop("window", None)
            if window not in ("fast", "slow"):
                continue
            key = _label_key(labels)
            groups.setdefault(key, {})[window] = _to_float(s.get("value"))
            group_labels[key] = labels
        out: Dict[tuple, tuple] = {}
        for key, windows in groups.items():
            fast = windows.get("fast", float("nan"))
            slow = windows.get("slow", float("nan"))
            value = max(fast, slow) if not (
                math.isnan(fast) or math.isnan(slow)) else float("nan")
            if math.isnan(value):
                verdict: Optional[bool] = None
            else:
                verdict = (fast >= rule.burn_threshold
                           and slow >= rule.burn_threshold)
            out[key] = (group_labels[key], value, verdict)
        return out

    # -- the lifecycle state machine -------------------------------------
    def _step(self, rule: AlertRule, st: _InstanceState,
              verdict: Optional[bool], transitions: List[dict]) -> None:
        if verdict is False:
            st.armed = True
        elif rule.arm_on_first_clear and not st.armed:
            # breaches (and no-data) before the first healthy evaluation
            # are boot noise, not regressions
            verdict = None
        if verdict is None:
            # fail closed: no data may move inactive to pending ("cannot
            # prove healthy"), but it never advances toward firing and
            # never resolves a firing alert — including indirectly: a
            # data gap RESETS the clear streak, or two non-consecutive
            # clears separated by a blind spot (a scrape wedging during
            # the very incident being alerted on) would resolve a live
            # breach. Unarmed arm_on_first_clear instances stay
            # inactive — boot grace is what arming is for.
            if st.state == "firing":
                st.clears = 0
            elif (st.state == "inactive"
                    and (st.armed or not rule.arm_on_first_clear)):
                self._transition(rule, st, "pending", transitions,
                                 reason="no data")
            elif st.state == "resolved":
                st.hold += 1
                if st.hold >= rule.resolved_hold_ticks:
                    self._transition(rule, st, "inactive", transitions)
            return
        if verdict:
            if st.state in ("inactive", "resolved"):
                self._transition(rule, st, "pending", transitions)
                st.pending = 1
            elif st.state == "pending":
                st.pending += 1
            else:  # firing: fresh evidence re-arms the resolve hysteresis
                st.clears = 0
                return
            if st.pending >= rule.for_ticks:
                self._transition(rule, st, "firing", transitions)
            return
        # verdict is False — clear
        if st.state == "pending":
            self._transition(rule, st, "inactive", transitions)
        elif st.state == "firing":
            st.clears += 1
            if st.clears >= rule.keep_firing_ticks:
                self._transition(rule, st, "resolved", transitions)
        elif st.state == "resolved":
            st.hold += 1
            if st.hold >= rule.resolved_hold_ticks:
                self._transition(rule, st, "inactive", transitions)

    def _transition(self, rule: AlertRule, st: _InstanceState, to: str,
                    transitions: List[dict], reason: str = "") -> None:
        prev = st.state
        st.state = to
        st.since_wall = self._wall()
        if to == "pending":
            st.pending = 0
            st.clears = 0
            st.exemplars = []
            if rule.annotate is not None:
                try:
                    st.annotations = dict(rule.annotate(st.labels) or {})
                except Exception:
                    logger.exception("annotate hook failed for %s",
                                     rule.name)
        elif to == "firing":
            st.clears = 0
            if rule.exemplar_category:
                st.exemplars = self.exemplars.recent(
                    rule.exemplar_category, k=rule.exemplar_k,
                    match={k: v for k, v in st.labels.items()
                           if k in ("worker", "model")})
        elif to == "resolved":
            st.hold = 0
        elif to == "inactive":
            st.pending = st.clears = st.hold = 0
        record = {
            "t": st.since_wall,
            "alert": rule.name,
            "severity": rule.severity,
            "labels": dict(st.labels),
            "from": prev,
            "to": to,
            "value": None if math.isnan(st.value) else st.value,
        }
        if reason:
            record["reason"] = reason
        if st.annotations:
            record["annotations"] = dict(st.annotations)
        if to == "firing" and st.exemplars:
            record["exemplars"] = list(st.exemplars)
        self.incidents.append(record)
        transitions.append(record)
        self._c_transitions.labels(alertname=rule.name, state=to).inc()

    # -- surfaces --------------------------------------------------------
    def active(self) -> List[dict]:
        """Every non-inactive alert instance (the ``/alerts`` payload's
        core), firing first."""
        out: List[dict] = []
        with self._lock:
            for rule in self.rules:
                for st in self._states[rule.name].values():
                    if st.state == "inactive":
                        continue
                    entry = {
                        "alert": rule.name,
                        "severity": rule.severity,
                        "state": st.state,
                        "labels": dict(st.labels),
                        "value": (None if math.isnan(st.value)
                                  else st.value),
                        "since": st.since_wall,
                    }
                    if st.annotations:
                        entry["annotations"] = dict(st.annotations)
                    if st.exemplars:
                        entry["exemplars"] = list(st.exemplars)
                    out.append(entry)
        order = {"firing": 0, "pending": 1, "resolved": 2}
        out.sort(key=lambda e: (order.get(e["state"], 3), e["alert"]))
        return out

    @staticmethod
    def _count(entries: List[dict]) -> Dict[str, int]:
        counts = {state: 0 for state in STATES[1:]}
        for entry in entries:
            counts[entry["state"]] += 1
        return counts

    def counts(self) -> Dict[str, int]:
        return self._count(self.active())

    def snapshot(self) -> dict:
        """The ``GET /alerts`` JSON payload. ``/alerts`` is polled
        continuously (dashboards, the drill's monitor), so the instance
        walk happens once and the counts derive from it."""
        with self._lock:
            ticks = self._ticks
            incidents = list(self.incidents)
        entries = self.active()
        return {
            "rules": [r.describe() for r in self.rules],
            "alerts": entries,
            "counts": self._count(entries),
            "ticks": ticks,
            "incidents": incidents,
        }

    def health_block(self) -> dict:
        """The compact ``/healthz`` block: what is firing, right now."""
        active = self.active()
        firing = [e for e in active if e["state"] == "firing"]
        return {
            "ok": not firing,
            "firing": [{"alert": e["alert"], "labels": e["labels"],
                        "severity": e["severity"]} for e in firing],
            "pending": sum(1 for e in active if e["state"] == "pending"),
            "rules": len(self.rules),
        }

    def to_prometheus(self) -> str:
        """``?format=prom``: the Prometheus alerting convention — one
        ``ALERTS{alertname,severity,state}`` series per pending/firing
        instance, value 1 (transition counters live in the registry's
        own exposition as ``fleet_alerts_total``)."""
        lines = ["# TYPE ALERTS gauge"]
        for entry in self.active():
            if entry["state"] not in ("pending", "firing"):
                continue
            labels = {"alertname": entry["alert"],
                      "severity": entry["severity"],
                      "state": entry["state"], **entry["labels"]}
            inner = ",".join(f'{k}="{v}"' for k, v in labels.items())
            lines.append("ALERTS{" + inner + "} 1")
        return "\n".join(lines) + "\n"


# -- default rule packs ------------------------------------------------------

def default_fleet_rules(*, probe_interval_s: float = 0.25,
                        scrape_stale_after_s: float = 10.0,
                        latency_drift_floor_s: float = 0.05,
                        annotate_member: Optional[Callable] = None
                        ) -> List[AlertRule]:
    """The rule pack covering the surfaces the fleet already exports
    (docs/OBSERVABILITY.md "Alerting" walks each one). Tick cadence is
    the router health loop's ``probe_interval``; the ``for_ticks``
    defaults below convert roughly into seconds through it.
    ``latency_drift_floor_s`` is the anomaly rule's MAD floor — the
    smallest p99 wiggle worth a standard unit; a p99 shift of roughly
    ``z_max / 0.6745`` floors over the baseline pages (~0.6 s at the
    defaults; an operator serving a fast fleet lowers it)."""
    ticks = lambda seconds: max(2, int(round(seconds / probe_interval_s)))  # noqa: E731
    return [
        AlertRule(
            name="worker_down", kind="threshold",
            metric="fleet_member_routable", op="<", bound=1.0,
            severity="page", for_ticks=ticks(0.6),
            keep_firing_ticks=ticks(0.6),
            arm_on_first_clear=True,
            exemplar_category="worker_failure",
            annotate=annotate_member,
            description="a member that once served is no longer routable "
                        "(ejected, draining, or dead)"),
        AlertRule(
            name="scrape_stale", kind="threshold",
            metric="fleet_member_scrape_age_seconds",
            op=">", bound=scrape_stale_after_s,
            severity="warn", for_ticks=ticks(0.6),
            keep_firing_ticks=ticks(0.6),
            arm_on_first_clear=True,
            annotate=annotate_member,
            description="a member's /metrics has not answered — wedged "
                        "observability is invisible failure"),
        AlertRule(
            name="slo_availability_burn", kind="burn",
            metric="fleet_slo_burn_rate", objective="availability",
            burn_threshold=1.0, severity="page",
            for_ticks=ticks(0.75), keep_firing_ticks=ticks(1.0),
            description="availability error budget burning on BOTH "
                        "windows (telemetry/slo.py semantics)"),
        AlertRule(
            name="slo_latency_burn", kind="burn",
            metric="fleet_slo_burn_rate", objective="latency",
            burn_threshold=1.0, severity="warn",
            for_ticks=ticks(0.75), keep_firing_ticks=ticks(1.0),
            description="latency error budget burning on BOTH windows"),
        AlertRule(
            name="brownout_latched", kind="threshold",
            metric="fleet_brownout", op=">=", bound=1.0,
            severity="warn", for_ticks=ticks(5.0),
            keep_firing_ticks=ticks(1.0),
            description="brownout admission control engaged and staying "
                        "engaged — capacity is exhausted, not blipped"),
        AlertRule(
            name="spawn_failures_climbing", kind="threshold",
            metric="fleet_spawn_failures_total", rate=True,
            op=">", bound=0.0, severity="page",
            for_ticks=ticks(0.75), keep_firing_ticks=ticks(1.5),
            description="workers dying before ever becoming routable — "
                        "the relaunch backoff ladder is climbing"),
        AlertRule(
            name="latency_anomaly", kind="anomaly",
            metric="fleet_request_latency_seconds", field="p99",
            window=240, min_points=20, z_max=8.0, direction="above",
            mad_floor_abs=latency_drift_floor_s,
            severity="page", for_ticks=ticks(0.75),
            keep_firing_ticks=ticks(1.0),
            exemplar_category="latency",
            description="p99 latency drifted far above its own rolling "
                        "baseline (median+MAD robust z) — the regression "
                        "no static threshold names"),
        AlertRule(
            name="queue_pressure_anomaly", kind="anomaly",
            metric="fleet_pressure", field=None,
            window=240, min_points=20, z_max=8.0, direction="above",
            mad_floor_abs=1.0,  # a healthy-idle median of 0 must not make
            # one queued request an infinite z
            severity="warn", for_ticks=ticks(0.75),
            keep_firing_ticks=ticks(1.0),
            description="queue+in-flight per routable worker far above "
                        "its rolling baseline"),
    ]


def default_mux_rules() -> List[AlertRule]:
    """Per-model scoping for a mux worker (docs/MULTIPLEX.md): the burn
    and queue rules read the per-model labeled families, so ONE rule
    fans out into one alert instance per variant."""
    return [
        AlertRule(
            name="model_slo_burn", kind="burn",
            metric="mux_slo_burn_rate", objective="availability",
            burn_threshold=1.0, severity="page",
            for_ticks=3, keep_firing_ticks=4,
            description="one variant's availability budget burning on "
                        "both windows (per-model SLI stream)"),
        AlertRule(
            name="model_queue_anomaly", kind="anomaly",
            metric="mux_queue_depth", field=None,
            window=240, min_points=20, z_max=8.0, direction="above",
            mad_floor_abs=1.0,
            severity="warn", for_ticks=3, keep_firing_ticks=4,
            description="one variant's queue depth far above its own "
                        "rolling baseline"),
    ]
