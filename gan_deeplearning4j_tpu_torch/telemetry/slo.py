"""SLO burn-rate tracking — the fleet's admission signal.

The PyTorch port's copy of ``gan_deeplearning4j_tpu/telemetry/slo.py`` (plain
Python, no JAX), kept inside the port so that it imports nothing of the
JAX package.

The router observes every request outcome the fleet produces; this module
turns that stream into the two numbers an operator (or the ROADMAP's
future autoscaler and the rolling-upgrade gate) can actually act on:

- **availability burn rate** — of the requests in a window, the fraction
  that failed (an answered 5xx, which includes the router's honest 503s),
  divided by the error budget ``1 - availability_target``. Burn rate 1.0
  means the fleet is spending budget exactly as fast as the SLO allows;
  14.4 means a 30-day budget dies in ~2 days (the classic page-now
  threshold, scaled to whatever windows are configured here).
- **latency burn rate** — same arithmetic over the latency objective:
  the fraction of answered (non-5xx) requests slower than
  ``latency_threshold_s``, against the budget ``1 - latency_target``.
  5xx answers are excluded so a fast failure cannot flatter the latency
  SLI while the availability one burns.

**Multi-window**: each objective is evaluated over a *fast* window (is it
burning NOW — reacts in seconds, noisy) and a *slow* window (has it been
burning — stable, slow to clear). The standard alerting/admission rule —
act only when BOTH exceed the threshold — is what :meth:`SLOTracker.ok`
implements: the fast window arms quickly, the slow window keeps one
transient blip from flapping the signal.

**Empty windows fail closed**: a window with zero observations has an
*undefined* burn rate, exported as ``NaN`` — and :meth:`SLOTracker.ok`
treats NaN as NOT-ok. An admission gate that cannot see traffic must not
conclude the fleet is healthy; "no data" and "healthy" are different
claims (the drill and the autoscaler both key on this).

Stdlib-only; events live in one bounded deque (drop-oldest beyond
``max_events``, prune-older-than-slow-window on every record).
"""

from __future__ import annotations

import dataclasses
import math
import threading
import time
from collections import deque
from typing import Callable, Optional

from gan_deeplearning4j_tpu_torch.telemetry.registry import get_registry


@dataclasses.dataclass
class SLOConfig:
    """Objectives and windows. Defaults suit a drill-scale fleet; a real
    deployment widens the windows (e.g. 300s/3600s) without touching the
    math."""

    availability_target: float = 0.999   # fraction of requests answered ok
    latency_threshold_s: float = 0.5     # "fast enough" boundary
    latency_target: float = 0.99         # fraction of answers under it
    fast_window_s: float = 60.0
    slow_window_s: float = 600.0
    max_events: int = 65536

    def validate(self) -> "SLOConfig":
        for name in ("availability_target", "latency_target"):
            v = getattr(self, name)
            if not 0.0 < v < 1.0:
                raise ValueError(f"{name} must be in (0, 1), got {v}")
        if self.latency_threshold_s <= 0:
            raise ValueError("latency_threshold_s must be > 0")
        if not 0 < self.fast_window_s <= self.slow_window_s:
            raise ValueError("need 0 < fast_window_s <= slow_window_s")
        if self.max_events < 1:
            raise ValueError("max_events must be >= 1")
        return self


class SLOTracker:
    """Sliding-window burn rates over a stream of request outcomes.

    ``record(ok, latency_s)`` is the hot path (router, once per routed
    request): one lock, one append. ``clock`` is injectable so the window
    math is testable without wall-clock sleeps."""

    OBJECTIVES = ("availability", "latency")
    WINDOWS = ("fast", "slow")

    def __init__(self, config: Optional[SLOConfig] = None,
                 clock: Callable[[], float] = time.monotonic,
                 *, metric_prefix: str = "fleet",
                 labels: Optional[dict] = None):
        """``metric_prefix``/``labels`` scope the exported gauges: the
        router's fleet-wide tracker keeps the default
        ``fleet_slo_burn_rate{objective,window}``; the mux plane tracks
        one SLI stream PER VARIANT with ``metric_prefix="mux"`` and
        ``labels={"model": name}``, so every tracker's burn rates land
        as distinct labeled series of one ``mux_slo_*`` family instead
        of N trackers fighting over one unlabeled series
        (docs/MULTIPLEX.md)."""
        self.config = (config or SLOConfig()).validate()
        self._clock = clock
        self._lock = threading.Lock()
        # (t, ok, latency_ok) — latency_ok is None for failed requests
        # (excluded from the latency SLI, see module docstring)
        self._events: deque = deque(maxlen=self.config.max_events)
        self._total = {"requests": 0, "failed": 0, "slow": 0}
        # high-water mark of observed clock readings: event timestamps
        # are clamped monotonic against it (see _now_locked)
        self._clock_hwm: Optional[float] = None
        self._labels = {str(k): str(v)
                        for k, v in sorted((labels or {}).items())}
        extra = tuple(self._labels)
        registry = get_registry()
        burn_family = registry.gauge(
            f"{metric_prefix}_slo_burn_rate",
            "error-budget burn rate per objective and window "
            "(NaN = empty window, fails closed)",
            labelnames=extra + ("objective", "window"))
        self._g_burn = lambda objective, window: burn_family.labels(
            **self._labels, objective=objective, window=window)
        ok_family = registry.gauge(
            f"{metric_prefix}_slo_ok",
            "1 when every objective's fast AND slow burn rates are under "
            "1.0, 0 otherwise (NaN burn = 0 — no data fails closed)",
            labelnames=extra)
        self._g_ok = ok_family.labels(**self._labels) if extra else ok_family

    # -- recording -------------------------------------------------------
    def _now_locked(self) -> float:
        """The clock reading, clamped monotonic (caller holds the lock).
        The default clock is ``time.monotonic``, but the tracker is
        clock-injectable and deployments substitute wall clocks — which
        STEP: NTP slews, VM suspend/resume, leap smears. A backwards
        step would write an out-of-order timestamp into the event deque,
        silently skewing window membership (the prune loop stops at the
        first in-window event, so misordered old events survive behind
        it, and a window evaluated at the stepped-back "now" ages events
        it should still hold). Clamping to the high-water mark keeps the
        deque sorted and every window evaluation consistent; when the
        clock recovers past the mark, real time resumes."""
        now = self._clock()
        if self._clock_hwm is not None and now < self._clock_hwm:
            return self._clock_hwm
        self._clock_hwm = now
        return now

    def record(self, ok: bool, latency_s: Optional[float] = None) -> None:
        """One observed outcome. ``ok`` False = availability failure (an
        answered 5xx / honest 503); ``latency_s`` is the client-visible
        duration, measured only for answered (ok) requests."""
        latency_ok: Optional[bool] = None
        if ok and latency_s is not None:
            latency_ok = latency_s <= self.config.latency_threshold_s
        with self._lock:
            now = self._now_locked()
            self._events.append((now, bool(ok), latency_ok))
            self._total["requests"] += 1
            if not ok:
                self._total["failed"] += 1
            if latency_ok is False:
                self._total["slow"] += 1
            # prune past the slow window so the deque holds only what any
            # window can still read (maxlen already bounds pathology)
            horizon = now - self.config.slow_window_s
            while self._events and self._events[0][0] < horizon:
                self._events.popleft()

    # -- window math -----------------------------------------------------
    def _window_counts(self, window_s: float, now: float) -> dict:
        lo = now - window_s
        total = failed = answered = slow = 0
        for t, ok, latency_ok in self._events:
            if t < lo:
                continue
            total += 1
            if not ok:
                failed += 1
            else:
                answered += 1
                if latency_ok is False:
                    slow += 1
        return {"total": total, "failed": failed,
                "answered": answered, "slow": slow}

    @staticmethod
    def _burn(bad: int, n: int, target: float) -> float:
        if n == 0:
            return float("nan")  # undefined, and ok() fails closed on it
        return (bad / n) / (1.0 - target)

    def burn_rates(self) -> dict:
        """``{objective: {window: burn}}`` — NaN for empty windows."""
        cfg = self.config
        with self._lock:
            # same monotonic clamp as record(): a stepped-back clock must
            # not evaluate windows at a "now" older than recorded events
            now = self._now_locked()
            counts = {
                "fast": self._window_counts(cfg.fast_window_s, now),
                "slow": self._window_counts(cfg.slow_window_s, now),
            }
        out: dict = {"availability": {}, "latency": {}}
        for window, c in counts.items():
            out["availability"][window] = self._burn(
                c["failed"], c["total"], cfg.availability_target)
            out["latency"][window] = self._burn(
                c["slow"], c["answered"], cfg.latency_target)
        return out

    def ok(self, threshold: float = 1.0) -> bool:
        """The admission signal: True only when EVERY objective's fast AND
        slow burn rates are strictly under ``threshold``. NaN (empty
        window) is not under anything — no data fails closed."""
        for rates in self.burn_rates().values():
            for burn in rates.values():
                if math.isnan(burn) or burn >= threshold:
                    return False
        return True

    def snapshot(self) -> dict:
        """The ``/healthz`` block — objectives, burn rates, lifetime
        counts, and the boolean signal. Also refreshes the registry
        gauges so a Prometheus scrape racing a healthz read sees the same
        numbers."""
        rates = self.burn_rates()
        for objective, windows in rates.items():
            for window, burn in windows.items():
                self._g_burn(objective, window).set(burn)
        # recompute from the rates already in hand (ok() would re-read
        # the clock and could disagree with the exported rates)
        signal = all(
            not (math.isnan(b) or b >= 1.0)
            for windows in rates.values() for b in windows.values()
        )
        self._g_ok.set(1.0 if signal else 0.0)
        with self._lock:
            totals = dict(self._total)
        cfg = self.config
        return {
            "objectives": {
                "availability_target": cfg.availability_target,
                "latency_threshold_s": cfg.latency_threshold_s,
                "latency_target": cfg.latency_target,
            },
            "windows_s": {"fast": cfg.fast_window_s,
                          "slow": cfg.slow_window_s},
            # JSON has no NaN: an empty window exports as null here (the
            # gauges keep the NaN; both read as "undefined, not healthy")
            "burn_rates": {
                objective: {
                    window: (None if math.isnan(b) else b)
                    for window, b in windows.items()
                }
                for objective, windows in rates.items()
            },
            "totals": totals,
            "ok": signal,
        }
