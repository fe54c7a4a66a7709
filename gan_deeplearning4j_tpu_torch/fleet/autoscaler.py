"""Autoscaler — SLO-driven elastic fleet sizing with graceful brownout.

The fleet served exactly the worker count it was launched with: a burst
could only be answered with honest 503s and an idle fleet burned N
workers forever. This module closes the loop the ROADMAP queued — the
admission signal (``telemetry/slo.py`` multi-window burn rates, fail
closed on empty windows) and the safe scale-down path (the manager's
draining restarts) already existed; the autoscaler is the controller
that connects them to fleet size:

- **signals** — one bounded read per tick of the same data
  ``GET /metrics?scope=fleet`` serves (the router's merged registry
  snapshot refreshes the SLO gauges) plus the router's live per-worker
  scrapes: routable count, total queue depth + in-flight (the occupancy
  pressure), and the availability/latency burn rates. A scrape that
  fails, or a signal that is missing or NaN, yields NO decision — the
  size HOLDS. An autoscaler that cannot see the fleet must not resize
  it; "no data" and "idle" are different claims (the same fail-closed
  stance the SLO tracker takes on empty windows).
- **hysteresis + cooldowns** — pressure must exceed the up threshold
  (or the SLO must be burning on BOTH windows of an objective) for
  ``up_consecutive`` ticks before a scale-up, and sit under the down
  threshold with no burn for ``down_consecutive`` ticks before a
  scale-down; each action arms its own cooldown. One noisy tick never
  moves the fleet, and the fleet never flaps between sizes.
- **scale-up** — a new worker slot spawns from the fleet's CURRENT
  bundle (the checkpoint store generation every other worker serves)
  and must re-earn router admission through the normal init-probe path
  before it counts as capacity — the pressure math only ever divides by
  *routable* workers, so a booting worker cannot flatter the signal.
  A spawn that wedges is bounded by the manager's boot timeout, and a
  spawn that dies before ever becoming routable relaunches under the
  manager's capped exponential backoff — never a hot relaunch loop.
- **scale-down** — only through the drain path: the LEAST-LOADED
  routable worker above ``min_workers`` is unrouted, drained (bounded),
  SIGTERMed, and removed. No in-flight request is ever dropped by a
  resize.
- **brownout** — at ``max_workers`` under continuing overload there is
  no capacity left to add, so degradation must be *ordered*, not
  emergent: the router enters tiered admission control. Tier 1 sheds
  oversized ``sample`` slabs (the largest single cost a request can
  impose) with an honest 503; tier 2 additionally shrinks effective
  deadlines so queued work is shed early instead of timing out late.
  The state is observable — ``"brownout"`` in the router's ``/healthz``
  and the ``fleet_brownout`` gauge — and exits (tier by tier) once
  pressure stays under the up threshold for ``brownout_exit_ticks``.

Resizes serialize with rolling upgrades through the manager's cycle
lock: a resize decided mid-roll *queues* (the streaks persist and the
action fires on the first post-roll tick) rather than interleaving with
the rotation. Crash supervision keeps running during a resize — the
supervise loop owns relaunches, the autoscaler only adds/removes slots.

``python -m gan_deeplearning4j_tpu_torch.fleet.drill --autoscale`` proves
the whole story under a ~10x closed-loop burst (docs/FLEET.md
"Autoscaling").

The PyTorch port's copy of ``gan_deeplearning4j_tpu/fleet/autoscaler.py``
(plain Python), imports rewritten.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import threading
import time
from typing import Callable, Optional

from gan_deeplearning4j_tpu_torch.telemetry.registry import get_registry
from gan_deeplearning4j_tpu_torch.telemetry.trace import TRACER

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class AutoscalerConfig:
    """Targets, thresholds, and pacing. Pressure is
    ``(queue_depth + in_flight) / routable`` — demand per unit of live
    capacity; with N closed-loop clients it reads ~N/routable."""

    min_workers: int = 1
    max_workers: int = 4
    #: pressure at/above which a tick counts toward scale-up
    up_pressure: float = 3.0
    #: pressure at/below which a tick counts toward scale-down
    down_pressure: float = 1.0
    #: SLO burn rate (both windows of one objective) that counts a tick
    #: toward scale-up even when queues look shallow — NaN never counts
    up_burn: float = 1.0
    #: consecutive qualifying ticks before acting (hysteresis)
    up_consecutive: int = 3
    down_consecutive: int = 10
    #: seconds between decision ticks
    interval_s: float = 1.0
    #: per-direction cooldowns armed after each resize
    up_cooldown_s: float = 5.0
    down_cooldown_s: float = 15.0
    #: brownout: enter after up_consecutive overloaded ticks AT max size;
    #: escalate tier 1 -> 2 after the same count again; de-escalate after
    #: brownout_exit_ticks calm ticks
    brownout_exit_ticks: int = 5
    #: tier-1 admission bound: /v1/sample slabs with more rows shed
    brownout_max_rows: int = 32
    #: tier-2 effective-deadline cap injected into admitted requests
    brownout_deadline_s: float = 1.0

    def validate(self) -> "AutoscalerConfig":
        if not 1 <= self.min_workers <= self.max_workers:
            raise ValueError(
                f"need 1 <= min_workers <= max_workers, got "
                f"{self.min_workers}..{self.max_workers}")
        if not 0.0 <= self.down_pressure < self.up_pressure:
            raise ValueError(
                "need 0 <= down_pressure < up_pressure (the hysteresis "
                f"band), got {self.down_pressure}/{self.up_pressure}")
        if self.up_consecutive < 1 or self.down_consecutive < 1:
            raise ValueError("consecutive tick counts must be >= 1")
        if self.brownout_exit_ticks < 1:
            # 0 would read `calm_streak >= 0` — always true — and flap
            # the brownout enter/exit every cycle under steady overload
            raise ValueError("brownout_exit_ticks must be >= 1")
        if self.interval_s <= 0:
            raise ValueError("interval_s must be > 0")
        if self.up_cooldown_s < 0 or self.down_cooldown_s < 0:
            raise ValueError("cooldowns must be >= 0")
        if self.brownout_max_rows < 1:
            raise ValueError("brownout_max_rows must be >= 1")
        if self.brownout_deadline_s <= 0:
            raise ValueError("brownout_deadline_s must be > 0")
        return self


class Autoscaler:
    """The control loop. ``tick()`` is driven by the manager's supervise
    loop (no thread of its own); ``clock`` and ``scrape`` are injectable
    so the state machine is testable without sockets or sleeps.

    ``scrape`` returns the signal dict or ``None`` (unreachable); the
    default reads the router in-process — the same merged snapshot
    ``GET /metrics?scope=fleet`` serves, plus the live worker scrapes.
    """

    def __init__(self, manager, config: AutoscalerConfig, *,
                 clock: Callable[[], float] = time.monotonic,
                 scrape: Optional[Callable[[], Optional[dict]]] = None):
        self.manager = manager
        self.config = config.validate()
        self._clock = clock
        self._scrape = scrape or self._default_scrape
        self._lock = threading.Lock()
        self._next_tick = 0.0
        self._cooldown_until = 0.0
        self._up_streak = 0
        self._down_streak = 0
        self._calm_streak = 0
        self._last_decision = "idle"
        self._last_signals: Optional[dict] = None
        self._scale_ups = 0
        self._scale_downs = 0
        self._deferred = 0
        registry = get_registry()
        self._c_decisions = registry.counter(
            "fleet_autoscale_decisions_total",
            "autoscaler decisions by action (hold actions included: an "
            "autoscaler that cannot see the fleet holds, observably)",
            labelnames=("action",))
        self._g_target = registry.gauge(
            "fleet_workers_target",
            "worker count the autoscaler is converging the fleet toward")
        self._g_target.set(len(manager.slots) if manager.slots
                           else config.min_workers)

    # -- signals ---------------------------------------------------------
    def _default_scrape(self) -> Optional[dict]:
        """One in-process read of the signals ``GET /metrics?scope=fleet``
        serves — the SLO burn rates and the per-worker queue/in-flight
        state the health loop already scrapes — WITHOUT the per-worker
        HTTP fan-out that endpoint performs (a tick must never block the
        supervise thread behind an unreachable worker's probe timeout).
        Any failure is None — the caller holds; an out-of-process
        deployment injects ``scrape`` and gets the same fail-closed
        contract on a dead router."""
        router = self.manager.router
        try:
            # router.member_signals() is THE shared signal seam: one
            # pass over the health loop's scraped worker state, also
            # feeding the fleet_member_* gauges the alert plane and the
            # prom surface read — autoscaling and alerting pay for the
            # same scrape exactly once
            signals = router.member_signals()
            return {
                "routable": signals["routable"],
                "queue_depth": signals["queue_depth"],
                "in_flight": signals["in_flight"],
                "burn_rates": router.slo.burn_rates(),
            }
        except Exception:
            logger.exception("autoscaler scrape failed")
            return None

    @staticmethod
    def _burning(burn_rates: dict, threshold: float) -> bool:
        """True when any objective burns on BOTH its windows. NaN is not
        burning — an empty window must not trigger a resize (it triggers
        a HOLD through the missing-signal path when the whole scrape is
        gone; here it just fails to qualify the tick)."""
        for windows in (burn_rates or {}).values():
            values = list(windows.values())
            if values and all(
                    not math.isnan(b) and b >= threshold for b in values):
                return True
        return False

    # -- the decision state machine --------------------------------------
    def decide(self, signals: Optional[dict]) -> str:
        """Fold one tick's signals into the streaks and return the
        action: ``up`` / ``down`` / ``brownout_enter`` /
        ``brownout_escalate`` / ``brownout_exit`` / ``hold`` /
        ``hold_no_signals`` / ``hold_cooldown``. Pure state (no process
        side effects) — :meth:`tick` applies the action."""
        cfg = self.config
        now = self._clock()
        if signals is None:
            # fail closed: never act on absent data, and reset the
            # streaks — evidence gathered before the blackout is stale
            self._up_streak = self._down_streak = self._calm_streak = 0
            return "hold_no_signals"
        routable = signals.get("routable")
        queue = signals.get("queue_depth")
        inflight = signals.get("in_flight")
        if any(v is None or (isinstance(v, float) and math.isnan(v))
               for v in (routable, queue, inflight)):
            self._up_streak = self._down_streak = self._calm_streak = 0
            return "hold_no_signals"
        if routable < 1:
            # nothing admitted: a resize decision divides by live
            # capacity it cannot see. Supervision (relaunch, backoff)
            # owns a fully-down fleet, not the autoscaler.
            self._up_streak = self._down_streak = self._calm_streak = 0
            return "hold_no_signals"
        pressure = (queue + inflight) / routable
        brownout = self.manager.router.brownout_level
        # while browned out, the burn signal is contaminated by our OWN
        # admission control: every tier-1 shed is an honest 503 the SLO
        # rightly counts as a failure — reading it as "still overloaded"
        # would latch the brownout forever on a trickle of large slabs
        # (and pin the fleet at max). Under brownout, pressure alone is
        # the controller's evidence; the burn re-arms once we exit.
        burning = (brownout == 0
                   and self._burning(signals.get("burn_rates"), cfg.up_burn))
        overloaded = pressure >= cfg.up_pressure or burning
        calm = pressure <= cfg.down_pressure and not burning
        self._up_streak = self._up_streak + 1 if overloaded else 0
        self._down_streak = self._down_streak + 1 if calm else 0
        self._calm_streak = 0 if overloaded else self._calm_streak + 1

        size = len(self.manager.slots)
        # brownout transitions ignore the resize cooldowns: admission
        # control is the pressure valve precisely when resizing is
        # exhausted, and releasing it promptly is as ordered as entering
        if brownout > 0 and self._calm_streak >= cfg.brownout_exit_ticks:
            self._calm_streak = 0
            return "brownout_exit"
        if overloaded and self._up_streak >= cfg.up_consecutive:
            if size >= cfg.max_workers:
                if brownout == 0:
                    self._up_streak = 0
                    return "brownout_enter"
                if brownout == 1:
                    self._up_streak = 0
                    return "brownout_escalate"
                return "hold"  # already at the deepest tier
            if now < self._cooldown_until:
                return "hold_cooldown"
            self._up_streak = 0
            return "up"
        if (calm and self._down_streak >= cfg.down_consecutive
                and brownout == 0):
            if size <= cfg.min_workers:
                return "hold"
            if now < self._cooldown_until:
                return "hold_cooldown"
            self._down_streak = 0
            return "down"
        return "hold"

    # -- driving ---------------------------------------------------------
    def tick(self) -> Optional[str]:
        """One throttled control-loop pass: scrape, decide, act. Returns
        the action taken (None between intervals). Resize actions
        serialize with rolling upgrades through the manager's cycle
        lock — a roll in flight defers the resize to the next tick, it
        never interleaves with the rotation."""
        now = self._clock()
        with self._lock:
            if now < self._next_tick:
                return None
            self._next_tick = now + self.config.interval_s
            signals = self._scrape()
            action = self.decide(signals)
            self._last_signals = signals
        applied = self._apply(action)
        with self._lock:
            self._last_decision = applied
        self._c_decisions.labels(action=applied).inc()
        if TRACER.enabled and applied not in ("hold", "hold_cooldown"):
            pressure = None
            try:
                pressure = round(
                    (signals["queue_depth"] + signals["in_flight"])
                    / max(1, signals["routable"]), 3)
            except (KeyError, TypeError):
                pass  # partial signals: decide() already held on them
            TRACER.instant("fleet.autoscale", {
                "action": applied,
                "size": len(self.manager.slots),
                "pressure": pressure,
            })
        return applied

    def _apply(self, action: str) -> str:
        cfg = self.config
        mgr = self.manager
        if action == "up":
            if not mgr._cycle_lock.acquire(blocking=False):
                self._note_deferred("up")
                return "deferred_roll"  # a roll owns the fleet right now
            try:
                with TRACER.span("fleet.scale_up"):
                    slot = mgr.scale_up_one()
            finally:
                mgr._cycle_lock.release()
            if slot is None:
                return "hold"
            with self._lock:
                self._scale_ups += 1
                self._cooldown_until = self._clock() + cfg.up_cooldown_s
            self._g_target.set(len(mgr.slots))
            logger.info("autoscaler scaled up: %d workers (spawned %s)",
                        len(mgr.slots), slot.id)
            return "up"
        if action == "down":
            if not mgr._cycle_lock.acquire(blocking=False):
                self._note_deferred("down")
                return "deferred_roll"
            try:
                with TRACER.span("fleet.scale_down"):
                    removed = mgr.scale_down_one()
            finally:
                mgr._cycle_lock.release()
            if not removed:
                return "hold"
            with self._lock:
                self._scale_downs += 1
                self._cooldown_until = self._clock() + cfg.down_cooldown_s
            self._g_target.set(len(mgr.slots))
            logger.info("autoscaler scaled down: %d workers", len(mgr.slots))
            return "down"
        if action == "brownout_enter":
            mgr.router.set_brownout(1, max_rows=cfg.brownout_max_rows,
                                    deadline_s=cfg.brownout_deadline_s)
            logger.warning("brownout tier 1: at max size (%d) under "
                           "sustained overload — shedding sample slabs "
                           "over %d rows", len(mgr.slots),
                           cfg.brownout_max_rows)
            return action
        if action == "brownout_escalate":
            mgr.router.set_brownout(2, max_rows=cfg.brownout_max_rows,
                                    deadline_s=cfg.brownout_deadline_s)
            logger.warning("brownout tier 2: overload continues — "
                           "capping effective deadlines at %.2fs",
                           cfg.brownout_deadline_s)
            return action
        if action == "brownout_exit":
            level = mgr.router.brownout_level
            mgr.router.set_brownout(max(0, level - 1))
            logger.info("brownout de-escalated to tier %d",
                        mgr.router.brownout_level)
            return action
        return action

    def _note_deferred(self, direction: str) -> None:
        """A resize deferred behind a roll keeps its evidence: re-arm the
        streak decide() consumed, so the action fires on the first
        post-roll tick instead of re-earning the whole hysteresis
        window while the overload (or idle burn) continues."""
        with self._lock:
            self._deferred += 1
            if direction == "up":
                self._up_streak = self.config.up_consecutive
            else:
                self._down_streak = self.config.down_consecutive

    # -- observability ---------------------------------------------------
    def status(self) -> dict:
        cfg = self.config
        with self._lock:
            signals = self._last_signals
            return {
                "min_workers": cfg.min_workers,
                "max_workers": cfg.max_workers,
                "last_decision": self._last_decision,
                "up_streak": self._up_streak,
                "down_streak": self._down_streak,
                "scale_ups": self._scale_ups,
                "scale_downs": self._scale_downs,
                "deferred": self._deferred,
                "cooldown_remaining_s": round(
                    max(0.0, self._cooldown_until - self._clock()), 3),
                "signals": signals,
                "brownout_level": self.manager.router.brownout_level,
                # the reaction-time surface (fleet_scaleup_routable_
                # seconds): how long the most recent worker admissions
                # took from launch to routable — what a scale-up
                # actually buys and when (warm elasticity shrinks this)
                "scaleup_routable_s": [
                    round(s.routable_s, 3) for s in self.manager.slots
                    if s.routable_s is not None
                ],
            }
