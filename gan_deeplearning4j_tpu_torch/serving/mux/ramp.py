"""RampController — continuous canary traffic ramp with auto-rollback.

The PyTorch port's copy of ``gan_deeplearning4j_tpu/serving/mux/ramp.py`` (plain
Python, no JAX), kept inside the port so that it imports nothing of the
JAX package.

The deploy plane's canary gate (docs/DEPLOY.md) makes ONE admission
decision: probe the candidate, then swap 100% of traffic. This module
generalizes that into the continuous form the fleet item queued
(ROADMAP: "1% → 50% → 100%"): an adopted candidate variant walks a stage
ladder of traffic fractions (default 1% → 10% → 50% → 100%), holding
each stage until the candidate has *positively demonstrated* health,
and rolling ALL of its traffic back on an SLO burn.

The health signal is three-valued, and the asymmetry is the point:

- **True (healthy evidence)** — counts toward the ``hold_ticks`` streak
  that advances the stage. Advancing requires data: the fail-closed rule
  of ``telemetry/slo.py`` applies to *promotion*.
- **False (burning)** — rolls back IMMEDIATELY: candidate weight to 0,
  every other variant restored to its pre-ramp weight (captured at
  ``start()``), state ``rolled_back``. One bad window un-does the whole
  ramp — re-running it is cheap, serving a burning variant at 50% is
  not.
- **None (no data)** — holds: neither advance nor rollback. An empty
  window must not *promote* a candidate (no data is not health), but it
  must not *kill* one either — at a 1% stage the candidate's window is
  legitimately sparse, and rolling back on silence would make small
  first stages impossible.

Stage weights are set through the registry's atomic ``set_weights`` so a
transition is never observed half-applied: at fraction ``f`` the
candidate's weight is chosen so its rendezvous *share* is exactly ``f``
against the captured base weights (``f = 1`` retires the bases to 0 —
the candidate has taken over; completing a ramp IS the new primary
election). The controller is passive — ``tick()`` is driven by the mux
service's control loop, the drill, or an operator."""

from __future__ import annotations

import math
import threading
from typing import Callable, Dict, Optional, Sequence

from gan_deeplearning4j_tpu_torch.telemetry.registry import get_registry
from gan_deeplearning4j_tpu_torch.telemetry.trace import TRACER

DEFAULT_STAGES = (0.01, 0.10, 0.50, 1.0)

#: ramp states (mux_ramp_state gauge exports the index)
STATES = ("idle", "ramping", "complete", "rolled_back")
_STATE_CODE = {name: i for i, name in enumerate(STATES)}


def health_from_tracker(tracker, threshold: float = 1.0,
                        window: str = "fast") -> Callable[[], Optional[bool]]:
    """The default ramp signal from a per-variant SLO tracker: False when
    any objective's ``window`` burn rate is at/over ``threshold`` (real
    evidence of burn), None when every burn is NaN (no data — hold),
    True otherwise."""

    def health() -> Optional[bool]:
        rates = tracker.burn_rates()
        burns = [windows[window] for windows in rates.values()]
        if any(not math.isnan(b) and b >= threshold for b in burns):
            return False
        if all(math.isnan(b) for b in burns):
            return None
        return True

    return health


class RampController:
    """Walks ``candidate`` up ``stages`` of traffic share inside a
    :class:`~.registry.MuxRegistry` (module docstring).

    ``health`` is the three-valued signal (:func:`health_from_tracker`
    builds one from an SLOTracker); ``hold_ticks`` is how many
    consecutive healthy ticks each stage must bank before advancing."""

    def __init__(self, registry, candidate: str, *,
                 stages: Sequence[float] = DEFAULT_STAGES,
                 hold_ticks: int = 2,
                 health: Optional[Callable[[], Optional[bool]]] = None):
        stages = tuple(float(s) for s in stages)
        if not stages or any(not 0.0 < s <= 1.0 for s in stages):
            raise ValueError(
                f"stages must be fractions in (0, 1], got {stages!r}")
        if list(stages) != sorted(stages):
            raise ValueError("stages must be non-decreasing")
        if hold_ticks < 1:
            raise ValueError("hold_ticks must be >= 1")
        self.registry = registry
        self.candidate = str(candidate)
        self.stages = stages
        self.hold_ticks = int(hold_ticks)
        self._health = health or (lambda: True)
        self._lock = threading.Lock()
        self._state = "idle"
        self._stage_idx = -1
        self._streak = 0
        self._base_weights: Dict[str, float] = {}
        self._rollbacks = 0
        self.events: list = []
        registry_m = get_registry()
        self._g_stage = registry_m.gauge(
            "mux_ramp_fraction",
            "candidate traffic fraction of the active ramp stage "
            "(-1 = no ramp running)", labelnames=("model",))
        self._g_state = registry_m.gauge(
            "mux_ramp_state",
            "ramp state: 0=idle 1=ramping 2=complete 3=rolled_back",
            labelnames=("model",))
        self._c_rollbacks = registry_m.counter(
            "mux_ramp_rollbacks_total",
            "ramps auto-rolled-back on an SLO burn", labelnames=("model",))
        self._g_stage.labels(model=self.candidate).set(-1.0)
        self._g_state.labels(model=self.candidate).set(_STATE_CODE["idle"])

    # -- weight math ------------------------------------------------------
    def _apply_fraction(self, fraction: float) -> None:
        """Set weights so the candidate's rendezvous share is exactly
        ``fraction`` against the captured base weights."""
        base = {n: w for n, w in self._base_weights.items()
                if n != self.candidate}
        if fraction >= 1.0:
            weights = {n: 0.0 for n in base}
            weights[self.candidate] = 1.0
        else:
            total = sum(w for w in base.values() if w > 0.0)
            if total <= 0.0:
                # no weighted incumbent: the candidate IS the traffic
                weights = {self.candidate: 1.0}
            else:
                weights = dict(base)
                weights[self.candidate] = fraction * total / (1.0 - fraction)
        self.registry.set_weights(weights)
        self._g_stage.labels(model=self.candidate).set(fraction)

    def _transition(self, state: str) -> None:
        self._state = state
        self._g_state.labels(model=self.candidate).set(_STATE_CODE[state])

    # -- lifecycle --------------------------------------------------------
    def start(self) -> None:
        """Capture the pre-ramp weights and enter the first stage. The
        candidate must be registered; it is warmed by the registry when
        its first stage weight lands (``set_weights`` warms cold
        variants gaining weight)."""
        with self._lock:
            if self._state == "ramping":
                raise RuntimeError("ramp already running")
            self._base_weights = self.registry.splitter.weights()
            self._stage_idx = 0
            self._streak = 0
            self._transition("ramping")
            self.events.append({"event": "start",
                                "stages": list(self.stages)})
        self._apply_fraction(self.stages[0])
        TRACER.instant("mux.ramp.start", {
            "candidate": self.candidate, "fraction": self.stages[0]})

    def tick(self) -> str:
        """One control-loop step (module docstring's three-valued rule).
        Returns the state after the step."""
        with self._lock:
            if self._state != "ramping":
                return self._state
            stage_idx = self._stage_idx
        healthy = self._health()
        if healthy is False:
            return self._rollback()
        if healthy is None:
            return "ramping"  # no data: hold, neither advance nor kill
        with self._lock:
            if self._state != "ramping" or self._stage_idx != stage_idx:
                return self._state  # raced a concurrent rollback/advance
            self._streak += 1
            if self._streak < self.hold_ticks:
                return "ramping"
            self._streak = 0
            self._stage_idx += 1
            done = self._stage_idx >= len(self.stages)
            if done:
                self._transition("complete")
                self.events.append({"event": "complete"})
            else:
                fraction = self.stages[self._stage_idx]
                self.events.append({"event": "advance",
                                    "fraction": fraction})
        if done:
            # the ladder is banked: the candidate takes all traffic (a
            # ladder ending below 1.0 completes AT its final fraction)
            if self.stages[-1] >= 1.0:
                self._apply_fraction(1.0)
            TRACER.instant("mux.ramp.complete", {
                "candidate": self.candidate})
            return "complete"
        self._apply_fraction(fraction)
        TRACER.instant("mux.ramp.advance", {
            "candidate": self.candidate, "fraction": fraction})
        return "ramping"

    def _rollback(self) -> str:
        with self._lock:
            if self._state != "ramping":
                return self._state
            restore = dict(self._base_weights)
            restore[self.candidate] = 0.0
            self._rollbacks += 1
            self._transition("rolled_back")
            self.events.append({"event": "rollback",
                                "stage_fraction":
                                    self.stages[self._stage_idx]})
        # warm=True: an incumbent the residency budget evicted mid-ramp
        # must come BACK when its weight is restored (set_weights applies
        # the weights first, so the restore itself is never delayed by
        # the re-warm)
        self.registry.set_weights(restore)
        self._g_stage.labels(model=self.candidate).set(-1.0)
        self._c_rollbacks.labels(model=self.candidate).inc()
        TRACER.instant("mux.ramp.rollback", {"candidate": self.candidate})
        return "rolled_back"

    # -- observability ----------------------------------------------------
    @property
    def state(self) -> str:
        with self._lock:
            return self._state

    @property
    def rollbacks(self) -> int:
        with self._lock:
            return self._rollbacks

    def snapshot(self) -> dict:
        with self._lock:
            idx = self._stage_idx
            return {
                "candidate": self.candidate,
                "state": self._state,
                "stages": list(self.stages),
                "stage_index": idx,
                "fraction": (self.stages[idx]
                             if self._state == "ramping"
                             and 0 <= idx < len(self.stages) else None),
                "streak": self._streak,
                "hold_ticks": self.hold_ticks,
                "rollbacks": self._rollbacks,
            }
