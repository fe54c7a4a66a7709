"""Per-worker health: active probing + passive outlier ejection.

A fleet router cannot trust a worker list — workers get SIGKILLed, hang
under SIGSTOP, restart into a warmup window, or rot behind a full queue.
This module is the router's opinion of one worker, built from two signal
streams:

- **active** — a bounded ``GET /healthz`` probe (:func:`probe_worker`).
  Only ``"ok"`` admits: ``"warming"`` means the compile ladder is still
  building (routing there buys tail latency), ``"draining"`` means the
  manager is rotating the worker out, ``"error"`` means a failed warmup
  that would pay serve-time compiles per request.
- **passive** — the outcome of every proxied request
  (:meth:`CircuitBreaker.record`). Consecutive failures OR a windowed
  error rate trips the breaker, so both a hard-down worker (every attempt
  fails) and a flaky one (interleaved successes keep any consecutive
  counter low) get ejected.

The breaker is the classic three-state machine, with admission gates the
serving tier needs:

``init`` → (first successful probe) → ``closed`` (healthy, routable)
→ (trip) → ``open`` (ejected, unroutable, backoff doubles per re-trip)
→ (reopen deadline) → ``half_open`` (ONE active probe may be spent)
→ probe ok → ``closed`` / probe fails → ``open`` again.

Everything takes an injectable ``clock`` so tests drive the state machine
without wall-clock sleeps. Thread-safety: one lock per breaker — the
router's request threads record outcomes concurrently with the health
loop's probes.

The PyTorch port's copy of ``gan_deeplearning4j_tpu/fleet/health.py``
(plain Python): nothing is adapted.
"""

from __future__ import annotations

import json
import threading
import urllib.error
import urllib.request
from collections import deque
from typing import Optional, Tuple

#: /healthz statuses that admit a worker into the routable pool
ADMITTABLE = ("ok",)

#: breaker states (gauge order: the fleet_worker_state metric exports the
#: index)
STATES = ("init", "closed", "open", "half_open")


def http_json(url: str, timeout: float, method: str = "GET",
              data: Optional[bytes] = None) -> Optional[dict]:
    """One bounded HTTP round trip decoded as JSON; None on ANY failure
    (refused, reset, timed out, non-JSON body). The single network helper
    behind probes, scrapes, and the manager's admin posts — failure is a
    health signal on every one of those paths, never an exception."""
    req = urllib.request.Request(url, data=data, method=method)
    if data is not None:
        req.add_header("Content-Type", "application/json")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return json.loads(resp.read())
    except (urllib.error.URLError, OSError, ValueError):
        return None


def probe_worker(base_url: str, timeout: float = 2.0
                 ) -> Tuple[bool, Optional[dict]]:
    """One bounded active probe: ``(admittable, healthz body or None)``.
    Never raises — a dead socket is exactly the signal being probed for."""
    body = http_json(f"{base_url}/healthz", timeout=timeout)
    if body is None:
        return False, None
    return body.get("status") in ADMITTABLE, body


class CircuitBreaker:
    """Trip/eject/re-admit state for one worker.

    ``consecutive_failures`` trips after N back-to-back failures;
    ``error_rate``/``rate_window``/``rate_min_samples`` trip when the
    failure fraction over the last ``rate_window`` outcomes exceeds
    ``error_rate`` with at least ``rate_min_samples`` observed (the flaky-
    worker path a consecutive counter misses). ``reopen_after`` is the
    initial open→half-open backoff; every re-trip from half-open doubles
    it up to ``reopen_max``.
    """

    def __init__(self, *, consecutive_failures: int = 3,
                 error_rate: float = 0.5, rate_window: int = 20,
                 rate_min_samples: int = 10, reopen_after: float = 1.0,
                 reopen_max: float = 30.0, clock=None):
        if consecutive_failures < 1:
            raise ValueError("consecutive_failures must be >= 1")
        if not 0.0 < error_rate <= 1.0:
            raise ValueError("error_rate must be in (0, 1]")
        import time

        self._clock = clock or time.monotonic
        self.consecutive_failures = consecutive_failures
        self.error_rate = error_rate
        self.rate_min_samples = rate_min_samples
        self.reopen_after = reopen_after
        self.reopen_max = reopen_max
        self._lock = threading.Lock()
        self._state = "init"
        self._fail_streak = 0
        self._window: deque = deque(maxlen=rate_window)
        self._backoff = reopen_after
        self._reopen_at: Optional[float] = None
        self.trips = 0  # lifetime ejections (router metrics)

    # -- state ----------------------------------------------------------
    @property
    def state(self) -> str:
        with self._lock:
            return self._effective_state()

    def _effective_state(self) -> str:
        # under the lock: an expired open deadline IS half-open — the
        # transition is lazy so no timer thread is needed
        if (self._state == "open" and self._reopen_at is not None
                and self._clock() >= self._reopen_at):
            self._state = "half_open"
        return self._state

    @property
    def routable(self) -> bool:
        """True when requests may be sent to this worker. Half-open is NOT
        routable — re-admission is spent on one active probe, not on a
        user's request."""
        return self.state == "closed"

    def probe_due(self) -> bool:
        """True when the health loop should spend an active probe here:
        half-open (the single re-admission probe) or still in init
        (a freshly registered or relaunched worker warming up)."""
        return self.state in ("init", "half_open")

    # -- signal intake ---------------------------------------------------
    def record(self, ok: bool) -> Optional[str]:
        """Passive outcome of one proxied request. Returns ``"tripped"``
        when THIS record ejected the worker (the caller counts
        ejections), else None."""
        with self._lock:
            if self._state not in ("closed",):
                return None  # outcomes while ejected don't re-trip
            self._window.append(ok)
            self._fail_streak = 0 if ok else self._fail_streak + 1
            if ok:
                return None
            failures = sum(1 for o in self._window if not o)
            rate_tripped = (len(self._window) >= self.rate_min_samples
                            and failures / len(self._window)
                            > self.error_rate)
            if self._fail_streak >= self.consecutive_failures or rate_tripped:
                self._trip()
                return "tripped"
            return None

    def probe_result(self, ok: bool) -> Optional[str]:
        """Outcome of one active probe. In half-open/init a success closes
        the breaker (worker admitted — returns ``"admitted"``); a
        half-open failure re-opens with doubled backoff. Init failures
        just stay init: a warming worker is not *failing*, it is not
        ready yet."""
        with self._lock:
            state = self._effective_state()
            if ok:
                if state in ("init", "half_open", "open"):
                    self._state = "closed"
                    self._fail_streak = 0
                    self._window.clear()
                    self._backoff = self.reopen_after
                    self._reopen_at = None
                    return "admitted"
                return None
            if state == "half_open":
                # the single re-admission probe failed: back to open,
                # doubled backoff (a hard-down worker costs one probe per
                # widening interval, not a probe storm)
                self._state = "open"
                self._backoff = min(self.reopen_max, self._backoff * 2)
                self._reopen_at = self._clock() + self._backoff
            return None

    def eject(self) -> None:
        """Force the breaker open (manager-side: the worker process is
        known dead or is being force-restarted)."""
        with self._lock:
            if self._state != "open":
                self._trip()

    def reset(self) -> None:
        """Back to init (a relaunched process behind the same worker id:
        it must re-earn admission through a probe)."""
        with self._lock:
            self._state = "init"
            self._fail_streak = 0
            self._window.clear()
            self._backoff = self.reopen_after
            self._reopen_at = None

    def _trip(self) -> None:
        # under the lock
        self._state = "open"
        self.trips += 1
        self._reopen_at = self._clock() + self._backoff

    def snapshot(self) -> dict:
        with self._lock:
            state = self._effective_state()
            return {
                "state": state,
                "fail_streak": self._fail_streak,
                "trips": self.trips,
                "reopen_in_s": (
                    None if self._reopen_at is None or state != "open"
                    else max(0.0, self._reopen_at - self._clock())),
            }
