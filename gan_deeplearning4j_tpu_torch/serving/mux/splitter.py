"""WeightedSplitter — deterministic hash-based traffic assignment.

The PyTorch port's copy of ``gan_deeplearning4j_tpu/serving/mux/splitter.py`` (plain
Python, no JAX), kept inside the port so that it imports nothing of the
JAX package.

The multiplexing plane (docs/MULTIPLEX.md) serves N model variants behind
ONE request surface; this module decides, per request key, which variant
answers. Three properties make that decision an infrastructure primitive
rather than a load balancer heuristic:

- **deterministic** — the assignment is a pure function of (key, variant
  names, weights) computed from a *seeded stdlib hash* (sha256), never
  Python's salted ``hash()`` and never process state: the same key routes
  to the same variant across router restarts, across processes, and
  across replicas, as long as the weights match. Sticky assignment is
  what makes a canary ramp meaningful — one user's traffic does not
  flap between the incumbent and the candidate on every request.
- **exactly weight-proportional** — assignment is weighted rendezvous
  (highest-random-weight) hashing: each variant scores
  ``weight / Exp(1)`` where the exponential draw is derived from
  ``sha256(key, variant)``, and the highest score wins. The winner
  distribution is *exactly* ``w_i / Σw`` (the max of competing
  scaled exponentials — argmin of ``Exp(w_i)`` — lands on ``i`` with
  probability proportional to its rate), so a 1% stage of the ramp
  controller really is 1% in expectation, not "roughly the smallest
  bucket".
- **minimal reassignment under live weight updates** — when one
  variant's weight is raised, keys only ever move *to* that variant
  (its scores grew; everyone else's are untouched), and the expected
  moved fraction is exactly the variant's share delta. Lowering a
  weight moves only that variant's keys away. A ramp step therefore
  disturbs precisely the traffic it admits — no global reshuffle, the
  property the determinism tests pin.

Weights are free-scale (only ratios matter); weight 0 removes a variant
from assignment without forgetting it. Thread-safe: weight reads/updates
take one lock; the hash math itself is pure.
"""

from __future__ import annotations

import hashlib
import math
import threading
from typing import Dict, Iterable, Mapping, Optional, Tuple

#: 2**64 as a float divisor — maps a 64-bit digest prefix into (0, 1)
_SCALE = float(1 << 64)


def _uniform(key: str, variant: str) -> float:
    """A deterministic uniform draw in (0, 1) for (key, variant), from
    sha256 — NOT ``hash()``, which is salted per process and would
    reassign every key on every restart."""
    digest = hashlib.sha256(
        f"{key}\x00{variant}".encode("utf-8", "surrogatepass")).digest()
    # +1 keeps the draw strictly positive so log() below is finite
    return (int.from_bytes(digest[:8], "big") + 1) / (_SCALE + 2.0)


class WeightedSplitter:
    """Weighted rendezvous assignment over named variants.

    ``assign(key)`` returns the variant whose score
    ``-weight / ln(u(key, variant))`` is highest — equivalently the
    argmin of per-variant exponentials with rate ``weight``, which is
    weight-proportional and minimally disruptive under weight changes
    (module docstring). Raises :class:`LookupError` when no variant
    carries positive weight."""

    def __init__(self, weights: Optional[Mapping[str, float]] = None):
        self._lock = threading.Lock()
        self._weights: Dict[str, float] = {}
        if weights:
            self.set_weights(weights)

    # -- weight management ----------------------------------------------
    @staticmethod
    def _validate(name: str, weight: float) -> float:
        weight = float(weight)
        if not math.isfinite(weight) or weight < 0.0:
            raise ValueError(
                f"weight for {name!r} must be finite and >= 0, "
                f"got {weight!r}")
        return weight

    def set_weight(self, name: str, weight: float) -> None:
        """Set (or add) one variant's weight live; 0 stops new
        assignments without removing the variant."""
        weight = self._validate(name, weight)
        with self._lock:
            self._weights[str(name)] = weight

    def set_weights(self, weights: Mapping[str, float]) -> None:
        """Replace-or-update several weights atomically — one lock, so a
        ramp step (candidate up, incumbent down) is a single transition
        no concurrent ``assign`` can observe half-applied."""
        validated = {str(n): self._validate(n, w)
                     for n, w in weights.items()}
        with self._lock:
            self._weights.update(validated)

    def remove(self, name: str) -> None:
        with self._lock:
            self._weights.pop(name, None)

    def weights(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._weights)

    # -- assignment -------------------------------------------------------
    def assign(self, key: str, among: Optional[Iterable[str]] = None) -> str:
        """The variant for ``key``. ``among`` restricts candidates (the
        mux service passes the currently *resident* names so a cold
        variant's share falls back to the survivors by the same
        rendezvous order instead of erroring)."""
        with self._lock:
            if among is None:
                candidates: Tuple[Tuple[str, float], ...] = tuple(
                    (n, w) for n, w in self._weights.items() if w > 0.0)
            else:
                candidates = tuple(
                    (n, self._weights.get(n, 0.0)) for n in among
                    if self._weights.get(n, 0.0) > 0.0)
        if not candidates:
            raise LookupError("no variant carries positive weight")
        key = str(key)
        best_name, best_score = None, -math.inf
        # sorted: ties (same weight AND same digest — practically never)
        # resolve identically on every process
        for name, weight in sorted(candidates):
            u = _uniform(key, name)
            score = -weight / math.log(u)
            if score > best_score:
                best_name, best_score = name, score
        return best_name

    def shares(self) -> Dict[str, float]:
        """Each positively-weighted variant's expected traffic fraction
        (``w / Σw``) — the number dashboards and the drill compare
        observed splits against."""
        with self._lock:
            live = {n: w for n, w in self._weights.items() if w > 0.0}
        total = sum(live.values())
        return {n: w / total for n, w in live.items()} if total else {}

    def snapshot(self) -> dict:
        with self._lock:
            weights = dict(self._weights)
        total = sum(w for w in weights.values() if w > 0.0)
        return {
            "weights": weights,
            "shares": {n: (w / total if total and w > 0.0 else 0.0)
                       for n, w in weights.items()},
        }
