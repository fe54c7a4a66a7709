"""Pipeline stage timing — the ``StageStats`` of
``gan_deeplearning4j_tpu/utils/profiling.py``, copied for the serving
batcher (the training ``PhaseTimer`` and device captures come with later
slices).

Per-stage samples live in the process-wide registry histogram
``serve_stage_seconds{stage=...}``, so ``/metrics``, Prometheus scrapes and
``summary_ms()`` read the same samples.
"""

from __future__ import annotations

import time
from typing import Dict, Sequence

from gan_deeplearning4j_tpu_torch.telemetry.registry import get_registry

__all__ = ["StageStats"]


class StageStats:
    """Busy-time + latency accounting for a fixed set of pipeline stages.

    The serving batcher splits a flush into assemble (host staging +
    async dispatch), device (wait-until-ready), and complete (scatter to
    callers); each stage records its per-flush duration here.
    ``occupancy()`` is busy-seconds / wall-seconds since construction —
    the direct read on whether the pipeline overlaps (assemble occupancy
    ≪ 1 while device occupancy ≈ 1 means the host keeps the device fed).
    Per-stage samples live in the registry histogram
    ``serve_stage_seconds`` (its ``sum`` is the process-wide busy time);
    ``busy`` and the wall-clock origin stay per-instance, and callers
    serialize ``add`` per stage (the batcher records each stage from the
    one thread that runs it)."""

    def __init__(self, stages: Sequence[str], max_samples: int = 65536,
                 metric: str = "serve_stage_seconds", registry=None):
        self._t0 = time.monotonic()
        self.busy: Dict[str, float] = {s: 0.0 for s in stages}
        hist = (registry or get_registry()).histogram(
            metric, "busy seconds per pipeline stage, per flush",
            labelnames=("stage",), max_samples=max_samples,
        )
        self._children = {s: hist.labels(stage=s) for s in stages}

    def add(self, stage: str, seconds: float) -> None:
        self.busy[stage] += seconds
        self._children[stage].observe(seconds)

    def occupancy(self) -> Dict[str, float]:
        elapsed = max(time.monotonic() - self._t0, 1e-9)
        return {s: b / elapsed for s, b in self.busy.items()}

    def summary_ms(self) -> Dict[str, Dict[str, float]]:
        # read through Histogram.percentiles (copies under the series lock):
        # the worker/completer threads observe concurrently with a /metrics
        # read, and iterating a deque mid-append raises
        return {
            s: {k: v * 1e3 for k, v in child.percentiles().items()}
            for s, child in self._children.items()
            if child.count
        }
