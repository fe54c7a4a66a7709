"""Phase timing, pipeline stage timing and device traces — counterpart of
``gan_deeplearning4j_tpu/utils/profiling.py``.

- ``PhaseTimer``: wall time per named training phase. A phase whose scope
  is handed device tensors (the yielded sink) closes on a CUDA
  synchronize, so device work is billed to it and not to the enqueue;
- ``StageStats``: the serving batcher's per-stage busy time;
- ``device_trace(dir)``: a ``torch.profiler`` capture of the enclosed
  region (CPU and, with a card, CUDA activity), written as a Chrome trace.

Samples live in the process-wide registry histograms
``train_phase_seconds{phase=...}`` and ``serve_stage_seconds{stage=...}``,
so ``/metrics``, Prometheus scrapes and these objects read the same
samples.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional, Sequence

import torch

from gan_deeplearning4j_tpu_torch.telemetry.registry import get_registry
from gan_deeplearning4j_tpu_torch.telemetry.trace import TRACER

__all__ = ["PhaseTimer", "StageStats", "device_trace"]


def _synchronize(tensors) -> None:
    """Wait for every CUDA device that holds one of ``tensors``."""
    for device in {t.device for t in tensors if isinstance(t, torch.Tensor) and t.is_cuda}:
        torch.cuda.synchronize(device)


class PhaseTimer:
    """Accumulates wall-clock per named phase across loop iterations, with
    the per-call samples in the registry histogram ``train_phase_seconds``
    (``report()`` states p50/p95/p99 beside the totals)."""

    def __init__(self, max_samples: int = 65536,
                 metric: str = "train_phase_seconds", registry=None):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self._hist = (registry or get_registry()).histogram(
            metric, "wall seconds per named training phase",
            labelnames=("phase",), max_samples=max_samples,
        )
        self._children: Dict[str, object] = {}

    def _child(self, name: str):
        child = self._children.get(name)
        if child is None:
            child = self._hist.labels(phase=name)
            self._children[name] = child
        return child

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[list]:
        """Time one phase. The scope yields a sink list: append the phase's
        output tensors to it and the timer synchronizes their devices before
        it stops the clock (PyTorch returns before the card finishes)."""
        sink: list = []
        start = time.perf_counter()
        try:
            yield sink
        finally:
            if sink:
                _synchronize(sink)
            end = time.perf_counter()
            elapsed = end - start
            self.totals[name] += elapsed
            self.counts[name] += 1
            self._child(name).observe(elapsed)
            if TRACER.enabled:
                TRACER.complete(f"train.{name}", start, end)

    def mean(self, name: str) -> float:
        c = self.counts.get(name, 0)
        return self.totals[name] / c if c else 0.0

    def _percentiles(self, name: str, qs=(50, 95, 99)) -> Dict[str, float]:
        child = self._children.get(name)
        return child.percentiles(qs) if child is not None else {}

    def percentile(self, name: str, q: float) -> float:
        return self._percentiles(name, (q,)).get(f"p{q:g}", 0.0)

    def report(self) -> str:
        rows = sorted(self.totals.items(), key=lambda kv: -kv[1])
        out = []
        for name, total in rows:
            ps = self._percentiles(name)
            tail = "  ".join(f"{k} {v*1e3:8.2f}ms" for k, v in ps.items())
            out.append(
                f"{name:>24s}: total {total:8.3f}s  mean {self.mean(name)*1e3:8.2f}ms  "
                f"{tail}  n={self.counts[name]}"
            )
        return "\n".join(out)


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


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of the enclosed region into
    ``log_dir/trace.json`` (Chrome trace format; Perfetto reads it). No-op
    when ``log_dir`` is None."""
    if log_dir is None:
        yield
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
