"""Process-wide metrics registry — one definition for every number the
repo reports.

Before this module each plane observed itself differently: the batcher
kept bespoke counter dicts, ``StageStats``/``PhaseTimer`` kept their own
sample deques, the resilience drill re-derived publish costs from event
lists, and the three agreed only by convention. Here every counter, gauge,
and histogram is a named *family* in one registry; a family fans out into
labeled *series* (``family.labels(kind="sample")``) that the hot paths
resolve ONCE at construction and then update lock-cheap — no dict lookups,
no allocation per update. The registry exports two ways from the same
storage: :meth:`MetricsRegistry.snapshot` (the JSON ``/metrics`` payload
and BENCH artifacts) and :meth:`MetricsRegistry.to_prometheus` (text
exposition for scrapers), so a bench file and a live scrape can never
disagree about what a metric means (the TensorFlow-system paper's point:
shared instrumentation is what turns claims into measurements).

Stdlib-only on purpose: the PyTorch port keeps this copy of the JAX
package's registry so that it imports nothing of that package.

Threading: every series update takes the series' own lock — counter
increments from the batcher's worker and completer threads must never
lose updates (``x += 1`` on a plain attribute is interleavable at the
bytecode level). Family/series *creation* takes the registry lock.
"""

from __future__ import annotations

import math
import threading
from collections import deque
from typing import Dict, Iterable, List, Optional, Sequence, Tuple


def percentiles(values: Iterable[float], qs: Sequence[float] = (50, 95, 99)
                ) -> Dict[str, float]:
    """Nearest-rank percentiles of ``values`` as ``{"p50": ..., ...}``
    (empty dict for no samples). THE percentile definition — PhaseTimer,
    StageStats, the serving latency metrics, and serve_bench all route
    through this one function so BENCH artifacts and /metrics agree."""
    data = sorted(float(v) for v in values)
    if not data:
        return {}
    out = {}
    for q in qs:
        rank = max(1, min(len(data), math.ceil(q / 100.0 * len(data))))
        out[f"p{q:g}"] = data[rank - 1]
    return out


def _check_labels(labelnames: Sequence[str], kv: dict) -> Tuple:
    if set(kv) != set(labelnames):
        raise ValueError(
            f"expected labels {tuple(labelnames)}, got {tuple(sorted(kv))}"
        )
    return tuple(kv[name] for name in labelnames)


class Counter:
    """Monotonic counter series. ``inc`` only goes up — rates and totals."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up; use a Gauge")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value


class Gauge:
    """Point-in-time value series (queue depth, generation number)."""

    __slots__ = ("_lock", "_value")

    def __init__(self):
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    @property
    def value(self) -> float:
        return self._value


class Histogram:
    """Distribution series: count + sum + a bounded deque of recent raw
    samples. Keeping raw samples (not fixed buckets) preserves the repo's
    nearest-rank p50/p95/p99 contract exactly — the same numbers land in
    the JSON ``/metrics`` payload, the Prometheus summary exposition, and
    BENCH artifacts, because they come from this one deque."""

    __slots__ = ("_lock", "count", "total", "samples")

    def __init__(self, max_samples: int = 65536):
        self._lock = threading.Lock()
        self.count = 0
        self.total = 0.0
        self.samples: deque = deque(maxlen=max_samples)

    def observe(self, value: float) -> None:
        with self._lock:
            self.count += 1
            self.total += value
            self.samples.append(value)

    def percentiles(self, qs: Sequence[float] = (50, 95, 99)
                    ) -> Dict[str, float]:
        with self._lock:
            data = tuple(self.samples)
        return percentiles(data, qs)

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0


_KINDS = {"counter": Counter, "gauge": Gauge, "histogram": Histogram}


class _Family:
    """One named metric: a set of series keyed by label values."""

    def __init__(self, name: str, kind: str, help: str,
                 labelnames: Sequence[str], **series_kw):
        self.name = name
        self.kind = kind
        self.help = help
        self.labelnames = tuple(labelnames)
        self._series_kw = series_kw
        self._lock = threading.Lock()
        self._series: Dict[Tuple, object] = {}

    def labels(self, **kv):
        """The series for one label combination — resolve once, keep the
        handle, update it directly on the hot path."""
        key = _check_labels(self.labelnames, kv)
        series = self._series.get(key)
        if series is None:
            with self._lock:
                series = self._series.get(key)
                if series is None:
                    series = _KINDS[self.kind](**self._series_kw)
                    self._series[key] = series
        return series

    # label-less families act as their own single series
    def _solo(self):
        return self.labels()

    def inc(self, amount: float = 1.0) -> None:
        self._solo().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self._solo().dec(amount)

    def set(self, value: float) -> None:
        self._solo().set(value)

    def observe(self, value: float) -> None:
        self._solo().observe(value)

    def remove(self, **kv) -> bool:
        """Drop one labeled series. Gauges describe facts about things
        that can stop existing (a retired fleet member): without removal
        the series would linger at its last value forever and read as a
        live fact to every scrape and alert rule."""
        key = _check_labels(self.labelnames, kv)
        with self._lock:
            return self._series.pop(key, None) is not None

    def series(self) -> List[Tuple[Dict[str, str], object]]:
        with self._lock:
            return [
                (dict(zip(self.labelnames, key)), s)
                for key, s in sorted(self._series.items())
            ]


def _prom_name(name: str) -> str:
    out = [c if (c.isalnum() or c in "_:") else "_" for c in name]
    if out and out[0].isdigit():
        out.insert(0, "_")
    return "".join(out)


def _prom_label_value(value) -> str:
    return (str(value).replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _prom_labels(labels: Dict[str, str], extra: Optional[dict] = None) -> str:
    merged = dict(labels)
    if extra:
        merged.update(extra)
    if not merged:
        return ""
    inner = ",".join(
        f'{_prom_name(k)}="{_prom_label_value(v)}"'
        for k, v in merged.items()
    )
    return "{" + inner + "}"


def _fmt(v: float) -> str:
    f = float(v)
    if math.isnan(f):
        return "NaN"  # Prometheus text form (an SLO burn rate with an
        # empty window exports as NaN, not as a crash in int())
    if math.isinf(f):
        return "+Inf" if f > 0 else "-Inf"
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


class MetricsRegistry:
    """Get-or-create families; one instance is the process-wide default
    (:func:`get_registry`). Re-requesting a family with the same name,
    kind, and labelnames returns the existing one — the serving engine,
    batcher, harness, and store can all declare their metrics idempotently
    — while a conflicting redeclaration raises instead of silently forking
    the definition."""

    def __init__(self):
        self._lock = threading.Lock()
        self._families: Dict[str, _Family] = {}

    def _family(self, name: str, kind: str, help: str,
                labelnames: Sequence[str], **series_kw) -> _Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if (fam.kind != kind or fam.labelnames != tuple(labelnames)
                        or fam._series_kw != series_kw):
                    raise ValueError(
                        f"metric {name!r} already registered as {fam.kind} "
                        f"with labels {fam.labelnames} and "
                        f"{fam._series_kw or 'no series options'}, "
                        f"re-requested as {kind} with labels "
                        f"{tuple(labelnames)} and {series_kw or 'none'}"
                    )
                return fam
            fam = _Family(name, kind, help, labelnames, **series_kw)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help: str = "",
                labelnames: Sequence[str] = ()) -> _Family:
        return self._family(name, "counter", help, labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Sequence[str] = ()) -> _Family:
        return self._family(name, "gauge", help, labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Sequence[str] = (),
                  max_samples: int = 65536) -> _Family:
        return self._family(name, "histogram", help, labelnames,
                            max_samples=max_samples)

    # -- introspection / export -------------------------------------------
    def families(self) -> List[_Family]:
        with self._lock:
            return [f for _, f in sorted(self._families.items())]

    def series_count(self) -> int:
        """Total live series across families — the overhead smoke asserts
        this does not move while the telemetry-off serve path runs (no
        allocation on the hot path)."""
        return sum(len(f.series()) for f in self.families())

    def snapshot(self, include_samples: bool = False) -> dict:
        """JSON-ready view: the payload embedded in ``/metrics`` and in
        BENCH artifacts (``serve_bench --record`` / ``resilience_drill``).

        ``include_samples`` additionally exports each histogram's raw
        sample deque — the form the fleet aggregator needs so merged
        percentiles keep the nearest-rank contract (percentiles cannot be
        merged from quantiles; they CAN be recomputed from the union of
        samples — :mod:`.aggregate`)."""
        out: dict = {}
        for fam in self.families():
            series = []
            for labels, s in fam.series():
                if fam.kind == "histogram":
                    entry = {
                        "labels": labels, "count": s.count, "sum": s.total,
                        **s.percentiles(),
                    }
                    if include_samples:
                        with s._lock:
                            entry["samples"] = list(s.samples)
                    series.append(entry)
                else:
                    series.append({"labels": labels, "value": s.value})
            out[fam.name] = {"type": fam.kind, "help": fam.help,
                             "series": series}
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition (version 0.0.4). Histograms export as
        summaries — quantile series straight off the same sample deque the
        JSON payload reads, plus ``_sum``/``_count``."""
        lines: List[str] = []
        for fam in self.families():
            name = _prom_name(fam.name)
            if fam.help:
                lines.append(f"# HELP {name} {fam.help}")
            kind = "summary" if fam.kind == "histogram" else fam.kind
            lines.append(f"# TYPE {name} {kind}")
            for labels, s in fam.series():
                if fam.kind == "histogram":
                    ps = s.percentiles((50, 95, 99))
                    for q, key in ((0.5, "p50"), (0.95, "p95"), (0.99, "p99")):
                        if key in ps:
                            lines.append(
                                f"{name}"
                                f"{_prom_labels(labels, {'quantile': q})} "
                                f"{_fmt(ps[key])}"
                            )
                    lines.append(
                        f"{name}_sum{_prom_labels(labels)} {_fmt(s.total)}")
                    lines.append(
                        f"{name}_count{_prom_labels(labels)} {s.count}")
                else:
                    lines.append(
                        f"{name}{_prom_labels(labels)} {_fmt(s.value)}")
        return "\n".join(lines) + "\n"


_default = MetricsRegistry()
_default_lock = threading.Lock()


def get_registry() -> MetricsRegistry:
    """The process-wide registry every subsystem registers into."""
    return _default


def set_registry(registry: MetricsRegistry) -> MetricsRegistry:
    """Swap the process-wide registry; returns the previous one. Test
    isolation hook (tests/conftest.py installs a fresh registry per test
    so per-instance assertions never see another test's series)."""
    global _default
    with _default_lock:
        previous = _default
        _default = registry
    return previous
