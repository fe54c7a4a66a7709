"""Fleet metrics aggregation — merge per-process registry snapshots.

The PyTorch port's copy of ``gan_deeplearning4j_tpu/telemetry/aggregate.py`` (plain
Python, no JAX), kept inside the port so that it imports nothing of the
JAX package.

The fleet runs N serving workers plus a router, each with its own
process-wide :class:`~.registry.MetricsRegistry`. Until this module the
"fleet view" was N separate ``/metrics`` endpoints a human had to sum in
their head. :func:`merge_snapshots` folds the per-worker snapshots
(``registry.snapshot(include_samples=True)``) into ONE snapshot-shaped
dict the router serves at ``GET /metrics?scope=fleet``:

- **counters** are summed across members per label combination — a
  monotonic total is additive, and the merge is pure arithmetic over
  already-atomic per-process values, so the fleet total is exactly the
  sum of what each member reported (no sampling, no loss);
- **gauges** are NOT summed — a queue depth of 3 on one worker and 0 on
  another is two facts, not a 3. Every gauge series gains a ``worker``
  label naming its member, so the fleet payload keeps each fact;
- **histograms** merge count + sum + the raw sample deques, and the
  p50/p95/p99 quoted for the merged series are recomputed by the SAME
  nearest-rank :func:`~.registry.percentiles` over the union of samples —
  the one way the repo's percentile contract can hold fleet-wide
  (quantiles of quantiles are not quantiles; quantiles of the pooled
  samples are).

Partial failure degrades, never crashes: a member whose scrape failed is
listed in the ``_fleet.gaps`` metadata AND as a labeled
``fleet_member_up{worker=...} 0`` gauge series, so a dashboard shows the
hole instead of silently under-counting.

Stdlib-only, like the rest of the metrics plane — the router process
never imports jax.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Optional

from gan_deeplearning4j_tpu_torch.telemetry.registry import (
    _fmt,
    _prom_labels,
    _prom_name,
    percentiles,
)

#: reserved top-level key carrying merge metadata (members, gaps,
#: conflicts) — not a metric family; the Prometheus renderer skips it
FLEET_META_KEY = "_fleet"

#: synthetic per-member liveness family injected by the merge: 1 for every
#: member whose snapshot landed, 0 for every gap
MEMBER_UP = "fleet_member_up"


def _label_key(labels: dict) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in (labels or {}).items()))


def merge_snapshots(parts: Dict[str, dict],
                    gaps: Iterable[str] = (),
                    member_labels: Optional[Dict[str, dict]] = None
                    ) -> dict:
    """Merge member snapshots into one fleet snapshot.

    ``parts`` maps member id (worker id, ``"router"``) to that process's
    ``registry.snapshot(include_samples=True)`` payload; ``gaps`` names
    members whose scrape failed. Malformed families or members are
    recorded under ``_fleet.conflicts`` and skipped — an aggregation
    endpoint must degrade to a labeled partial view, never 500.

    ``member_labels`` maps a member id to extra labels stamped on EVERY
    series that member contributes — the model/generation dimension
    (docs/MULTIPLEX.md): two workers serving different generations emit
    identical ``serve_requests_total{kind,status}`` series, and without
    a distinguishing label the merge would sum them into one number,
    collapsing the per-model story. The router passes each worker's
    scraped ``generation`` here, so the merged counters keep one series
    per (labels × generation). Pass-through only fills labels a series
    does not already carry — a worker's own per-model labels (the mux
    plane's ``model=...``) always win."""
    families: dict = {}
    conflicts: list = []
    member_labels = member_labels or {}
    # accumulators: family -> label_key -> merged state
    for member in sorted(parts):
        snapshot = parts[member]
        extra = member_labels.get(member) or {}
        if not isinstance(snapshot, dict):
            conflicts.append(f"{member}: snapshot is not an object")
            continue
        for name in sorted(snapshot):
            fam = snapshot[name]
            if not (isinstance(fam, dict) and isinstance(
                    fam.get("series"), list) and "type" in fam):
                conflicts.append(f"{member}: family {name!r} malformed")
                continue
            kind = fam["type"]
            merged = families.setdefault(name, {
                "type": kind, "help": fam.get("help", ""), "series": {},
            })
            if merged["type"] != kind:
                conflicts.append(
                    f"{member}: family {name!r} is {kind}, fleet has "
                    f"{merged['type']} — member series skipped")
                continue
            for s in fam["series"]:
                if not isinstance(s, dict):
                    continue
                labels = dict(s.get("labels") or {})
                for k, v in extra.items():
                    # member-level dimension (generation/model): fill,
                    # never override a label the series already carries
                    labels.setdefault(str(k), str(v))
                if kind == "gauge":
                    # one fact per member: label, don't sum. setdefault —
                    # a series that already names the member it describes
                    # (the router's per-worker fleet_member_* gauges)
                    # keeps its own worker label; overriding it with the
                    # CONTRIBUTING member would relabel every fact as a
                    # fact about the router process
                    labels.setdefault("worker", member)
                key = _label_key(labels)
                slot = merged["series"].get(key)
                if slot is None:
                    slot = merged["series"][key] = {
                        "labels": labels, "count": 0, "sum": 0.0,
                        "samples": [], "value": 0.0,
                    }
                if kind == "histogram":
                    slot["count"] += int(s.get("count", 0))
                    slot["sum"] += float(s.get("sum", 0.0))
                    samples = s.get("samples")
                    if isinstance(samples, list):
                        slot["samples"].extend(
                            float(v) for v in samples)
                else:
                    slot["value"] += float(s.get("value", 0.0))

    out: dict = {}
    for name in sorted(families):
        fam = families[name]
        series = []
        for _, slot in sorted(fam["series"].items()):
            if fam["type"] == "histogram":
                entry = {"labels": slot["labels"], "count": slot["count"],
                         "sum": slot["sum"]}
                # the nearest-rank contract, fleet-wide: recompute from the
                # pooled samples (members that snapshot without samples
                # contribute count/sum only — percentiles then describe
                # the sampled subset, still nearest-rank)
                entry.update(percentiles(slot["samples"]))
                series.append(entry)
            else:
                series.append({"labels": slot["labels"],
                               "value": slot["value"]})
        out[name] = {"type": fam["type"], "help": fam["help"],
                     "series": series}

    gaps = sorted(set(gaps))
    members = sorted(parts)
    out[MEMBER_UP] = {
        "type": "gauge",
        "help": "1 when the member's registry scrape landed in this "
                "fleet snapshot, 0 when it failed (labeled gap)",
        "series": (
            [{"labels": {"worker": m}, "value": 1.0} for m in members]
            + [{"labels": {"worker": g}, "value": 0.0} for g in gaps]
        ),
    }
    out[FLEET_META_KEY] = {
        "members": members,
        "gaps": gaps,
        "conflicts": conflicts,
    }
    return out


def json_sanitize(obj):
    """Deep copy with non-finite floats replaced by None. JSON has no
    NaN/Infinity: a gauge holding NaN (the SLO burn rates' empty-window
    value) must reach the JSON fleet surface as ``null``, or strict
    parsers (jq, JS, Go) reject the whole payload — Python's own
    ``json.loads`` accepting ``NaN`` is the trap. The Prometheus path
    renders the SAME snapshot through ``_fmt``, which emits the text
    forms ``NaN``/``+Inf`` instead."""
    if isinstance(obj, float) and not math.isfinite(obj):
        return None
    if isinstance(obj, dict):
        return {k: json_sanitize(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [json_sanitize(v) for v in obj]
    return obj


def snapshot_to_prometheus(snapshot: dict) -> str:
    """Prometheus text exposition (0.0.4) of a snapshot-shaped dict — the
    merged fleet snapshot or any single ``registry.snapshot()`` payload.
    Histograms export as summaries off the same p50/p95/p99 the JSON
    quotes, so the two fleet surfaces can never disagree."""
    lines: list = []
    for name in sorted(k for k in snapshot if k != FLEET_META_KEY):
        fam = snapshot[name]
        if not (isinstance(fam, dict) and isinstance(
                fam.get("series"), list)):
            continue
        prom = _prom_name(name)
        if fam.get("help"):
            lines.append(f"# HELP {prom} {fam['help']}")
        kind = fam.get("type", "gauge")
        lines.append(
            f"# TYPE {prom} {'summary' if kind == 'histogram' else kind}")
        for s in fam["series"]:
            labels = s.get("labels") or {}
            if kind == "histogram":
                for q, key in ((0.5, "p50"), (0.95, "p95"), (0.99, "p99")):
                    if key in s:
                        lines.append(
                            f"{prom}{_prom_labels(labels, {'quantile': q})} "
                            f"{_fmt(s[key])}")
                lines.append(
                    f"{prom}_sum{_prom_labels(labels)} "
                    f"{_fmt(s.get('sum', 0.0))}")
                lines.append(
                    f"{prom}_count{_prom_labels(labels)} "
                    f"{int(s.get('count', 0))}")
            else:
                lines.append(
                    f"{prom}{_prom_labels(labels)} "
                    f"{_fmt(s.get('value', 0.0))}")
    return "\n".join(lines) + "\n"


def merge_traces(docs: Dict[str, Optional[dict]],
                 metadata: Optional[dict] = None) -> dict:
    """Concatenate Chrome trace documents into ONE trace. Valid by
    construction: every process's tracer pins timestamps to the wall
    epoch and stamps its own pid, so merged events share a timeline and
    render as distinct process tracks (docs/OBSERVABILITY.md). ``docs``
    maps member id to its ``/debug/spans`` payload (None = scrape
    failure, recorded as a gap)."""
    events: list = []
    sources: dict = {}
    gaps: list = []
    for member in sorted(docs):
        doc = docs[member]
        member_events = (doc or {}).get("traceEvents")
        if not isinstance(member_events, list):
            gaps.append(member)
            continue
        sources[member] = len(member_events)
        events.extend(member_events)
    meta = {"sources": sources, "gaps": gaps}
    if metadata:
        meta.update(metadata)
    return {"traceEvents": events, "displayTimeUnit": "ms",
            "metadata": meta}
