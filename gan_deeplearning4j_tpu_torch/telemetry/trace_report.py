"""trace_report — fold Chrome trace(s) into occupancy + attribution tables.

Consumes the Chrome trace-event JSON the telemetry span tracer exports
(``Tracer.dump``, ``serve_bench --trace``, the serving API's
``GET /debug/spans``, the fleet router's merged ``GET /debug/trace``, the
resilience worker's ``--span-trace``), or any file in the same format,
and answers the questions a wall of spans hides:

1. **per-phase occupancy** — for each span name: total busy seconds, how
   much of the trace's wall span that is, call count, mean and max. The
   "phase" is the span name's dotted prefix family (``serve.batcher.*``,
   ``resilience.*``), so the report reads as a plane-by-plane budget.
2. **top spans** — the N longest individual spans with their timestamps
   and correlation args: the tail-latency forensics view.
3. **per-worker occupancy skew** — when the (merged) trace holds more
   than one pid: busy seconds and occupancy per pid, plus a per-span-name
   skew table (max/min busy across pids) naming where the mesh is
   unbalanced. Multiple trace files merge by concatenation — every
   process's tracer pins timestamps to the wall epoch and stamps its own
   pid, so N worker traces are ONE timeline (docs/OBSERVABILITY.md).
4. **barrier-wait attribution** — ``resilience.mesh_stage`` /
   ``resilience.mesh_commit_wait`` spans fold per (generation, worker)
   into a table that NAMES the straggler of each coordinated publish: the
   worker with the longest stage time is the one everyone else's
   commit-wait paid for.
5. **alert overlay** (``--alerts <alerts.json>``) — the fleet alert
   plane's incident ring (the ``GET /alerts`` payload, or a bare list of
   transition records) rendered as instant events on the same wall-epoch
   timeline, so an incident reads as ONE story: the spans that slowed
   down, the alert going pending → firing over them, and the resolve
   after the recovery (docs/OBSERVABILITY.md "Alerting").

Exit status is the campaign-gate contract: nonzero when a file is
missing, malformed, or the merged trace contains no complete spans — an
empty trace artifact must FAIL the pipeline that was supposed to produce
one, not pass silently (the fleet drill gates on it over the router's
merged trace).

Stdlib-only. The PyTorch port's copy of ``scripts/trace_report.py``, run
as a module; nothing is adapted, so the two fold one trace identically.
A ``torch.profiler`` trace (``POST /debug/trace``, SIGUSR2) is in the
same format: its kernels fold as spans named after them.

Usage::

    python -m gan_deeplearning4j_tpu_torch.telemetry.trace_report artifacts/serve_trace.json
    python -m gan_deeplearning4j_tpu_torch.telemetry.trace_report w0_trace.json w1_trace.json \\
        --merge-out artifacts/mesh_trace.json --json report.json
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from collections import defaultdict

#: span names whose (gen, worker) args drive the barrier table
STAGE_SPAN = "resilience.mesh_stage"
WAIT_SPAN = "resilience.mesh_commit_wait"


def alert_events(path: str) -> list:
    """Alert lifecycle transitions as Chrome instant events. Accepts the
    ``GET /alerts`` payload (reads its ``incidents`` ring) or a bare list
    of transition records; each record's wall-clock ``t`` lands on the
    same epoch the span tracers pin their timestamps to, so the overlay
    and the spans share one timeline. Raises ValueError on anything that
    is not alert-shaped — a wrong file must fail the report, not overlay
    nothing."""
    with open(path) as fh:
        doc = json.load(fh)
    records = doc.get("incidents") if isinstance(doc, dict) else doc
    if not isinstance(records, list):
        raise ValueError(f"{path}: not an /alerts payload "
                         f"(no incidents list)")
    events = []
    for record in records:
        if not (isinstance(record, dict) and "alert" in record
                and isinstance(record.get("t"), (int, float))):
            raise ValueError(f"{path}: malformed incident record "
                             f"{record!r}")
        to = record.get("to", "?")
        events.append({
            "name": f"alert:{record['alert']}:{to}",
            "ph": "i",
            "s": "g",  # global scope: the marker spans the whole track
            "ts": record["t"] * 1e6,
            "pid": "alerts",
            "tid": record.get("severity", "alert"),
            "args": {k: v for k, v in record.items() if k != "t"},
        })
    return events


def load_events(path: str) -> list:
    """The trace's event list. Accepts both the object form
    (``{"traceEvents": [...]}``) and the bare-array form the Chrome
    format also allows. Raises ValueError on anything else."""
    with open(path) as fh:
        doc = json.load(fh)
    if isinstance(doc, dict):
        events = doc.get("traceEvents")
    elif isinstance(doc, list):
        events = doc
    else:
        raise ValueError(f"not a Chrome trace: top-level {type(doc).__name__}")
    if not isinstance(events, list):
        raise ValueError("not a Chrome trace: no traceEvents array")
    return events


def validate(events: list) -> list:
    """Schema check — every event needs ph/ts/pid/tid and a name; returns
    the list of violations (empty = valid)."""
    problems = []
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            problems.append(f"event {i}: not an object")
            continue
        for field in ("name", "ph", "ts", "pid", "tid"):
            if field not in ev:
                problems.append(f"event {i} ({ev.get('name', '?')}): "
                                f"missing {field!r}")
        if ev.get("ph") == "X" and "dur" not in ev:
            problems.append(f"event {i} ({ev.get('name', '?')}): "
                            f"complete event without dur")
    return problems


def _pair_async(events: list) -> list:
    """Synthesize (name, ts, dur, args, pid) rows for async b/e pairs
    keyed by (pid, name, id) — the batcher's cross-thread flight spans.
    The pid joins the key so two processes' flights never cross-pair in
    a merged trace."""
    open_by_key: dict = {}
    rows = []
    for ev in events:
        if ev.get("ph") == "b":
            open_by_key[(ev.get("pid"), ev["name"], ev.get("id"))] = ev
        elif ev.get("ph") == "e":
            begin = open_by_key.pop(
                (ev.get("pid"), ev["name"], ev.get("id")), None)
            if begin is not None:
                rows.append({
                    "name": ev["name"],
                    "ts": begin["ts"],
                    "dur": max(0.0, ev["ts"] - begin["ts"]),
                    "pid": begin.get("pid"),
                    "args": {**(begin.get("args") or {}),
                             **(ev.get("args") or {})},
                })
    return rows


def _worker_tables(spans: list, wall_us: float) -> dict:
    """Per-pid occupancy + per-span-name skew, for merged multi-process
    traces. Skew = max/min busy seconds across the pids that ran the
    span name — 1.0 is a perfectly balanced mesh; the table is sorted
    worst-first so the unbalanced phase tops the report."""
    by_pid: dict = defaultdict(lambda: {"busy_us": 0.0, "spans": 0})
    by_name_pid: dict = defaultdict(lambda: defaultdict(float))
    for s in spans:
        pid = s.get("pid")
        by_pid[pid]["busy_us"] += s["dur"]
        by_pid[pid]["spans"] += 1
        by_name_pid[s["name"]][pid] += s["dur"]
    workers = {
        str(pid): {
            "busy_s": agg["busy_us"] / 1e6,
            "spans": agg["spans"],
            "occupancy": agg["busy_us"] / wall_us,
        }
        for pid, agg in by_pid.items()
    }
    skew = {}
    for name, pids in by_name_pid.items():
        if len(pids) < 2:
            continue  # a single-pid span name has no skew to attribute
        values = sorted(pids.values())
        lo, hi = values[0], values[-1]
        skew[name] = {
            "pids": {str(p): v / 1e6 for p, v in sorted(pids.items())},
            "min_s": lo / 1e6,
            "max_s": hi / 1e6,
            "skew": (hi / lo) if lo > 0 else float("inf"),
        }
    return {
        "workers": dict(sorted(workers.items())),
        "skew": dict(sorted(skew.items(), key=lambda kv: -kv[1]["skew"])),
    }


def _barrier_table(spans: list) -> list:
    """Per coordinated publish (keyed by the ``gen`` span arg): each
    worker's stage vs commit-wait seconds, and THE NAMED STRAGGLER — the
    worker whose shard write took longest, i.e. what every other
    worker's barrier wait was spent on."""
    rounds: dict = defaultdict(lambda: defaultdict(
        lambda: {"stage_s": 0.0, "wait_s": 0.0, "pid": None}))
    for s in spans:
        if s["name"] not in (STAGE_SPAN, WAIT_SPAN):
            continue
        args = s.get("args") or {}
        gen, worker = args.get("gen"), args.get("worker")
        if gen is None or worker is None:
            continue
        slot = rounds[gen][worker]
        slot["pid"] = s.get("pid")
        key = "stage_s" if s["name"] == STAGE_SPAN else "wait_s"
        slot[key] += s["dur"] / 1e6
    table = []
    for gen in sorted(rounds):
        workers = rounds[gen]
        straggler = max(workers, key=lambda w: workers[w]["stage_s"])
        peers = [w for w in workers if w != straggler]
        table.append({
            "generation": gen,
            "workers": {
                str(w): {"pid": v["pid"],
                         "stage_s": round(v["stage_s"], 6),
                         "commit_wait_s": round(v["wait_s"], 6)}
                for w, v in sorted(workers.items())
            },
            "straggler": straggler,
            "straggler_stage_s": round(workers[straggler]["stage_s"], 6),
            "peer_max_wait_s": round(
                max((workers[w]["wait_s"] for w in peers), default=0.0), 6),
        })
    return table


def fold(events: list, top_n: int = 10) -> dict:
    """The report payload: wall span, per-name occupancy, top spans —
    plus per-worker and barrier attribution when the trace spans more
    than one process."""
    spans = [
        {"name": ev["name"], "ts": ev["ts"], "dur": ev.get("dur", 0.0),
         "pid": ev.get("pid"), "args": ev.get("args") or {}}
        for ev in events if ev.get("ph") == "X"
    ]
    spans += _pair_async(events)
    if not spans:
        raise ValueError("trace holds no complete spans (ph=X or b/e pairs)")
    all_ts = [ev["ts"] for ev in events if isinstance(ev.get("ts"), (int, float))]
    wall_us = max(
        max((s["ts"] + s["dur"]) for s in spans),
        max(all_ts),
    ) - min(all_ts)
    wall_us = max(wall_us, 1e-9)

    by_name: dict = defaultdict(lambda: {"busy_us": 0.0, "count": 0,
                                         "max_us": 0.0})
    for s in spans:
        agg = by_name[s["name"]]
        agg["busy_us"] += s["dur"]
        agg["count"] += 1
        agg["max_us"] = max(agg["max_us"], s["dur"])
    phases = {}
    for name, agg in by_name.items():
        phases[name] = {
            "busy_s": agg["busy_us"] / 1e6,
            "count": agg["count"],
            "mean_ms": agg["busy_us"] / agg["count"] / 1e3,
            "max_ms": agg["max_us"] / 1e3,
            "occupancy": agg["busy_us"] / wall_us,
        }

    top = sorted(spans, key=lambda s: -s["dur"])[:top_n]
    report = {
        "wall_s": wall_us / 1e6,
        "events": len(events),
        "spans": len(spans),
        "pids": sorted({str(s["pid"]) for s in spans}),
        "phases": dict(sorted(phases.items(),
                              key=lambda kv: -kv[1]["busy_s"])),
        "top_spans": [
            {"name": s["name"], "start_us": s["ts"], "dur_ms": s["dur"] / 1e3,
             "pid": s["pid"], "args": s["args"]}
            for s in top
        ],
    }
    if len(report["pids"]) > 1:
        report.update(_worker_tables(spans, wall_us))
    barriers = _barrier_table(spans)
    if barriers:
        report["barriers"] = barriers
    return report


def render(report: dict) -> str:
    out = [
        f"wall {report['wall_s']:.3f}s — {report['events']} events, "
        f"{report['spans']} spans, {len(report['pids'])} process(es)",
        "",
        f"{'span name':>32s}  {'busy s':>9s}  {'occ':>6s}  {'n':>6s}  "
        f"{'mean ms':>9s}  {'max ms':>9s}",
    ]
    for name, p in report["phases"].items():
        out.append(
            f"{name:>32s}  {p['busy_s']:9.3f}  {p['occupancy']:6.1%}  "
            f"{p['count']:6d}  {p['mean_ms']:9.3f}  {p['max_ms']:9.3f}"
        )
    if "workers" in report:
        out.append("")
        out.append("per-worker occupancy:")
        out.append(f"  {'pid':>10s}  {'busy s':>9s}  {'occ':>6s}  "
                   f"{'spans':>6s}")
        for pid, w in report["workers"].items():
            out.append(f"  {pid:>10s}  {w['busy_s']:9.3f}  "
                       f"{w['occupancy']:6.1%}  {w['spans']:6d}")
        if report.get("skew"):
            out.append("")
            out.append("occupancy skew (max/min busy across pids, "
                       "worst first):")
            for name, s in list(report["skew"].items())[:10]:
                skew = ("inf" if s["skew"] == float("inf")
                        else f"{s['skew']:.2f}x")
                out.append(f"  {name:<32s}  {skew:>8s}  "
                           f"(min {s['min_s']:.3f}s, max {s['max_s']:.3f}s)")
    for b in report.get("barriers", []):
        out.append("")
        out.append(
            f"mesh publish gen {b['generation']}: straggler worker "
            f"{b['straggler']} (stage {b['straggler_stage_s']:.3f}s; "
            f"peers waited up to {b['peer_max_wait_s']:.3f}s)")
        for w, v in b["workers"].items():
            out.append(f"  worker {w} (pid {v['pid']}): stage "
                       f"{v['stage_s']:.3f}s, commit wait "
                       f"{v['commit_wait_s']:.3f}s")
    out.append("")
    out.append("top spans:")
    for s in report["top_spans"]:
        args = {k: v for k, v in s["args"].items() if k != "riders"}
        out.append(f"  {s['dur_ms']:9.3f}ms  {s['name']:<28s}  {args}")
    return "\n".join(out)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("traces", nargs="+",
                   help="Chrome trace-event JSON file(s); several merge "
                        "into one timeline (wall-epoch timestamps)")
    p.add_argument("--top", type=int, default=10,
                   help="longest individual spans to list")
    p.add_argument("--json", default=None, metavar="PATH",
                   help="also write the report as JSON")
    p.add_argument("--merge-out", default=None, metavar="PATH",
                   help="write the merged Chrome trace (Perfetto-loadable)")
    p.add_argument("--alerts", default=None, metavar="PATH",
                   help="overlay the alert plane's firing/resolved "
                        "transitions (a GET /alerts payload, or a bare "
                        "incident list) as instant events on the merged "
                        "timeline")
    args = p.parse_args(argv)

    events: list = []
    try:
        for path in args.traces:
            file_events = load_events(path)
            problems = validate(file_events)
            if problems:
                for line in problems[:20]:
                    sys.stderr.write(f"trace_report: {line}\n")
                sys.stderr.write(
                    f"trace_report: {path}: {len(problems)} schema "
                    f"violation(s)\n")
                return 1
            events.extend(file_events)
        overlay = alert_events(args.alerts) if args.alerts else []
        events.extend(overlay)
        report = fold(events, top_n=args.top)
    except (OSError, ValueError, json.JSONDecodeError) as exc:
        sys.stderr.write(f"trace_report: {exc}\n")
        return 1
    if overlay:
        by_state: dict = {}
        for ev in overlay:
            to = (ev.get("args") or {}).get("to", "?")
            by_state[to] = by_state.get(to, 0) + 1
        report["alerts"] = {"transitions": len(overlay),
                            "by_state": dict(sorted(by_state.items()))}
    print(render(report))
    if overlay:
        print("\nalert overlay:")
        for ev in overlay:
            arg = ev.get("args") or {}
            labels = arg.get("labels") or {}
            label_text = ",".join(f"{k}={v}" for k, v in
                                  sorted(labels.items()))
            print(f"  {ev['ts'] / 1e6:.3f}s  {arg.get('alert', '?'):<28s}"
                  f"  {arg.get('from', '?')} -> {arg.get('to', '?')}"
                  f"  {{{label_text}}}")
    if args.merge_out:
        os.makedirs(os.path.dirname(os.path.abspath(args.merge_out)),
                    exist_ok=True)
        with open(args.merge_out, "w") as fh:
            json.dump({"traceEvents": events, "displayTimeUnit": "ms",
                       "metadata": {"sources": args.traces}}, fh)
            fh.write("\n")
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)),
                    exist_ok=True)
        with open(args.json, "w") as fh:
            json.dump(report, fh, indent=2)
            fh.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
