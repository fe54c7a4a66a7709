"""serve bench — closed-loop load against the serving path; the port's
``scripts/serve_bench.py``, with its modes, flags and JSON keys.

Builds fresh MNIST artifacts (the generator and the discriminator-feature
classifier), publishes them with the port's serializer as a training run
would, loads them back through ``ServingEngine.from_checkpoints`` and
drives the in-process service with a mixed workload: every client thread
loops submit → wait → submit (closed loop) over random request kinds and
batch sizes. An OVERLOAD phase follows (a tiny queue, tight deadlines,
more clients than slots), which shows that shedding stays explicit under
pressure. The summary holds throughput, latency percentiles, the
per-stage pipeline breakdown (assemble / device / complete), the batch
occupancy histogram, shed counts and the capture ledger. It exits 1 when
an invariant breaks:

- ``zero_lost``: every submit returns ok or an explicit shed, in the main
  phase; ``overload_zero_lost`` the same in the overload phase;
- ``compiles_bounded``: captures per kind ≤ the engine's declared bound
  (ladder size × replicas);
- ``no_serve_time_compiles``: after warmup the count per kind does not
  move (mixed request sizes ride the padded buckets).

A "compile" here — ``compile_counts``, ``serve_compile_counts``,
``expected_max_compiles``, ``warmup_compile_s`` and the invariants'
names, all kept from the JAX script — is a CUDA-graph capture on the card
(a first run on the CPU): what the JAX engine compiles ahead of time per
(kind, bucket), the port's engine captures.

Modes:

- ``--legacy``: the unstaged path, ``engine.run_host`` (an eager forward
  on the default stream after a host ``np.concatenate`` pad) behind a
  serial flush loop (``pipeline_depth=1``), replica 0 only;
- ``--compare ROUNDS``: after the main phase, ROUNDS pairs of a fast round
  and a legacy round in this process against the same warm engine; the
  paired ratio cancels machine noise;
- ``--replay TRACE.json``: the learned-ladder bench. The trace holds
  ``{"name", "sizes", "conditional"?: {"classes": C}}``, the JAX input
  format; it is replayed twice against one bundle, once on the fixed
  ``--replay-baseline`` ladder and once on the ladder ``solve_ladder``
  learns from the baseline pass's flush-size histogram, at the same
  capture budget. It reports analytic and measured padded-rows waste,
  p99 and captures side by side, and exits 1 unless
  ``learned_ladder_within_budget`` and ``learned_waste_not_worse`` hold
  beside the three above. The JAX script reads
  ``scripts/data/heavy_tail_trace.json`` by default; that file is not in
  the repo, so here the path is required.

Where the port differs, and why:

- ``--replicas N`` puts N replicas on the one device (``devices=(dev,) *
  N``: each its own stream, graph pool and captures, as ``chip_smoke.py``
  (z) runs them on one card); the JAX script forces N host devices. The
  bound has no +1 per kind for a bulk executable: the port's bulk lane
  replays the top-bucket graphs and captures nothing of its own;
- the replay's ``elasticity`` block keeps its keys, but ``cache_dir`` is
  null: the JAX block times a warmup refilled from XLA's persistent
  compile cache, and captured CUDA graphs do not outlive the process.
  ``warm_warmup_s`` is a second, fresh engine on the baseline ladder
  warmed in the same process, and ``--compilation-cache`` is refused;
- ``--trace DIR`` writes a ``torch.profiler`` trace of the main phase
  (``DIR/trace.json``, through ``utils/profiling.py::device_trace``); with
  ``--telemetry`` the span tracer's Chrome trace lands beside it
  (``DIR/spans.json``);
- latency percentiles and ``telemetry`` read the process-wide registry,
  as in the JAX script, but the bench and each replay pass swap in a
  fresh one for their run (``telemetry.registry.set_registry``) and put
  the caller's back after. In the JAX script the learned pass's
  percentiles also hold the baseline pass's samples (one histogram), and
  an in-process caller's earlier traffic would enter the main phase's.

Usage::

    python -m gan_deeplearning4j_tpu_torch.serving.bench                  # on the card
    python -m gan_deeplearning4j_tpu_torch.serving.bench --cpu --smoke
    python -m gan_deeplearning4j_tpu_torch.serving.bench --compare 3
    python -m gan_deeplearning4j_tpu_torch.serving.bench --replay TRACE.json

It runs on ``cuda:0`` unless given ``--cpu``, and without a card it exits
2 and runs nothing. It prints the summary's headline as JSON and writes a
file only where asked: ``--output PATH``, and ``--record TAG``
(``BENCH_torch_serving_<TAG>.json``, or ``BENCH_torch_ladder_<TAG>.json``
for a replay, at the repo root).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import threading
import time

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def build_bundle(directory: str, seed: int = 666, classes: int = 0) -> dict:
    """Fresh (untrained) MNIST artifacts through the port's publish path:
    the graphs are built and their serving checkpoints written with
    ``write_model``, so the bench loads what a trained bundle would give
    the loader; weights do not change the serving layer's work.

    ``classes > 0`` builds the conditional variant: the generator's input
    grows by the one-hot label block as the conditional trainer builds
    it, and ``scenario`` is the zoo manifest block a conditional bundle
    declares, so the engine the bench loads is conditional end to end."""
    import dataclasses

    from gan_deeplearning4j_tpu_torch.harness import ExperimentConfig
    from gan_deeplearning4j_tpu_torch.models import registry
    from gan_deeplearning4j_tpu_torch.utils import write_model

    cfg = ExperimentConfig(seed=seed)
    family = registry.get("mnist")
    model_cfg = family.make_model_config(cfg)
    dis = family.build_discriminator(model_cfg)
    gen_cfg = model_cfg
    scenario = None
    if classes > 0:
        gen_cfg = dataclasses.replace(model_cfg, z_size=model_cfg.z_size + classes)
        from gan_deeplearning4j_tpu_torch.zoo.manifest import ScenarioManifest

        scenario = ScenarioManifest(
            architecture="dcgan", conditioning="class", dataset="mnist",
            resolution=cfg.height, num_classes=classes, z_size=model_cfg.z_size,
        ).to_dict()
    gen = family.build_generator(gen_cfg)
    # params are drawn on the CPU and written: the engine moves them once
    dis_params = dis.init(device="cpu")
    cv, cv_params = family.build_transfer_classifier(dis, dis_params, model_cfg)
    gen_path = os.path.join(directory, "bench_gen_serving.zip")
    cv_path = os.path.join(directory, "bench_CV_serving.zip")
    write_model(gen_path, gen, gen.init(device="cpu"), save_updater=False)
    write_model(cv_path, cv, cv_params, save_updater=False)
    return {
        "generator": gen_path,
        "classifier": cv_path,
        "feature_vertex": list(family.dis_to_cv.values())[-1],
        "z_size": model_cfg.z_size,
        "num_features": cfg.num_features,
        "classes": classes,
        "scenario": scenario,
    }


def _drive(service, kinds, width, sizes, requests, threads, seed,
           timeout=None, classes=0):
    """Closed-loop phase: ``threads`` clients loop submit → wait → submit.
    Returns (statuses, rows_done, elapsed): one status per request, the
    zero-lost ledger. ``classes > 0`` drives the conditional sample kind:
    the last ``classes`` columns of each sample row are a one-hot label
    block (a random class per row), as the HTTP seam's ``?class=k``
    appends. Worker ``w`` draws from ``np.random.default_rng(seed + w)``
    exactly as the JAX script's does, so both send the same requests."""
    statuses = []
    lock = threading.Lock()
    per_thread = requests // threads
    rows_done = [0]

    def worker(widx: int) -> None:
        rng = np.random.default_rng(seed + widx)
        for _ in range(per_thread):
            kind = kinds[rng.integers(len(kinds))]
            n = int(sizes[rng.integers(len(sizes))])
            if kind == "sample" and classes > 0:
                z = rng.random((n, width[kind] - classes), dtype=np.float32) * 2.0 - 1.0
                onehot = np.eye(classes, dtype=np.float32)[rng.integers(classes, size=n)]
                rows = np.concatenate([z, onehot], axis=1)
            else:
                rows = rng.random((n, width[kind]), dtype=np.float32)
                if kind == "sample":
                    rows = rows * 2.0 - 1.0
            res = service.batcher.submit(kind, rows, timeout=timeout)
            with lock:
                statuses.append(res.status)
                if res.ok:
                    rows_done[0] += res.data.shape[0]

    workers = [threading.Thread(target=worker, args=(w,), daemon=True) for w in range(threads)]
    t0 = time.perf_counter()
    for t in workers:
        t.start()
    for t in workers:
        t.join()
    return statuses, rows_done[0], time.perf_counter() - t0


class _LegacyService:
    """The unstaged path on the same artifacts and knobs: ``run_host`` (a
    host pad and an eager forward on replica 0) behind a strictly serial
    flush loop."""

    def __init__(self, engine, args):
        from gan_deeplearning4j_tpu_torch.serving import MicroBatcher

        self.engine = engine
        self.batcher = MicroBatcher(
            engine.run_host,
            max_batch=engine.buckets[-1],
            max_latency=args.max_latency,
            max_queue=args.max_queue,
            default_timeout=args.timeout,
            pipeline_depth=1,
        )

    def metrics(self) -> dict:
        return {**self.batcher.metrics(), "compile_counts": self.engine.compile_counts}

    def close(self) -> None:
        self.batcher.close()


def _make_service(engine, args, legacy: bool):
    from gan_deeplearning4j_tpu_torch.serving import InferenceService

    if legacy:
        return _LegacyService(engine, args)
    return InferenceService(
        engine,
        max_latency=args.max_latency,
        max_queue=args.max_queue,
        default_timeout=args.timeout,
        warmup=False,  # the bench warms (and times) the engine itself
        pipeline_depth=args.pipeline_depth,
    )


def _devices(args) -> tuple:
    """The replicas' devices: ``--replicas`` of the one device."""
    return ("cpu" if args.cpu else "cuda:0",) * args.replicas


def _build_engine(bundle: dict, args, buckets):
    from gan_deeplearning4j_tpu_torch.serving import ServingEngine

    return ServingEngine.from_checkpoints(
        generator=bundle["generator"],
        classifier=bundle["classifier"],
        buckets=buckets,
        feature_vertex=bundle["feature_vertex"],
        replicas=args.replicas,
        devices=_devices(args),
        scenario=bundle["scenario"],
    )


@contextlib.contextmanager
def _own_registry():
    """A fresh process-wide metrics registry for the block, the previous
    one restored after: a phase's latency percentiles and ``telemetry``
    then hold its own samples only."""
    from gan_deeplearning4j_tpu_torch.telemetry.registry import MetricsRegistry, set_registry

    previous = set_registry(MetricsRegistry())
    try:
        yield
    finally:
        set_registry(previous)


def _platform(engine) -> dict:
    out = {"platform": engine.platform}
    if engine.platform == "gpu":
        import torch

        out["device_name"] = torch.cuda.get_device_name(engine.device)
    return out


def run_bench(args) -> dict:
    """The main phase, the overload phase and the paired rounds; the
    summary with the JAX script's keys."""
    from gan_deeplearning4j_tpu_torch.serving import InferenceService
    from gan_deeplearning4j_tpu_torch.telemetry.registry import get_registry
    from gan_deeplearning4j_tpu_torch.utils.profiling import device_trace

    with tempfile.TemporaryDirectory() as tmp, _own_registry():
        bundle = build_bundle(tmp, seed=args.seed)
        engine = _build_engine(bundle, args, args.buckets)
        t_compile = time.perf_counter()
        engine.warmup()
        compile_s = time.perf_counter() - t_compile
        warm_compiles = engine.compile_counts
        service = _make_service(engine, args, args.legacy)

        width = {"sample": bundle["z_size"],
                 "classify": bundle["num_features"],
                 "features": bundle["num_features"]}
        kinds = list(engine.kinds)
        sizes = [s for s in args.sizes if s <= max(args.buckets)]

        with device_trace(args.trace):
            statuses, rows_ok, elapsed = _drive(
                service, kinds, width, sizes, args.requests, args.threads, args.seed,
            )
        metrics = service.metrics()
        service.close()
        # snapshot here, before the overload and compare phases observe into
        # the same process-wide series: the telemetry section must agree with
        # the main phase's own latency_ms
        telemetry_snapshot = get_registry().snapshot()

        # -- overload: more clients than queue slots, tight deadlines; every
        # submit must still get exactly one explicit result
        overload = {"requests": 0}
        if args.overload_requests > 0:
            ob = InferenceService(
                engine,
                max_latency=args.max_latency,
                max_queue=args.overload_queue,
                default_timeout=args.overload_timeout,
                warmup=False,
                pipeline_depth=args.pipeline_depth,
            )
            o_statuses, _, o_elapsed = _drive(
                ob, kinds, width, sizes, args.overload_requests,
                args.overload_threads, args.seed + 1000,
            )
            ob.close()
            overload = {
                "requests": args.overload_threads * (args.overload_requests
                                                     // args.overload_threads),
                "returned": len(o_statuses),
                "ok": sum(1 for s in o_statuses if s == "ok"),
                "shed": sum(1 for s in o_statuses if s in ("overloaded", "deadline")),
                "errors": sum(1 for s in o_statuses if s == "error"),
                "elapsed_s": o_elapsed,
                "max_queue": args.overload_queue,
                "timeout_s": args.overload_timeout,
            }

        # -- compare: a fast round and a legacy round in turn, in this process
        # against the same warm engine
        compare = None
        if args.compare > 0:
            rounds = []
            for _ in range(args.compare):
                row = {}
                for label, legacy in (("fast", False), ("legacy", True)):
                    svc = _make_service(engine, args, legacy)
                    _, rows_n, secs = _drive(
                        svc, kinds, width, sizes, args.requests, args.threads, args.seed,
                    )
                    row[f"{label}_flushes"] = svc.metrics()["flushes"]
                    svc.close()
                    row[label] = rows_n / secs if secs > 0 else 0.0
                row["ratio"] = row["fast"] / row["legacy"] if row["legacy"] > 0 else 0.0
                rounds.append(row)
            ratios = sorted(r["ratio"] for r in rounds)
            compare = {"rounds": rounds, "median_ratio": ratios[len(ratios) // 2]}

        serve_compiles = engine.serve_compile_counts
        compile_counts = engine.compile_counts
        max_compiles = engine.expected_max_compiles
        replica_dispatches = engine.stats()["replica_dispatches"]
        platform = _platform(engine)
        engine.close()

    submitted = args.threads * (args.requests // args.threads)
    lost = submitted - len(statuses)
    ok = sum(1 for s in statuses if s == "ok")
    shed = sum(1 for s in statuses if s in ("overloaded", "deadline"))
    errors = sum(1 for s in statuses if s == "error")
    o_lost = overload.get("requests", 0) - overload.get("returned", 0)
    return {
        "bench": "serve_bench",
        "config": {
            "requests": submitted,
            "threads": args.threads,
            "buckets": list(args.buckets),
            "sizes": sizes,
            "replicas": args.replicas,
            "pipeline_depth": args.pipeline_depth,
            "legacy": bool(args.legacy),
            "max_latency_s": args.max_latency,
            "max_queue": args.max_queue,
            "timeout_s": args.timeout,
            **platform,
        },
        "results": {
            "ok": ok,
            "shed": shed,
            "errors": errors,
            "lost": lost,
            "elapsed_s": elapsed,
            "warmup_compile_s": compile_s,
            "warmup_compile_counts": warm_compiles,
            "throughput_rps": submitted / elapsed if elapsed > 0 else 0.0,
            "throughput_rows_per_s": rows_ok / elapsed if elapsed > 0 else 0.0,
            "latency_ms": metrics["latency_ms"],
            "batch_occupancy": metrics["batch_occupancy"],
            "flushes": metrics["flushes"],
            "pipeline": metrics["pipeline"],
            "compile_counts": compile_counts,
            "serve_compile_counts": serve_compiles,
            "replica_dispatches": replica_dispatches,
        },
        "overload": overload,
        "compare": compare,
        # the registry series a /metrics?format=prom scrape would show at the
        # end of the main phase
        "telemetry": telemetry_snapshot,
        "invariants": {
            "zero_lost": lost == 0 and errors == 0,
            "overload_zero_lost": o_lost == 0 and overload.get("errors", 0) == 0,
            "compiles_bounded": all(c <= max_compiles for c in compile_counts.values()),
            "no_serve_time_compiles": all(c == 0 for c in serve_compiles.values()),
        },
    }


def _replay_phase(engine, args, kinds, width, trace_sizes, threads, classes=0):
    """Drive one engine over the trace's draws; its measured side of the
    pair (waste, latency, captures, the zero-lost ledger)."""
    from gan_deeplearning4j_tpu_torch.serving import InferenceService

    service = InferenceService(
        engine,
        max_latency=args.max_latency,
        max_queue=args.max_queue,
        default_timeout=args.timeout,
        warmup=False,  # the replay warms (and times) the engine itself
        pipeline_depth=args.pipeline_depth,
    )
    statuses, rows_ok, elapsed = _drive(
        service, kinds, width, trace_sizes, len(trace_sizes), threads, args.seed,
        classes=classes,
    )
    metrics = service.metrics()
    stats = engine.stats()
    flush_counts = service.batcher.size_histogram.merged()
    service.close()
    submitted = threads * (len(trace_sizes) // threads)
    wasted = stats["padded_rows_wasted"]
    return flush_counts, {
        "buckets": list(engine.buckets),
        "requests": submitted,
        "ok": sum(1 for s in statuses if s == "ok"),
        "shed": sum(1 for s in statuses if s in ("overloaded", "deadline")),
        "errors": sum(1 for s in statuses if s == "error"),
        "lost": submitted - len(statuses),
        "rows_ok": rows_ok,
        "elapsed_s": elapsed,
        "throughput_rows_per_s": rows_ok / elapsed if elapsed > 0 else 0.0,
        "latency_ms": metrics["latency_ms"],
        "padded_rows_wasted": dict(wasted),
        "padded_rows_wasted_total": sum(wasted.values()),
        "compile_counts": dict(engine.compile_counts),
        "compiles_total": sum(engine.compile_counts.values()),
        "serve_compile_counts": dict(engine.serve_compile_counts),
        "expected_max_compiles": engine.expected_max_compiles,
    }


def run_replay(args) -> dict:
    """The paired heavy-tail replay: the learned ladder against the fixed
    baseline at the same capture budget, and a re-warm.

    The learned ladder is solved from the flush-size histogram the
    baseline pass records (the signal the reload plane learns from a live
    incumbent), because the engine pads coalesced flushes, not single
    submits. Both passes replay the same draws, so the comparison is
    paired."""
    from gan_deeplearning4j_tpu_torch.serving import expected_waste, solve_ladder

    with open(args.replay) as fh:
        trace = json.load(fh)
    trace_sizes = [int(s) for s in trace.get("sizes", []) if int(s) >= 1]
    if not trace_sizes:
        raise SystemExit(f"replay trace {args.replay} has no sizes")
    # a conditional trace declares its class count: the replay then builds a
    # conditional bundle and drives full-width sample rows (latent + one-hot)
    classes = int((trace.get("conditional") or {}).get("classes", 0))
    threads = args.threads
    if args.smoke:
        trace_sizes = trace_sizes[:96]
        threads = min(threads, 4)

    baseline = tuple(sorted(set(args.replay_baseline)))
    top = baseline[-1]

    with tempfile.TemporaryDirectory() as tmp:
        bundle = build_bundle(tmp, seed=args.seed, classes=classes)
        width = {"sample": bundle["z_size"] + classes,
                 "classify": bundle["num_features"],
                 "features": bundle["num_features"]}

        # -- the baseline pass, shaped like an incumbent: its cold warmup is
        # the elasticity half's cold time, its flush histogram the solver's
        # input
        with _own_registry():
            base_engine = _build_engine(bundle, args, baseline)
            t0 = time.perf_counter()
            base_engine.warmup()
            cold_s = time.perf_counter() - t0
            kinds = list(base_engine.kinds)
            flush_counts, baseline_phase = _replay_phase(
                base_engine, args, kinds, width, trace_sizes, threads, classes=classes)
            platform = _platform(base_engine)
            base_engine.close()

        learned = solve_ladder(flush_counts, budget=len(baseline), top=top)
        analytic = {
            "baseline_rows": expected_waste(flush_counts, baseline),
            "learned_rows": expected_waste(flush_counts, learned),
        }
        analytic["ratio"] = (analytic["learned_rows"] / analytic["baseline_rows"]
                             if analytic["baseline_rows"] > 0 else 0.0)

        with _own_registry():
            engine = _build_engine(bundle, args, learned)
            engine.warmup()
            _, learned_phase = _replay_phase(
                engine, args, kinds, width, trace_sizes, threads, classes=classes)
            engine.close()

        # -- re-warm: a fresh engine on the baseline ladder, in this process.
        # No store of captured graphs outlives a process, so this is what a
        # second engine costs, not a restarted worker's warmup
        warm_engine = _build_engine(bundle, args, baseline)
        t0 = time.perf_counter()
        warm_engine.warmup()
        warm_s = time.perf_counter() - t0
        warm_engine.close()
        elasticity = {
            "cache_dir": None,
            "cold_warmup_s": cold_s,
            "warm_warmup_s": warm_s,
            "speedup": cold_s / warm_s if warm_s > 0 else 0.0,
            "note": ("captured CUDA graphs do not outlive the process, so no persistent "
                     "cache is read: warm_warmup_s is a second, fresh engine warmed in the "
                     "same process (a restarted worker's boot is measured by chip_smoke.py (y))"),
        }

    measured = {
        "baseline_rows": baseline_phase["padded_rows_wasted_total"],
        "learned_rows": learned_phase["padded_rows_wasted_total"],
    }
    measured["ratio"] = (measured["learned_rows"] / measured["baseline_rows"]
                         if measured["baseline_rows"] > 0 else 0.0)

    return {
        "bench": "serve_replay",
        "config": {
            "trace": os.path.relpath(args.replay, _REPO),
            "trace_name": trace.get("name"),
            "requests": len(trace_sizes),
            "distinct_sizes": len(set(trace_sizes)),
            "threads": threads,
            "replicas": args.replicas,
            "conditional_classes": classes,
            "smoke": bool(args.smoke),
            **platform,
        },
        "ladder": {
            "baseline": list(baseline),
            "learned": list(learned),
            "budget": len(baseline),
            "analytic_padded_rows": analytic,
            "solved_from_flush_sizes": {str(s): c for s, c in sorted(flush_counts.items())},
        },
        "phases": {"baseline": baseline_phase, "learned": learned_phase},
        "waste": measured,
        "elasticity": elasticity,
        "invariants": {
            "zero_lost": all(p["lost"] == 0 and p["errors"] == 0
                             for p in (baseline_phase, learned_phase)),
            "no_serve_time_compiles": all(
                c == 0 for p in (baseline_phase, learned_phase)
                for c in p["serve_compile_counts"].values()),
            "compiles_bounded": all(
                c <= p["expected_max_compiles"] for p in (baseline_phase, learned_phase)
                for c in p["compile_counts"].values()),
            "learned_ladder_within_budget": len(learned) <= len(baseline),
            "learned_waste_not_worse": (
                analytic["learned_rows"] <= analytic["baseline_rows"]
                and measured["learned_rows"] <= measured["baseline_rows"]),
        },
    }


def _ints(kind):
    return lambda s: kind(int(b) for b in s.split(","))


def parse_args(argv=None) -> argparse.Namespace:
    """The CLI's arguments, ``--smoke``'s shapes applied. Refuses
    ``--compilation-cache`` (exit 2)."""
    p = argparse.ArgumentParser(prog="python -m gan_deeplearning4j_tpu_torch.serving.bench",
                                description=__doc__.splitlines()[0])
    p.add_argument("--requests", type=int, default=200)
    p.add_argument("--threads", type=int, default=8)
    p.add_argument("--buckets", default="1,8,32", type=_ints(tuple))
    p.add_argument("--sizes", default="1,2,5,8,13,32", type=_ints(list),
                   help="request batch sizes the clients draw from")
    p.add_argument("--replicas", type=int, default=1,
                   help="replicas on the one device, each with its own stream and graphs")
    p.add_argument("--pipeline-depth", type=int, default=None,
                   help="in-flight flush window (default: 2 per replica on the card)")
    p.add_argument("--legacy", action="store_true",
                   help="measure the unstaged path: run_host, serial flushes, replica 0")
    p.add_argument("--compare", type=int, default=0, metavar="ROUNDS",
                   help="after the main phase, ROUNDS of a fast and a legacy round in turn "
                        "in this process, and the paired ratio")
    p.add_argument("--max-latency", type=float, default=0.002)
    p.add_argument("--max-queue", type=int, default=256)
    p.add_argument("--timeout", type=float, default=30.0)
    p.add_argument("--overload-requests", type=int, default=64,
                   help="overload-phase requests (0 skips the phase)")
    p.add_argument("--overload-threads", type=int, default=16)
    p.add_argument("--overload-queue", type=int, default=4)
    p.add_argument("--overload-timeout", type=float, default=0.5)
    p.add_argument("--replay", default=None, metavar="TRACE.json",
                   help="replay a request-size trace: the learned ladder against "
                        "--replay-baseline at the same capture budget")
    p.add_argument("--replay-baseline", default="1,8,32,128", type=_ints(tuple),
                   help="the fixed ladder the learned one is paired against")
    p.add_argument("--smoke", action="store_true", help="small fixed shapes, for a quick check")
    p.add_argument("--seed", type=int, default=666)
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    p.add_argument("--record", default=None, metavar="TAG",
                   help="also write BENCH_torch_serving_<TAG>.json (a replay: "
                        "BENCH_torch_ladder_<TAG>.json) at the repo root")
    p.add_argument("--compilation-cache", default=None, metavar="DIR",
                   help="refused: captured CUDA graphs do not outlive the process")
    p.add_argument("--telemetry", action="store_true",
                   help="enable span tracing (metrics are always on)")
    p.add_argument("--trace", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the main phase to DIR/trace.json")
    p.add_argument("--output", default=None, help="also write the summary to this file")
    args = p.parse_args(argv)
    if args.compilation_cache is not None:
        p.error("--compilation-cache is refused: the port keeps no persistent store of "
                "captured CUDA graphs (they do not outlive the process), so there is no "
                "cache to fill or reuse")
    if args.smoke:
        args.requests = min(args.requests, 48)
        args.threads = min(args.threads, 4)
        args.buckets = (1, 8)
        args.sizes = [1, 3, 8]
        args.overload_requests = min(args.overload_requests, 32)
        args.overload_threads = min(args.overload_threads, 8)
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    if not args.cpu and not torch.cuda.is_available():
        sys.stderr.write("serve bench: no CUDA device is available; pass --cpu to run "
                         "on the CPU\n")
        return 2
    from gan_deeplearning4j_tpu_torch.telemetry.trace import TRACER

    if args.telemetry:
        TRACER.enable()
    summary = run_replay(args) if args.replay else run_bench(args)
    if args.telemetry and args.trace:
        TRACER.dump(os.path.join(args.trace, "spans.json"),
                    {"source": "serve_bench", "smoke": bool(args.smoke)})
    paths = [args.output] if args.output else []
    if args.record:
        family = "ladder" if args.replay else "serving"
        paths.append(os.path.join(_REPO, f"BENCH_torch_{family}_{args.record}.json"))
    for path in paths:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as fh:
            json.dump(summary, fh, indent=2)
            fh.write("\n")
    headline = ({"ladder": summary["ladder"], "waste": summary["waste"],
                 "elasticity": summary["elasticity"]}
                if args.replay else summary["results"])
    sys.stdout.write(json.dumps(headline, indent=2) + "\n")
    if summary.get("compare"):
        sys.stdout.write(json.dumps({"compare": summary["compare"]}, indent=2) + "\n")
    bad = [k for k, v in summary["invariants"].items() if not v]
    if bad:
        sys.stderr.write(f"serve bench: invariants violated: {bad}\n")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
