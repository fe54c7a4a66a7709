"""Fleet drill — real faults against the multi-process serving plane.

``python -m gan_deeplearning4j_tpu_torch.fleet.drill [--smoke] [--cpu]
[--autoscale | --alerts | --mux]``: the PyTorch port's counterpart of
``scripts/fleet_drill.py``, with the same phases, invariants and payload
keys, against the port's fleet (``python -m gan_deeplearning4j_tpu_torch.
fleet``), serving workers and supervised trainer, under closed-loop load
through the router:

1. **boot** — an untrained experiment seeds serving generation 0 into a
   fresh store; the fleet CLI spawns N workers from it plus the router,
   and the drill waits until every worker is warm and routable.
   Closed-loop client threads then hammer the ROUTER's ``/v1/sample`` for
   the rest of the drill.
2. **SIGKILL** — one worker is hard-killed. The router ejects it (or the
   manager relaunches it first — whichever signal lands first), requests
   in flight there are retried on another worker under the budget, and
   the slot must come back routable with a fresh process.
3. **SIGSTOP** — one worker is hung, not killed. Per-request timeouts
   plus the passive breaker must eject it; after SIGCONT the half-open
   probe must RE-ADMIT it without a restart (the hang was transient).
4. **rolling upgrade** — a supervisor segment trains and publishes newer
   serving generations on cadence; the fleet must admit them through ONE
   sidecar canary decision each and roll workers one at a time, ending
   converged on the trainer's final generation.
5. **poison** — a digest-valid but quality-garbage generation is
   published. The fleet admission gate must reject it, quarantine it
   through the store (fleet-wide, once), and no worker may ever serve it.
6. **trace propagation + fleet aggregation** — a deliberately-retried
   request (a client deadline no worker can meet, so every attempt sheds
   and the router re-routes it) must leave spans carrying ONE trace id on
   the router and at least two distinct worker pids in the router's
   merged ``GET /debug/trace``; ``trace_report`` must fold that merged
   trace with rc 0. ``GET /metrics?scope=fleet`` (JSON and Prometheus)
   must sum per-worker request counters EXACTLY against simultaneous
   direct worker scrapes, and the router's own ok counter must equal the
   load ledger's ok count.
7. **ledger** — every submitted request got exactly one answer, zero
   lost, client-visible 503s bounded by the router's own honest-503
   counters (the retry-budget contract), zero 5xx, and every worker's
   ``serve_compile_counts`` (captures after warmup) stays 0.

``--autoscale``, ``--alerts`` and ``--mux`` run the JAX script's other
three drills instead (:mod:`.drill_modes`).

Adaptations, against the JAX script:

- Every ``run_*`` function takes a workload made elsewhere (a
  ``{"config": path, "data": path}`` pair): ``chip_smoke.py`` hands them
  the DCGAN-MNIST model at full width; the CLI makes the toy with
  ``resilience.drill.make_workload``. The fleet gets ``--device`` from the
  workload's config (the card unless ``--cpu``), so every worker and
  sidecar probe runs where the trainer does.
- The clients' latent width is read from the published ``serving.json``
  (``z_size``), not taken as the toy's literal 4.
- The subprocess environment is the caller's minus the JAX package's
  compilation-cache switch, and the fleet gets no ``--compilation-cache``
  (a CUDA graph is not cached across processes).
- The trace check runs the port's ``telemetry.trace_report``.
- :func:`run_fault_drill` takes ``poison``, which picks the poisoned
  generation and the canary's bars together (``deploy.drill.POISONS``):
  the CLI runs the JAX drill's, ``chip_smoke.py`` the diverged one
  (``deploy/drill.py`` says why the full-width run needs it). The payload's
  ``probes`` carry every sidecar probe's FID and accuracy.
- No fallback: on top of the JAX invariants, every worker that answers
  (``/healthz``), every sidecar probe (the manager's ``probes``) and the
  trainer (its summary) must report the workload's platform, and every
  worker's captures after warmup stay 0. The payload also records what
  the card spends: SIGKILL → routable, SIGSTOP → ejected and re-admitted
  seconds, each roll's and probe's seconds, the router's p50/p99 seen by
  the clients, and every worker boot's split (:func:`boot_splits`).
- Results go to ``--output``; ``--record TAG`` writes
  ``BENCH_fleet_torch_<TAG>.json`` (``_autoscale_``, ``_alerts_``,
  ``_mux_`` likewise), never the JAX drill's files.

Exit status is nonzero on any invariant breach.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

from gan_deeplearning4j_tpu_torch.deploy.drill import (
    _ENV,
    _REPO,
    POISONS,
    bundle_z_size,
    free_port,
    http_json,
    poison_newest,
    seed_bundle,
    workload_device,
)

FLEET = [sys.executable, "-m", "gan_deeplearning4j_tpu_torch.fleet"]
TRAINER = [sys.executable, "-m", "gan_deeplearning4j_tpu_torch.resilience"]
TRACE_REPORT = [sys.executable, "-m", "gan_deeplearning4j_tpu_torch.telemetry.trace_report"]


def log(msg: str) -> None:
    print(f"[fleet-drill] {msg}", flush=True)


def expected_platform(workload: dict) -> str:
    return "gpu" if workload_device(workload) == "cuda" else "cpu"


class LoadGenerator:
    """Closed-loop /v1/sample clients against the ROUTER. Every attempt
    is accounted: ok (200), shed (503), error (other status), or lost
    (no HTTP answer at all) — the exactly-one-answer ledger — and
    admitted (200) latencies are captured for the autoscale phase's
    bounded-p99 invariant. The thread population can be ramped
    mid-drill (:meth:`add_threads` — the ~10x burst). The client
    timeout leaves room for the router's full retry schedule, so a slow
    answer is never misread as a lost one."""

    def __init__(self, base: str, z_size: int, threads: int = 2,
                 timeout: float = 30.0, pace: float = 0.005,
                 rows: tuple = (1, 4)):
        self.base = base
        self.z_size = z_size
        self.timeout = timeout
        self.rows = rows  # rng.integers(*rows) rows per request
        self.stop = threading.Event()
        self.counts = {"sent": 0, "ok": 0, "shed": 0, "error": 0, "lost": 0}
        self.ok_latencies: list = []
        self._lock = threading.Lock()
        self._threads: list = []
        self._boot = (threads, pace)

    def _run(self, tid: int, pace: float) -> None:
        rng = np.random.default_rng(2000 + tid)
        while not self.stop.is_set():
            rows = (rng.random((int(rng.integers(*self.rows)), self.z_size),
                               dtype=np.float32) * 2.0 - 1.0)
            with self._lock:
                self.counts["sent"] += 1
            t0 = time.monotonic()
            status, _ = http_json(
                "POST", f"{self.base}/v1/sample", {"data": rows.tolist()},
                timeout=self.timeout)
            latency = time.monotonic() - t0
            with self._lock:
                if status is None:
                    self.counts["lost"] += 1
                elif status == 200:
                    self.counts["ok"] += 1
                    self.ok_latencies.append(latency)
                elif status == 503:
                    self.counts["shed"] += 1
                else:
                    self.counts["error"] += 1
            time.sleep(pace)  # keep 2 shared cores breathable

    def start(self) -> None:
        self.add_threads(*self._boot)

    def add_threads(self, n: int, pace: float = 0.005) -> None:
        for _ in range(n):
            t = threading.Thread(
                target=self._run, args=(len(self._threads), pace),
                daemon=True)
            t.start()
            self._threads.append(t)

    def finish(self) -> dict:
        self.stop.set()
        for t in self._threads:
            t.join(timeout=self.timeout + 5.0)
        # the joins are bounded — a straggler stuck in a slow request may
        # still be incrementing, so read under the same lock the workers
        # write under
        with self._lock:
            return dict(self.counts)

    def latencies(self) -> list:
        with self._lock:
            return list(self.ok_latencies)


class FleetMonitor:
    """Polls the router's /healthz continuously, recording every (worker,
    generation) pair observed and the routable-count envelope — the
    drill's ground truth for 'the poison was never served' and 'the
    ejection actually happened' — and each change of the manager's state
    with its time (what a canary and a roll took)."""

    def __init__(self, base: str):
        self.base = base
        self.stop = threading.Event()
        self.generations_served: set = set()
        self.min_routable: int = 10**9
        self.max_routable: int = 0
        self.last: dict = {}
        self.states: list = []  # (monotonic s, manager state, generation)
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self) -> None:
        while not self.stop.is_set():
            status, body = http_json("GET", f"{self.base}/healthz",
                                     timeout=5.0)
            if status == 200 and body:
                self.last = body
                self.min_routable = min(self.min_routable,
                                        body.get("routable", 0))
                self.max_routable = max(self.max_routable,
                                        body.get("routable", 0))
                for w in body.get("workers", []):
                    if w.get("routable") and w.get("generation") is not None:
                        self.generations_served.add(w["generation"])
                fleet = body.get("fleet") or {}
                state = (fleet.get("state"), fleet.get("generation"))
                if not self.states or self.states[-1][1:] != state:
                    self.states.append((time.monotonic(), *state))
            time.sleep(0.1)

    def start(self) -> None:
        self._thread.start()

    def finish(self) -> None:
        self.stop.set()
        self._thread.join(timeout=10.0)

    def phase_seconds(self, state: str) -> list:
        """Seconds of every stretch the manager spent in ``state``."""
        out = []
        for (t, s, _), (t_next, *_rest) in zip(self.states, self.states[1:]):
            if s == state:
                out.append(round(t_next - t, 3))
        return out


def fleet_health(base: str):
    _, body = http_json("GET", f"{base}/healthz", timeout=5.0)
    return body or {}


def wait_for(predicate, deadline_s: float, what: str, interval: float = 0.2):
    """Poll until predicate() is truthy; returns its value (None on
    timeout, logged — the caller's invariant records the breach)."""
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        value = predicate()
        if value:
            return value
        time.sleep(interval)
    log(f"TIMEOUT waiting for {what} ({deadline_s:.0f}s)")
    return None


def worker_by_id(health: dict, worker_id: str) -> dict:
    for w in (health.get("fleet") or {}).get("workers", []):
        if w["id"] == worker_id:
            return w
    return {}


def router_worker(health: dict, worker_id: str) -> dict:
    for w in health.get("workers", []):
        if w["id"] == worker_id:
            return w
    return {}


def percentile(samples: list, q: float) -> float:
    """The ``q`` quantile (0..1) of ``samples`` by rank, NaN when empty."""
    if not samples:
        return float("nan")
    ranked = sorted(samples)
    return ranked[min(len(ranked) - 1,
                      max(0, int(np.ceil(q * len(ranked))) - 1))]


def boot_splits(log_dir: str) -> list:
    """Every worker boot the fleet's logs hold, split from the serving CLI's
    ``boot stamps`` line: interpreter + ``import torch`` (process start to
    ``main``), the CUDA context, the bundle load, the warmup captures, and
    the reserved bytes once warm."""
    from gan_deeplearning4j_tpu_torch.serving.__main__ import BOOT_STAMPS

    out = []
    for path in sorted(glob.glob(os.path.join(log_dir, "worker-*.log"))):
        worker = os.path.basename(path)[len("worker-"):-len(".log")]
        with open(path, errors="replace") as fh:
            for line in fh:
                if BOOT_STAMPS not in line:
                    continue
                s = json.loads(line.split(BOOT_STAMPS, 1)[1])
                start = s.get("process_start")
                out.append({
                    "worker": worker,
                    "interpreter_and_torch_s": (None if start is None
                                                else round(s["main"] - start, 3)),
                    "cuda_context_s": round(s["cuda_context"] - s["main"], 3),
                    "bundle_load_s": round(s["bundle_loaded"] - s["cuda_context"], 3),
                    "warmup_captures_s": round(s["warm"] - s["bundle_loaded"], 3),
                    "total_s": (None if start is None else round(s["warm"] - start, 3)),
                    "warmed": s.get("warmed"),
                    "platform": s.get("platform"),
                    "reserved_bytes": s.get("reserved_bytes"),
                })
    return out


def worker_platforms(ports) -> dict:
    """Each live worker's ``/healthz`` platform, by port."""
    out = {}
    for port in ports:
        _, body = http_json("GET", f"http://127.0.0.1:{port}/healthz", timeout=10.0)
        out[str(port)] = (body or {}).get("platform")
    return out


def worker_serve_compiles(ports) -> dict:
    """Each live worker's captures after warmup, by port."""
    out = {}
    for port in ports:
        _, m = http_json("GET", f"http://127.0.0.1:{port}/metrics", timeout=5.0)
        if m:
            out[str(port)] = (m.get("engine") or {}).get("serve_compile_counts", {})
    return out


def no_serve_compiles(counts: dict) -> bool:
    return bool(counts) and all(
        bool(c) and all(v == 0 for v in c.values()) for c in counts.values())


def run_trace_report(trace_out: str, *extra: str) -> int:
    """The port's trace folder over ``trace_out``; its exit status."""
    report = subprocess.run(TRACE_REPORT + [trace_out, *extra], cwd=_REPO, env=_ENV,
                            capture_output=True, text=True, timeout=120.0)
    return report.returncode


def start_fleet(workload: dict, serve_store: str, workdir: str, router_port: int,
                flags: list) -> subprocess.Popen:
    """The fleet CLI on ``serve_store`` with the workload's device."""
    fleet_log = open(os.path.join(workdir, "fleet.log"), "w")
    try:
        return subprocess.Popen(
            FLEET + ["--store", serve_store, "--port", str(router_port),
                     "--log-dir", workdir, "--device", workload_device(workload)] + flags,
            cwd=_REPO, env=_ENV, stdout=fleet_log, stderr=fleet_log,
        )
    finally:
        fleet_log.close()  # the child holds its own descriptor


def stop_process(proc, grace: float = 20.0) -> None:
    if proc is not None and proc.poll() is None:
        proc.terminate()
        try:
            proc.wait(timeout=grace)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=grace)


def run_trace_phase(base: str, z_size: int, worker_pids: set,
                    trace_out: str, invariants: dict) -> dict:
    """Phase 5a — prove one trace id threads a retried request across the
    router and two distinct worker processes. The probe request carries a
    client deadline no worker can meet (1 µs), so every attempt sheds
    with a worker-side ``serve.request`` span and the router re-routes to
    a different worker; the router's merged ``GET /debug/trace`` must
    then show the id on ≥2 worker pids plus the router's own spans, and
    ``trace_report`` must fold the merged artifact with rc 0."""
    rows = [[0.0] * z_size]
    chosen = None
    observed: dict = {}
    for attempt in range(5):
        tid = f"drill-retry-{attempt}"
        status, _ = http_json(
            "POST", f"{base}/v1/sample", {"data": rows, "timeout": 1e-6},
            timeout=30.0, headers={"X-Trace-Id": tid})
        _, merged = http_json("GET", f"{base}/debug/trace", timeout=20.0)
        events = (merged or {}).get("traceEvents") or []
        pids = {e.get("pid") for e in events
                if (e.get("args") or {}).get("trace_id") == tid}
        observed = {
            "trace_id": tid, "probe_status": status,
            "pids_with_id": sorted(p for p in pids if p is not None),
            "worker_pids": sorted(worker_pids),
            "merged_events": len(events),
        }
        if len(pids & worker_pids) >= 2 and (pids - worker_pids):
            chosen = merged
            break
        time.sleep(0.3)
    invariants["trace_one_id_spans_router_and_two_workers"] = (
        chosen is not None)
    rc = None
    if chosen is not None:
        with open(trace_out, "w") as fh:
            json.dump(chosen, fh)
            fh.write("\n")
        rc = run_trace_report(trace_out)
        log(f"trace_report on merged fleet trace: rc={rc}")
        observed["trace_out"] = trace_out
    invariants["trace_report_folds_merged_trace"] = rc == 0
    observed["trace_report_rc"] = rc
    return observed


def _counter_total(snapshot: dict, family: str, match=None) -> float:
    total = 0.0
    for s in ((snapshot or {}).get(family) or {}).get("series", []):
        labels = s.get("labels") or {}
        if match and any(labels.get(k) != v for k, v in match.items()):
            continue
        total += float(s.get("value", 0.0))
    return total


def run_aggregation_phase(base: str, worker_ports: list, counts: dict,
                          invariants: dict) -> dict:
    """Phase 5b — the aggregation-exactness story, on frozen counters:
    the fleet-scope snapshot (JSON and Prometheus) must sum per-worker
    ``serve_requests_total`` EXACTLY against simultaneous direct worker
    scrapes, report zero scrape gaps, and the router's own ok counter
    must equal the load ledger's ok count. Also checks the satellite
    surfaces: SLO block and per-worker scrape staleness in /healthz."""
    import urllib.request

    direct_total = 0.0
    per_worker: dict = {}
    for port in worker_ports:
        _, snap = http_json(
            "GET", f"http://127.0.0.1:{port}/metrics?scope=registry",
            timeout=10.0)
        t = _counter_total(snap, "serve_requests_total")
        per_worker[str(port)] = t
        direct_total += t
    _, fleet_snap = http_json("GET", f"{base}/metrics?scope=fleet",
                              timeout=30.0)
    fleet_snap = fleet_snap or {}
    fleet_total = _counter_total(fleet_snap, "serve_requests_total")
    router_ok = _counter_total(fleet_snap, "fleet_requests_total",
                               match={"outcome": "ok"})
    gaps = (fleet_snap.get("_fleet") or {}).get("gaps")

    prom_total = None
    try:
        with urllib.request.urlopen(
                f"{base}/metrics?scope=fleet&format=prom",
                timeout=30.0) as resp:
            prom_text = resp.read().decode()
        prom_total = sum(
            float(line.rsplit(" ", 1)[1])
            for line in prom_text.splitlines()
            if line.startswith("serve_requests_total{"))
    except (OSError, ValueError):
        pass

    health = fleet_health(base)
    slo = health.get("slo") or {}
    ages = [w.get("last_scrape_age_s") for w in health.get("workers", [])]

    invariants["fleet_counter_sum_exact"] = (
        fleet_total == direct_total > 0)
    invariants["fleet_prom_matches_json"] = prom_total == fleet_total
    invariants["fleet_scrape_no_gaps"] = gaps == []
    invariants["router_ok_counter_matches_ledger"] = (
        router_ok == counts["ok"])
    invariants["slo_surfaced_with_traffic"] = (
        (slo.get("totals") or {}).get("requests", 0) >= counts["sent"])
    invariants["worker_scrape_age_surfaced"] = bool(ages) and all(
        isinstance(a, (int, float)) for a in ages)
    return {
        "per_worker_requests": per_worker,
        "direct_total": direct_total,
        "fleet_total": fleet_total,
        "prom_total": prom_total,
        "router_ok": router_ok,
        "ledger_ok": counts["ok"],
        "gaps": gaps,
        "slo": slo,
        "last_scrape_age_s": ages,
    }


def run_fault_drill(workload: dict, workdir: str, *, n_workers: int = 3,
                    total: int = 24, serve_every: int = 6, keep_last: int = 10,
                    seed: int = 1, smoke: bool = False, trace_out=None,
                    poison: str = "saturate") -> dict:
    """The fault drill on ``workload`` in ``workdir`` (phases 1-7 above);
    returns the payload."""
    serve_store = os.path.join(workdir, "store_serve")
    train_store = os.path.join(workdir, "store_train")
    platform = expected_platform(workload)
    results: dict = {}
    invariants: dict = {}
    fleet = trainer = None
    load = monitor = None
    trainer_summary: dict = {}
    router_port = free_port()
    worker_ports = [free_port() for _ in range(n_workers)]
    base = f"http://127.0.0.1:{router_port}"
    t_start = time.monotonic()

    try:
        # -- phase 0: seed + boot the fleet -----------------------------
        gen0 = seed_bundle(workload, serve_store, keep_last)
        z_size = bundle_z_size(serve_store, keep_last)
        log(f"seeded serving generation {gen0} (z_size {z_size})")
        fleet = start_fleet(workload, serve_store, workdir, router_port, [
            "--workers", str(n_workers),
            "--worker-ports", ",".join(str(x) for x in worker_ports),
            "--poll", "0.5", "--probe-interval", "0.15",
            "--request-timeout", "3.0",
            "--retry-ratio", "0.5", "--retry-burst", "10",
            "--eject-failures", "3", "--reopen-after", "0.5",
            "--drain-timeout", "15", "--warm-timeout", "240",
            "--hang-restart", "30",
            "--buckets", "1,8", "--replicas", "1",
            "--max-latency", "0.002",
            "--canary-data", workload["data"],
            "--canary-samples", "32",
            *POISONS[poison][1],
            "--boot-wait", "60", "--telemetry",
        ])
        t_boot = time.monotonic()
        health = wait_for(
            lambda: (fleet.poll() is None
                     and (h := fleet_health(base)).get("routable")
                     == n_workers and h.get("generation") == gen0 and h),
            420.0, "fleet healthy on the seed generation")
        if not health:
            log(f"fleet never became healthy (rc={fleet.poll()})")
            return _payload("fleet_drill", results, invariants, t_start, {
                "workers": n_workers, "total_steps": total,
                "serve_publish_every": serve_every, "seed": seed,
                "smoke": bool(smoke), "platform": None})
        results["boot_s"] = time.monotonic() - t_boot
        marks = results["phase_marks"] = {"healthy": time.monotonic() - t_start}
        log(f"fleet healthy on {base}: {n_workers} workers, "
            f"generation {gen0}")
        monitor = FleetMonitor(base)
        monitor.start()
        load = LoadGenerator(base, z_size)
        load.start()
        time.sleep(1.0)  # let traffic establish before the first fault

        # -- phase 1: SIGKILL a worker ----------------------------------
        victim = worker_by_id(health, "w0")
        log(f"SIGKILL worker w0 (pid {victim.get('pid')})")
        t_kill = time.monotonic()
        os.kill(victim["pid"], signal.SIGKILL)
        recovered = wait_for(
            lambda: ((h := fleet_health(base)).get("routable") == n_workers
                     and worker_by_id(h, "w0").get("restarts", 0) >= 1
                     and worker_by_id(h, "w0").get("pid")
                     not in (None, victim["pid"]) and h),
            300.0, "SIGKILLed worker relaunched and re-admitted")
        results["sigkill"] = {
            "old_pid": victim.get("pid"),
            "new_pid": worker_by_id(recovered or {}, "w0").get("pid"),
            "restarts": worker_by_id(recovered or {}, "w0").get("restarts"),
            "routable_s": worker_by_id(recovered or {}, "w0").get(
                "routable_s"),
            "kill_to_routable_s": time.monotonic() - t_kill,
            "counts_at_recovery": dict(load.counts),
        }
        invariants["sigkill_worker_relaunched"] = bool(recovered)
        marks["sigkill_recovered"] = time.monotonic() - t_start
        # the re-spawned worker captured its whole ladder before admission;
        # no request may ever pay a capture on the new pid
        _, w0_metrics = http_json(
            "GET", f"http://127.0.0.1:{worker_ports[0]}/metrics",
            timeout=5.0)
        respawn_compiles = ((w0_metrics or {}).get("engine") or {}).get(
            "serve_compile_counts", {})
        results["sigkill"]["serve_compile_counts"] = respawn_compiles
        invariants["respawned_worker_no_serve_compiles"] = bool(
            respawn_compiles) and all(
            v == 0 for v in respawn_compiles.values())

        # -- phase 2: SIGSTOP (hang) + half-open re-admission -----------
        health = fleet_health(base)
        hung = worker_by_id(health, "w1")
        restarts_before = hung.get("restarts", 0)
        log(f"SIGSTOP worker w1 (pid {hung.get('pid')})")
        t_stop = time.monotonic()
        os.kill(hung["pid"], signal.SIGSTOP)
        try:
            ejected = wait_for(
                lambda: not router_worker(fleet_health(base),
                                          "w1").get("routable", True),
                120.0, "hung worker ejected")
            ejected_s = time.monotonic() - t_stop
        finally:
            os.kill(hung["pid"], signal.SIGCONT)
        t_cont = time.monotonic()
        log("SIGCONT sent — waiting for half-open re-admission")
        readmitted = wait_for(
            lambda: ((h := fleet_health(base)).get("routable") == n_workers
                     and router_worker(h, "w1").get("routable") and h),
            120.0, "hung worker re-admitted")
        restarts_after = worker_by_id(readmitted or {}, "w1").get(
            "restarts", -1)
        results["sigstop"] = {
            "pid": hung.get("pid"),
            "ejected": bool(ejected),
            "readmitted": bool(readmitted),
            "restarts_before": restarts_before,
            "restarts_after": restarts_after,
            "stop_to_ejected_s": ejected_s,
            "cont_to_readmitted_s": time.monotonic() - t_cont,
            "counts_at_recovery": dict(load.counts),
        }
        invariants["hung_worker_ejected"] = bool(ejected)
        marks["sigstop_readmitted"] = time.monotonic() - t_start
        invariants["hung_worker_readmitted_without_restart"] = (
            bool(readmitted) and restarts_after == restarts_before)

        # -- phase 3: rolling generation upgrades -----------------------
        trainer_log = open(os.path.join(workdir, "trainer.log"), "w")
        try:
            trainer = subprocess.Popen(
                TRAINER + [
                    "--config", workload["config"], "--data", workload["data"],
                    "--store", train_store,
                    "--serve-store", serve_store,
                    "--total-steps", str(total),
                    "--publish-every", str(serve_every),
                    "--serve-publish-every", str(serve_every),
                    "--keep-last", str(keep_last),
                    "--summary", os.path.join(workdir, "trainer_summary.json"),
                ],
                cwd=_REPO, env=_ENV, stdout=trainer_log, stderr=trainer_log,
            )
        finally:
            trainer_log.close()
        try:
            trainer.wait(timeout=600.0)
        except subprocess.TimeoutExpired:
            trainer.kill()
            trainer.wait(timeout=20.0)
            log("trainer hung — killed")
        try:
            with open(os.path.join(workdir, "trainer_summary.json")) as fh:
                trainer_summary = json.load(fh)
        except (OSError, json.JSONDecodeError):
            trainer_summary = {}
        final_gen = trainer_summary.get("final_serve_generation")
        marks["trainer_done"] = time.monotonic() - t_start
        log(f"trainer done rc={trainer.returncode}, "
            f"final serve generation {final_gen}")
        converged = wait_for(
            lambda: ((h := fleet_health(base)).get("generation") == final_gen
                     and h.get("routable") == n_workers
                     and (h.get("fleet") or {}).get("state") == "idle"
                     and h),
            600.0, "fleet converged on the trainer's final generation")
        fleet_state = (converged or fleet_health(base)).get("fleet") or {}
        results["rolling_upgrade"] = {
            "trainer_rc": trainer.returncode,
            "final_serve_generation": final_gen,
            "fleet_generation": (converged or {}).get("generation"),
            "rolls": fleet_state.get("rolls"),
            "rejected": fleet_state.get("rejected"),
            "counts_at_convergence": dict(load.counts),
        }
        invariants["fleet_converged_to_final_generation"] = bool(converged)
        marks["converged"] = time.monotonic() - t_start
        invariants["rolling_upgrades_ge_1"] = (
            (fleet_state.get("rolls") or 0) >= 1)
        invariants["trainer_on_expected_platform"] = (
            trainer_summary.get("platform") == platform)

        # -- phase 4: poisoned generation, one fleet-wide decision ------
        rejected_before = fleet_state.get("rejected", 0)
        poison_gen = poison_newest(serve_store, keep_last, poison)
        log(f"published poisoned generation {poison_gen}")
        rejected = wait_for(
            lambda: (((h := fleet_health(base)).get("fleet") or {})
                     .get("rejected", 0) > rejected_before and h),
            420.0, "fleet rejected the poisoned generation")
        from gan_deeplearning4j_tpu_torch.resilience import CheckpointStore

        entry = CheckpointStore(serve_store,
                                keep_last=keep_last).entry(poison_gen)
        after = fleet_health(base)
        results["poison"] = {
            "generation": poison_gen,
            "kind": poison,
            "ledger_status": entry.get("status"),
            "quarantine_reason": entry.get("reason"),
            "fleet_generation_after": after.get("generation"),
            "rejected": (after.get("fleet") or {}).get("rejected"),
        }
        invariants["poison_rejected_once_fleet_wide"] = bool(rejected)
        marks["poison_rejected"] = time.monotonic() - t_start
        invariants["poison_quarantined_in_store"] = (
            entry.get("status") == "quarantined"
            and "canary" in (entry.get("reason") or ""))
        invariants["poison_never_served"] = (
            poison_gen not in monitor.generations_served
            and after.get("generation") == final_gen)

        # -- phase 5: trace propagation + fleet aggregation -------------
        # quiesce first: with the load generator stopped, per-worker
        # counters are frozen, so the exactness assertions below compare
        # stable numbers instead of racing live traffic
        counts = load.finish()
        latencies = load.latencies()
        load = None
        monitor.finish()
        trace_out = trace_out or os.path.join(workdir, "fleet_trace.json")
        health_now = fleet_health(base)
        worker_pids = {w.get("pid")
                       for w in (health_now.get("fleet") or {})
                       .get("workers", []) if w.get("pid")}
        results["trace"] = run_trace_phase(base, z_size, worker_pids,
                                           trace_out, invariants)
        results["fleet_metrics"] = run_aggregation_phase(
            base, worker_ports, counts, invariants)

        # -- phase 6: ledgers -------------------------------------------
        _, router_metrics = http_json("GET", f"{base}/metrics", timeout=5.0)
        router_metrics = router_metrics or {}
        results["requests"] = counts
        results["router"] = {
            k: router_metrics.get(k)
            for k in ("proxied", "ok", "error", "retries",
                      "budget_exhausted", "no_worker", "attempts_exhausted",
                      "ejections", "retry_budget_tokens")
        }
        results["latency"] = {"ok_requests": len(latencies),
                              "p50_s": percentile(latencies, 0.50),
                              "p99_s": percentile(latencies, 0.99)}
        results["generations_served"] = sorted(monitor.generations_served)
        results["routable_envelope"] = [monitor.min_routable,
                                        monitor.max_routable]
        results["canary_s"] = monitor.phase_seconds("canary")
        results["roll_s"] = monitor.phase_seconds("rolling")
        # launch-to-routable per worker (fleet_scaleup_routable_seconds
        # feeds the same numbers to /metrics) — the elasticity surface
        # scale-ups and re-spawns are judged on
        final_health = fleet_health(base)
        final_fleet = final_health.get("fleet") or {}
        results["scaleup_routable_s"] = {
            w["id"]: w.get("routable_s")
            for w in final_fleet.get("workers", [])}
        probes = final_fleet.get("probes") or []
        results["probes"] = probes
        invariants["exactly_one_answer_zero_lost"] = (
            counts["lost"] == 0
            and counts["ok"] + counts["shed"] + counts["error"]
            == counts["sent"])
        # the retry-budget contract: every client-visible 503 is one of
        # the router's honest-503 paths, and no request got a 5xx the
        # router could not account for
        honest_503s = ((router_metrics.get("budget_exhausted") or 0)
                       + (router_metrics.get("no_worker") or 0)
                       + (router_metrics.get("attempts_exhausted") or 0))
        invariants["errors_bounded_by_retry_budget"] = (
            counts["error"] == 0 and counts["shed"] <= honest_503s)
        # no worker ever captured after its warmup (scraped directly, not
        # via the router)
        serve_compiles = worker_serve_compiles(worker_ports)
        results["serve_compile_counts"] = serve_compiles
        invariants["no_serve_time_compiles"] = no_serve_compiles(serve_compiles)
        # no fallback: every worker, boot and probe ran where the workload does
        platforms = worker_platforms(worker_ports)
        boots = boot_splits(workdir)
        results["worker_platforms"] = platforms
        results["boot_splits"] = boots
        invariants["workers_on_expected_platform"] = bool(platforms) and all(
            p == platform for p in platforms.values())
        invariants["every_boot_on_expected_platform"] = (
            len(boots) >= n_workers + 1
            and all(b["platform"] == platform and b["warmed"] for b in boots))
        invariants["probes_on_expected_platform"] = bool(probes) and all(
            p.get("platform") == platform for p in probes)
    finally:
        if load is not None:
            load.finish()
        if monitor is not None and not monitor.stop.is_set():
            monitor.finish()
        for proc in (trainer, fleet):
            stop_process(proc)

    return _payload("fleet_drill", results, invariants, t_start, {
        "workers": n_workers, "total_steps": total,
        "serve_publish_every": serve_every, "seed": seed,
        "smoke": bool(smoke), "device": workload_device(workload),
        "poison": poison,
        "platform": platform,
        "trainer_platform": trainer_summary.get("platform")})


def _payload(bench: str, results: dict, invariants: dict, t_start: float,
             config: dict) -> dict:
    return {
        "bench": bench,
        "config": config,
        "wall_seconds": time.monotonic() - t_start,
        "results": results,
        "invariants": invariants,
        "ok": bool(invariants) and all(invariants.values()),
    }


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--smoke", action="store_true",
                   help="CI shape: 2 workers, 12 trainer steps")
    p.add_argument("--cpu", action="store_true",
                   help="run every worker, probe and trainer on the CPU "
                        "(default: the card)")
    p.add_argument("--workers", type=int, default=None)
    p.add_argument("--total-steps", type=int, default=None)
    p.add_argument("--serve-every", type=int, default=None)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--keep-last", type=int, default=10)
    p.add_argument("--workdir", default=None,
                   help="keep work files here instead of a temp dir")
    p.add_argument("--trace-out", default=None, metavar="PATH",
                   help="where the merged fleet Chrome trace lands "
                        "(default: <workdir>/fleet_trace.json)")
    p.add_argument("--output", default=None, metavar="PATH")
    p.add_argument("--record", default=None, metavar="TAG",
                   help="also write BENCH_fleet_torch_<TAG>.json at the repo "
                        "root (BENCH_autoscale_torch_<TAG>.json with "
                        "--autoscale, and so on)")
    p.add_argument("--autoscale", action="store_true",
                   help="run the autoscale-under-burst phase instead of "
                        "the fault drill: min-size boot, ~10x closed-loop "
                        "ramp, grow/brownout/shrink invariants")
    p.add_argument("--mux", action="store_true",
                   help="run the multi-model multiplexing drill instead: "
                        "weighted split, 1%%->100%% canary ramp with an "
                        "injected-burn auto-rollback, per-model brownout "
                        "shed order")
    p.add_argument("--alerts", action="store_true",
                   help="run the alerting fire-and-resolve drill instead: "
                        "SIGKILL -> worker_down with the dead pid + an "
                        "exemplar trace, overload -> latency anomaly, "
                        "quiesce -> both resolve, zero false fires in the "
                        "calm audits")
    p.add_argument("--max-workers", type=int, default=None,
                   help="autoscale ceiling (default 3; --workers is the "
                        "min, default 1)")
    p.add_argument("--burst-threads", type=int, default=None,
                   help="closed-loop threads in the burst (default 12 "
                        "smoke / 16 full; the ~10x ramp over the single "
                        "light-phase thread)")
    p.add_argument("--p99-bound", type=float, default=15.0,
                   help="autoscale invariant: p99 seconds bound for "
                        "admitted (200) requests")
    args = p.parse_args(argv)
    if sum(map(bool, (args.autoscale, args.mux, args.alerts))) > 1:
        p.error("--autoscale, --mux, and --alerts are separate drills")
    return args


def main(argv=None) -> int:
    from gan_deeplearning4j_tpu_torch.fleet import drill_modes
    from gan_deeplearning4j_tpu_torch.resilience.drill import make_workload

    args = parse_args(argv)
    mode = ("autoscale" if args.autoscale else "mux" if args.mux
            else "alerts" if args.alerts else "fleet")
    workdir = args.workdir or tempfile.mkdtemp(prefix=f"fleet_{mode}_")
    cleanup = args.workdir is None
    os.makedirs(workdir, exist_ok=True)
    workload = make_workload(workdir, args.seed, use_accelerator=not args.cpu)
    if mode == "autoscale":
        payload = drill_modes.run_autoscale(
            workload, workdir, min_workers=args.workers or 1,
            max_workers=args.max_workers or 3,
            burst_threads=args.burst_threads or (12 if args.smoke else 16),
            p99_bound=args.p99_bound, keep_last=args.keep_last, seed=args.seed,
            smoke=args.smoke)
    elif mode == "alerts":
        payload = drill_modes.run_alerts(
            workload, workdir, n_workers=args.workers or 2,
            burst_threads=args.burst_threads or 12, keep_last=args.keep_last,
            seed=args.seed, smoke=args.smoke, trace_out=args.trace_out)
    elif mode == "mux":
        payload = drill_modes.run_mux(workload, workdir, keep_last=args.keep_last,
                                      seed=args.seed, smoke=args.smoke)
    else:
        payload = run_fault_drill(
            workload, workdir, n_workers=args.workers or (2 if args.smoke else 3),
            total=args.total_steps or (12 if args.smoke else 24),
            serve_every=args.serve_every or 6, keep_last=args.keep_last,
            seed=args.seed, smoke=args.smoke, trace_out=args.trace_out)
    ok = payload["ok"]
    text = json.dumps(payload, indent=2)
    print(text)
    if args.output:
        os.makedirs(os.path.dirname(os.path.abspath(args.output)),
                    exist_ok=True)
        with open(args.output, "w") as fh:
            fh.write(text + "\n")
    if args.record:
        with open(os.path.join(_REPO, f"BENCH_{mode}_torch_{args.record}.json"),
                  "w") as fh:
            fh.write(text + "\n")
    if cleanup and ok:
        shutil.rmtree(workdir, ignore_errors=True)
    elif not ok:
        log(f"INVARIANT BREACH — work files kept at {workdir}")
    for name, good in sorted(payload["invariants"].items()):
        log(f"invariant {name}: {'ok' if good else 'BREACH'}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
