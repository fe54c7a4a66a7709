"""The fleet drill's other three modes: ``--autoscale``, ``--alerts``,
``--mux`` (``python -m gan_deeplearning4j_tpu_torch.fleet.drill``).

The port of ``scripts/fleet_drill.py``'s ``run_autoscale``, ``run_alerts``
and ``run_mux``, with their phases, invariants and payload keys, beside
:mod:`.drill` (the fault drill, the shared load generator and monitors) so
that neither file grows past what a reader can hold. The adaptations are
:mod:`.drill`'s: each function takes a workload made elsewhere, the fleet
(or, in ``--mux``, every engine) runs on the workload's device, the
latent width is the published bundle's, and on top of the JAX invariants
every worker must report the workload's platform and capture nothing
after its warmup. ``run_mux`` runs in process over the port's
``MuxRegistry`` / ``MuxService``; its "lite" variant is the port's
``build_bf16_variant`` of a seeded generation.
"""

from __future__ import annotations

import json
import os
import signal
import threading
import time

import numpy as np

from gan_deeplearning4j_tpu_torch.deploy.drill import (
    bundle_z_size,
    free_port,
    http_json,
    seed_bundle,
    workload_device,
)
from gan_deeplearning4j_tpu_torch.fleet.drill import (
    LoadGenerator,
    _counter_total,
    _payload,
    boot_splits,
    expected_platform,
    fleet_health,
    log,
    no_serve_compiles,
    percentile,
    run_trace_report,
    start_fleet,
    stop_process,
    wait_for,
    worker_by_id,
    worker_platforms,
    worker_serve_compiles,
)


# ===========================================================================
# the autoscale-under-burst drill (--autoscale)
# ===========================================================================

class AutoscaleMonitor:
    """Polls the router's /healthz, recording the (slot count, brownout)
    trajectory — the ground truth for 'the fleet grew, brownout engaged
    only at max, and it shrank back'."""

    def __init__(self, base: str):
        self.base = base
        self.stop = threading.Event()
        self.max_slots = 0
        self.min_slots = 10**9
        self.brownout_seen = False
        self.brownout_slot_counts: set = set()
        self.transitions: list = []  # (slots, brownout_level) changes
        self.last: dict = {}
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self) -> None:
        prev = None
        while not self.stop.is_set():
            status, body = http_json("GET", f"{self.base}/healthz",
                                     timeout=5.0)
            if status == 200 and body:
                self.last = body
                slots = len((body.get("fleet") or {}).get("workers", []))
                brownout = (body.get("brownout") or {})
                level = int(brownout.get("level") or 0)
                self.max_slots = max(self.max_slots, slots)
                self.min_slots = min(self.min_slots, slots)
                if level > 0:
                    self.brownout_seen = True
                    self.brownout_slot_counts.add(slots)
                if (slots, level) != prev:
                    prev = (slots, level)
                    self.transitions.append(
                        {"t": round(time.monotonic(), 3),
                         "slots": slots, "brownout": level})
            time.sleep(0.1)

    def start(self) -> None:
        self._thread.start()

    def finish(self) -> None:
        self.stop.set()
        self._thread.join(timeout=10.0)


def _worker_ports(health: dict) -> list:
    return [w["port"] for w in (health.get("fleet") or {}).get("workers", [])
            if w.get("alive")]


def run_autoscale(workload: dict, workdir: str, *, min_workers: int = 1,
                  max_workers: int = 3, burst_threads: int = 12,
                  p99_bound: float = 15.0, keep_last: int = 10, seed: int = 1,
                  smoke: bool = False) -> dict:
    """The autoscale-under-burst drill (docs/FLEET.md "Autoscaling"):
    boot an elastic fleet at min size, ramp closed-loop load ~10x, and
    assert the whole elasticity story — grow to max, mid-resize SIGKILL
    recovered, brownout only at max, large slabs shed with honest 503s,
    zero lost, bounded p99 for admitted requests, shrink back to min
    after quiesce."""
    serve_store = os.path.join(workdir, "store_serve")
    platform = expected_platform(workload)
    results: dict = {}
    invariants: dict = {}
    fleet = None
    load = monitor = None
    ok_latencies: list = []
    router_port = free_port()
    base = f"http://127.0.0.1:{router_port}"
    brownout_max_rows = 16
    t_start = time.monotonic()
    config = {"min_workers": min_workers, "max_workers": max_workers,
              "burst_threads": burst_threads, "seed": seed, "smoke": bool(smoke),
              "device": workload_device(workload), "platform": platform}

    try:
        # -- phase 0: seed + boot the elastic fleet at min size ----------
        gen0 = seed_bundle(workload, serve_store, keep_last)
        z_size = bundle_z_size(serve_store, keep_last)
        log(f"seeded serving generation {gen0} (z_size {z_size})")
        fleet = start_fleet(workload, serve_store, workdir, router_port, [
            "--workers", str(min_workers),
            "--poll", "2.0", "--probe-interval", "0.15",
            "--request-timeout", "3.0",
            "--retry-ratio", "0.5", "--retry-burst", "10",
            "--eject-failures", "3", "--reopen-after", "0.5",
            "--drain-timeout", "15", "--warm-timeout", "240",
            "--hang-restart", "30",
            "--buckets", "1,8", "--replicas", "1",
            "--max-latency", "0.002",
            "--boot-wait", "60",
            "--autoscale", "--max-workers", str(max_workers),
            "--scale-interval", "0.5",
            "--scale-up-pressure", "3.0", "--scale-down-pressure", "1.0",
            "--scale-up-ticks", "2", "--scale-down-ticks", "6",
            "--scale-up-cooldown", "2.0", "--scale-down-cooldown", "2.0",
            "--brownout-exit-ticks", "4",
            "--brownout-max-rows", str(brownout_max_rows),
            "--brownout-deadline-ms", "1500",
            "--spawn-backoff", "0.5", "--spawn-backoff-max", "5.0",
            "--slo-fast-window", "5", "--slo-slow-window", "30",
        ])
        health = wait_for(
            lambda: (fleet.poll() is None
                     and (h := fleet_health(base)).get("routable")
                     == min_workers and h.get("generation") == gen0 and h),
            420.0, "fleet healthy at min size")
        if not health:
            log(f"fleet never became healthy (rc={fleet.poll()})")
            return _payload("fleet_autoscale_drill", results, invariants, t_start, config)
        initial_ids = {w["id"] for w in (health.get("fleet") or {})
                       .get("workers", [])}
        invariants["boots_at_min_size"] = len(initial_ids) == min_workers
        monitor = AutoscaleMonitor(base)
        monitor.start()
        marks = results["phase_marks"] = {"healthy": time.monotonic() - t_start}

        # -- phase 1: light load holds at min ----------------------------
        load = LoadGenerator(base, z_size, threads=0)
        load.add_threads(1, pace=0.05)
        time.sleep(6.0)
        slots_light = len((fleet_health(base).get("fleet") or {})
                          .get("workers", []))
        invariants["light_load_holds_at_min"] = slots_light == min_workers
        log(f"light load: {slots_light} slot(s) (min {min_workers})")

        # -- phase 2: ~10x burst -> scale-up, with a mid-resize SIGKILL --
        log(f"ramping to {burst_threads + 1} closed-loop threads")
        load.add_threads(burst_threads, pace=0.002)
        grown = wait_for(
            lambda: (len(((h := fleet_health(base)).get("fleet") or {})
                         .get("workers", [])) > min_workers and h),
            180.0, "first scale-up under burst")
        invariants["scales_up_under_burst"] = bool(grown)
        marks["grown"] = time.monotonic() - t_start
        kill_result: dict = {"killed": None}
        if grown:
            # the first scaled-up worker is still booting (torch import,
            # the CUDA context, its warmup captures): SIGKILL it
            # mid-resize. The supervise loop must relaunch it
            # (spawn-failure backoff, no hot loop) and the fleet must
            # still reach max.
            new_workers = [w for w in (grown.get("fleet") or {})
                           .get("workers", []) if w["id"] not in initial_ids]
            victim = new_workers[0]
            log(f"mid-resize SIGKILL: worker {victim['id']} "
                f"(pid {victim['pid']})")
            try:
                os.kill(victim["pid"], signal.SIGKILL)
                kill_result["killed"] = victim
            except (OSError, TypeError) as exc:
                log(f"SIGKILL failed ({exc}) — worker finished booting?")
            recovered = wait_for(
                lambda: ((w := worker_by_id(fleet_health(base),
                                            victim["id"])).get("alive")
                         and w.get("pid") not in (None, victim["pid"])
                         and w),
                120.0, "mid-resize-killed worker relaunched")
            kill_result["recovered"] = recovered or None
            invariants["mid_resize_sigkill_recovered"] = bool(recovered)
        results["mid_resize_kill"] = kill_result

        # -- phase 3: brownout at max size -------------------------------
        browned = wait_for(
            lambda: ((h := fleet_health(base)).get("brownout") or {})
                    .get("active") and h,
            240.0, "brownout under sustained overload at max size")
        marks["brownout"] = time.monotonic() - t_start
        at_brownout = browned or fleet_health(base)
        slots_at_brownout = len((at_brownout.get("fleet") or {})
                                .get("workers", []))
        invariants["brownout_engages"] = bool(browned)
        invariants["brownout_only_at_max"] = (
            bool(browned) and slots_at_brownout == max_workers
            and monitor.brownout_slot_counts <= {max_workers})
        results["brownout"] = {
            "slots_at_engage": slots_at_brownout,
            "healthz_status": (browned or {}).get("status"),
            "block": (browned or {}).get("brownout"),
        }
        # tier-1 admission: an oversized sample slab sheds with an honest
        # 503 naming the brownout, while the small-slab load keeps flowing
        big = [[0.0] * z_size for _ in range(brownout_max_rows + 8)]
        status, body = http_json("POST", f"{base}/v1/sample",
                                 {"data": big}, timeout=30.0)
        invariants["brownout_sheds_large_slabs"] = (
            status == 503 and "brownout" in json.dumps(body or {}))
        results["brownout"]["large_slab_probe"] = {
            "status": status, "body": body}
        _, rm = http_json("GET", f"{base}/metrics", timeout=10.0)
        results["brownout"]["router_level"] = (rm or {}).get("brownout_level")
        invariants["brownout_gauge_surfaced"] = (
            (rm or {}).get("brownout_level", 0) >= 1
            and (rm or {}).get("brownout_shed", 0) >= 1)

        # every scaled-up worker (the relaunched SIGKILL victim included)
        # must finish warming and re-earn router admission — "capacity"
        # means routable, not spawned
        full = wait_for(
            lambda: ((h := fleet_health(base)).get("routable")
                     == max_workers and h),
            240.0, "scaled-up workers admitted as routable capacity")
        invariants["scaled_up_workers_admitted"] = bool(full)
        marks["full"] = time.monotonic() - t_start
        # at max size: every worker on the card, none capturing after warmup
        ports = _worker_ports(full or fleet_health(base))
        platforms = worker_platforms(ports)
        compiles = worker_serve_compiles(ports)
        results["at_max"] = {
            "worker_platforms": platforms, "serve_compile_counts": compiles,
            "routable_s": {w["id"]: w.get("routable_s") for w in
                           ((full or {}).get("fleet") or {}).get("workers", [])},
        }
        _, fleet_snap = http_json("GET", f"{base}/metrics?scope=fleet", timeout=30.0)
        results["at_max"]["fleet_scaleup_routable_seconds"] = (
            (fleet_snap or {}).get("fleet_scaleup_routable_seconds"))
        invariants["workers_on_expected_platform"] = (
            len(platforms) == max_workers
            and all(p == platform for p in platforms.values()))
        invariants["no_serve_time_compiles"] = no_serve_compiles(compiles)

        # -- phase 4: quiesce -> drain back to min, brownout released ----
        marks["checked_at_max"] = time.monotonic() - t_start
        counts = load.finish()
        ok_latencies = load.latencies()
        load = None
        marks["load_stopped"] = time.monotonic() - t_start
        log("load stopped — waiting for scale-down to min")
        shrunk = wait_for(
            lambda: ((h := fleet_health(base)).get("routable") == min_workers
                     and len((h.get("fleet") or {}).get("workers", []))
                     == min_workers
                     and not (h.get("brownout") or {}).get("active") and h),
            300.0, "fleet drained back to min after quiesce")
        invariants["quiesce_shrinks_to_min"] = bool(shrunk)
        marks["shrunk"] = time.monotonic() - t_start
        monitor.finish()

        # -- phase 5: ledgers --------------------------------------------
        _, router_metrics = http_json("GET", f"{base}/metrics", timeout=5.0)
        router_metrics = router_metrics or {}
        results["requests"] = counts
        results["router"] = {
            k: router_metrics.get(k)
            for k in ("proxied", "ok", "error", "retries",
                      "budget_exhausted", "no_worker", "attempts_exhausted",
                      "brownout_shed", "ejections", "retry_budget_tokens")
        }
        results["scaling"] = {
            "max_slots": monitor.max_slots,
            "min_slots": monitor.min_slots,
            "transitions": monitor.transitions,
            "autoscaler": ((shrunk or fleet_health(base)).get("fleet")
                           or {}).get("autoscaler"),
        }
        invariants["exactly_one_answer_zero_lost"] = (
            counts["lost"] == 0 and counts["error"] == 0
            and counts["ok"] + counts["shed"] + counts["error"]
            == counts["sent"])
        honest_503s = ((router_metrics.get("budget_exhausted") or 0)
                       + (router_metrics.get("no_worker") or 0)
                       + (router_metrics.get("attempts_exhausted") or 0)
                       + (router_metrics.get("brownout_shed") or 0))
        invariants["sheds_bounded_by_honest_503s"] = (
            counts["shed"] <= honest_503s)
        boots = boot_splits(workdir)
        results["boot_splits"] = boots
        invariants["every_boot_on_expected_platform"] = bool(boots) and all(
            b["platform"] == platform and b["warmed"] for b in boots)
    finally:
        if load is not None:
            load.finish()
            ok_latencies = load.latencies()
        if monitor is not None and not monitor.stop.is_set():
            monitor.finish()
        stop_process(fleet)

    # p99 of admitted requests, bounded: an autoscaling fleet may queue,
    # but an admitted request must never hang toward its client timeout
    p99 = percentile(ok_latencies, 0.99)
    results["latency"] = {
        "ok_requests": len(ok_latencies),
        "p50_s": None if not ok_latencies else percentile(ok_latencies, 0.50),
        "p99_s": None if not ok_latencies else round(p99, 4),
        "bound_s": p99_bound,
    }
    invariants["p99_of_admitted_bounded"] = (
        bool(ok_latencies) and p99 <= p99_bound)
    return _payload("fleet_autoscale_drill", results, invariants, t_start, config)


# ===========================================================================
# the alerting drill (--alerts)
# ===========================================================================

class AlertsMonitor:
    """Polls the router's /alerts continuously: every alertname ever seen
    FIRING (with a sample payload), plus audit windows — during a window
    opened by :meth:`open_window`, any firing instance is recorded as a
    false fire. The drill's ground truth for 'fires on the fault, silent
    when calm'."""

    def __init__(self, base: str):
        self.base = base
        self.stop = threading.Event()
        self.fired: dict = {}          # alertname -> first firing entry
        self.false_fires: list = []    # firing entries seen inside windows
        self._window = None            # (name,) when an audit window is open
        self._lock = threading.Lock()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self) -> None:
        while not self.stop.is_set():
            status, body = http_json("GET", f"{self.base}/alerts",
                                     timeout=5.0)
            if status == 200 and body:
                firing = [e for e in body.get("alerts", [])
                          if e.get("state") == "firing"]
                with self._lock:
                    window = self._window
                    for entry in firing:
                        self.fired.setdefault(entry["alert"], entry)
                        if window is not None:
                            self.false_fires.append(
                                {"window": window, **entry})
            time.sleep(0.1)

    def open_window(self, name: str) -> None:
        with self._lock:
            self._window = name

    def close_window(self) -> None:
        with self._lock:
            self._window = None

    def start(self) -> None:
        self._thread.start()

    def finish(self) -> None:
        self.stop.set()
        self._thread.join(timeout=10.0)


def _firing_names(alerts_body: dict) -> set:
    return {e["alert"] for e in (alerts_body or {}).get("alerts", [])
            if e.get("state") == "firing"}


def run_alerts(workload: dict, workdir: str, *, n_workers: int = 2,
               burst_threads: int = 12, keep_last: int = 10, seed: int = 1,
               smoke: bool = False, trace_out=None) -> dict:
    """The fire-and-resolve drill (docs/OBSERVABILITY.md "Alerting"):
    boot a fleet with the alert plane on, prove the default rule pack
    end-to-end — calm phases stay silent, a SIGKILLed worker fires
    ``worker_down`` with the dead pid and an exemplar trace id that
    resolves into the merged ``GET /debug/trace``, an overload ramp
    fires ``latency_anomaly``, quiesce resolves both, and the
    exactly-one-answer ledger holds throughout."""
    serve_store = os.path.join(workdir, "store_serve")
    platform = expected_platform(workload)
    results: dict = {}
    invariants: dict = {}
    fleet = None
    load = burst = monitor = None
    router_port = free_port()
    base = f"http://127.0.0.1:{router_port}"
    calm_audit_s = 6.0 if smoke else 10.0
    t_start = time.monotonic()
    config = {"workers": n_workers, "burst_threads": burst_threads,
              "calm_audit_s": calm_audit_s, "seed": seed, "smoke": bool(smoke),
              "device": workload_device(workload), "platform": platform}

    try:
        # -- phase 0: seed + boot with the alert plane on ----------------
        gen0 = seed_bundle(workload, serve_store, keep_last)
        z_size = bundle_z_size(serve_store, keep_last)
        log(f"seeded serving generation {gen0} (z_size {z_size})")
        fleet = start_fleet(workload, serve_store, workdir, router_port, [
            "--workers", str(n_workers),
            "--poll", "2.0", "--probe-interval", "0.15",
            "--request-timeout", "10.0",
            "--retry-ratio", "0.5", "--retry-burst", "10",
            "--eject-failures", "3", "--reopen-after", "0.5",
            "--drain-timeout", "15", "--warm-timeout", "240",
            "--hang-restart", "30",
            "--buckets", "1,8", "--replicas", "1",
            "--max-latency", "0.002",
            "--boot-wait", "60",
            "--slo-fast-window", "5", "--slo-slow-window", "30",
            "--telemetry",
            "--alerts", "--alert-stale-after", "10",
            # drill scale: the drill workload's p99 drifts by hundreds of
            # ms, not the production default's ~0.6 s page bar
            "--alert-latency-drift", "0.02",
        ])
        health = wait_for(
            lambda: (fleet.poll() is None
                     and (h := fleet_health(base)).get("routable")
                     == n_workers and h.get("generation") == gen0 and h),
            420.0, "fleet healthy with the alert plane on")
        if not health:
            log(f"fleet never became healthy (rc={fleet.poll()})")
            return _payload("fleet_alerts_drill", results, invariants, t_start, config)
        _, alerts0 = http_json("GET", f"{base}/alerts", timeout=10.0)
        invariants["alert_surface_up"] = bool(
            alerts0 and alerts0.get("rules"))
        results["rules"] = [r.get("name")
                            for r in (alerts0 or {}).get("rules", [])]
        log(f"alert plane up: rules {results['rules']}")
        monitor = AlertsMonitor(base)
        monitor.start()

        # -- phase 1: calm — baselines build, nothing may fire -----------
        load = LoadGenerator(base, z_size, threads=2, timeout=30.0,
                             pace=0.02)
        load.start()
        time.sleep(4.0)  # settle: baselines arm, boot noise ages out
        monitor.open_window("calm_1")
        try:
            time.sleep(calm_audit_s)
        finally:
            monitor.close_window()
        invariants["calm1_zero_firing"] = not any(
            f["window"] == "calm_1" for f in monitor.false_fires)
        log(f"calm-1 audit done ({calm_audit_s:.0f}s, firing seen: "
            f"{sorted(_firing_names(http_json('GET', base + '/alerts', timeout=5.0)[1]))})")

        # -- phase 2: SIGKILL -> worker_down fires with evidence ---------
        victim = worker_by_id(fleet_health(base), "w0")
        log(f"SIGKILL worker w0 (pid {victim.get('pid')})")
        os.kill(victim["pid"], signal.SIGKILL)
        fired = wait_for(
            lambda: next(
                (e for e in (http_json("GET", f"{base}/alerts",
                                       timeout=5.0)[1] or {})
                 .get("alerts", [])
                 if e.get("alert") == "worker_down"
                 and e.get("state") == "firing"
                 and e.get("labels", {}).get("worker") == "w0"), None),
            90.0, "worker_down firing for w0")
        invariants["worker_down_fires"] = bool(fired)
        exemplars = (fired or {}).get("exemplars") or []
        exemplar_pids = {e.get("pid") for e in exemplars}
        exemplar_ids = [e.get("trace_id") for e in exemplars
                        if e.get("trace_id")]
        invariants["worker_down_labels_dead_pid"] = (
            victim.get("pid") in exemplar_pids)
        invariants["worker_down_has_exemplar"] = bool(exemplar_ids)
        results["worker_down"] = {
            "victim_pid": victim.get("pid"),
            "alert": fired,
        }
        # the exemplar ids must resolve into the merged fleet trace —
        # an alert is one click from the causal chain of a bad request
        _, merged = http_json("GET", f"{base}/debug/trace", timeout=20.0)
        trace_ids = {(e.get("args") or {}).get("trace_id")
                     for e in (merged or {}).get("traceEvents", [])}
        linked = sorted(set(exemplar_ids) & trace_ids)
        invariants["exemplar_trace_in_merged_trace"] = bool(linked)
        results["worker_down"]["exemplars_in_trace"] = linked
        # surfaces: prom ALERTS series, healthz block, transition counter
        import urllib.request
        with urllib.request.urlopen(f"{base}/alerts?format=prom",
                                    timeout=10.0) as resp:
            prom = resp.read().decode()
        invariants["prom_alerts_series"] = (
            'ALERTS{alertname="worker_down"' in prom
            and 'state="firing"' in prom)
        hz = fleet_health(base)
        invariants["healthz_alerts_block"] = any(
            f.get("alert") == "worker_down"
            for f in (hz.get("alerts") or {}).get("firing", []))
        _, fleet_snap = http_json("GET", f"{base}/metrics?scope=fleet",
                                  timeout=30.0)
        invariants["transition_counter_surfaced"] = _counter_total(
            fleet_snap, "fleet_alerts_total",
            match={"alertname": "worker_down", "state": "firing"}) >= 1

        # -- phase 3: relaunch + re-admission -> worker_down resolves ----
        recovered = wait_for(
            lambda: (h := fleet_health(base)).get("routable") == n_workers
            and h,
            300.0, "killed worker relaunched and re-admitted")
        invariants["worker_relaunched"] = bool(recovered)
        resolved = wait_for(
            lambda: "worker_down" not in _firing_names(
                http_json("GET", f"{base}/alerts", timeout=5.0)[1]),
            60.0, "worker_down resolves after re-admission")
        invariants["worker_down_resolves"] = bool(resolved)
        log("worker_down resolved")

        # -- phase 4: overload ramp -> latency_anomaly fires -------------
        # slab-shaped burst: 200-256-row samples chunk through the
        # 8-bucket ladder (25-32 flushes each), so the light load's small
        # requests queue behind real work and their router-measured
        # latency genuinely drifts — the signal the anomaly rule exists
        # for (the p99 must clear the rule's MAD floor over the calm
        # baseline)
        burst = LoadGenerator(base, z_size, threads=0, timeout=60.0,
                              rows=(200, 257))
        burst.add_threads(burst_threads + 4, pace=0.002)
        log(f"overload ramp: +{burst_threads} slab-slinging threads")
        anomaly = wait_for(
            lambda: "latency_anomaly" in _firing_names(
                http_json("GET", f"{base}/alerts", timeout=5.0)[1]),
            150.0, "latency_anomaly firing under overload")
        invariants["latency_anomaly_fires"] = bool(anomaly)
        _, mid_alerts = http_json("GET", f"{base}/alerts", timeout=5.0)
        results["overload_firing"] = sorted(_firing_names(mid_alerts))
        _, mid_snap = http_json("GET", f"{base}/metrics?scope=fleet",
                                timeout=30.0)
        lat = ((mid_snap or {}).get("fleet_request_latency_seconds")
               or {}).get("series") or [{}]
        results["overload_latency"] = {
            k: lat[0].get(k) for k in ("p50", "p99", "count")}

        # -- phase 5: quiesce -> everything resolves ---------------------
        burst_counts = burst.finish()
        burst = None
        log("burst stopped — waiting for every alert to resolve "
            "(the light load keeps the latency stream fresh)")
        quiet = wait_for(
            lambda: not _firing_names(
                http_json("GET", f"{base}/alerts", timeout=5.0)[1]),
            180.0, "all alerts resolve after quiesce")
        invariants["all_alerts_resolve"] = bool(quiet)

        # -- phase 6: calm again — still nothing may fire ----------------
        monitor.open_window("calm_2")
        try:
            time.sleep(calm_audit_s)
        finally:
            monitor.close_window()
        invariants["calm2_zero_firing"] = not any(
            f["window"] == "calm_2" for f in monitor.false_fires)
        monitor.finish()

        # -- phase 7: audits + ledger ------------------------------------
        # every alertname that ever fired must be explainable by the
        # faults this drill injected; anything else is a false fire
        expected = {"worker_down", "latency_anomaly"}
        allowed = expected | {"slo_availability_burn", "slo_latency_burn",
                              "queue_pressure_anomaly", "scrape_stale"}
        ever_fired = set(monitor.fired)
        invariants["expected_alerts_fired"] = expected <= ever_fired
        invariants["no_unexpected_alertnames"] = ever_fired <= allowed
        results["ever_fired"] = sorted(ever_fired)
        results["false_fires"] = len(monitor.false_fires)
        results["false_fire_entries"] = monitor.false_fires[:20]

        counts = load.finish()
        load = None
        for key, value in burst_counts.items():
            counts[key] = counts.get(key, 0) + value
        results["requests"] = counts
        _, router_metrics = http_json("GET", f"{base}/metrics",
                                      timeout=5.0)
        router_metrics = router_metrics or {}
        results["router"] = {
            k: router_metrics.get(k)
            for k in ("proxied", "ok", "error", "retries",
                      "budget_exhausted", "no_worker",
                      "attempts_exhausted", "ejections")
        }
        invariants["exactly_one_answer_zero_lost"] = (
            counts["lost"] == 0 and counts["error"] == 0
            and counts["ok"] + counts["shed"] + counts["error"]
            == counts["sent"])
        honest_503s = ((router_metrics.get("budget_exhausted") or 0)
                       + (router_metrics.get("no_worker") or 0)
                       + (router_metrics.get("attempts_exhausted") or 0))
        invariants["sheds_bounded_by_honest_503s"] = (
            counts["shed"] <= honest_503s)
        ports = _worker_ports(fleet_health(base))
        platforms = worker_platforms(ports)
        compiles = worker_serve_compiles(ports)
        results["worker_platforms"] = platforms
        results["serve_compile_counts"] = compiles
        invariants["workers_on_expected_platform"] = (
            len(platforms) == n_workers
            and all(p == platform for p in platforms.values()))
        invariants["no_serve_time_compiles"] = no_serve_compiles(compiles)

        # -- phase 8: the incident as ONE timeline -----------------------
        # (trace_report --alerts: spans + alert transitions)
        _, final_alerts = http_json("GET", f"{base}/alerts", timeout=10.0)
        alerts_out = os.path.join(workdir, "alerts.json")
        with open(alerts_out, "w") as fh:
            json.dump(final_alerts or {}, fh)
            fh.write("\n")
        trace_out = trace_out or os.path.join(workdir, "alerts_trace.json")
        _, merged = http_json("GET", f"{base}/debug/trace", timeout=30.0)
        with open(trace_out, "w") as fh:
            json.dump(merged or {}, fh)
            fh.write("\n")
        rc = run_trace_report(trace_out, "--alerts", alerts_out)
        invariants["trace_report_alert_overlay"] = rc == 0
        results["incident_timeline"] = {
            "alerts_json": alerts_out, "trace": trace_out,
            "trace_report_rc": rc,
            "incidents": len((final_alerts or {}).get("incidents", [])),
        }
        log(f"trace_report --alerts rc={rc}")
    finally:
        for gen in (load, burst):
            if gen is not None:
                gen.finish()
        if monitor is not None and not monitor.stop.is_set():
            monitor.finish()
        stop_process(fleet)

    return _payload("fleet_alerts_drill", results, invariants, t_start, config)


# ===========================================================================
# the multi-model multiplexing drill (--mux)
# ===========================================================================

def _mux_counts(snapshot: dict) -> dict:
    """Per-model outcome totals off ``mux_requests_total`` (summed over
    kinds): {model: {status: count}}."""
    out: dict = {}
    for s in snapshot.get("mux_requests_total", {}).get("series", []):
        labels = s.get("labels", {})
        model, status = labels.get("model"), labels.get("status")
        per = out.setdefault(model, {})
        per[status] = per.get(status, 0.0) + float(s.get("value", 0.0))
    return out


def _brownout_sheds(snapshot: dict) -> dict:
    return {
        s["labels"]["model"]: float(s["value"])
        for s in snapshot.get("mux_brownout_sheds_total",
                              {}).get("series", [])
    }


def run_mux(workload: dict, workdir: str, *, keep_last: int = 10, seed: int = 1,
            smoke: bool = False) -> dict:
    """The multiplexing drill (docs/MULTIPLEX.md): real engines from
    three seeded store generations behind one MuxService, driven
    in-process over real HTTP:

    1. **split** — two variants (expensive "heavy" at 90%, cheap "lite"
       at 10%) under closed-loop load: zero lost, both served, observed
       split within tolerance of the weights.
    2. **ramp + injected burn** — a third generation is adopted and
       ramped 1% → 10% → 50% → 100% on its own per-variant SLO signal;
       a burst of injected failures into the candidate's tracker must
       AUTO-ROLLBACK the ramp (weights restored exactly), then a clean
       re-ramp must complete with the candidate elected primary.
    3. **brownout** — synthetic overload (big-slab closed-loop burst
       against a small queue) must walk the per-model brownout tier up:
       the expensive variant sheds with honest 503s while the cheap one
       keeps answering; quiesce releases the tier.

    The exactly-one-answer ledger holds across all phases."""
    from gan_deeplearning4j_tpu_torch.quant import (
        build_bf16_variant,
        measure_bundle_cost,
        measure_engine_cost,
    )
    from gan_deeplearning4j_tpu_torch.resilience import CheckpointStore
    from gan_deeplearning4j_tpu_torch.serving import make_server
    from gan_deeplearning4j_tpu_torch.serving.mux import (
        BrownoutController,
        MuxRegistry,
        MuxService,
        health_from_tracker,
    )
    from gan_deeplearning4j_tpu_torch.telemetry.registry import get_registry
    from gan_deeplearning4j_tpu_torch.telemetry.slo import SLOConfig

    serve_store = os.path.join(workdir, "store_serve")
    device = workload_device(workload)
    platform = expected_platform(workload)
    split_seconds = 5.0 if smoke else 8.0
    results: dict = {}
    invariants: dict = {}
    server = svc = load = None
    t_start = time.monotonic()

    try:
        # -- phase 0: seed three generations, boot the mux service -------
        bundles = []
        store = CheckpointStore(serve_store, keep_last=keep_last)
        for _ in range(3):
            gen_number = seed_bundle(workload, serve_store, keep_last)
            bundles.append((gen_number, store.latest_valid().path))
        z_size = bundle_z_size(serve_store, keep_last)
        log(f"seeded serving generations "
            f"{[n for n, _ in bundles]} into {serve_store} (z_size {z_size})")
        drill_buckets = (1, 8)  # the ladder every drill engine serves
        registry = MuxRegistry(
            buckets=drill_buckets, budget=3,
            batcher_kwargs={"max_latency": 0.002, "max_queue": 12,
                            "default_timeout": 5.0},
            device=device)
        # the cost gradient the brownout sheds by: "heavy" is the
        # expensive fp32 primary, "lite" a REAL bf16 sibling built by
        # the quant plane — half the resident bytes, so the MEASURED cost
        # ordering is deterministic even on a noisy host. "lite" lands
        # pre-measured through the manifest adoption path:
        # measure_bundle_cost writes the cost block and registry.add()
        # picks it up, flipping cost_source to "measured" without any
        # drill-side plumbing.
        lite_dir = os.path.join(workdir, "variant_bf16")
        build_bf16_variant(bundles[1][1], lite_dir)
        # price the variant on the ladder the registry will serve it on
        # (a literal here would shadow a learned manifest ladder — JG031)
        measure_bundle_cost(lite_dir, buckets=drill_buckets, rounds=2, device=device)
        registry.add("heavy", bundle_path=bundles[0][1], cost=4.0,
                     weight=0.9, generation=bundles[0][0])
        registry.add("lite", bundle_path=lite_dir, cost=1.0,
                     weight=0.1, generation=bundles[1][0])
        # the manifest-adoption path worked before any drill-side
        # plumbing ran: lite entered already measured, heavy (a store
        # bundle, no cost block) on its declared bootstrap
        invariants["manifest_cost_block_adopted"] = (
            registry.cost_sources() == {"heavy": "declared",
                                        "lite": "measured"})
        svc = MuxService(
            registry,
            slo_config=SLOConfig(
                availability_target=0.9, latency_target=0.9,
                latency_threshold_s=2.0,
                fast_window_s=2.0, slow_window_s=8.0),
            brownout=BrownoutController(
                threshold=0.25, enter_ticks=2, exit_ticks=6))
        svc.start_control_loop(interval=0.2)
        server = make_server(svc, port=0)
        port = server.server_address[1]
        base = f"http://127.0.0.1:{port}"
        threading.Thread(target=server.serve_forever, daemon=True).start()
        health = fleet_health(base)
        invariants["boots_ok"] = health.get("status") == "ok"
        invariants["shared_pool_attached"] = (
            registry.engine_for("heavy")._shared_staging is registry.pool)
        invariants["engines_on_expected_platform"] = all(
            registry.engine_for(n).platform == platform for n in ("heavy", "lite"))
        # the measurement the ordering invariants run on is PAIRED:
        # both live engines profiled back to back, interleaved, and the
        # min-per_row block kept per engine — an unpaired measurement
        # lets one slow sample flip the ranking on a small model. This
        # also exercises the second adoption route: set_measured_cost
        # landing a live profile on a registered variant (heavy flips
        # declared -> measured here).
        heavy_cost = lite_cost = None
        for _ in range(3):
            hb = measure_engine_cost(registry.engine_for("heavy"),
                                     rounds=2)
            lb = measure_engine_cost(registry.engine_for("lite"),
                                     rounds=2)
            if heavy_cost is None or hb["per_row_s"] < heavy_cost[
                    "per_row_s"]:
                heavy_cost = hb
            if lite_cost is None or lb["per_row_s"] < lite_cost[
                    "per_row_s"]:
                lite_cost = lb
        registry.set_measured_cost("heavy", heavy_cost)
        registry.set_measured_cost("lite", lite_cost)
        costs = registry.costs()
        sources = registry.cost_sources()
        results["measured_costs"] = {
            "scalars": costs,
            "sources": sources,
            "resident_param_bytes": {
                "heavy": heavy_cost["resident_param_bytes"],
                "lite": lite_cost["resident_param_bytes"],
            },
        }
        invariants["costs_measured_not_declared"] = (
            sources.get("heavy") == "measured"
            and sources.get("lite") == "measured")
        # the quant claim, measured on this host: the bf16 sibling pins
        # half the bytes and its residency-rent scalar ranks below fp32
        invariants["bf16_variant_genuinely_cheaper"] = (
            lite_cost["resident_param_bytes"]
            < heavy_cost["resident_param_bytes"]
            and costs["lite"] < costs["heavy"])
        health = fleet_health(base)
        invariants["status_reports_cost_source"] = all(
            health.get("costs", {}).get(n, {}).get("cost_source")
            == "measured" for n in ("heavy", "lite"))
        log(f"mux service up at {base}: "
            f"variants {sorted(registry.names())}, measured costs "
            f"{ {n: f'{c:.3g}' for n, c in costs.items()} }")

        # -- phase 1: 10/90 split under closed-loop load ------------------
        load = LoadGenerator(base, z_size, threads=4, pace=0.004)
        load.start()
        time.sleep(split_seconds)
        counts = _mux_counts(get_registry().snapshot())
        heavy_ok = counts.get("heavy", {}).get("ok", 0.0)
        lite_ok = counts.get("lite", {}).get("ok", 0.0)
        served = heavy_ok + lite_ok
        lite_share = (lite_ok / served) if served else float("nan")
        results["split"] = {
            "requests": served, "heavy_ok": heavy_ok, "lite_ok": lite_ok,
            "lite_share_observed": lite_share, "lite_share_expected": 0.1,
        }
        invariants["split_serves_both_variants"] = (
            heavy_ok > 0 and lite_ok > 0)
        # binomial tolerance, wide enough for a short smoke window
        invariants["split_matches_weights"] = (
            served >= 200 and 0.04 <= lite_share <= 0.20)
        log(f"split: {served:.0f} served, lite share "
            f"{lite_share:.3f} (want ~0.10)")

        # -- phase 2: ramp with one injected SLO burn → auto-rollback -----
        registry.add("cand", bundle_path=bundles[2][1], cost=1.0,
                     weight=0.0, generation=bundles[2][0])
        # the candidate's store bundle carries no cost block: it enters
        # on its declared bootstrap, coexisting with measured peers —
        # the bootstrap-default contract
        invariants["declared_bootstrap_coexists"] = (
            registry.cost_sources().get("cand") == "declared")
        # generous holds: the injection below must land while the ramp
        # is still mid-ladder, not race a sprinting one
        ramp = svc.start_ramp("cand", stages=(0.01, 0.10, 0.50, 1.0),
                              hold_ticks=10)
        mid = wait_for(
            lambda: (ramp.snapshot().get("fraction") or 0.0) >= 0.10
            or ramp.state != "ramping",
            60.0, "ramp reaches the 10% stage")
        invariants["ramp_reaches_mid_stage"] = bool(
            mid and ramp.state == "ramping")
        # the injected burn: a failure burst into the candidate's OWN
        # SLI stream (the signal the rollback rule reads) — the mux
        # analogue of the resilience drill's fault injections
        tracker = svc.tracker_for("cand")
        for _ in range(200):
            tracker.record(False)
        rolled = wait_for(lambda: ramp.state == "rolled_back", 20.0,
                          "ramp auto-rollback on the injected burn")
        weights = registry.splitter.weights()
        invariants["ramp_rolls_back_on_burn"] = bool(rolled)
        invariants["rollback_restores_weights"] = (
            weights.get("cand") == 0.0
            and abs(weights.get("heavy", 0) - 0.9) < 1e-9
            and abs(weights.get("lite", 0) - 0.1) < 1e-9)
        results["ramp_rollback"] = {
            "rollbacks": ramp.rollbacks,
            "events": list(ramp.events),
            "weights_after": weights,
        }
        log(f"ramp rolled back (events: "
            f"{[e['event'] for e in ramp.events]})")

        # -- phase 3: clean re-ramp completes 1% → 100% -------------------
        # the injected failures must first age out of the candidate's
        # fast window, or the re-ramp reads yesterday's burn and rolls
        # back on stale evidence
        burn_gone = wait_for(
            lambda: health_from_tracker(tracker)() is not False,
            20.0, "injected burn ages out of the fast window",
            interval=0.5)
        invariants["injected_burn_ages_out"] = bool(burn_gone)
        ramp2 = svc.start_ramp("cand", stages=(0.01, 0.10, 0.50, 1.0),
                               hold_ticks=2)
        done = wait_for(
            lambda: ramp2.state in ("complete", "rolled_back"),
            120.0, "clean ramp completion")
        invariants["ramp_completes"] = (
            done is not None and ramp2.state == "complete")
        invariants["candidate_elected_primary"] = (
            registry.primary_name() == "cand"
            and registry.splitter.shares() == {"cand": 1.0})
        results["ramp_complete"] = {
            "state": ramp2.state,
            "events": list(ramp2.events),
            "shares": registry.splitter.shares(),
        }
        log(f"clean ramp: {ramp2.state}, primary "
            f"{registry.primary_name()}")

        # -- phase 4: synthetic overload → per-model brownout -------------
        # restore the two-variant split so the cost gradient is live
        # (cand keeps zero weight; level-2 would shed it before "lite")
        registry.set_weights({"heavy": 0.6, "lite": 0.4, "cand": 0.0})
        sheds_before = _brownout_sheds(get_registry().snapshot())
        counts_before = _mux_counts(get_registry().snapshot())
        # big-slab closed-loop burst: 256-row slabs chunk through the
        # 8-bucket ladder (32 real flushes each), backing the small
        # (max_queue=12) per-variant queues up — real queue pressure,
        # synthetic only in its shape
        slab_stop = threading.Event()

        def slab_client(tid: int) -> None:
            rng = np.random.default_rng(7000 + tid)
            while not slab_stop.is_set():
                rows = rng.random((256, z_size), dtype=np.float32)
                http_json("POST", f"{base}/v1/sample",
                          {"data": rows.tolist()}, timeout=30.0)

        slab_threads = [
            threading.Thread(target=slab_client, args=(i,), daemon=True)
            for i in range(16)
        ]
        for t in slab_threads:
            t.start()
        engaged = wait_for(lambda: svc.brownout_level >= 1, 30.0,
                           "brownout engages under the slab burst")
        level_seen = svc.brownout_level
        # hold the burst briefly so sheds accumulate while engaged
        time.sleep(2.0)
        sheds_mid = _brownout_sheds(get_registry().snapshot())
        slab_stop.set()
        for t in slab_threads:
            t.join(timeout=40.0)
        heavy_sheds = (sheds_mid.get("heavy", 0.0)
                       - sheds_before.get("heavy", 0.0))
        lite_sheds = (sheds_mid.get("lite", 0.0)
                      - sheds_before.get("lite", 0.0))
        counts_mid = _mux_counts(get_registry().snapshot())
        lite_ok_during = (counts_mid.get("lite", {}).get("ok", 0.0)
                          - counts_before.get("lite", {}).get("ok", 0.0))
        invariants["brownout_engages_under_overload"] = bool(engaged)
        invariants["brownout_sheds_expensive_first"] = (
            heavy_sheds > 0 and lite_sheds == 0)
        # and that order came from the MEASUREMENT: both shed-ranked
        # variants carry measured scalars and the one that shed ranks
        # above the one that served — not the 4.0-vs-1.0 declaration
        mid_costs = registry.costs()
        mid_sources = registry.cost_sources()
        invariants["shed_order_follows_measured_cost"] = (
            mid_sources.get("heavy") == "measured"
            and mid_sources.get("lite") == "measured"
            and mid_costs["heavy"] > mid_costs["lite"]
            and heavy_sheds > 0 and lite_sheds == 0)
        invariants["cheap_variant_serves_through_brownout"] = (
            lite_ok_during > 0)
        released = wait_for(lambda: svc.brownout_level == 0, 30.0,
                            "brownout releases after quiesce")
        invariants["brownout_releases_after_quiesce"] = bool(released)
        results["brownout"] = {
            "max_level_seen": level_seen,
            "heavy_sheds": heavy_sheds,
            "lite_sheds": lite_sheds,
            "lite_ok_during_brownout": lite_ok_during,
        }
        log(f"brownout: level {level_seen}, heavy sheds "
            f"{heavy_sheds:.0f}, lite sheds {lite_sheds:.0f}, "
            f"lite ok during {lite_ok_during:.0f}")

        # -- phase 5: manifest-built conditional variant ------------------
        # the zoo seam: a variant built FROM a scenario manifest —
        # conditional dcgan-mnist (28×28 conv generator, latent + one-hot
        # input) — joins the SAME registry. The publish goes through the
        # real experiment path so serving.json carries the zoo block; the
        # engine the registry builds from the bundle is conditional end
        # to end, and the mux width check scopes to the ROUTED variant:
        # full-width rows pinned to it serve while latent-width rows 400
        # without touching the other variants' contracts.
        from gan_deeplearning4j_tpu_torch.harness import GanExperiment
        from gan_deeplearning4j_tpu_torch.zoo.manifest import ScenarioManifest

        scn = ScenarioManifest(
            architecture="dcgan", conditioning="class", dataset="mnist",
            resolution=28, num_classes=10, z_size=z_size)
        cond_dir = os.path.join(workdir, "variant_cond")
        cond_exp = GanExperiment(scn.experiment_config(
            seed=seed + 41, use_accelerator=device == "cuda"))
        try:
            cond_exp.publish_for_serving(cond_dir)
        finally:
            cond_exp.close()
        # price it on the ladder it will serve (a variable, not a
        # literal — JG031) so it enters the registry already measured
        measure_bundle_cost(cond_dir, buckets=drill_buckets, rounds=2, device=device)
        registry.add("cond", bundle_path=cond_dir, cost=2.0, weight=0.0)
        registry.ensure_resident("cond")
        cond_engine = registry.engine_for("cond")
        cond_width = cond_engine.input_width("sample")
        heavy_width = registry.engine_for("heavy").input_width("sample")
        rng = np.random.default_rng(seed + 42)
        zc = rng.random((5, cond_width - 10), dtype=np.float32) * 2.0 - 1.0
        onehot = np.eye(10, dtype=np.float32)[np.arange(5) % 10]
        full_rows = np.concatenate([zc, onehot], axis=1)
        st_full, body_full = http_json(
            "POST", f"{base}/v1/sample",
            {"data": full_rows.tolist(), "model": "cond"}, timeout=30.0)
        st_narrow, _ = http_json(
            "POST", f"{base}/v1/sample",
            {"data": zc.tolist(), "model": "cond"}, timeout=30.0)
        cond_costs = registry.costs()
        results["conditional_variant"] = {
            "scenario": dict(cond_engine.scenario or {}),
            "input_width": cond_width,
            "base_input_width": heavy_width,
            "pinned_full_width_status": st_full,
            "pinned_latent_width_status": st_narrow,
            "cost": cond_costs.get("cond"),
            "cost_source": registry.cost_sources().get("cond"),
        }
        invariants["conditional_variant_manifest_built"] = (
            bool(cond_engine.conditional)
            and cond_engine.class_count == 10
            and (cond_engine.scenario or {}).get("dataset") == "mnist")
        invariants["conditional_enters_measured"] = (
            registry.cost_sources().get("cond") == "measured")
        invariants["conditional_pinned_serves_full_width"] = (
            st_full == 200
            and len((body_full or {}).get("data", [])) == 5)
        invariants["conditional_width_guard_rejects_latent"] = (
            st_narrow == 400)
        invariants["conditional_architecture_distinct"] = (
            cond_width != heavy_width
            and cond_costs.get("cond") != cond_costs.get("heavy"))
        log(f"conditional variant: width {cond_width} (base "
            f"{heavy_width}), pinned full-width -> {st_full}, "
            f"latent-width -> {st_narrow}, cost "
            f"{cond_costs.get('cond'):.3g} ({results['conditional_variant']['cost_source']})")

        # -- ledger -------------------------------------------------------
        final = load.finish()
        latencies = load.latencies()
        load = None
        results["ledger"] = final
        results["latency"] = {"ok_requests": len(latencies),
                              "p50_s": percentile(latencies, 0.50),
                              "p99_s": percentile(latencies, 0.99)}
        results["staging_pool"] = registry.pool.stats()
        results["registry"] = registry.snapshot()
        serve_compiles = {n: registry.engine_for(n).serve_compile_counts
                          for n in sorted(registry.names())
                          if registry.engine_for(n) is not None}
        results["serve_compile_counts"] = serve_compiles
        invariants["zero_lost"] = final["lost"] == 0
        invariants["zero_client_errors"] = final["error"] == 0
        invariants["no_serve_time_compiles"] = no_serve_compiles(serve_compiles)
        log(f"ledger: {final}")
    finally:
        if load is not None and not load.stop.is_set():
            load.finish()
        if server is not None:
            server.shutdown()
            server.server_close()
        if svc is not None:
            svc.close()

    return _payload("fleet_mux_drill", results, invariants, t_start, {
        "seed": seed, "smoke": bool(smoke), "split_seconds": split_seconds,
        "device": device, "platform": platform})
