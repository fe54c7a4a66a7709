"""Fleet CLI — ``python -m gan_deeplearning4j_tpu_torch.fleet [flags]``.

Boots the whole serving plane from one checkpoint store: N worker
processes (spawned from the newest digest-valid serving generation), the
health-ejecting router in front of them, and the manager's supervise +
rolling-upgrade loop. Runs until interrupted. Example::

    python -m gan_deeplearning4j_tpu_torch.fleet --store bundles \\
        --workers 3 --port 8100 --canary-data canary.npz

The flags are the JAX fleet CLI's (``gan_deeplearning4j_tpu/fleet/
__main__.py``) but ``--compilation-cache`` (a CUDA graph is not cached
across processes), plus ``--device``: the torch device of every worker and
sidecar probe (default ``cuda``; ``cpu`` runs the whole fleet on the CPU).
SIGTERM stops the fleet as Ctrl-C does, workers first; in the JAX CLI it
ends the router's process alone.
"""

from __future__ import annotations

import argparse
import logging
import signal
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="gan_deeplearning4j_tpu_torch.fleet",
        description="multi-process serving fleet: router + N workers",
    )
    p.add_argument("--store", required=True,
                   help="checkpoint store root holding serving generations")
    p.add_argument("--workers", type=int, default=2)
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8100, help="router port")
    p.add_argument("--worker-ports", default=None,
                   help="comma-separated worker ports (default: free ports)")
    p.add_argument("--log-dir", default=".",
                   help="where worker-<id>.log files land")
    p.add_argument("--boot-wait", type=float, default=120.0,
                   help="seconds to wait for the first valid serving "
                        "generation in the store")
    p.add_argument("--poll", type=float, default=2.0,
                   help="store poll interval for rolling upgrades")
    p.add_argument("--request-timeout", type=float, default=10.0,
                   help="per-proxied-request timeout at the router")
    p.add_argument("--probe-interval", type=float, default=0.25,
                   help="health loop cadence (probes + /metrics scrapes)")
    p.add_argument("--retry-ratio", type=float, default=0.2,
                   help="retry-budget deposit per proxied request")
    p.add_argument("--retry-burst", type=float, default=10.0,
                   help="retry-budget token cap")
    p.add_argument("--eject-failures", type=int, default=3,
                   help="consecutive failures that eject a worker")
    p.add_argument("--reopen-after", type=float, default=1.0,
                   help="initial ejected→half-open backoff seconds")
    p.add_argument("--drain-timeout", type=float, default=30.0,
                   help="bounded wait for a draining worker's pipeline")
    p.add_argument("--warm-timeout", type=float, default=300.0,
                   help="bounded wait for a relaunched worker to go healthy")
    p.add_argument("--hang-restart", type=float, default=20.0,
                   help="force-restart a worker whose breaker stays open "
                        "this long while its process is alive")
    p.add_argument("--buckets", default=None,
                   help="worker batch ladder, e.g. 1,8,32,128")
    p.add_argument("--replicas", default=None,
                   help="device replicas per worker (int or 'all')")
    p.add_argument("--max-latency", type=float, default=None,
                   help="worker micro-batch trigger seconds")
    p.add_argument("--timeout", type=float, default=None,
                   help="worker default per-request deadline seconds")
    p.add_argument("--canary-data", default=None, metavar="NPZ",
                   help="npz with 'features' (and optionally 'labels') for "
                        "the fleet admission gate; omitted = digest-valid "
                        "generations roll ungated")
    p.add_argument("--canary-samples", type=int, default=256)
    p.add_argument("--canary-seed", type=int, default=666)
    p.add_argument("--canary-feature", choices=("raw", "dis_features"),
                   default="raw",
                   help="FID feature space for the admission probes "
                        "(dis_features: the incumbent classifier's feature "
                        "vertex — docs/FLEET.md)")
    p.add_argument("--canary-fid-ratio", type=float, default=1.5)
    p.add_argument("--canary-fid-slack", type=float, default=10.0)
    p.add_argument("--canary-acc-drop", type=float, default=0.05)
    p.add_argument("--telemetry", action="store_true",
                   help="enable span tracing on the router/manager process "
                        "AND every worker (GET /debug/trace then merges "
                        "one fleet-wide Chrome trace)")
    p.add_argument("--slo-availability", type=float, default=0.999,
                   help="availability target (fraction answered non-5xx)")
    p.add_argument("--slo-latency-ms", type=float, default=500.0,
                   help="latency objective threshold in milliseconds")
    p.add_argument("--slo-latency-target", type=float, default=0.99,
                   help="fraction of answers that must beat the threshold")
    p.add_argument("--slo-fast-window", type=float, default=60.0,
                   help="fast burn-rate window seconds")
    p.add_argument("--slo-slow-window", type=float, default=600.0,
                   help="slow burn-rate window seconds")
    p.add_argument("--autoscale", action="store_true",
                   help="enable the SLO-driven elastic control loop: "
                        "--workers becomes the min/boot size and the "
                        "fleet resizes up to --max-workers "
                        "(docs/FLEET.md 'Autoscaling')")
    p.add_argument("--max-workers", type=int, default=None,
                   help="autoscaler ceiling (default: 2x --workers); at "
                        "this size continued overload enters brownout")
    p.add_argument("--scale-up-pressure", type=float, default=3.0,
                   help="queue+in-flight per routable worker at/above "
                        "which a tick counts toward scale-up")
    p.add_argument("--scale-down-pressure", type=float, default=1.0,
                   help="pressure at/below which a tick counts toward "
                        "scale-down (must be < --scale-up-pressure)")
    p.add_argument("--scale-up-ticks", type=int, default=3,
                   help="consecutive overloaded ticks before scaling up")
    p.add_argument("--scale-down-ticks", type=int, default=10,
                   help="consecutive calm ticks before scaling down")
    p.add_argument("--scale-interval", type=float, default=1.0,
                   help="autoscaler decision tick seconds")
    p.add_argument("--scale-up-cooldown", type=float, default=5.0,
                   help="seconds after a scale-up before the next resize")
    p.add_argument("--scale-down-cooldown", type=float, default=15.0,
                   help="seconds after a scale-down before the next resize")
    p.add_argument("--brownout-max-rows", type=int, default=32,
                   help="tier-1 brownout: /v1/sample slabs with more rows "
                        "are shed with an honest 503")
    p.add_argument("--brownout-deadline-ms", type=float, default=1000.0,
                   help="tier-2 brownout: effective per-request deadline "
                        "cap injected at the router")
    p.add_argument("--brownout-exit-ticks", type=int, default=5,
                   help="consecutive calm ticks before a brownout tier "
                        "releases")
    p.add_argument("--spawn-backoff", type=float, default=0.5,
                   help="base seconds for the capped exponential backoff "
                        "on workers that die before becoming routable")
    p.add_argument("--spawn-backoff-max", type=float, default=30.0,
                   help="backoff cap for repeated spawn failures")
    p.add_argument("--device", default="cuda",
                   help="torch device of every worker and sidecar probe "
                        "(default: cuda; there is no fallback to the CPU)")
    p.add_argument("--alerts", action="store_true",
                   help="enable the alerting plane (telemetry/alerts.py, "
                        "default fleet rule pack): GET /alerts, healthz "
                        "alerts block, exemplar capture; evaluation rides "
                        "the health loop, no extra scrape")
    p.add_argument("--alert-stale-after", type=float, default=10.0,
                   help="scrape_stale rule: seconds since a member's last "
                        "successful /metrics scrape before it alerts")
    p.add_argument("--alert-latency-drift", type=float, default=0.05,
                   help="latency_anomaly rule: smallest p99 drift (s) "
                        "worth a robust-z unit — a shift of ~12x this "
                        "over the rolling baseline pages")
    p.add_argument("--alert-webhook", default=None, metavar="URL",
                   help="POST every alert transition to this URL (bounded "
                        "timeout + retries, off the evaluation path)")
    args = p.parse_args(argv)

    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s %(name)s %(message)s"
    )
    from gan_deeplearning4j_tpu_torch.deploy.canary import CanaryThresholds
    from gan_deeplearning4j_tpu_torch.fleet.autoscaler import AutoscalerConfig
    from gan_deeplearning4j_tpu_torch.fleet.manager import FleetManager
    from gan_deeplearning4j_tpu_torch.fleet.router import (
        FleetRouter,
        make_router_server,
    )
    from gan_deeplearning4j_tpu_torch.telemetry.slo import SLOConfig
    from gan_deeplearning4j_tpu_torch.telemetry.trace import TRACER, configure_from_env

    if args.telemetry:
        TRACER.enable()
    else:
        configure_from_env()
    worker_args = []
    if args.buckets:
        worker_args += ["--buckets", args.buckets]
    if args.replicas is not None:
        worker_args += ["--replicas", str(args.replicas)]
    if args.max_latency is not None:
        worker_args += ["--max-latency", str(args.max_latency)]
    if args.timeout is not None:
        worker_args += ["--timeout", str(args.timeout)]
    ports = None
    if args.worker_ports:
        ports = [int(x) for x in args.worker_ports.split(",") if x.strip()]
        if len(ports) != args.workers:
            p.error(f"--worker-ports names {len(ports)} ports for "
                    f"--workers {args.workers}")
    router = FleetRouter(
        request_timeout=args.request_timeout,
        probe_interval=args.probe_interval,
        retry_ratio=args.retry_ratio,
        retry_burst=args.retry_burst,
        breaker_kwargs={
            "consecutive_failures": args.eject_failures,
            "reopen_after": args.reopen_after,
        },
        slo_config=SLOConfig(
            availability_target=args.slo_availability,
            latency_threshold_s=args.slo_latency_ms / 1e3,
            latency_target=args.slo_latency_target,
            fast_window_s=args.slo_fast_window,
            slow_window_s=args.slo_slow_window,
        ),
    )
    autoscale = None
    if args.autoscale:
        autoscale = AutoscalerConfig(
            min_workers=args.workers,
            max_workers=args.max_workers or 2 * args.workers,
            up_pressure=args.scale_up_pressure,
            down_pressure=args.scale_down_pressure,
            up_consecutive=args.scale_up_ticks,
            down_consecutive=args.scale_down_ticks,
            interval_s=args.scale_interval,
            up_cooldown_s=args.scale_up_cooldown,
            down_cooldown_s=args.scale_down_cooldown,
            brownout_exit_ticks=args.brownout_exit_ticks,
            brownout_max_rows=args.brownout_max_rows,
            brownout_deadline_s=args.brownout_deadline_ms / 1e3,
        )
    manager = FleetManager(
        router, args.store,
        num_workers=args.workers, ports=ports, host=args.host,
        worker_args=worker_args, log_dir=args.log_dir,
        poll_interval=args.poll,
        drain_timeout=args.drain_timeout,
        warm_timeout=args.warm_timeout,
        hang_restart_after=args.hang_restart,
        canary_data=args.canary_data,
        canary_samples=args.canary_samples,
        canary_seed=args.canary_seed,
        canary_feature=args.canary_feature,
        thresholds=CanaryThresholds(
            fid_ratio_max=args.canary_fid_ratio,
            fid_slack=args.canary_fid_slack,
            accuracy_drop_max=args.canary_acc_drop,
        ),
        telemetry=args.telemetry,
        autoscale=autoscale,
        spawn_backoff_base=args.spawn_backoff,
        spawn_backoff_max=args.spawn_backoff_max,
        device=args.device,
    )
    if args.alerts:
        from gan_deeplearning4j_tpu_torch.telemetry.alerts import (
            AlertManager,
            WebhookSink,
            default_fleet_rules,
            log_sink,
        )

        sinks = [log_sink]
        if args.alert_webhook:
            sinks.append(WebhookSink(args.alert_webhook))
        router.attach_alerts(AlertManager(
            default_fleet_rules(
                probe_interval_s=args.probe_interval,
                scrape_stale_after_s=args.alert_stale_after,
                latency_drift_floor_s=args.alert_latency_drift,
                annotate_member=router.annotate_member),
            sinks=tuple(sinks)))
    log = logging.getLogger(__name__)
    # bind the router port BEFORE spawning workers: a bind failure must
    # not leave N orphaned worker subprocesses behind
    server = make_router_server(router, args.host, args.port)

    def _terminate(signum, frame):
        raise KeyboardInterrupt

    # SIGTERM stops the workers too (the ``finally`` below), as Ctrl-C does:
    # by default it would kill this process alone and orphan every worker
    signal.signal(signal.SIGTERM, _terminate)
    try:
        manager.start(boot_wait=args.boot_wait)
        log.info("fleet router on http://%s:%d (%d workers, generation %s)",
                 args.host, server.server_address[1], len(manager.slots),
                 manager.generation)
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        manager.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
