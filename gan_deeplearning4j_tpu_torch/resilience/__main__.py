"""Supervised training worker CLI —
``python -m gan_deeplearning4j_tpu_torch.resilience``.

The PyTorch port's counterpart of ``gan_deeplearning4j_tpu/resilience/
__main__.py``: the same flags, exit codes and summary. The device is the
config's (``use_accelerator``: True is ``cuda:0`` and raises without CUDA,
False is the CPU). On the card the experiment pins what makes a run
replay bit for bit in every process (``runtime/device.py``): cuDNN
deterministic algorithms with benchmark-mode autotuning off, TF32 off for
fp32 convolutions and matmuls, and one cuBLAS workspace configuration
(``CUBLAS_WORKSPACE_CONFIG=:4096:8`` unless the environment sets one), so a
relaunched worker picks the kernels the killed one picked. SIGTERM only
sets the supervisor's preemption flag, honoured at the next step boundary;
SIGUSR2 starts one background ``torch.profiler`` capture
(``telemetry/device.py``): the first signal primes the profiler on the
main thread, the capture's start and stop wait on the process capture
lock rather than break a CUDA-graph capture, and the worker waits for a
capture in flight before it exits.

One invocation = one supervisor lifetime. The process-level contract the
drill (and any orchestrator) relies on:

- exit 0   — run completed (``total_steps`` reached, final generation
             published);
- exit 75  — preempted (EX_TEMPFAIL: a checkpoint was published and the
             worker exited cleanly; relaunch to continue) — in mesh mode
             also any worker fault (``status: worker_fault``): in-process
             retries are disabled under a gang, so the relauncher
             restarts the whole mesh from the last coordinated
             generation;
- exit 70  — terminal (EX_SOFTWARE: retry budget exhausted — relaunching
             without intervention would fail the same way);
- exit 76  — gang abort (EX_PROTOCOL: a mesh barrier timed out — a peer
             worker is dead or wedged; relaunch the WHOLE mesh with a
             fresh ``--mesh-token``, never just this worker);
- killed by signal — a hard fault; the store still holds a consistent
             generation, so relaunching resumes from it.

Mesh mode (``--mesh-size N --mesh-worker K``): N invocations of this CLI
against ONE ``--store`` form a coordinated checkpoint gang — each worker
stages its shard, worker 0 two-phase-commits the generation
(docs/RESILIENCE.md, resilience/mesh.py). ``--mesh-token`` must be unique
per gang launch (the relauncher's job) so stale rounds from a dead gang
can never collide with live ones.

The run summary (status, steps, restore/publish timings, fault events) is
written as JSON to ``--summary`` and echoed to stdout.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m gan_deeplearning4j_tpu_torch.resilience",
        description="fault-tolerant supervised training worker",
    )
    p.add_argument("--config", required=True,
                   help="ExperimentConfig JSON file")
    p.add_argument("--store", required=True, help="checkpoint store root")
    p.add_argument("--data", required=True,
                   help="npz with 'features' and 'labels' arrays")
    p.add_argument("--total-steps", type=int, required=True)
    p.add_argument("--publish-every", type=int, default=10)
    p.add_argument("--serve-store", default=None, metavar="DIR",
                   help="also publish inference bundles (generator + "
                        "classifier, no updater) into this checkpoint "
                        "store on a cadence — what a live server's reload "
                        "plane watches (docs/DEPLOY.md)")
    p.add_argument("--serve-publish-every", type=int, default=0,
                   help="serving-bundle cadence in steps (0 = follow "
                        "--publish-every; needs --serve-store)")
    p.add_argument("--max-retries", type=int, default=3)
    p.add_argument("--backoff-base", type=float, default=0.5)
    p.add_argument("--backoff-max", type=float, default=30.0)
    p.add_argument("--keep-last", type=int, default=3)
    p.add_argument("--keep-every", type=int, default=0)
    p.add_argument("--mesh-size", type=int, default=1,
                   help="number of coordinated checkpoint workers sharing "
                        "--store (1 = single-writer, the default)")
    p.add_argument("--mesh-worker", type=int, default=0,
                   help="this worker's id in [0, --mesh-size); worker 0 "
                        "is the commit coordinator")
    p.add_argument("--mesh-token", default="r0",
                   help="gang-launch token — MUST be fresh per relaunch "
                        "so a dead gang's staging can never be mistaken "
                        "for a live round")
    p.add_argument("--mesh-timeout", type=float, default=60.0,
                   help="bound on every in-round mesh wait, seconds; "
                        "expiry = gang abort (exit 76)")
    p.add_argument("--mesh-boot-timeout", type=float, default=300.0,
                   help="bound on the gang's first rendezvous (restore "
                        "resolution), absorbing cold-start skew")
    p.add_argument("--fault-schedule", default=None,
                   help="FaultSchedule JSON file (docs/RESILIENCE.md)")
    p.add_argument("--summary", default=None,
                   help="write the run summary JSON here as well as stdout")
    p.add_argument("--telemetry", action="store_true",
                   help="enable span tracing (also honored via "
                        "GDT_TELEMETRY=trace); metrics are always on")
    p.add_argument("--span-trace", default=None, metavar="PATH",
                   help="dump the span tracer's Chrome trace JSON here on "
                        "exit (implies --telemetry)")
    p.add_argument("--trace-artifacts", default=None, metavar="DIR",
                   help="SIGUSR2 captures a 1s torch.profiler device trace "
                        "into this dir (default: $GDT_TRACE_DIR or "
                        "./artifacts/device_traces)")
    args = p.parse_args(argv)

    from gan_deeplearning4j_tpu_torch.harness import ExperimentConfig
    from gan_deeplearning4j_tpu_torch.resilience import (
        CheckpointStore,
        FaultInjector,
        FaultSchedule,
        MeshCoordinator,
        MeshTimeout,
        RetryBudgetExceeded,
        SupervisorConfig,
        TrainingSupervisor,
        UnsupportedExperimentError,
    )

    from gan_deeplearning4j_tpu_torch.telemetry import device as _device
    from gan_deeplearning4j_tpu_torch.telemetry.registry import get_registry
    from gan_deeplearning4j_tpu_torch.telemetry.trace import TRACER, configure_from_env

    if args.telemetry or args.span_trace:
        TRACER.enable()
    else:
        configure_from_env()
    # SIGUSR2 → one bounded on-demand device capture; the supervisor's
    # SIGTERM preemption handler is untouched (different signal, different
    # contract)
    _device.install_signal_capture(
        args.trace_artifacts or _device.default_artifacts_dir())

    cfg = ExperimentConfig.from_json(args.config)
    with np.load(args.data) as npz:
        features, labels = npz["features"], npz["labels"]
    if not 0 <= args.mesh_worker < max(args.mesh_size, 1):
        raise SystemExit(f"--mesh-worker {args.mesh_worker} outside mesh "
                         f"of {args.mesh_size}")
    faults = None
    if args.fault_schedule:
        faults = FaultInjector(FaultSchedule.from_json(args.fault_schedule),
                               worker_id=args.mesh_worker)
    mesh = None
    store = None
    if args.mesh_size > 1:
        store = CheckpointStore(args.store, keep_last=args.keep_last,
                                keep_every=args.keep_every,
                                fault_injector=faults)
        mesh = MeshCoordinator(
            args.store, worker=args.mesh_worker, world_size=args.mesh_size,
            token=args.mesh_token, timeout_s=args.mesh_timeout,
            boot_timeout_s=args.mesh_boot_timeout, faults=faults,
        )
    sup = TrainingSupervisor(
        cfg,
        SupervisorConfig(
            total_steps=args.total_steps,
            publish_every=args.publish_every,
            max_retries=args.max_retries,
            backoff_base_s=args.backoff_base,
            backoff_max_s=args.backoff_max,
            keep_last=args.keep_last,
            keep_every=args.keep_every,
            serve_publish_every=args.serve_publish_every,
        ),
        features, labels,
        store=store,
        store_root=args.store,
        faults=faults,
        serve_store_root=args.serve_store,
        mesh=mesh,
    )
    sup.install_signal_handlers()

    def emit(summary: dict) -> None:
        # one definition for bench artifacts and live metrics: the summary
        # carries a registry snapshot, so the drill's BENCH record quotes
        # the same series a scraper would
        summary["telemetry"] = get_registry().snapshot()
        # where the steps ran, observed (a CUDA context exists only where
        # the card was used): the fleet and reload drills hold it to "gpu"
        import torch

        summary["platform"] = "gpu" if torch.cuda.is_initialized() else "cpu"
        text = json.dumps(summary, indent=2, default=str)
        if args.summary:
            with open(args.summary, "w") as fh:
                fh.write(text + "\n")
        print(text)
        if args.span_trace:
            TRACER.dump(args.span_trace,
                        {"source": "gan_deeplearning4j_tpu_torch.resilience"})

    # a SIGUSR2 capture still running must end before the process does
    try:
        try:
            summary = sup.run()
        except RetryBudgetExceeded as exc:
            emit({"status": "terminal", "error": str(exc),
                  "events": sup.events})
            return 70  # EX_SOFTWARE
        except MeshTimeout as exc:
            emit({"status": "mesh_abort", "error": str(exc),
                  "events": sup.events})
            return 76  # EX_PROTOCOL: relaunch the whole gang, fresh token
        except Exception as exc:
            if mesh is None or isinstance(exc, UnsupportedExperimentError):
                # single-writer faults are retried in-process by the
                # supervisor, and a terminal config error retries into the
                # same wall on any mesh — both deserve the loud traceback
                raise
            # mesh mode disables in-process retries (a retry would rejoin
            # barriers its peers are not at), so ANY worker fault surfaces
            # here; the remedy is the relauncher's — restart the whole gang
            # with a fresh token — which is exactly what 75 asks for
            emit({"status": "worker_fault",
                  "error": f"{type(exc).__name__}: {exc}",
                  "events": sup.events})
            return 75  # EX_TEMPFAIL
        emit(summary)
        return 0 if summary["status"] == "completed" else 75  # EX_TEMPFAIL
    finally:
        _device.join_signal_captures()


if __name__ == "__main__":
    sys.exit(main())
