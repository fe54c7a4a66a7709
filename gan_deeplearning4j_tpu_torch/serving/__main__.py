"""Server CLI — ``python -m gan_deeplearning4j_tpu_torch.serving [flags]``.

Loads a serving bundle (``serving.json``), explicit checkpoint zips, or the
first valid serving generation of a checkpoint store, and serves the HTTP
JSON API until interrupted, on the card by default::

    python -m gan_deeplearning4j_tpu_torch.serving --bundle output/serving
    python -m gan_deeplearning4j_tpu_torch.serving \\
        --generator output/mnist_gen_model.zip \\
        --classifier output/mnist_CV_model.zip \\
        --feature-vertex dis_dense_layer_6 --port 8000 --device cuda
    python -m gan_deeplearning4j_tpu_torch.serving --reload-store store \\
        --canary-data canary.npz

The flags are the JAX server's (``gan_deeplearning4j_tpu/serving/
__main__.py``) but ``--compilation-cache`` (a capture is not cached across
processes), plus ``--device``. ``--replicas`` takes an int or ``all`` (every
card, the default), as the JAX CLI's does; a count above the host's cards
fails at engine construction with the JAX engine's message.

Once the engine is warm the server logs one line, ``boot stamps {...}``:
the wall-clock times (Unix seconds) at which the process started, entered
``main`` (the interpreter and ``import torch`` behind it), held its CUDA
context, had loaded the bundle and had captured every (kind, bucket), and
the card's reserved bytes then. The fleet drill splits a worker's boot
from them.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys
import threading
import time

from gan_deeplearning4j_tpu_torch.serving.engine import DEFAULT_BUCKETS, ServingEngine
from gan_deeplearning4j_tpu_torch.serving.service import InferenceService, serve_forever


def _parse_buckets(text: str):
    try:
        return tuple(int(b) for b in text.split(",") if b.strip())
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"buckets must be comma-separated ints, got {text!r}"
        )


def _parse_replicas(text: str):
    if text == "all":
        return "all"
    try:
        return int(text)
    except ValueError:
        raise argparse.ArgumentTypeError(f"--replicas takes 'all' or an int, got {text!r}")


#: the log line a warm server writes its boot stamps on
BOOT_STAMPS = "boot stamps "


def _process_start_unix():
    """When this process started, in Unix seconds (Linux ``/proc``, to the
    clock tick), or None where that cannot be read."""
    try:
        with open("/proc/self/stat") as fh:
            # the command name may hold spaces: fields count from its ")"
            fields = fh.read().rsplit(")", 1)[1].split()
        with open("/proc/stat") as fh:
            btime = next(int(line.split()[1]) for line in fh if line.startswith("btime"))
        return btime + int(fields[19]) / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return None


def _log_boot_stamps(log, engine, stamps: dict) -> None:
    """Wait for the engine's warmup, then log the boot stamps line."""
    import torch

    try:
        engine.wait_warm()
    except RuntimeError:
        pass  # the warmup's failure is /healthz's "error"; the stamps say so
    stamps["warm"] = time.time()
    stamps["warmed"] = bool(engine.warmed)
    stamps["platform"] = engine.platform
    stamps["reserved_bytes"] = (torch.cuda.memory_reserved(engine.device)
                                if engine.device.type == "cuda" else 0)
    log.info("%s%s", BOOT_STAMPS, json.dumps(stamps))


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="gan_deeplearning4j_tpu_torch.serving",
        description="Batched inference server for the trained GAN artifacts (PyTorch)",
    )
    p.add_argument("--bundle", default=None,
                   help="serving bundle directory (contains serving.json)")
    p.add_argument("--generator", default=None, help="generator checkpoint zip")
    p.add_argument("--classifier", default=None, help="classifier checkpoint zip")
    p.add_argument("--feature-vertex", default=None,
                   help="classifier vertex served by /v1/features")
    p.add_argument("--buckets", type=_parse_buckets, default=DEFAULT_BUCKETS,
                   help="padded batch ladder, e.g. 1,8,32,128")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max-latency", type=float, default=0.005,
                   help="micro-batch trigger: max seconds a request waits "
                        "for batch-mates")
    p.add_argument("--max-queue", type=int, default=256,
                   help="bound on queued requests before shedding")
    p.add_argument("--timeout", type=float, default=5.0,
                   help="default per-request deadline (seconds)")
    p.add_argument("--replicas", type=_parse_replicas, default="all",
                   help="devices to route batches across: an int, or 'all' "
                        "for every card (default)")
    p.add_argument("--pipeline-depth", type=int, default=None,
                   help="bound on dispatched-but-unfinished flushes "
                        "(default: 2 per replica on the card, 1 on the CPU)")
    p.add_argument("--warmup", choices=("eager", "sync", "off"), default="eager",
                   help="'eager' captures every (kind, bucket) on a background "
                        "thread (serve immediately, /healthz reports "
                        "'warming'); 'sync' blocks startup until warm; 'off' "
                        "leaves each capture to the first request")
    p.add_argument("--device", default="cuda",
                   help="torch device to serve on (default: cuda; there is no "
                        "fallback to the CPU)")
    p.add_argument("--reload-store", default=None, metavar="DIR",
                   help="zero-downtime reload plane: watch this checkpoint-"
                        "store root for newer digest-valid serving "
                        "generations and swap them in live; without "
                        "--bundle/--generator the FIRST valid generation "
                        "there is the initial model")
    p.add_argument("--reload-poll", type=float, default=2.0,
                   help="reload-plane poll interval in seconds")
    p.add_argument("--reload-wait", type=float, default=120.0,
                   help="with --reload-store and no --bundle: seconds to "
                        "wait for the first valid serving generation")
    p.add_argument("--canary-data", default=None, metavar="NPZ",
                   help="npz with 'features' (and optionally 'labels') "
                        "arrays for the reload canary gate; omitted = no "
                        "quality gate (digest verification still applies)")
    p.add_argument("--canary-samples", type=int, default=256,
                   help="seeded probe batch size for the canary gate")
    p.add_argument("--canary-feature", choices=("raw", "dis_features"), default="raw",
                   help="FID feature space for the canary probes: 'raw' "
                        "compares raw sample rows; 'dis_features' embeds "
                        "both sides in the discriminator-feature space of "
                        "the BOOT bundle's classifier at its feature vertex")
    p.add_argument("--canary-fid-ratio", type=float, default=1.5,
                   help="reject a candidate whose probe FID exceeds "
                        "incumbent × ratio + slack")
    p.add_argument("--canary-fid-slack", type=float, default=10.0,
                   help="additive FID slack")
    p.add_argument("--canary-acc-drop", type=float, default=0.05,
                   help="reject a candidate whose classifier accuracy "
                        "drops more than this below the incumbent")
    p.add_argument("--telemetry", action="store_true",
                   help="enable span tracing (GET /debug/spans exports a "
                        "Chrome trace; also honored via GDT_TELEMETRY=trace); "
                        "metrics are always on")
    p.add_argument("--debug-artifacts", default=None, metavar="DIR",
                   help="where POST /debug/trace dumps torch.profiler "
                        "captures (default: $GDT_TRACE_DIR or "
                        "./artifacts/device_traces)")
    return p


def _canary(args, canary_bundle, canary_classifier, p):
    """The reload plane's quality gate from the ``--canary-*`` flags, or
    None without ``--canary-data``."""
    import numpy as np

    from gan_deeplearning4j_tpu_torch.deploy import (
        CanaryGate,
        CanaryThresholds,
        classifier_from_bundle,
        feature_fn_from_checkpoint,
    )

    if not args.canary_data:
        return None
    feature_fn = None
    if args.canary_feature == "dis_features":
        if canary_classifier is None and canary_bundle is not None:
            canary_classifier = classifier_from_bundle(canary_bundle)
        if canary_classifier is None:
            p.error("--canary-feature dis_features needs a boot bundle (or "
                    "--classifier/--feature-vertex) serving a dis-feature vertex")
        feature_fn = feature_fn_from_checkpoint(*canary_classifier, device=args.device)
    with np.load(args.canary_data) as npz:
        features = npz["features"]
        labels = npz["labels"] if "labels" in npz.files else None
    return CanaryGate(
        features, labels,
        num_samples=min(args.canary_samples, features.shape[0]),
        feature_fn=feature_fn,
        thresholds=CanaryThresholds(
            fid_ratio_max=args.canary_fid_ratio,
            fid_slack=args.canary_fid_slack,
            accuracy_drop_max=args.canary_acc_drop,
        ),
    )


def main(argv=None) -> int:
    stamps = {"process_start": _process_start_unix(), "main": time.time()}
    p = _build_parser()
    args = p.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    log = logging.getLogger(__name__)
    if args.device.startswith("cuda"):
        import torch

        # the context first and alone, so that the boot stamps time it; a
        # process without the card raises here (no fallback to the CPU)
        torch.empty(1, device=args.device)
        torch.cuda.synchronize(args.device)
    stamps["cuda_context"] = time.time()
    from gan_deeplearning4j_tpu_torch.telemetry.trace import TRACER, configure_from_env

    if args.telemetry:
        TRACER.enable()
    else:
        configure_from_env()
    watcher = None
    if args.reload_store is not None:
        from gan_deeplearning4j_tpu_torch.deploy import StoreWatcher
        from gan_deeplearning4j_tpu_torch.resilience import CheckpointStore

        watcher = StoreWatcher(store=CheckpointStore(args.reload_store))
    canary_bundle = None  # bundle dir a dis-feature classifier resolves from
    canary_classifier = None  # (checkpoint, vertex) for dis-feature probes
    if args.bundle is not None:
        engine = ServingEngine.from_bundle(args.bundle, buckets=args.buckets,
                                           replicas=args.replicas, device=args.device)
        canary_bundle = args.bundle
    elif args.generator or args.classifier:
        engine = ServingEngine.from_checkpoints(
            generator=args.generator,
            classifier=args.classifier,
            buckets=args.buckets,
            feature_vertex=args.feature_vertex,
            replicas=args.replicas,
            device=args.device,
        )
        if args.classifier and args.feature_vertex:
            canary_classifier = (args.classifier, args.feature_vertex)
    elif watcher is not None:
        # the first valid serving generation of the store is the initial
        # model (a trainer may still be on its way to its first publish)
        deadline = time.monotonic() + args.reload_wait
        candidate = watcher.poll_once()
        while candidate is None:
            if time.monotonic() >= deadline:
                log.error("no valid serving generation appeared in %s within %.0fs",
                          args.reload_store, args.reload_wait)
                return 1
            time.sleep(0.5)
            candidate = watcher.poll_once()
        log.info("initial bundle: generation %s (%s)", candidate.generation, candidate.path)
        engine = ServingEngine.from_bundle(candidate.path, buckets=args.buckets,
                                           replicas=args.replicas, device=args.device)
        canary_bundle = candidate.path
    else:
        p.error("need --bundle, --generator/--classifier, or --reload-store")
        return 2  # unreachable; argparse exits
    stamps["bundle_loaded"] = time.time()
    service = InferenceService(
        engine,
        max_latency=args.max_latency,
        max_queue=args.max_queue,
        default_timeout=args.timeout,
        warmup={"eager": "eager", "sync": "sync", "off": False}[args.warmup],
        pipeline_depth=args.pipeline_depth,
        artifacts_dir=args.debug_artifacts,
    )
    threading.Thread(target=_log_boot_stamps, args=(log, engine, stamps),
                     name="boot-stamps", daemon=True).start()
    controller = None
    if watcher is not None:
        from gan_deeplearning4j_tpu_torch.deploy import ReloadController

        controller = ReloadController(
            service, watcher, canary=_canary(args, canary_bundle, canary_classifier, p),
            poll_interval=args.reload_poll,
        )
        service.attach_reloader(controller)
        controller.start()
    try:
        serve_forever(service, args.host, args.port)
    finally:
        if controller is not None:
            controller.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
