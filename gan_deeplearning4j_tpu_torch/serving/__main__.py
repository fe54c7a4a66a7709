"""Server CLI — ``python -m gan_deeplearning4j_tpu_torch.serving [flags]``.

Loads a serving bundle (``serving.json``) or explicit checkpoint zips and
serves the HTTP JSON API until interrupted, on the card by default::

    python -m gan_deeplearning4j_tpu_torch.serving --bundle output/serving
    python -m gan_deeplearning4j_tpu_torch.serving \\
        --generator output/mnist_gen_model.zip \\
        --classifier output/mnist_CV_model.zip \\
        --feature-vertex dis_dense_layer_6 --port 8000 --device cuda
"""

from __future__ import annotations

import argparse
import logging
import sys

from gan_deeplearning4j_tpu_torch.serving.engine import DEFAULT_BUCKETS, ServingEngine
from gan_deeplearning4j_tpu_torch.serving.service import InferenceService, serve_forever


def _parse_buckets(text: str):
    try:
        return tuple(int(b) for b in text.split(",") if b.strip())
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"buckets must be comma-separated ints, got {text!r}"
        )


def main(argv=None) -> int:
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
    p.add_argument("--warmup", choices=("eager", "sync", "off"), default="eager",
                   help="'eager' runs every (kind, bucket) once on a background "
                        "thread (serve immediately, /healthz reports "
                        "'warming'); 'sync' blocks startup until warm; 'off' "
                        "leaves each first run to the first request")
    p.add_argument("--device", default="cuda",
                   help="torch device to serve on (default: cuda; there is no "
                        "fallback to the CPU)")
    args = p.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    if args.bundle is not None:
        engine = ServingEngine.from_bundle(args.bundle, buckets=args.buckets, device=args.device)
    elif args.generator or args.classifier:
        engine = ServingEngine.from_checkpoints(
            generator=args.generator,
            classifier=args.classifier,
            buckets=args.buckets,
            feature_vertex=args.feature_vertex,
            device=args.device,
        )
    else:
        p.error("need --bundle or --generator/--classifier")
        return 2  # unreachable; argparse exits
    service = InferenceService(
        engine,
        max_latency=args.max_latency,
        max_queue=args.max_queue,
        default_timeout=args.timeout,
        warmup={"eager": "eager", "sync": "sync", "off": False}[args.warmup],
    )
    serve_forever(service, args.host, args.port)
    return 0


if __name__ == "__main__":
    sys.exit(main())
