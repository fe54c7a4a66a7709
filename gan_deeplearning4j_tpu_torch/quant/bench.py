"""quant bench — paired fp32 / bf16 / int8 serving economics, measured;
the port's ``scripts/quant_bench.py``, with the same JSON keys.

In one process, against one freshly published bundle:

1. **publish**: a seeded full-width DCGAN-MNIST experiment publishes its
   fp32 serving bundle (generator and transfer classifier);
2. **build**: ``quant/variants.py`` derives the bf16 and int8 siblings
   (the same calibration seed every run);
3. **measure**: each variant's engine is profiled on the same ladder
   (``quant/cost.py``) and the blocks land in each bundle's manifest;
4. **A/B**: paired alternating-round latency at the top bucket, fp32
   against each variant per request kind;
5. **drift and canary**: the largest output deviation per kind on fixed
   seeded rows, then the canary gate evaluates each variant against the
   fp32 incumbent on labelled synthetic rows.

Usage::

    python -m gan_deeplearning4j_tpu_torch.quant.bench            # on the card
    python -m gan_deeplearning4j_tpu_torch.quant.bench --cpu --smoke
    python -m gan_deeplearning4j_tpu_torch.quant.bench --record r01

It prints the results as JSON and exits 1 when an invariant fails. It
writes a file only where asked: ``--output PATH``, and ``--record TAG``
(``BENCH_torch_quant_<TAG>.json`` at the repo root).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _publish_fp32(workdir: str, seed: int, use_accelerator: bool) -> str:
    from gan_deeplearning4j_tpu_torch.harness import ExperimentConfig, GanExperiment

    cfg = ExperimentConfig(
        batch_size_train=8, batch_size_pred=8, num_iterations=1, latent_grid=2,
        save_models=False, seed=seed, output_dir=os.path.join(workdir, "train_out"),
        use_accelerator=use_accelerator,
    )
    bundle = os.path.join(workdir, "fp32")
    GanExperiment(cfg).publish_for_serving(bundle)
    return bundle


def _paired_ab(base, other, *, rounds: int) -> dict:
    """Alternating-round min latency per kind at the top bucket: the
    variant's share of the fp32 time (< 1 means faster)."""
    out = {}
    top = max(base.buckets)
    for kind in base.kinds:
        rows = np.zeros((top, base.input_width(kind)), np.float32)
        best_base = best_other = float("inf")
        for _ in range(max(1, rounds)):
            t0 = time.perf_counter()
            base.run(kind, rows)
            best_base = min(best_base, time.perf_counter() - t0)
            t0 = time.perf_counter()
            other.run(kind, rows)
            best_other = min(best_other, time.perf_counter() - t0)
        out[kind] = {"fp32_s": best_base, "variant_s": best_other,
                     "ratio": best_other / best_base if best_base > 0 else None}
    return out


def _output_drift(base, other, *, seed: int) -> dict:
    out = {}
    for kind in base.kinds:
        rows = np.random.default_rng(seed).random((8, base.input_width(kind))).astype(np.float32)
        a = np.asarray(base.run(kind, rows), np.float32)
        b = np.asarray(other.run(kind, rows), np.float32)
        out[kind] = float(np.max(np.abs(a - b)))
    return out


def run_bench(args) -> dict:
    from gan_deeplearning4j_tpu_torch.data import synthetic_mnist
    from gan_deeplearning4j_tpu_torch.deploy import CanaryGate
    from gan_deeplearning4j_tpu_torch.quant import (
        build_bf16_variant,
        build_int8_variant,
        measure_engine_cost,
        write_cost_block,
    )
    from gan_deeplearning4j_tpu_torch.serving import ServingEngine

    device = "cpu" if args.cpu else None
    workdir = tempfile.mkdtemp(prefix="quant_bench_")
    try:
        t0 = time.time()
        fp32_dir = _publish_fp32(workdir, args.seed, use_accelerator=not args.cpu)
        dirs = {"fp32": fp32_dir, "bf16": os.path.join(workdir, "bf16"),
                "int8": os.path.join(workdir, "int8")}
        build_bf16_variant(fp32_dir, dirs["bf16"])
        build_int8_variant(fp32_dir, dirs["int8"], device=device)

        engines, costs = {}, {}
        for name, d in dirs.items():
            engine = ServingEngine.from_bundle(d, buckets=args.buckets, device=device,
                                               export_gauge=False)
            engine.warmup()
            engines[name] = engine
            block = measure_engine_cost(engine, rounds=args.rounds)
            write_cost_block(d, block)
            costs[name] = block

        fp32 = engines["fp32"]
        variants = {}
        for name in ("bf16", "int8"):
            block = costs[name]
            variants[name] = {
                "resident_param_bytes": block["resident_param_bytes"],
                "bytes_ratio": block["resident_param_bytes"] / costs["fp32"]["resident_param_bytes"],
                "cost_scalar": block["scalar"],
                "cost_ratio": block["scalar"] / costs["fp32"]["scalar"],
                "ab_latency": _paired_ab(fp32, engines[name], rounds=args.rounds),
                "output_drift": _output_drift(fp32, engines[name], seed=args.seed),
            }

        (rows, labels), _ = synthetic_mnist(num_train=args.canary_rows, num_test=1, seed=args.seed)
        gate = CanaryGate(rows, labels, num_samples=args.canary_samples, seed=args.seed)
        canary = {}
        for name in ("bf16", "int8"):
            decision = gate.evaluate(engines[name], fp32)
            canary[name] = {"passed": decision.passed, "reason": decision.reason,
                            "candidate": decision.candidate, "incumbent": decision.incumbent}
            gate._incumbent_cache = None  # the next variant gates against fp32 too
        failures = sum(1 for c in canary.values() if not c["passed"])

        results = {
            "fp32": {"resident_param_bytes": costs["fp32"]["resident_param_bytes"],
                     "cost_scalar": costs["fp32"]["scalar"],
                     "per_row_s": costs["fp32"]["per_row_s"]},
            "bf16": variants["bf16"],
            "int8": variants["int8"],
            "canary": canary,
            "canary_failures": failures,
            "wall_s": time.time() - t0,
        }
        invariants = {
            "bf16_bytes_halved": variants["bf16"]["bytes_ratio"] <= 0.6,
            "int8_bytes_shrunk": variants["int8"]["bytes_ratio"] < 1.0,
            # the bytes factor halves exactly, dwarfing latency noise; int8's
            # scalar is recorded, not gated (the measurement decides)
            "bf16_cost_cheaper": variants["bf16"]["cost_ratio"] < 1.0,
            "canary_admits_both": failures == 0,
        }
        config = {"rounds": args.rounds, "buckets": list(args.buckets), "seed": args.seed,
                  "smoke": bool(args.smoke), "platform": fp32.platform}
        if fp32.platform == "gpu":
            import torch

            config["device_name"] = torch.cuda.get_device_name(fp32.device)
        return {"bench": "quant", "config": config, "results": results,
                "invariants": invariants, "ok": all(invariants.values())}
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rounds", type=int, default=5,
                   help="timing rounds per (kind, bucket), min-of-rounds")
    p.add_argument("--buckets", default="1,8,32",
                   type=lambda s: tuple(int(b) for b in s.split(",")))
    p.add_argument("--canary-rows", type=int, default=64)
    p.add_argument("--canary-samples", type=int, default=32)
    p.add_argument("--seed", type=int, default=666)
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    p.add_argument("--smoke", action="store_true", help="small fixed shape, for a quick check")
    p.add_argument("--record", default=None, metavar="TAG",
                   help="also write BENCH_torch_quant_<TAG>.json at the repo root")
    p.add_argument("--output", default=None, help="also write the summary to this file")
    args = p.parse_args(argv)

    if args.smoke:
        args.rounds = min(args.rounds, 2)
        args.buckets = (1, 8)
        args.canary_rows = min(args.canary_rows, 48)
        args.canary_samples = min(args.canary_samples, 16)

    summary = run_bench(args)
    paths = [args.output] if args.output else []
    if args.record:
        paths.append(os.path.join(_REPO, f"BENCH_torch_quant_{args.record}.json"))
    for path in paths:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as fh:
            json.dump(summary, fh, indent=2)
            fh.write("\n")
    sys.stdout.write(json.dumps(summary["results"], indent=2) + "\n")
    bad = [k for k, v in summary["invariants"].items() if not v]
    if bad:
        sys.stderr.write(f"quant bench: invariants violated: {bad}\n")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
