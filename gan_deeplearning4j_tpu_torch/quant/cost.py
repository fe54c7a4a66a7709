"""Measured variant cost — counterpart of
``gan_deeplearning4j_tpu/quant/cost.py``, with the same keys and
``cost_schema`` 1, so a block written by either package reads in the other.

A variant's cost is measured on a built engine's own bucket ladder:

- **per-bucket request latency**: ``engine.run`` timed per (kind, bucket),
  the minimum of ``rounds`` (the run least disturbed by the host); on the
  card ``run`` returns after the device's result is on the host, so the
  wall time covers the device work;
- **resident param bytes**: ``engine.resident_param_bytes()`` (bf16 halves
  them, int8 ``W_q`` count one byte);
- **staged width**: the input width per kind, and the pinned staging bytes
  of a top-bucket flush.

The scalar a mux ranks variants by is a residency rent,
``resident GiB × serve-seconds per kilorow``. ``write_cost_block`` folds
the block into the bundle's ``serving.json`` (atomic rewrite).
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Sequence

import numpy as np

from gan_deeplearning4j_tpu_torch.quant.variants import (
    read_bundle_manifest,
    write_bundle_manifest,
)

#: cost block schema version (manifest ``cost.cost_schema``)
COST_SCHEMA = 1

#: timing rounds per (kind, bucket): min-of-rounds noise floor
DEFAULT_ROUNDS = 5


def _scalar(resident_bytes: int, per_row_s: float) -> float:
    """GiB·seconds of device residency per kilorow served."""
    return (resident_bytes / 2**30) * per_row_s * 1000.0


def measure_engine_cost(engine, *, rounds: int = DEFAULT_ROUNDS,
                        kinds: Optional[Sequence[str]] = None) -> dict:
    """Profile a built engine on its own ladder (warmed first, so no first
    run is timed). Returns the manifest ``cost`` block."""
    if not engine.warmed:
        engine.warmup()
    kinds = list(kinds or engine.kinds)
    if not kinds:
        raise ValueError("engine serves no request kinds to measure")
    per_bucket: Dict[str, Dict[str, float]] = {}
    staged_widths: Dict[str, int] = {}
    for kind in kinds:
        width = engine.input_width(kind)
        staged_widths[kind] = width
        timings: Dict[str, float] = {}
        for bucket in engine.buckets:
            rows = np.zeros((bucket, width), np.float32)
            best = float("inf")
            for _ in range(max(1, rounds)):
                t0 = time.perf_counter()
                engine.run(kind, rows)
                best = min(best, time.perf_counter() - t0)
            timings[str(bucket)] = best
        per_bucket[kind] = timings
    top = max(engine.buckets)
    per_row_s = (sum(per_bucket[k][str(top)] for k in kinds) / len(kinds)) / top
    resident = engine.resident_param_bytes()
    return {
        "cost_schema": COST_SCHEMA,
        "scalar": _scalar(resident, per_row_s),
        "scalar_unit": "GiB*s_per_kilorow",
        "per_row_s": per_row_s,
        "per_bucket_s": per_bucket,
        "resident_param_bytes": resident,
        "staged_widths": staged_widths,
        "staged_bytes_top_bucket": {k: top * w * 4 for k, w in staged_widths.items()},
        "buckets": list(engine.buckets),
        "replicas": engine.replica_count,
        "precision": getattr(engine, "precision", None) or "fp32",
        "platform": engine.platform,
        "rounds": int(rounds),
        "measured_unix": time.time(),
    }


def write_cost_block(bundle_dir: str, block: dict) -> dict:
    """Fold a measured cost block into the bundle's ``serving.json``
    (atomic rewrite). Returns the updated manifest."""
    manifest = read_bundle_manifest(bundle_dir)
    manifest["cost"] = block
    write_bundle_manifest(bundle_dir, manifest)
    return manifest


def measure_bundle_cost(bundle_dir: str, *, buckets=None, replicas: int = 1,
                        rounds: int = DEFAULT_ROUNDS, write: bool = True,
                        device=None, devices=None) -> dict:
    """Build the bundle's engine off to the side (no generation gauge
    claim) on ``device`` (the card unless the caller asks for the CPU) or
    the first ``replicas`` of an explicit ``devices`` pool,
    measure it and, by default, write the ``cost`` block into its
    manifest. ``buckets=None`` takes the bundle's learned ladder when its
    manifest has one."""
    from gan_deeplearning4j_tpu_torch.serving.engine import ServingEngine

    engine = ServingEngine.from_bundle(bundle_dir, buckets=buckets, replicas=replicas,
                                       device=device, devices=devices, export_gauge=False)
    block = measure_engine_cost(engine, rounds=rounds)
    if write:
        write_cost_block(bundle_dir, block)
    return block


def manifest_cost(bundle_dir: str) -> Optional[dict]:
    """The bundle's measured cost block, or None when its manifest has none
    or cannot be read (a missing measurement is a bootstrap case, never an
    error)."""
    try:
        manifest = read_bundle_manifest(bundle_dir)
    except (OSError, ValueError):
        return None
    block = manifest.get("cost")
    if (isinstance(block, dict) and isinstance(block.get("scalar"), (int, float))
            and block["scalar"] > 0):
        return block
    return None


__all__ = [
    "COST_SCHEMA",
    "measure_engine_cost",
    "measure_bundle_cost",
    "write_cost_block",
    "manifest_cost",
]
