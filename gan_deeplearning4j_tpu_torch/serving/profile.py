"""Where the serving path's time goes on the card:
``python -m gan_deeplearning4j_tpu_torch.serving.profile``.

Builds the full-width DCGAN-MNIST ``gen`` and transfer classifier ``cv``
with random weights from seed 666, serves them with ``ServingEngine`` on
``cuda:0``, and for each request kind at the ladder's smallest and largest
bucket traces 20 warm ``engine.run`` calls with ``torch.profiler``. Prints
one JSON line per (kind, bucket):

- ``wall_ms``: host time per run (staging, copies, forward, wait);
- ``kernel_ms`` / ``memcpy_ms``: device time per run, as the union of the
  kernel (resp. copy) intervals the profiler recorded;
- ``device_busy_share``: union of all device intervals over the wall time;
- ``kernels_per_run`` and the ``top`` kernels by device time;
- ``bound_ms``: the least time the card could take for the forward pass,
  the larger of its fp32 operations (convolutions and GEMMs, from the
  graph's shapes, up to the served vertex) over 67 TFLOP/s and its bytes
  (params, input and output rows, each once) over 3.35 TB/s — the H100
  SXM data-sheet peaks, fp32 outside the tensor cores since TF32 is off;
  ``roofline_share`` is ``bound_ms / kernel_ms``.

Each line carries the card's name and power limit from ``nvidia-smi``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from collections import defaultdict

import numpy as np
import torch

RUNS = 20
FP32_FLOP_PER_S = 67e12
HBM_BYTE_PER_S = 3.35e12


def _union_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def _bound(graph, bucket: int, last: str):
    """(flops, bytes, bound_ms, bound_by) of one forward pass of ``bucket``
    rows through ``graph`` up to vertex ``last``."""
    from gan_deeplearning4j_tpu_torch.nn.layers import ConvolutionLayer, DenseLayer

    shapes = graph.param_shapes()
    flops, nbytes = 0, 4 * bucket * graph.input_types[0].features
    for v in graph.vertices:
        nbytes += sum(4 * int(np.prod(s)) for s in shapes.get(v.name, {}).values())
        if isinstance(v.layer, ConvolutionLayer):
            h, w, c = v.out_type.shape
            kh, kw, cin, _ = shapes[v.name]["W"]
            flops += 2 * bucket * h * w * c * kh * kw * cin
        elif isinstance(v.layer, DenseLayer):
            n_in, n_out = shapes[v.name]["W"]
            flops += 2 * bucket * n_in * n_out
        if v.name == last:
            nbytes += 4 * bucket * v.out_type.features
            break
    t_ops, t_bytes = flops / FP32_FLOP_PER_S, nbytes / HBM_BYTE_PER_S
    return flops, nbytes, max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def main() -> int:
    from gan_deeplearning4j_tpu_torch.models import dcgan_mnist
    from gan_deeplearning4j_tpu_torch.serving import ServingEngine

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    gen = dcgan_mnist.build_generator()
    dis = dcgan_mnist.build_discriminator()
    cv, cv_params = dcgan_mnist.build_transfer_classifier(dis, dis.init(seed=666, device="cpu"))
    engine = ServingEngine(
        {"generator": (gen, gen.init(seed=666, device="cpu")), "classifier": (cv, cv_params)},
        feature_vertex="dis_dense_layer_6", device="cuda",
    )
    engine.warmup()
    rng = np.random.default_rng(666)
    served = {"sample": (gen, gen.output_names[0]), "classify": (cv, cv.output_names[0]),
              "features": (cv, "dis_dense_layer_6")}
    activities = [torch.profiler.ProfilerActivity.CUDA]
    for kind in engine.kinds:
        for bucket in (engine.buckets[0], engine.buckets[-1]):
            rows = rng.random((bucket, engine.input_width(kind)), dtype=np.float32)
            for _ in range(5):
                engine.run(kind, rows)
            torch.cuda.synchronize()
            with torch.profiler.profile(activities=activities) as prof:
                t0 = time.perf_counter()
                for _ in range(RUNS):
                    engine.run(kind, rows)
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6
            kernels, copies, by_name = [], [], defaultdict(float)
            for ev in prof.events():
                if ev.device_type != torch.autograd.DeviceType.CUDA:
                    continue
                span = (ev.time_range.start, ev.time_range.end)
                if ev.name.startswith("Memcpy") or ev.name.startswith("Memset"):
                    copies.append(span)
                else:
                    kernels.append(span)
                    by_name[ev.name] += span[1] - span[0]
            top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
            flops, nbytes, bound_ms, bound_by = _bound(served[kind][0], bucket, served[kind][1])
            kernel_ms = _union_us(kernels) / RUNS / 1e3
            print(json.dumps({
                "kind": kind, "bucket": bucket, "runs": RUNS,
                "wall_ms": wall_us / RUNS / 1e3,
                "kernel_ms": kernel_ms,
                "memcpy_ms": _union_us(copies) / RUNS / 1e3,
                "device_busy_share": _union_us(kernels + copies) / wall_us,
                "kernels_per_run": len(kernels) / RUNS,
                "flops": flops, "bytes": nbytes, "bound_ms": bound_ms, "bound_by": bound_by,
                "roofline_share": bound_ms / kernel_ms,
                "top": [{"name": n[:80], "ms_per_run": us / RUNS / 1e3} for n, us in top],
                "card": card,
            }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
