"""mfu — the MFU ceiling, measured; the port's ``scripts/mfu_ceiling.py``::

    python -m gan_deeplearning4j_tpu_torch.harness.mfu                 # on the card
    python -m gan_deeplearning4j_tpu_torch.harness.mfu --cpu --gemm-n 64 --batches 8

The bench reports the achieved MFU of the full alternating iteration
(optimizer steps, weight syncs, BatchNorm state, loss plumbing included).
This measures how much of the gap is the iteration's bookkeeping and how
much the model's shapes, at three tiers on one device:

1. ``gemm``: a chain of ``SCAN_K`` square bf16 products, ``tanh(carry @ b)
   * scale + a * eps`` at n × n, the card's friendliest shape; it pins the
   bf16 peak the MFU denominators take. ``gemm_fp32`` is the same chain in
   fp32 under ``runtime/device.py::pin_fp32_precision`` (TF32 off), the
   precision the training iteration runs in on the card;
2. ``bare``: config 1's compute core (the sampler forward, the
   discriminator's gradients on real rows (soft 1) and on fakes (soft 0),
   the gan gradient, a nudge to ``gen``, the classifier's gradient) at
   each ``--batches`` entry, each gradient followed by a 1e-12
   pseudo-update in place, with no optimizer state, no rebinds and no
   BatchNorm running-stat carry. On the card one step is captured as a
   CUDA graph (``runtime/capture.py::capture_guard``) whose z draws come
   from the CUDA generator inside the graph, and a timed call is
   ``SCAN_K`` replays;
3. ``achieved``: the captured full iteration
   (``GanExperiment.train_iteration``) at b64 and b256, timed in this
   process by ``harness/profile.py::sweep_row``.

Every timed call is fenced by a value read of that call's own output
(:func:`_timed_calls`). It runs on ``cuda:0`` unless given ``--cpu``;
without a card it exits 2 and builds nothing. It prints each tier's row
and then the report as JSON, and writes a file only where asked:
``--out PATH``, or ``--record TAG`` (``BENCH_torch_mfu_<TAG>.json`` at
the repo root).

What differs from the JAX script, and why:

- the fp32 peak. The iteration runs in fp32 with TF32 off
  (``harness/experiment.py::experiment_device``), so its products run
  outside the tensor cores, and the bf16 peak is the wrong denominator for
  them; the JAX script divides by one peak because a TPU runs its
  default-precision fp32 products as bf16 passes. ``PEAK_FLOPS_BY_KIND``
  holds both peaks per card: ``gemm`` divides by the bf16 one,
  ``gemm_fp32``, ``bare`` and ``achieved`` by the fp32 one. Added keys:
  the ``gemm_fp32`` tier; ``peak_flops_fp32_assumed`` beside
  ``peak_flops_assumed`` (the bf16 peak, its JAX meaning); ``peak_flops``
  in each gemm and bare row (the peak it divides by); ``achieved_iteration``
  (the ``sweep_row`` behind each ``achieved`` value, with its ``mfu``);
- ``flops_per_iter`` of ``bare`` is ``FlopCounterMode``'s count over one
  eager step: matrix products and convolutions only. XLA's cost analysis,
  the JAX script's, also counts the elementwise work;
- ``achieved`` is measured here. The JAX script reads it from
  ``artifacts/benchmarks.json``, the JAX bench's own record; a batch not
  in ``--batches`` gives null (``"1"`` is b64, ``"1b"`` b256);
- ``--out`` has no default (the JAX script writes
  ``artifacts/mfu_ceiling.json`` on every run); ``--record`` is added;
- ``platform`` is ``gpu`` or ``cpu``, ``device_kind`` the card's name
  (``torch.cuda.get_device_name``); a card missing from the table gives
  null peaks and null MFU keys, as the JAX script's ``_peak_flops`` does.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch

from gan_deeplearning4j_tpu_torch.harness.profile import _device_kind, _flops, sweep_row

#: products chained per gemm call and bare steps per bare call (the bench's
#: device-loop window)
SCAN_K = 128
#: seconds of timed calls per tier, and the most calls
GEMM_MIN_S, BARE_MIN_S, MAX_CALLS = 2.0, 3.0, 50
#: calls in ``sweep_row``'s long window for ``achieved``
ACHIEVED_ITERS = 40
#: ``achieved``'s keys: the JAX bench's config names for MNIST b64 and b256
ACHIEVED_CONFIGS = {"1": 64, "1b": 256}

#: per card, matched on a lower-cased substring of ``torch.cuda.get_device_name``
#: in this order: dense bf16 tensor-core FLOP/s and fp32 FLOP/s outside the
#: tensor cores. Source: NVIDIA's H100 Tensor Core GPU data sheet, whose
#: tensor-core rows are with sparsity (the dense rate is half): SXM bf16
#: 1,979 / 2, fp32 67 TFLOP/s; PCIe 1,513 / 2, 51; NVL 1,671 / 2, 60 (per card)
PEAK_FLOPS_BY_KIND = [
    ("h100 nvl", {"bf16": 835.5e12, "fp32": 60e12}),
    ("h100 pcie", {"bf16": 756.5e12, "fp32": 51e12}),
    ("h100 80gb hbm3", {"bf16": 989e12, "fp32": 67e12}),
    ("h100 sxm", {"bf16": 989e12, "fp32": 67e12}),
]


def _peak_flops(device_kind: str) -> Optional[Dict[str, float]]:
    """``{"bf16": ..., "fp32": ...}`` FLOP/s of the card named
    ``device_kind``; None for a card (or the CPU) not in the table."""
    kind = (device_kind or "").lower()
    for key, peaks in PEAK_FLOPS_BY_KIND:
        if key in kind:
            return peaks
    return None


def _timed_calls(fn, sync, *, min_s: float = 3.0, max_calls: int = MAX_CALLS) -> float:
    """Median seconds per call over enough calls to cover ``min_s``.

    ``sync`` receives each timed call's own return value and reads a value
    of it on the host, so the clock stops when that call's work is done;
    fencing on an output bound before the loop would time the launches."""
    sync(fn())  # warm: the first call captures or builds
    times = []
    while sum(times) < min_s and len(times) < max_calls:
        t0 = time.perf_counter()
        sync(fn())
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def _read_first(out: torch.Tensor) -> float:
    return float(out.reshape(-1)[0])


# -- gemm ---------------------------------------------------------------------
def bench_gemm(n: int, dtype: torch.dtype, peak: Optional[float], device: torch.device) -> dict:
    """``SCAN_K`` chained n × n products in ``dtype``; ``frac_of_peak``
    against ``peak`` FLOP/s."""
    g = [np.random.default_rng(s).standard_normal((n, n)) for s in (0, 1)]
    a, b = (torch.as_tensor(x, dtype=dtype).to(device) for x in g)
    # the constants in the chain's dtype, made once outside the loop
    scale = torch.tensor(1e-3, dtype=dtype, device=device)
    eps = torch.tensor(1e-6, dtype=dtype, device=device)

    def loop() -> torch.Tensor:
        carry = a
        for _ in range(SCAN_K):  # each product reads the last: none is hoisted
            carry = torch.tanh(carry @ b) * scale + a * eps
        return carry

    with torch.no_grad():
        sec_per_call = _timed_calls(loop, _read_first, min_s=GEMM_MIN_S)
    flops_per_call = 2.0 * n ** 3 * SCAN_K  # tanh and the scale are O(n²)
    return {
        "n": n, "dtype": str(dtype).replace("torch.", ""),
        "sec_per_matmul": sec_per_call / SCAN_K,
        "tflops": round(flops_per_call / sec_per_call / 1e12, 2),
        "frac_of_peak": round(flops_per_call / (sec_per_call * peak), 4) if peak else None,
        "peak_flops": peak,
    }


# -- bare -----------------------------------------------------------------------
def _clone(params: Dict) -> Dict:
    return {layer: {name: t.detach().clone() for name, t in lp.items()}
            for layer, lp in params.items()}


def _grads(trainer, params: Dict, features, labels):
    """``(keys, gradients)`` of ``trainer``'s graph loss at ``params``
    (its trainable leaves); the forward's new BatchNorm stats are dropped."""
    from gan_deeplearning4j_tpu_torch.parallel.trainer import grad_leaves

    p, keys, leaves = grad_leaves(trainer.optimizer, params)
    with torch.enable_grad():
        loss, _ = trainer.graph.loss(p, features, labels, train=True)
        return keys, torch.autograd.grad(loss, leaves)


def _pseudo(params: Dict, keys, grads) -> None:
    """The 1e-12 pseudo-update, in place: it keeps every gradient live at
    the cost of reading it once."""
    with torch.no_grad():
        for (layer, name), g in zip(keys, grads):
            params[layer][name].add_(g, alpha=-1e-12)


def bare_step(exp, trees: Dict, feats, labels):
    """One bare step on ``trees`` (``dis``, ``gan``, ``cv``, ``gen``
    params, updated in place); returns the first leaf of its last gradient
    (the classifier's, else the gan's)."""
    b = feats.shape[0]
    dev = feats.device
    z_size = exp.model_cfg.z_size
    soft1 = torch.ones((b, 1), dtype=torch.float32, device=dev)
    soft0 = torch.zeros((b, 1), dtype=torch.float32, device=dev)
    with torch.no_grad():
        z = torch.rand((b, z_size), device=dev).mul_(2.0).sub_(1.0)
        fake = exp.gen.output(trees["gen"], z, train=False).reshape(feats.shape)
    _pseudo(trees["dis"], *_grads(exp.dis_trainer, trees["dis"], feats, soft1))
    _pseudo(trees["dis"], *_grads(exp.dis_trainer, trees["dis"], fake, soft0))
    z2 = torch.rand((b, z_size), device=dev).mul_(2.0).sub_(1.0)
    keys, g_gan = _grads(exp.gan_trainer, trees["gan"], z2, soft1)
    _pseudo(trees["gan"], keys, g_gan)
    with torch.no_grad():
        nudge = 1e-12 * g_gan[0].sum()
        for lp in trees["gen"].values():
            for t in lp.values():
                t.sub_(nudge)
    last = g_gan
    if exp.cv is not None:
        keys, last = _grads(exp.cv_trainer, trees["cv"], feats, labels)
        _pseudo(trees["cv"], keys, last)
    return last[0]


def _captured_step(step, device: torch.device):
    """``(graph, output)``: ``step()`` captured on the process's capture
    stream after two warm runs there."""
    from gan_deeplearning4j_tpu_torch.harness.graphs import _side_stream
    from gan_deeplearning4j_tpu_torch.runtime.capture import CAPTURE_ERROR_MODE, capture_guard

    side = _side_stream(device)
    graph = torch.cuda.CUDAGraph()
    with capture_guard():
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for _ in range(2):
                step()
        torch.cuda.current_stream(device).wait_stream(side)
        with torch.cuda.graph(graph, stream=side, capture_error_mode=CAPTURE_ERROR_MODE):
            out = step()
    return graph, out


def bench_bare(exp, feats, labels, peak: Optional[float]) -> dict:
    """Config 1's compute core on ``exp``'s graphs at ``feats``' batch
    (module docstring, tier 2); MFU against the fp32 ``peak``."""
    batch = feats.shape[0]
    trees = {"dis": _clone(exp.dis_state.params), "gan": _clone(exp.gan_state.params),
             "cv": None if exp.cv is None else _clone(exp.cv_state.params),
             "gen": _clone(exp.gen_params)}

    def step():
        return bare_step(exp, trees, feats, labels)

    flops_per_iter = _flops(step)
    graph = None
    if feats.device.type == "cuda":
        graph, out = _captured_step(step, feats.device)

        def call():
            for _ in range(SCAN_K):
                graph.replay()
            return out
    else:
        def call():
            last = None
            for _ in range(SCAN_K):
                last = step()
            return last

    sec_per_call = _timed_calls(call, _read_first, min_s=BARE_MIN_S)
    if graph is not None:
        from gan_deeplearning4j_tpu_torch.runtime.capture import CAPTURE_LOCK

        with CAPTURE_LOCK:  # no graph is destroyed inside another's capture
            graph.reset()
    sec_per_iter = sec_per_call / SCAN_K
    mfu = flops_per_iter / (sec_per_iter * peak) if peak else None
    return {
        "batch": batch,
        "sec_per_iter": round(sec_per_iter, 6),
        "flops_per_iter": flops_per_iter,
        "images_per_sec": round(batch / sec_per_iter, 2),
        "bare_mfu": round(mfu, 4) if mfu is not None else None,
        "peak_flops": peak,
    }


# -- the report ---------------------------------------------------------------------
def run(args) -> dict:
    from gan_deeplearning4j_tpu_torch.harness.profile import _mnist_experiment
    from gan_deeplearning4j_tpu_torch.runtime.device import pin_fp32_precision

    device = torch.device("cpu" if args.cpu else "cuda:0")
    kind = _device_kind(device)
    peaks = _peak_flops(kind) or {}
    bf16_peak, fp32_peak = peaks.get("bf16"), peaks.get("fp32")
    if device.type == "cuda":
        pin_fp32_precision()  # the training iteration's fp32 (``experiment_device``)
    report = {
        "platform": "gpu" if device.type == "cuda" else "cpu",
        "device_kind": kind,
        "peak_flops_assumed": bf16_peak,
        "peak_flops_fp32_assumed": fp32_peak,
        "scan_window": SCAN_K,
        "gemm": bench_gemm(args.gemm_n, torch.bfloat16, bf16_peak, device),
    }
    print(json.dumps({"gemm": report["gemm"]}), flush=True)
    report["gemm_fp32"] = bench_gemm(args.gemm_n, torch.float32, fp32_peak, device)
    print(json.dumps({"gemm_fp32": report["gemm_fp32"]}), flush=True)
    report["bare"] = {}
    measured = {}
    for b in [int(x) for x in args.batches.split(",")]:
        exp, feats, labels = _mnist_experiment(b, None, args.cpu)
        report["bare"][str(b)] = bench_bare(exp, feats, labels, fp32_peak)
        print(json.dumps({f"bare_b{b}": report["bare"][str(b)]}), flush=True)
        if b in ACHIEVED_CONFIGS.values():
            row = sweep_row(exp, feats, labels, b, ACHIEVED_ITERS)
            row["mfu"] = (row["flops_per_iter"] / (row["sec_per_iter"] * fp32_peak)
                          if fp32_peak else None)
            measured[b] = row
            print(json.dumps({f"achieved_b{b}": row}), flush=True)
        exp.close()
    report["achieved"] = {name: measured[b]["mfu"] if b in measured else None
                          for name, b in ACHIEVED_CONFIGS.items()}
    report["achieved_iteration"] = {name: measured.get(b) for name, b in ACHIEVED_CONFIGS.items()}
    return report


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m gan_deeplearning4j_tpu_torch.harness.mfu",
                                description=__doc__.splitlines()[0])
    p.add_argument("--out", default=None, help="also write the report to this file")
    p.add_argument("--gemm-n", type=int, default=4096)
    p.add_argument("--batches", default="64,256")
    p.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    p.add_argument("--record", default=None, metavar="TAG",
                   help="also write BENCH_torch_mfu_<TAG>.json at the repo root")
    return p.parse_args(argv)


_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    args = parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        sys.stderr.write("mfu: no CUDA device is available; pass --cpu to run on the CPU\n")
        return 2
    report = run(args)
    paths = [args.out] if args.out else []
    if args.record:
        paths.append(os.path.join(_REPO, f"BENCH_torch_mfu_{args.record}.json"))
    for path in paths:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as fh:
            json.dump(report, fh, indent=2)
            fh.write("\n")
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
