"""Smoke test of the PyTorch port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Drives the port (``gan_deeplearning4j_tpu_torch``) at the full width of the
DCGAN-MNIST model and of the tabular, image and WGAN-GP families, with
random weights from seed 666, and fails (non-zero exit, no result line) if
any phase fails. First the serving path:

1. print the card's ``name, power.limit`` as ``nvidia-smi`` reports them;
2. build ``gen`` and the transfer classifier ``cv`` and write a serving
   bundle with the port's serializer;
3. load it with ``ServingEngine.from_bundle(..., device="cuda")``, warm up,
   and check that every (kind, bucket) was captured as a CUDA graph once
   and none after warmup;
4. for every kind and n in (1, 3, 8, 21, 130): the card's rows match the
   same bundle served on the CPU within 1e-4 (TF32 off), and the staged
   ``run`` (a graph replay) equals ``run_host`` (the eager forward) bit for
   bit on the card;
5. serve it over HTTP (``make_server`` on an ephemeral port), send
   concurrent ``sample``/``classify``/``features`` requests and check status,
   shapes, softmax row sums and ``/healthz``;
6. time each (kind, bucket) with CUDA events over 50 runs — the model's
   forward pass on device-resident rows, and the engine's whole ``run`` —
   and the HTTP round trip.

Then the training path (``GanExperiment``, the reference's settings, data
from ``prepare_mnist(source="synthetic")``). On the card every iteration
of (a)-(l) goes through the captured path (``harness/graphs.py``): a
window of K iterations is K replays of one CUDA graph per entry, and
``train_iteration`` a window of one:

a. the same init on the card and on the CPU, 2 fused iterations at batch
   64 on both with the same z: the card-vs-CPU errors of losses, params,
   RmsProp caches and BatchNorm stats after each; fails above the tests'
   one-iteration tolerance (losses 1e-4 relative, every leaf 5e-3
   normwise) after the first;
b. resume on the card at batch 200: 2 iterations, ``save_models``,
   ``load_models`` into a fresh experiment, 2 more, bit-equal to 4
   straight iterations; the ops ``torch.use_deterministic_algorithms``
   flags meanwhile are listed;
c. ``run()`` for 4 iterations with exports and checkpoints, then
   ``publish_for_serving`` → ``ServingEngine.from_bundle(device="cuda")``,
   whose ``sample``/``classify`` rows match the trainer's own ``gen``/``cv``
   within 1e-5;
d. timing at batch 200 without checkpoints: the median iteration over 20
   after 5 warm ones (host clock with a synchronize, and CUDA events),
   images/s, peak memory, a ``torch.profiler`` window of 5 iterations
   (device-busy share, top 10 kernels), a second window with host
   activity that splits the iteration by stage (``iteration.*`` and
   ``step.*`` ranges, host and device time; a replay runs no host code,
   so this window runs the device body uncaptured), and the fp32 bound of
   the iteration's convolution and GEMM FLOPs at 67 TFLOP/s.

Then the other families at full width (``FAMILIES``: the JAX bench's
configs 2-5, fp32), on synthetic rows from each family's own source:

e. card vs CPU, one iteration from the same init and draws: tabular at
   batch 256, ``cifar10`` at 64 and ``wgan_gp`` (CIFAR-10 shaped) at 80
   (5 critic steps of 16); the same limits as (a), on the whole iteration
   for tabular and ``cifar10`` and, for ``wgan_gp``, on the losses and
   gradients of its first critic step and of a generator step (the round
   itself, whose Adam steps amplify rounding, is reported);
f. bit-exact resume (2 + save + load + 2 against 4 iterations), ``cifar10``
   at batch 64 and ``wgan_gp`` at 320, listing the ops that
   ``use_deterministic_algorithms`` flags;
g. ``run()`` of 4 iterations, ``publish_for_serving`` (a generator-only
   bundle with its zoo block) and ``ServingEngine`` on the card, for
   ``cifar10`` and ``wgan_gp``: ``sample`` matches the trainer's generator
   within 1e-5, and ``classify`` is absent;
h. timing as in (d), at the JAX bench's batches: tabular 256, ``cifar10``
   64, ``celeba64`` 64 and ``wgan_gp`` 320 (top 5 kernels, no stage split).

Then bf16, as the JAX package runs it (``compute_dtype="bf16"``: dense and
convolution products in bf16 with fp32 accumulation, params fp32;
``param_dtype="bf16"``: params and updater state stored in bf16 too):

i. card vs CPU, one iteration from the same init and draws, every family
   under mixed precision at (a)'s and (e)'s batches, held to stated bf16
   bounds (``BF16_ITER_BOUNDS``, ``BF16_WGAN_BOUNDS``);
j. bit-exact resume in bf16: MNIST b200 and ``cifar10`` b64 mixed, MNIST
   b200 with bf16 storage; an op that ``use_deterministic_algorithms``
   flags fails it;
k. a bf16-storage MNIST run published and served on the card (its bf16
   params computed in fp32) against the trainer; ``build_bf16_variant`` of
   the serving bundle served on the card against the fp32 bundle for every
   kind and n, and its resident param bytes halved;
l. timing as in (h) under mixed precision: MNIST b200, tabular b256 and
   b4096, ``cifar10`` b64, ``celeba64`` b64, ``wgan_gp`` b320, with copy
   (cast) kernels counted and the roofline share against the dense bf16
   tensor-core peak (989 TFLOP/s).

Then the device loop, the port of the JAX package's ``_build_multi_iteration``:

p. windows bit for bit: for MNIST b200 (fp32, mixed bf16, bf16 storage),
   tabular b256, ``cifar10`` b64 and ``wgan_gp`` b320 (fp32 and mixed
   bf16; the gradient penalty's double backward inside the graph), 9
   iterations from one init and one stream of draws, the device body
   applied eagerly against one ``train_iteration`` and a window of 8
   (``train_iterations``), against ``run(DeviceResidentIterator,
   loss_fetch_every=8)`` (a window of 1, the manifold export's, then one
   ``next_window`` slice of 8), and ``run()`` with ``prefetch=2`` over an
   ``ArrayDataSetIterator`` against the resident run: every leaf and loss
   equal, every key captured once, a second window capturing nothing;
   then a ragged epoch tail (tabular, 640 rows at 256, two epochs) captured
   once and replayed;
q. uncaptured (the device body launched op by op) against captured, back
   to back in one call, at the batches of (d), (h) and (l), fp32 (mixed
   bf16's captured timing is (l)'s): the first two iterations' seconds
   (warmup and capture included), host and CUDA-event ms, rows/s, busy share, kernels and
   launch calls (kernel launches, graph launches, copies) per iteration,
   peak memory and each entry's private pool, and (captured) a window of
   16 over one resident batch.

Then int8 (``quant/``), the port's one hand-written kernel first: before
any phase, ``gan_deeplearning4j_tpu_torch/csrc/quant_dense.cu`` is built
by ``nvcc`` (what ``ptxas -v`` says is printed). ``build_int8_variant`` of
the serving bundle, calibrated on the card, then:

m. the ``quant_dense`` kernel against its plain PyTorch version at both
   quantized layers (1152 → 1024, 1024 → 10) and n in (1, 3, 8, 21, 32,
   128), on rows holding half codes and values past ±127·act_scale:
   bit-equal. Device times by CUDA-graph replay, operands cold in HBM (an
   L2-sized fill before each call, its time subtracted), of the kernel, the
   plain version, ``torch._int_mm`` with the same quantize and dequantize
   (a yardstick, where it takes the shape) and the fp32 ``addmm`` of the
   float layer, beside the bound (bytes at 3.35 TB/s, int8 operations at
   1,979 TOP/s); the kernel's time with its operands warm in L2, and its
   eager time per call (CUDA events around one call, the wrapper's host
   time included), beside; the launch plan of each shape
   (``ops/linear.py::quant_dense_plan``: route, strip, cluster, K-chunk,
   row tile, CTAs, shared memory) and what ``ptxas`` said of each kernel
   instance (registers, static shared memory, spills);
n. the main path: the int8 bundle served on the card (launch count zeroed
   before, read after: the wrapper's, and replays × launches captured per
   graph): staged ``run`` equals ``run_host``, two launches per run chunk,
   no capture after warmup, card vs CPU within two code
   steps, resident bytes exactly 28,694,660, the generator byte-identical,
   the drift from the fp32 bundle within 5e-2 of the largest output, one
   HTTP ``classify``; then the device time of the two dense vertices per
   run, fp32 against int8, read from profiler ranges around them;
o. ``measure_bundle_cost`` of the fp32, bf16 and int8 bundles (bytes
   ratios exactly 0.5 and 28,694,660 / 32,260,188), and ``CanaryGate``
   admitting the bf16 and int8 variants against the fp32 incumbent and, on
   a tiny dense bundle, rejecting an int8 variant calibrated on rows × 1e9
   for its accuracy.

Then serving as the JAX engine serves, from one compiled (here: captured)
program per (kind, bucket), and the planes around it:

r. serving captured: the fp32 bundle, its ``build_bf16_variant`` and its
   int8 variant, each (kind, bucket) captured once in warmup and none
   after; staged ``run`` bit-equal to ``run_host`` for n in (1, 3, 8, 21,
   130); card vs CPU within (k)'s and (n)'s limits; ``quant_dense``
   replayed inside the int8 graphs bit-equal to its plain version; per
   (kind, bucket), captured and uncaptured in one call: ``run`` ms (median
   of 20), launch calls a run, busy share, kernels, capture seconds, pool
   bytes;
s. the mux on the card: one ``MuxRegistry`` of the three variants with one
   ``SharedStagingPool`` behind ``make_server``; six closed-loop HTTP
   clients with request keys: every answer ok, routed by
   ``WeightedSplitter.assign``, within (r)'s limits of its variant's own
   ``run_host``; the pool reused across variants; a ramp 1% → 100% and a
   rolled-back one; forced brownout shedding the costliest variant first;
   ``demote`` then ``ensure_resident`` re-capturing while others serve;
t. reload on the card: a ``CheckpointStore``, ``ReloadController`` with the
   real ``CanaryGate``; generation 1 published under six HTTP clients and
   swapped in with zero non-ok answers and no capture after the new
   engine's warmup, bit-equal to a fresh engine's ``run_host``; a poisoned
   generation quarantined; ``POST /debug/trace?ms=200&block=1`` leaving a
   ``torch.profiler`` trace.

Then the model zoo (``zoo/``) and class conditioning:

u. (u1) the conditional MNIST DCGAN (``ExperimentConfig``'s defaults, z 2
   plus a 10-wide one-hot) card vs CPU at batch 64, within (a)'s limits;
   (u2) (p)'s window check on the conditional MNIST DCGAN at batch 200 and
   the conditional image family (``cifar_shaped``) at 64, the one-hot read
   from the window's static labels; (u3) the port's zoo drill
   (``gan_deeplearning4j_tpu_torch.zoo.drill``) at full width: conditional
   MNIST at batch 200 through ``StreamingDataSetIterator``, published,
   every class served over HTTP by ``sample?class=k`` bit-equal to
   ``run_host``, no capture after warmup, the 400 contract; WGAN-GP
   ``cifar_shaped`` at 320, one round; both behind one mux with the
   conditional bundle's int8 variant, under ``sample`` and ``classify``
   requests (the kernel's launch count zeroed before, read after; its
   replays in the int8 variant's graphs must be some), every answer ok; the int8 variant's replays
   bit-equal to ``quant_dense_plain`` and its ``sample?class=k`` to
   ``run_host``; (u4) timing, recorded: the captured iteration conditional
   against unconditional at batch 200, the streaming iterator against the
   in-memory one (feeding alone and feeding training), conditional
   ``sample`` ``run`` ms against the unconditional bundle's, buckets 1-128.

Then data-parallel training (``parallel/``), one process per rank over
``torch.distributed``:

v. (v1) NCCL at world size 1, in this process (a ``FileStore``
   rendezvous): MNIST b200 under ``pmean``, ``pmean`` + update sharding
   and ``param_averaging`` (the per-fit averaging body), and ``wgan_gp``
   b320 under ``pmean``, 4 iterations (2 rounds) each as captured replays,
   the NCCL collectives inside the graph: replays bit-equal to the same
   window run eagerly, each key captured once and none by a second
   window, the single-card experiment from the same init and draws
   bit-equal (or, where synchronised BatchNorm's reduction takes another
   route, within 1e-6 on losses and 1e-5 on every leaf), the collectives
   issued per iteration and the NCCL kernels of one; (v2) the reference's
   ``local[4]``: four gloo ranks sharing the card
   (``parallel/launch.py``), ``ParameterAveragingTrainer.fit_rounds`` on
   the dis graph at 200 a worker and frequency 10, 2 phased averaging
   iterations, ``pmean`` at a global 800 with and without update sharding,
   ``wgan_gp`` ``pmean`` at 320, the dis graph's sharded steps both ways;
   every rank's states bit-identical; ``pmean`` at world 4 against one
   card at 800 and against four CPU ranks, within (a)'s limits (the
   classifier's frozen-layer caches apart); WGAN-GP's first critic and
   generator steps within (e)'s (the round reported); update sharding
   bit-equal to the replicated run, its reduce-scatter variant to
   rounding; resident updater bytes per rank; (v3) the four ranks' mesh
   checkpoint restored at world 1 (NCCL) and 2 (gloo) bit for bit, and two
   iterations from it equal to two from a whole-file checkpoint of the
   same state; (v4) timing, recorded: the single card against NCCL world
   1, captured, MNIST b200 (median of 20 after 5 warm, NCCL's share of the
   kernel time), and gloo world 4 eager (ms, rows/s over the ranks, the
   host staging's share). ``--only parallel`` runs (v) alone, as a
   rehearsal, with no result line.

Then evaluation (``eval/``), the quality run's path:

w. (w1) the Inception-schema interpreter (``inception_feature_fn``) card
   against CPU, on InceptionV3's published stem and ``Mixed_5b`` block
   (``eval/inception_schema.py``: conv biases and relu, weights from
   ``default_rng(666)``, 256 features) at 299×299×3 fed 28×28×1 MNIST rows
   (resized up, broadcast) and at 32×32×3 fed 64×64×3 ``celeba64`` rows
   (resized down), and the frozen extractor at seed 7 with 3 channels:
   features within 1e-4 of the largest, TF32 off; (w2) the quality run
   (``eval/quality_run.py``) in this process at the reference's width
   (MNIST b200, ``ExperimentConfig``'s defaults): 100 iterations, export
   every 25, quick FID on 2048 samples, FID@10000, the (w1) 299 schema as
   ``$INCEPTION_WEIGHTS``: the report has ``scripts/quality_run.py``'s
   keys, ``fid_inception`` is a number, rescoring the saved best generator
   reproduces its quick FID bit for bit, the final generator's quick FID
   on the card is within 1e-3 of the CPU's from the same params,
   ``evaluate_classifier`` gives ``export_predictions``' accuracy, and
   ``GraphTrainer.fit`` over ``RecordReaderDataSetIterator(
   InMemoryRecordReader)`` for 4 batches is bit-equal to 4 ``train_step``s;
   (w3) timing, recorded: ms per quick-FID score, Inception-schema rows/s
   at 299×299, ``evaluate_classifier`` rows/s, the run's phase seconds.
   ``--only eval`` runs (w) alone.

Every number is printed beside the card's name and power limit. The
``kernels`` line lists ``quant_dense`` (the JAX package has no Pallas
kernel; its XLA-lowered ``quant_dense`` is the one op stock torch cannot
fuse) with its launches on this slice's main path, (u), and by path. The
last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
``--json PATH`` also writes every measurement to PATH.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import gc
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import urllib.error
import urllib.request

import numpy as np
import torch

SEED = 666
SIZES = (1, 3, 8, 21, 130)
CPU_TOL = 1e-4
TIMED_RUNS = 50
# the one-iteration tolerance of tests/test_torch_train.py
ITER_LOSS_RTOL, ITER_LEAF_REL = 1e-4, 5e-3
FP32_FLOP_PER_S = 67e12
# NVIDIA's H100 SXM data sheet, dense bf16 tensor-core rate (no sparsity)
BF16_FLOP_PER_S = 989e12


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0].strip()


def _build_bundle(directory: str) -> dict:
    """Full-width gen + cv from seed 666, BatchNorm statistics randomised
    (seeded) so that the normalisation is exercised, written as a bundle."""
    from gan_deeplearning4j_tpu_torch.models import dcgan_mnist
    from gan_deeplearning4j_tpu_torch.utils import write_model

    gen = dcgan_mnist.build_generator()
    dis = dcgan_mnist.build_discriminator()
    gen_params = gen.init(seed=SEED, device="cpu")
    cv, cv_params = dcgan_mnist.build_transfer_classifier(dis, dis.init(seed=SEED, device="cpu"))
    g = torch.Generator().manual_seed(SEED)
    for params in (gen_params, cv_params):
        for leaves in params.values():
            if "var" in leaves:
                n = leaves["var"].shape
                leaves["gamma"] = 0.5 + torch.rand(n, generator=g)
                leaves["beta"] = 0.1 * torch.randn(n, generator=g)
                leaves["mean"] = 0.1 * torch.randn(n, generator=g)
                leaves["var"] = 0.5 + torch.rand(n, generator=g)
    write_model(os.path.join(directory, "gen.zip"), gen, gen_params, save_updater=False)
    write_model(os.path.join(directory, "cv.zip"), cv, cv_params, save_updater=False)
    manifest = {"format_version": 1, "family": "mnist", "generator": "gen.zip",
                "classifier": "cv.zip", "feature_vertex": "dis_dense_layer_6",
                "z_size": 2, "num_features": 784, "num_classes": 10, "generation": None}
    with open(os.path.join(directory, "serving.json"), "w") as fh:
        json.dump(manifest, fh)
    return {"sample": (gen, gen_params), "classify": (cv, cv_params), "features": (cv, cv_params)}


def _rows(kind: str, n: int, rng: np.random.Generator) -> np.ndarray:
    if kind == "sample":
        return rng.standard_normal((n, 2)).astype(np.float32)
    return rng.random((n, 784), dtype=np.float32)


def _check_outputs(engine, cpu_engine) -> dict:
    rng = np.random.default_rng(SEED)
    errs = {}
    for kind in engine.kinds:
        worst = 0.0
        for n in SIZES:
            rows = _rows(kind, n, rng)
            staged = engine.run(kind, rows)
            host = engine.run_host(kind, rows)
            if not np.array_equal(staged, host):
                raise AssertionError(f"{kind} n={n}: run differs from run_host on the card")
            ref = cpu_engine.run_host(kind, rows)
            if staged.shape != ref.shape or not np.all(np.isfinite(staged)):
                raise AssertionError(f"{kind} n={n}: shape {staged.shape} vs {ref.shape} or non-finite")
            err = float(np.max(np.abs(staged - ref)))
            if err > CPU_TOL:
                raise AssertionError(f"{kind} n={n}: card vs CPU max abs err {err} > {CPU_TOL}")
            worst = max(worst, err)
        errs[kind] = worst
    return errs


def _post(base: str, kind: str, rows: np.ndarray, **fields):
    req = urllib.request.Request(
        f"{base}/v1/{kind}", data=json.dumps({"data": rows.tolist(), **fields}).encode(),
        headers={"Content-Type": "application/json"},
    )
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            body = json.loads(r.read())
            status = r.status
    except urllib.error.HTTPError as exc:  # a 503 or 500 still answers JSON
        body = json.loads(exc.read() or b"{}")
        status = exc.code
    return status, body, time.perf_counter() - t0


def _check_http(engine) -> dict:
    from gan_deeplearning4j_tpu_torch.serving import InferenceService, make_server

    service = InferenceService(engine, warmup="sync")
    server = make_server(service, port=0)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    widths = {"sample": 784, "classify": 10, "features": 1024}
    try:
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
            health = json.loads(r.read())
        if health["status"] != "ok" or health["platform"] != "gpu":
            raise AssertionError(f"/healthz: {health}")
        results, errors = [], []

        def client(i: int) -> None:
            rng = np.random.default_rng(SEED + i)
            try:
                for j in range(3):
                    kind = ("sample", "classify", "features")[(i + j) % 3]
                    n = (1, 3, 8, 21)[(i * 3 + j) % 4]
                    results.append((kind, n) + _post(base, kind, _rows(kind, n, rng)))
            except Exception as exc:  # reported below; the phase fails
                errors.append(repr(exc))

        threads = [threading.Thread(target=client, args=(i,)) for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        if errors or any(t.is_alive() for t in threads) or len(results) != 24:
            raise AssertionError(f"concurrent HTTP clients failed: {errors}")
        for kind, n, status, body, _ in results:
            data = np.asarray(body.get("data"))
            if status != 200 or body["status"] != "ok" or data.shape != (n, widths[kind]):
                raise AssertionError(f"{kind} n={n}: HTTP {status} {body.get('status')} shape {data.shape}")
            if kind == "classify" and np.max(np.abs(data.sum(axis=1) - 1.0)) > 1e-5:
                raise AssertionError("softmax rows do not sum to 1 within 1e-5")
        rng = np.random.default_rng(SEED)
        sequential = [_post(base, "sample", _rows("sample", 1, rng))[2] for _ in range(TIMED_RUNS)]
        if engine.serve_compile_counts != {k: 0 for k in engine.kinds}:
            raise AssertionError(f"serve-time first runs: {engine.serve_compile_counts}")
        return {
            "http_concurrent_p50_ms": 1e3 * statistics.median(r[4] for r in results),
            "http_sample_n1_p50_ms": 1e3 * statistics.median(sequential),
        }
    finally:
        server.shutdown()
        server.server_close()
        service.close()
        thread.join(timeout=30)


def _event_median_ms(fn, runs: int = TIMED_RUNS, warm: int = 5) -> float:
    """Median of ``runs`` single runs of ``fn``, each between two CUDA
    events on the current stream, after ``warm`` untimed runs."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(runs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _time_ladder(engine, models) -> list:
    rng = np.random.default_rng(SEED)
    rows_out = []
    for kind in engine.kinds:
        graph, params = models[kind]
        params = {k: {n: t.to("cuda") for n, t in v.items()} for k, v in params.items()}
        for bucket in engine.buckets:
            host_rows = _rows(kind, bucket, rng)
            dev_rows = torch.from_numpy(host_rows).to("cuda")
            if kind == "features":
                def forward():
                    graph.feed_forward(params, dev_rows)["dis_dense_layer_6"]
            else:
                def forward():
                    graph.output(params, dev_rows)
            with torch.inference_mode():
                forward_ms = _event_median_ms(forward)
            run_ms = _event_median_ms(lambda: engine.run(kind, host_rows))
            rows_out.append({"kind": kind, "bucket": bucket, "forward_ms": forward_ms,
                             "run_ms": run_ms})
    return rows_out


def _training_data(directory: str):
    """The synthetic MNIST CSVs (the reference layout), as arrays and as the
    CLI's record-reader iterators."""
    from gan_deeplearning4j_tpu_torch.__main__ import _csv_iterator
    from gan_deeplearning4j_tpu_torch.data import load_mnist_csv, one_hot_np, prepare_mnist

    train_csv, test_csv = prepare_mnist(directory, seed=SEED, source="synthetic")
    x, y = load_mnist_csv(train_csv)
    return x, one_hot_np(y, 10), (lambda: _csv_iterator(train_csv, 200, 784, 10)), \
        (lambda: _csv_iterator(test_csv, 500, 784, 10))


def _config(**overrides):
    from gan_deeplearning4j_tpu_torch.harness import ExperimentConfig

    return ExperimentConfig(**{"save_models": False, **overrides})


def _split_errors(a: dict, b: dict) -> dict:
    """Max abs error of params, RmsProp caches and BatchNorm running stats
    between two ``flatten_states``."""
    out = {"params": 0.0, "caches": 0.0, "bn_stats": 0.0}
    for key, value in a.items():
        if not isinstance(value, torch.Tensor):
            continue
        kind = ("caches" if "/opt_state/" in key else
                "bn_stats" if key.endswith("/mean") or key.endswith("/var") else "params")
        err = float((value.cpu().double() - b[key].cpu().double()).abs().max())
        out[kind] = max(out[kind], err)
    return out


def _frozen_updater_keys(exp, flat: dict) -> list:
    """``flatten_states`` keys of the classifier's updater state in its
    frozen (learning rate 0) layers: state that moves no param."""
    frozen = [layer for layer, u in exp.cv.layer_updaters().items() if u.learning_rate == 0]
    return [k for k in flat if any(k.startswith(f"CV/opt_state/{layer}/") for layer in frozen)]


def _phase_card_vs_cpu(x, y, card: str, frozen_apart: bool = False, **overrides) -> list:
    """(a), and (u1) with ``conditioning="class"``: 2 iterations at batch 64
    on the card and on the CPU from one init and one stream of draws.

    ``frozen_apart`` ((u1)) holds the classifier's updater state in its
    frozen layers apart from ``max_leaf_rel``: at learning rate 0 it moves
    no param, and its value (the square of a gradient through the frozen
    feature stack, ending in a 50,176-term cancelling sum at the first
    BatchNorm) is not fixed by fp32: two CPU runs of the same iteration with
    1 and 4 threads differ there by 1.3e-2 at (u1)'s batch, the card vs the
    CPU by as much. Those leaves are reported (their worst relative error,
    and the CPU's own spread on them, measured here with one thread)."""
    from gan_deeplearning4j_tpu_torch.harness import GanExperiment
    from gan_deeplearning4j_tpu_torch.harness.experiment import flatten_states, state_divergence

    gpu = GanExperiment(_config(batch_size_train=64, **overrides))
    cpu = GanExperiment(_config(batch_size_train=64, use_accelerator=False, **overrides))
    rows = []
    for it in range(2):
        xb, yb = x[it * 64:(it + 1) * 64], y[it * 64:(it + 1) * 64]
        lg, lc = gpu.train_iteration(xb, yb), cpu.train_iteration(xb, yb)
        loss_rel = max(abs(float(lg[k]) - float(lc[k])) / abs(float(lc[k])) for k in lc)
        loss_abs = max(abs(float(lg[k]) - float(lc[k])) for k in lc)
        a, b = flatten_states(gpu.digest_states()), flatten_states(cpu.digest_states())
        apart = _frozen_updater_keys(cpu, b) if frozen_apart else []
        div = state_divergence(a, b, apart)
        row = {"phase": "train_card_vs_cpu", **overrides, "iteration": it + 1, "batch": 64,
               "losses_max_abs_err": loss_abs, "losses_max_rel_err": loss_rel,
               **{f"{k}_max_abs_err": v for k, v in _split_errors(a, b).items()},
               "max_leaf_rel_err": div["max_leaf_rel"], **_leaf_errors(a, b, apart), "card": card}
        if apart:
            row["frozen_updater_state"] = {
                "leaves": len(apart),
                "max_leaf_rel_err": state_divergence({k: a[k] for k in apart}, {k: b[k] for k in apart})
                ["max_leaf_rel"]}
        print(json.dumps(row))
        rows.append(row)
        if it == 0 and (loss_rel > ITER_LOSS_RTOL or div["max_leaf_rel"] > ITER_LEAF_REL):
            raise AssertionError(f"card vs CPU after one iteration: {row}")
    if frozen_apart:
        # the CPU's own spread on those leaves: the first iteration again,
        # on one thread
        threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            one = GanExperiment(_config(batch_size_train=64, use_accelerator=False, **overrides))
            one.train_iteration(x[:64], y[:64])
        finally:
            torch.set_num_threads(threads)
        ref = GanExperiment(_config(batch_size_train=64, use_accelerator=False, **overrides))
        ref.train_iteration(x[:64], y[:64])
        c, d = flatten_states(one.digest_states()), flatten_states(ref.digest_states())
        apart = _frozen_updater_keys(ref, d)
        rows[0]["frozen_updater_state"]["cpu_1_vs_%d_threads_max_leaf_rel" % threads] = state_divergence(
            {k: c[k] for k in apart}, {k: d[k] for k in apart})["max_leaf_rel"]
        rows[0]["cpu_1_vs_%d_threads_max_leaf_rel_rest" % threads] = state_divergence(c, d, apart)["max_leaf_rel"]
        print(json.dumps({"phase": "train_card_vs_cpu_cpu_spread", **overrides,
                          "frozen_updater_state": rows[0]["frozen_updater_state"], "card": card}))
    return rows


def _resume_check(make, batches, directory: str) -> dict:
    """4 iterations of ``make()`` against 2 + ``save_models`` + ``load_models``
    into a fresh experiment + 2, under ``use_deterministic_algorithms``
    (warn only): the leaves that differ (dtype or bits) and the ops it
    flagged meanwhile."""
    import warnings

    from gan_deeplearning4j_tpu_torch.harness.experiment import flatten_states

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            straight = make()
            for xb, yb in batches:
                straight.train_iteration(xb, yb)
            first = make()
            for xb, yb in batches[:2]:
                first.train_iteration(xb, yb)
            first.save_models(directory)
            resumed = make()
            if resumed.load_models(directory) != 2:
                raise AssertionError("load_models did not restore iteration 2")
            for xb, yb in batches[2:]:
                resumed.train_iteration(xb, yb)
    finally:
        torch.use_deterministic_algorithms(False)
    a, b = flatten_states(straight.digest_states()), flatten_states(resumed.digest_states())
    differ = [k for k in a if not (a[k].dtype == b[k].dtype and torch.equal(a[k], b[k])
                                   if isinstance(a[k], torch.Tensor) else a[k] == b[k])]
    flagged = sorted({str(w.message).split("\n")[0][:160] for w in caught
                      if "deterministic" in str(w.message)})
    return {"bit_exact": not differ, "leaves": len(a), "differing_leaves": differ[:5],
            "nondeterministic_ops_flagged": flagged}


def _mnist_batches(x, y, batch: int, count: int) -> list:
    n = x.shape[0] // batch
    return [(x[(i % n) * batch:(i % n + 1) * batch], y[(i % n) * batch:(i % n + 1) * batch])
            for i in range(count)]


def _phase_resume(x, y, directory: str, card: str) -> dict:
    from gan_deeplearning4j_tpu_torch.harness import GanExperiment

    checked = _resume_check(lambda: GanExperiment(_config()), _mnist_batches(x, y, 200, 4), directory)
    if not checked["bit_exact"]:
        raise AssertionError(f"resume is not bit-exact on the card: {checked['differing_leaves']}")
    row = {"phase": "train_resume", "batch": 200, **checked, "card": card}
    print(json.dumps(row))
    return row


def _phase_run_and_publish(make_train, make_test, directory: str, card: str) -> dict:
    from gan_deeplearning4j_tpu_torch.harness import GanExperiment
    from gan_deeplearning4j_tpu_torch.serving import ServingEngine

    exp = GanExperiment(_config(num_iterations=4, save_models=True, checkpoint_every=4,
                                output_dir=os.path.join(directory, "out")))
    t0 = time.perf_counter()
    result = exp.run(make_train(), make_test())
    run_s = time.perf_counter() - t0
    files = sorted(os.listdir(exp.config.output_dir))
    want = {f"mnist_out_{i}.csv" for i in range(1, 5)} | {
        f"mnist_test_predictions_{i}.csv" for i in range(1, 5)} | {
        f"mnist_{m}_model.zip" for m in ("dis", "gan", "gen", "CV")}
    history = result["history"]
    if result["iterations"] != 4 or not want <= set(files) or len(history) != 4 or not all(
            np.isfinite([h[k] for k in ("d_loss", "g_loss", "cv_loss")]).all() for h in history):
        raise AssertionError(f"run(): {result['iterations']} iterations, files {files}, history {history}")
    bundle = exp.publish_for_serving(os.path.join(directory, "serving"))["directory"]
    engine = ServingEngine.from_bundle(bundle, device=exp.device)
    rng = np.random.default_rng(SEED)
    z = rng.uniform(-1, 1, (21, 2)).astype(np.float32)
    rows = rng.random((21, 784), dtype=np.float32)
    with torch.no_grad():
        want_sample = exp.gen.output(exp.gen_params, torch.from_numpy(z).to(exp.device))
        want_sample = want_sample.reshape(21, -1).cpu().numpy()
        want_cls = exp.cv.output(exp.cv_state.params, torch.from_numpy(rows).to(exp.device)).cpu().numpy()
    errs = {"sample": float(np.max(np.abs(engine.run("sample", z) - want_sample))),
            "classify": float(np.max(np.abs(engine.run("classify", rows) - want_cls)))}
    if max(errs.values()) > 1e-5:
        raise AssertionError(f"published bundle vs trainer: {errs}")
    row = {"phase": "train_run_publish", "iterations": 4, "run_s": run_s,
           "losses": [[h["d_loss"], h["g_loss"], h["cv_loss"]] for h in history],
           "engine_vs_trainer_max_abs_err": errs, "timings_s": result["timings"], "card": card}
    print(json.dumps(row))
    return row


def _measure_iterations(exp, batches, batch: int, top_n: int, peak=("fp32", FP32_FLOP_PER_S)) -> dict:
    """Steady-state cost of ``exp.train_iteration`` over ``batches`` (30
    ``(x, y)`` pairs): 5 warm iterations, the median of 20 by the host clock
    (with a synchronize) and by CUDA events, peak memory, then a
    ``torch.profiler`` window of 5 iterations tracing the card only
    (device-busy share, kernels per iteration, of which copy kernels (the
    dtype casts among them), the ``top_n`` kernels), and the bound of the
    iteration's FLOPs from shapes at the ``peak`` rate (fp32: 67 TFLOP/s)."""
    from gan_deeplearning4j_tpu_torch.serving.profile import _union_us

    for xb, yb in batches[:5]:
        exp.train_iteration(xb, yb)
    torch.cuda.synchronize()
    gc.collect()
    resident_mib = torch.cuda.memory_allocated() / 2**20
    torch.cuda.reset_peak_memory_stats()
    host_ms, event_ms = [], []
    for xb, yb in batches[5:25]:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        exp.train_iteration(xb, yb)
        end.record()
        torch.cuda.synchronize()
        host_ms.append((time.perf_counter() - t0) * 1e3)
        event_ms.append(start.elapsed_time(end))
    peak_mib = torch.cuda.max_memory_allocated() / 2**20
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for xb, yb in batches[25:30]:
            exp.train_iteration(xb, yb)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans, by_name, launches, copies = [], {}, 0, 0
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        span = (ev.time_range.start, ev.time_range.end)
        spans.append(span)
        if not (ev.name.startswith("Memcpy") or ev.name.startswith("Memset")):
            launches += 1
            copies += "copy" in ev.name
            by_name[ev.name] = by_name.get(ev.name, 0.0) + span[1] - span[0]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:top_n]
    flops = exp.flops_per_iteration(batch)
    median_host, median_event = statistics.median(host_ms), statistics.median(event_ms)
    bound_ms = flops / peak[1] * 1e3
    return {"batch": batch, "iterations_timed": 20,
            "iteration_ms_host_median": median_host,
            "iteration_ms_event_median": median_event,
            "rows_per_s": batch / median_host * 1e3,
            "peak_memory_mib": peak_mib, "resident_before_mib": resident_mib,
            "profiled_iterations": 5,
            "device_busy_share": _union_us(spans) / wall_us,
            "kernels_per_iteration": launches / 5,
            "copy_kernels_per_iteration": copies / 5,
            "top_kernels": [{"name": k[:90], "ms_per_iteration": us / 5 / 1e3} for k, us in top],
            "flops_per_iteration": flops, f"{peak[0]}_bound_ms": bound_ms,
            "roofline_share": bound_ms / median_event}


def _phase_timing(x, y, card: str) -> dict:
    from gan_deeplearning4j_tpu_torch.harness import GanExperiment

    exp = GanExperiment(_config())
    batches = _mnist_batches(x, y, 200, 30)
    measured = _measure_iterations(exp, batches, 200, top_n=10)
    measured["images_per_s"] = measured.pop("rows_per_s")
    # a second window with host activity: the iteration's stages
    # (record_function ranges) by host time and by the device time of
    # their kernels. A replay runs no host code, so this window runs the
    # device body uncaptured
    cpu_cuda = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    exp.graphs.captured = False
    with torch.profiler.profile(activities=cpu_cuda) as prof:
        for xb, yb in batches[25:30]:
            exp.train_iteration(xb, yb)
        torch.cuda.synchronize()
    exp.graphs.captured = True
    stages: dict = {}
    for ev in prof.events():  # the host-side ranges; their kernels' time
        if ev.device_type == torch.autograd.DeviceType.CPU and ev.name.startswith(("iteration.", "step.")):
            stage = stages.setdefault(ev.name, {"host_ms": 0.0, "kernel_ms": 0.0})
            stage["host_ms"] += ev.cpu_time_total / 5 / 1e3
            stage["kernel_ms"] += ev.device_time_total / 5 / 1e3
    row = {"phase": "train_timing", **measured, "stages_per_iteration": stages, "card": card}
    print(json.dumps(row))
    return row


# -- the tabular, image and WGAN-GP families ---------------------------------

#: each family at full width, as the JAX bench runs it (bench.py, configs
#: 2-5): ExperimentConfig overrides
FAMILIES = {
    "tabular": dict(model_family="tabular", num_features=32, z_size=8, height=1, width=1,
                    channels=1),
    "cifar10": dict(model_family="cifar10", height=32, width=32, channels=3,
                    num_features=3072, z_size=64, dataset="cifar_shaped"),
    "celeba64": dict(model_family="celeba64", height=64, width=64, channels=3,
                     num_features=12288, z_size=64),
    "wgan_gp": dict(model_family="wgan_gp", height=32, width=32, channels=3,
                    num_features=3072, z_size=128, n_critic=5, dataset="cifar_shaped"),
}


def _family_experiment(name: str, batch: int, **overrides):
    from gan_deeplearning4j_tpu_torch.harness import make_experiment

    return make_experiment(_config(**FAMILIES[name], batch_size_train=batch, **overrides))


def _family_batches(exp, count: int, batch: int, seed: int = SEED) -> list:
    """``count`` distinct ``(x, y)`` batches of the family's synthetic rows
    (one-hot labels cycling over the classes; only mnist reads them)."""
    x = exp.family.synthetic_data(count * batch, exp.model_cfg, seed)
    y = np.eye(10, dtype=np.float32)[np.arange(count * batch) % 10]
    return [(x[i * batch:(i + 1) * batch], y[i * batch:(i + 1) * batch]) for i in range(count)]


def _leaf_errors(a: dict, b: dict, rounding_only) -> dict:
    """The five leaves furthest apart (normwise, as ``state_divergence``
    reads them) and the share of param elements more than 1e-6 apart."""
    rel, apart, total = {}, 0, 0
    for key, value in a.items():
        if not isinstance(value, torch.Tensor) or not value.numel() or key in rounding_only:
            continue
        diff = (value.cpu().double() - b[key].cpu().double()).abs()
        floor = 1e-5 * diff.numel() ** 0.5
        rel[key] = float(diff.norm()) / max(float(b[key].cpu().double().norm()), floor)
        if "/params/" in key:
            apart += int((diff > 1e-6).sum())
            total += diff.numel()
    worst = sorted(rel.items(), key=lambda kv: -kv[1])[:5]
    return {"worst_leaves": [[k, v] for k, v in worst],
            "param_elements_apart_share": apart / total if total else None}


def _wgan_first_step_grads(exp, xb) -> tuple:
    """Loss and gradients of the first critic step and of a generator step,
    both at the experiment's current state and the round's draws, in the
    experiment's compute dtype."""
    from gan_deeplearning4j_tpu_torch.runtime import compute_dtype_scope

    batches = exp._critic_batches(exp._to_device(xb))
    rows = batches.shape[1]
    zs, epsilons, gen_z = exp._unpack_draws(
        exp._to_device(exp._step_draws(int(exp.gen_state.step), rows)), rows)
    with compute_dtype_scope(exp._compute_dtype):
        c_loss, c_grads = exp.trainer.critic_grads(exp.critic_state.params, exp.gen_state.params,
                                                   batches[0], zs[0], epsilons[0])
        g_loss, g_grads, _ = exp.trainer.gen_grads(exp.gen_state.params, exp.critic_state.params, gen_z)
    return {"critic": float(c_loss), "gen": float(g_loss)}, {"critic": c_grads, "gen": g_grads}


def _phase_family_card_vs_cpu(card: str) -> list:
    """(e) One iteration from the same init and draws on the card and on
    the CPU, held to losses within 1e-4 relative and every leaf within
    5e-3 by ``state_divergence``: for tabular and ``cifar10`` (RmsProp) the
    whole iteration; for ``wgan_gp`` the first critic step and a generator
    step from the same state (losses and gradients). A WGAN-GP round is
    five Adam(β1 = 0) critic steps: each moves every param by about
    ``lr·sign(g)``, so the card's rounding (gradients ~1e-3 apart
    normwise) flips the step of every element whose gradient is that small,
    and the flips feed the next steps' gradients. The round's divergence
    is reported, not held."""
    from gan_deeplearning4j_tpu_torch.harness.experiment import flatten_states, state_divergence

    rows = []
    for name, batch in (("tabular", 256), ("cifar10", 64), ("wgan_gp", 80)):
        gpu = _family_experiment(name, batch)
        cpu = _family_experiment(name, batch, use_accelerator=False)
        (xb, yb), = _family_batches(gpu, 1, batch)
        first_step = {}
        if name == "wgan_gp":
            (lg1, gg1), (lc1, gc1) = _wgan_first_step_grads(gpu, xb), _wgan_first_step_grads(cpu, xb)
            grads = state_divergence(flatten_states(gg1), flatten_states(gc1))
            first_step = {
                "first_step_losses": {k: [lg1[k], lc1[k]] for k in lg1},
                "first_step_losses_max_rel_err": max(abs(lg1[k] - lc1[k]) / abs(lc1[k]) for k in lg1),
                "first_step_grads_max_leaf_rel_err": grads["max_leaf_rel"],
                "first_step_grads_max_abs_err": grads["max_abs"],
                "first_step_grads_worst_leaves": _leaf_errors(
                    flatten_states(gg1), flatten_states(gc1), ())["worst_leaves"],
            }
        lg, lc = gpu.train_iteration(xb, yb), cpu.train_iteration(xb, yb)
        keys = ("d_loss", "g_loss")
        loss_rel = max(abs(float(lg[k]) - float(lc[k])) / abs(float(lc[k])) for k in keys)
        a, b = flatten_states(gpu.digest_states()), flatten_states(cpu.digest_states())
        div = state_divergence(a, b, gpu.rounding_only_keys())
        held = first_step or {"losses_max_rel_err": loss_rel, "max_leaf_rel_err": div["max_leaf_rel"]}
        loss_key = "first_step_losses_max_rel_err" if first_step else "losses_max_rel_err"
        leaf_key = "first_step_grads_max_leaf_rel_err" if first_step else "max_leaf_rel_err"
        row = {"phase": "family_card_vs_cpu", "family": name, "batch": batch,
               "held": [loss_key, leaf_key],
               "losses": {k: [float(lg[k]), float(lc[k])] for k in keys},
               "losses_max_rel_err": loss_rel, "max_abs_err": div["max_abs"],
               "max_leaf_rel_err": div["max_leaf_rel"],
               "rounding_only_leaves": gpu.rounding_only_keys(),
               "rounding_only_max_abs_err": div["rounding_only_max_abs"],
               **_leaf_errors(a, b, gpu.rounding_only_keys()), **first_step, "card": card}
        print(json.dumps(row))
        rows.append(row)
        if held[loss_key] > ITER_LOSS_RTOL or held[leaf_key] > ITER_LEAF_REL:
            raise AssertionError(f"card vs CPU: {row}")
    return rows


def _phase_family_resume(directory: str, card: str) -> list:
    """(f) 2 iterations, save, load into a fresh experiment, 2 more:
    bit-equal to 4 straight iterations; the ops that
    ``use_deterministic_algorithms`` flags meanwhile are listed."""
    rows = []
    for name, batch in (("cifar10", 64), ("wgan_gp", 320)):
        batches = _family_batches(_family_experiment(name, batch), 4, batch)
        checked = _resume_check(lambda: _family_experiment(name, batch), batches,
                                os.path.join(directory, f"resume_{name}"))
        row = {"phase": "family_resume", "family": name, "batch": batch, **checked, "card": card}
        print(json.dumps(row))
        rows.append(row)
        if not checked["bit_exact"]:
            raise AssertionError(f"{name}: resume is not bit-exact on the card: {checked['differing_leaves']}")
    return rows


def _phase_family_run_publish(directory: str, card: str) -> list:
    """(g) ``run()`` of 4 iterations, ``publish_for_serving`` (a
    generator-only bundle), ``ServingEngine`` on the card: ``sample``
    matches the trainer's generator within 1e-5 and there is no
    ``classify``."""
    from gan_deeplearning4j_tpu_torch.data import ArrayDataSetIterator
    from gan_deeplearning4j_tpu_torch.serving import ServingEngine

    rows = []
    for name, batch in (("cifar10", 64), ("wgan_gp", 80)):
        out = os.path.join(directory, f"run_{name}")
        exp = _family_experiment(name, batch, num_iterations=4, save_models=True,
                                 checkpoint_every=4, output_dir=out)
        batches = _family_batches(exp, 4, batch)
        x = np.concatenate([b[0] for b in batches])
        y = np.concatenate([b[1] for b in batches])
        t0 = time.perf_counter()
        result = exp.run(ArrayDataSetIterator(x, y, batch_size=batch))
        run_s = time.perf_counter() - t0
        history = result["history"]
        if result["iterations"] != 4 or len(history) != 4 or not all(
                np.isfinite([h["d_loss"], h["g_loss"]]).all() for h in history):
            raise AssertionError(f"{name} run(): {result['iterations']} iterations, {history}")
        manifest = exp.publish_for_serving(os.path.join(out, "serving"))
        if manifest["classifier"] is not None or manifest.get("zoo", {}).get("dataset") != "cifar_shaped":
            raise AssertionError(f"{name} manifest: {manifest}")
        engine = ServingEngine.from_bundle(manifest["directory"], device=exp.device)
        if engine.kinds != ("sample",):
            raise AssertionError(f"{name}: the bundle serves {engine.kinds}")
        z = np.random.default_rng(SEED).standard_normal((21, exp.model_cfg.z_size)).astype(np.float32)
        with torch.no_grad():
            want = exp.gen.output(exp.gen_params, torch.from_numpy(z).to(exp.device))
            want = want.reshape(21, -1).cpu().numpy()
        got = engine.run("sample", z)
        err = float(np.max(np.abs(got - want)))
        row = {"phase": "family_run_publish", "family": name, "batch": batch, "iterations": 4,
               "run_s": run_s, "losses": [[h["d_loss"], h["g_loss"]] for h in history],
               "engine_kinds": list(engine.kinds), "sample_shape": list(got.shape),
               "zoo": manifest["zoo"], "engine_vs_trainer_max_abs_err": err,
               "timings_s": result["timings"], "card": card}
        print(json.dumps(row))
        rows.append(row)
        if got.shape != (21, exp.config.num_features) or err > 1e-5:
            raise AssertionError(f"{name}: published bundle vs trainer: {row}")
    return rows


def _phase_family_timing(card: str) -> list:
    """(h) fp32 iteration timing at the JAX bench's batches (its configs 2,
    3 and 5 run in bf16, so these are not comparable to BASELINE.md)."""
    rows = []
    for name, batch in (("tabular", 256), ("cifar10", 64), ("celeba64", 64), ("wgan_gp", 320)):
        exp = _family_experiment(name, batch)
        distinct = _family_batches(exp, 4, batch)
        batches = [distinct[i % 4] for i in range(30)]
        row = {"phase": "family_timing", "family": name, "dtype": "fp32",
               **_measure_iterations(exp, batches, batch, top_n=5), "card": card}
        print(json.dumps(row))
        rows.append(row)
        del exp  # an experiment holds a reference cycle (its bound z source)
        gc.collect()
        torch.cuda.empty_cache()
    return rows


# -- bf16: mixed precision and bf16 storage ----------------------------------

#: (i)'s batches: those of (a) and (e)
BF16_BATCHES = {"mnist": 64, "tabular": 256, "cifar10": 64, "wgan_gp": 80}
#: (i)'s bounds, card against CPU after one bf16 iteration, per family:
#: (relative bound on each loss, bound on the params' worst leaf by
#: ``state_divergence``, leaves of one step's size apart). bf16 rounding
#: flips max-pool winners and the sign of RmsProp's ±lr steps where
#: gradients cancel, so these are of the CPU tests' bounds against the JAX
#: package (tests/test_torch_bf16_train.py), not the fp32 phases' 1e-4 /
#: 5e-3.
BF16_ITER_BOUNDS = {
    "mnist": ({"d_loss": 1e-3, "g_loss": 1e-3, "cv_loss": 3e-2}, 0.1),
    "tabular": ({"d_loss": 1e-4, "g_loss": 1e-4}, 0.05),
    "cifar10": ({"d_loss": 1e-3, "g_loss": 1e-3}, 0.06),
}
#: the WGAN-GP first steps' bounds (losses: critic, generator; gradient leaves)
BF16_WGAN_BOUNDS = ({"critic": 1e-3, "gen": 1e-2}, 0.15)


def _params_only(flat: dict) -> dict:
    return {k: v for k, v in flat.items()
            if isinstance(v, torch.Tensor) and v.ndim and "/opt_state/" not in k}


def _step_sized(params: dict, lr: float) -> list:
    """Param leaves no larger than two steps of ``lr`` in every element
    (``‖p‖ ≤ 2·lr·√n``): zero-initialised biases and BatchNorm shifts after
    their first steps. Where their gradients cancel, a rounding difference
    flips the sign of the whole ±lr step, so ``state_divergence`` reports
    them apart (``rounding_only``), held by the step bound alone."""
    return [k for k, v in params.items() if float(v.double().norm()) <= 2 * lr * v.numel() ** 0.5]


def _mnist_experiment(batch: int, **overrides):
    from gan_deeplearning4j_tpu_torch.harness import GanExperiment

    return GanExperiment(_config(batch_size_train=batch, **overrides))


def _phase_bf16_card_vs_cpu(x, y, card: str) -> list:
    """(i) Every family under ``compute_dtype="bf16"``, one iteration from
    the same init and draws on the card (cuDNN bf16 convolutions, the bf16
    GEMM with an fp32 output) and on the CPU (fp32 arithmetic on
    bf16-rounded operands): losses and the params' worst leaf held to
    ``BF16_ITER_BOUNDS`` (leaves of one step's size apart, see
    ``_step_sized``), every param element to 2·lr a step; for
    ``wgan_gp`` the first critic step's and a generator step's losses and
    gradients, the round reported."""
    from gan_deeplearning4j_tpu_torch.harness.experiment import flatten_states, state_divergence
    from gan_deeplearning4j_tpu_torch.ops.linear import dense_route

    rows = []
    for name, batch in BF16_BATCHES.items():
        if name == "mnist":
            gpu = _mnist_experiment(batch, compute_dtype="bf16")
            cpu = _mnist_experiment(batch, compute_dtype="bf16", use_accelerator=False)
            xb, yb = x[:batch], y[:batch]
        else:
            gpu = _family_experiment(name, batch, compute_dtype="bf16")
            cpu = _family_experiment(name, batch, compute_dtype="bf16", use_accelerator=False)
            (xb, yb), = _family_batches(gpu, 1, batch)
        held, first_step = {}, {}
        if name == "wgan_gp":
            (lg1, gg1), (lc1, gc1) = _wgan_first_step_grads(gpu, xb), _wgan_first_step_grads(cpu, xb)
            grads = state_divergence(flatten_states(gg1), flatten_states(gc1))
            loss_rel = {k: abs(lg1[k] - lc1[k]) / abs(lc1[k]) for k in lg1}
            first_step = {"first_step_losses": {k: [lg1[k], lc1[k]] for k in lg1},
                          "first_step_losses_rel_err": loss_rel,
                          "first_step_grads_max_leaf_rel_err": grads["max_leaf_rel"],
                          "first_step_grads_worst_leaves": _leaf_errors(
                              flatten_states(gg1), flatten_states(gc1), ())["worst_leaves"]}
            loss_bounds, leaf_bound = BF16_WGAN_BOUNDS
            held = {"losses": all(loss_rel[k] <= loss_bounds[k] for k in loss_rel),
                    "grads": grads["max_leaf_rel"] <= leaf_bound}
        lg, lc = gpu.train_iteration(xb, yb), cpu.train_iteration(xb, yb)
        keys = ("d_loss", "g_loss") + (("cv_loss",) if name == "mnist" else ())
        rel = {k: abs(float(lg[k]) - float(lc[k])) / abs(float(lc[k])) for k in keys}
        a, b = flatten_states(gpu.digest_states()), flatten_states(cpu.digest_states())
        lr = max(gpu.config.dis_learning_rate, gpu.config.gen_learning_rate)
        step_sized = _step_sized(_params_only(b), lr)
        params = state_divergence(_params_only(a), _params_only(b), step_sized)
        if name != "wgan_gp":
            loss_bounds, leaf_bound = BF16_ITER_BOUNDS[name]
            held = {"losses": all(rel[k] <= loss_bounds[k] for k in keys),
                    "params": params["max_leaf_rel"] <= leaf_bound
                    and max(params["max_abs"], params["rounding_only_max_abs"]) <= 4 * lr}
        row = {"phase": "bf16_card_vs_cpu", "family": name, "batch": batch, "compute_dtype": "bf16",
               "dense_route_card": dense_route(gpu.device), "held": held,
               "losses": {k: [float(lg[k]), float(lc[k])] for k in keys}, "losses_rel_err": rel,
               "params_max_abs_err": params["max_abs"], "params_max_leaf_rel_err": params["max_leaf_rel"],
               "step_sized_leaves": len(step_sized),
               "step_sized_max_abs_err": params["rounding_only_max_abs"],
               "all_leaves_max_leaf_rel_err": state_divergence(a, b)["max_leaf_rel"],
               **_leaf_errors(_params_only(a), _params_only(b), ()), **first_step, "card": card}
        print(json.dumps(row))
        rows.append(row)
        del gpu, cpu
        gc.collect()
    missed = [row["family"] for row in rows if not all(row["held"].values())]
    if missed:
        raise AssertionError(f"bf16 card vs CPU outside the bounds: {missed}")
    return rows


def _phase_bf16_resume(x, y, directory: str, card: str) -> list:
    """(j) Bit-exact resume on the card in bf16 (2 + save + load + 2
    against 4): MNIST b200 and ``cifar10`` b64 under mixed precision, MNIST
    b200 under bf16 storage. A bf16 op that ``use_deterministic_algorithms``
    flags fails the phase: no fallback to fp32 or to the CPU."""
    rows = []
    cases = (("mnist", 200, {"compute_dtype": "bf16"}), ("cifar10", 64, {"compute_dtype": "bf16"}),
             ("mnist", 200, {"param_dtype": "bf16"}))
    for name, batch, dtypes in cases:
        if name == "mnist":
            make = lambda: _mnist_experiment(batch, **dtypes)  # noqa: E731
            batches = _mnist_batches(x, y, batch, 4)
        else:
            make = lambda: _family_experiment(name, batch, **dtypes)  # noqa: E731
            batches = _family_batches(make(), 4, batch)
        mode = "_".join(dtypes)
        checked = _resume_check(make, batches, os.path.join(directory, f"bf16_resume_{name}_{mode}"))
        row = {"phase": "bf16_resume", "family": name, "batch": batch, **dtypes, **checked, "card": card}
        print(json.dumps(row))
        rows.append(row)
        if not checked["bit_exact"] or checked["nondeterministic_ops_flagged"]:
            raise AssertionError(f"bf16 resume on the card: {row}")
        gc.collect()
    return rows


#: (k): a bf16 bundle's outputs against the fp32 bundle's, relative to the
#: largest |fp32 output| of the kind
BF16_SERVE_REL = 5e-2


def _phase_bf16_publish_serve(x, y, bundle_dir: str, directory: str, card: str) -> dict:
    """(k) A ``param_dtype="bf16"`` MNIST run (2 iterations, b64) →
    ``publish_for_serving`` → the engine on the card, computing its bf16
    params in fp32 as the JAX engine does: equal to the trainer's own
    ``gen`` and ``cv`` (fp32 arithmetic) within 1e-5. Then
    ``build_bf16_variant`` of the serving phase's fp32 bundle, served on
    the card: staged ``run`` equals ``run_host`` for every kind and n in
    (1, 3, 8, 21, 130), the rows are within ``BF16_SERVE_REL`` of the fp32
    bundle's on the card (the same bf16 bundle on the CPU is reported), and
    the resident param bytes are half the fp32 bundle's."""
    from gan_deeplearning4j_tpu_torch.quant import build_bf16_variant
    from gan_deeplearning4j_tpu_torch.serving import ServingEngine

    exp = _mnist_experiment(64, param_dtype="bf16", output_dir=os.path.join(directory, "bf16_run"))
    for xb, yb in _mnist_batches(x, y, 64, 2):
        exp.train_iteration(xb, yb)
    manifest = exp.publish_for_serving(os.path.join(directory, "bf16_run", "serving"))
    engine = ServingEngine.from_bundle(manifest["directory"], device=exp.device)
    rng = np.random.default_rng(SEED)
    z = rng.uniform(-1, 1, (21, 2)).astype(np.float32)
    rows = rng.random((21, 784), dtype=np.float32)
    with torch.no_grad():
        want_sample = exp.gen.output(exp.gen_params, torch.from_numpy(z).to(exp.device))
        want_sample = want_sample.reshape(21, -1).cpu().numpy()
        want_cls = exp.cv.output(exp.cv_state.params, torch.from_numpy(rows).to(exp.device)).cpu().numpy()
    storage_errs = {"sample": float(np.max(np.abs(engine.run("sample", z) - want_sample))),
                    "classify": float(np.max(np.abs(engine.run("classify", rows) - want_cls)))}
    leaf_dtypes = sorted({str(t.dtype) for lp in exp.gen_params.values() for t in lp.values()})
    if max(storage_errs.values()) > 1e-5 or leaf_dtypes != ["torch.bfloat16"]:
        raise AssertionError(f"bf16-storage bundle vs trainer: {storage_errs}, {leaf_dtypes}")

    variant = build_bf16_variant(bundle_dir, os.path.join(directory, "bf16_variant"))
    bf16 = ServingEngine.from_bundle(os.path.join(directory, "bf16_variant"), device="cuda")
    bf16_cpu = ServingEngine.from_bundle(os.path.join(directory, "bf16_variant"), device="cpu")
    fp32 = ServingEngine.from_bundle(bundle_dir, device="cuda")
    bf16.warmup()
    rng = np.random.default_rng(SEED)
    vs_fp32, vs_cpu = {}, {}
    for kind in bf16.kinds:
        for n in SIZES:
            rows = _rows(kind, n, rng)
            staged = bf16.run(kind, rows)
            if not np.array_equal(staged, bf16.run_host(kind, rows)) or not np.all(np.isfinite(staged)):
                raise AssertionError(f"bf16 {kind} n={n}: run differs from run_host, or non-finite")
            ref = fp32.run(kind, rows)
            scale = max(float(np.max(np.abs(ref))), 1e-6)
            vs_fp32[kind] = max(vs_fp32.get(kind, 0.0), float(np.max(np.abs(staged - ref))) / scale)
            vs_cpu[kind] = max(vs_cpu.get(kind, 0.0),
                               float(np.max(np.abs(staged - bf16_cpu.run(kind, rows)))) / scale)
    resident = {"bf16": bf16.resident_param_bytes(), "fp32": fp32.resident_param_bytes()}
    row = {"phase": "bf16_publish_serve", "storage_run_engine_vs_trainer_max_abs_err": storage_errs,
           "storage_bundle_leaf_dtypes": leaf_dtypes, "variant_quant": variant["quant"]["method"],
           "variant_stats_precision": bf16.stats()["precision"],
           "variant_vs_fp32_rel_err": vs_fp32, "variant_card_vs_cpu_rel_err": vs_cpu,
           "resident_param_bytes": resident, "serve_compile_counts": bf16.serve_compile_counts,
           "card": card}
    print(json.dumps(row))
    if (max(vs_fp32.values()) > BF16_SERVE_REL or 2 * resident["bf16"] != resident["fp32"]
            or bf16.stats()["precision"] != "bf16" or any(bf16.serve_compile_counts.values())):
        raise AssertionError(f"bf16 variant: {row}")
    return row


def _phase_bf16_timing(x, y, card: str) -> list:
    """(l) Iteration timing under ``compute_dtype="bf16"``, as the JAX bench
    runs its configs 1-5 (bench.py), on one card: MNIST b200 (beside (d)),
    tabular b256 and b4096 (configs 2, 2b), ``cifar10`` b64 (3),
    ``celeba64`` b64 (4), ``wgan_gp`` b320 (5). The roofline share is
    against the dense bf16 tensor-core peak, 989 TFLOP/s (NVIDIA's H100
    SXM data sheet)."""
    from gan_deeplearning4j_tpu_torch.ops.linear import dense_route

    rows = []
    for name, batch in (("mnist", 200), ("tabular", 256), ("tabular", 4096), ("cifar10", 64),
                        ("celeba64", 64), ("wgan_gp", 320)):
        if name == "mnist":
            exp = _mnist_experiment(batch, compute_dtype="bf16")
            batches = _mnist_batches(x, y, batch, 30)
        else:
            exp = _family_experiment(name, batch, compute_dtype="bf16")
            distinct = _family_batches(exp, 4, batch)
            batches = [distinct[i % 4] for i in range(30)]
        row = {"phase": "bf16_timing", "family": name, "compute_dtype": "bf16",
               "dense_route": dense_route(exp.device),
               **_measure_iterations(exp, batches, batch, top_n=5, peak=("bf16", BF16_FLOP_PER_S)),
               "card": card}
        print(json.dumps(row))
        rows.append(row)
        del exp
        gc.collect()
        torch.cuda.empty_cache()
    return rows



# -- captured windows: the port of the JAX package's device loop ---------------

#: (p)'s cases: (family, batch, config overrides)
WINDOW_CASES = (
    ("mnist", 200, {}), ("mnist", 200, {"compute_dtype": "bf16"}),
    ("mnist", 200, {"param_dtype": "bf16"}), ("tabular", 256, {}), ("cifar10", 64, {}),
    ("wgan_gp", 320, {}), ("wgan_gp", 320, {"compute_dtype": "bf16"}),
)
#: (p)'s window, and (q)'s window over one resident batch
WINDOW_K, RESIDENT_K = 8, 16


def _experiment_for(name: str, batch: int, **overrides):
    if name == "mnist":
        return _mnist_experiment(batch, **overrides)
    return _family_experiment(name, batch, **overrides)


def _stacked_batches(exp, name: str, x, y, count: int, batch: int):
    """``count`` batches as ``(count, batch, F)`` features and labels."""
    pairs = _mnist_batches(x, y, batch, count) if name == "mnist" else _family_batches(exp, count, batch)
    return np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])


def _eager_body(exp, feats, labels) -> np.ndarray:
    """The device body applied straight to the trees, uncaptured and with
    no static buffer (the eager iteration): ``(K, 3)`` losses."""
    rows = []
    for k in range(feats.shape[0]):
        inputs = {"features": torch.from_numpy(feats[k]).to(exp.device),
                  "draws": exp._window_draws(1, feats.shape[1])[0]}
        if exp.cv is not None or exp._cond_classes:
            inputs["labels"] = torch.from_numpy(labels[k]).to(exp.device)
        trees, row = exp._body(exp._trees(), inputs)
        exp._set_trees(trees)
        rows.append(row)
    return torch.stack(rows).cpu().numpy()


def _differing_leaves(a, b) -> list:
    """``flatten_states`` keys whose dtype or bits differ between two
    experiments."""
    from gan_deeplearning4j_tpu_torch.harness.experiment import flatten_states

    fa, fb = flatten_states(a.digest_states()), flatten_states(b.digest_states())
    return [k for k in fa if not (fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k])
                                  if isinstance(fa[k], torch.Tensor) else fa[k] == fb[k])]


def _history(result) -> np.ndarray:
    return np.array([[h[k] for k in ("d_loss", "g_loss", "cv_loss")] for h in result["history"]],
                    dtype=np.float32)


def _window_case(name: str, batch: int, dtypes: dict, x, y, directory: str, card: str):
    """One case of (p): 9 iterations from one init and one stream of draws,
    four ways (the eager body; ``train_iteration`` + ``train_iterations``
    over 8; ``run(DeviceResidentIterator)``; ``run()`` with ``prefetch=2``):
    ``(row, ok)``. ``dtypes`` are the case's config overrides."""
    from gan_deeplearning4j_tpu_torch.data import ArrayDataSetIterator, DeviceResidentIterator

    n_it = WINDOW_K + 1
    eager = _experiment_for(name, batch, **dtypes)
    feats, labels = _stacked_batches(eager, name, x, y, n_it, batch)
    want = _eager_body(eager, feats, labels)
    window = _experiment_for(name, batch, **dtypes)
    first = window.train_iteration(feats[0], labels[0])
    rest = window.train_iterations(feats[1:], labels[1:])
    got_window = np.concatenate([
        torch.stack([first[k] for k in ("d_loss", "g_loss", "cv_loss")])[None].cpu().numpy(),
        torch.stack([rest[k] for k in ("d_loss", "g_loss", "cv_loss")], dim=1).cpu().numpy()])
    flat_x, flat_y = feats.reshape(n_it * batch, -1), labels.reshape(n_it * batch, -1)
    runs = {}
    for mode in ("resident", "prefetch"):
        exp = _experiment_for(name, batch, num_iterations=n_it, loss_fetch_every=WINDOW_K,
                              print_every=1000, prefetch=2 if mode == "prefetch" else 0,
                              output_dir=f"{directory}_{mode}", **dtypes)
        it = (DeviceResidentIterator(flat_x, flat_y, batch_size=batch, device=exp.device)
              if mode == "resident" else ArrayDataSetIterator(flat_x, flat_y, batch_size=batch))
        runs[mode] = (exp, _history(exp.run(it)))
    counts = dict(window.graphs.capture_counts)
    window.train_iterations(feats[1:], labels[1:])  # a second window: no capture
    checks = {
        "train_iterations_losses_equal": bool(np.array_equal(got_window, want, equal_nan=True)),
        "run_resident_losses_equal": bool(np.array_equal(runs["resident"][1], want, equal_nan=True)),
        "run_prefetch_history_equal": bool(np.array_equal(runs["prefetch"][1], runs["resident"][1],
                                                          equal_nan=True)),
        "run_resident_leaves_differing": _differing_leaves(runs["resident"][0], eager)[:5],
        "run_prefetch_leaves_differing": _differing_leaves(runs["prefetch"][0], eager)[:5],
        "captures": {m: dict(e.graphs.capture_counts) for m, e in
                     (("train_iterations", window), ("run_resident", runs["resident"][0]),
                      ("run_prefetch", runs["prefetch"][0]))},
        "second_window_captured": window.graphs.capture_counts != counts,
    }
    # the second window: 8 more eager iterations, then every leaf
    eager_more = _eager_body(eager, feats[1:], labels[1:])
    checks["train_iterations_leaves_differing"] = _differing_leaves(window, eager)[:5]
    row = {"phase": "windows", "family": name, "batch": batch, **dtypes, "iterations": n_it,
           "window": WINDOW_K, **checks,
           "entries": window.graphs.entry_stats(), "card": card}
    print(json.dumps(row))
    ok = (checks["train_iterations_losses_equal"] and checks["run_resident_losses_equal"]
          and checks["run_prefetch_history_equal"] and not checks["run_resident_leaves_differing"]
          and not checks["run_prefetch_leaves_differing"]
          and not checks["train_iterations_leaves_differing"] and not checks["second_window_captured"]
          and all(c and set(c.values()) == {1} for c in checks["captures"].values())
          and np.isfinite(eager_more[:, :2]).all())
    del eager, window, runs
    gc.collect()
    torch.cuda.empty_cache()
    return row, ok


def _phase_windows(x, y, directory: str, card: str) -> list:
    """(p) Captured windows against the eager body, bit for bit. For each
    of ``WINDOW_CASES``, from one init and one stream of draws, 9
    iterations four ways: the device body applied eagerly; one
    ``train_iteration`` then ``train_iterations`` over a window of 8 (graph
    replays); ``run(DeviceResidentIterator, loss_fetch_every=8)``, whose
    first iteration ends at the manifold export and whose next 8 are one
    ``next_window`` slice; and ``run()`` with ``prefetch=2`` over an
    ``ArrayDataSetIterator``. Every leaf (dtype and bits) and every loss
    equal; every key captured once, and a second window captures nothing.
    Then the ragged tail: tabular b256 over 640 rows for two epochs, whose
    128-row batch is captured once and replayed, against the eager body on
    the same batches."""
    from gan_deeplearning4j_tpu_torch.data import DeviceResidentIterator

    rows, failed = [], []
    for i, (name, batch, dtypes) in enumerate(WINDOW_CASES):
        row, ok = _window_case(name, batch, dtypes, x, y, os.path.join(directory, f"windows_{i}"), card)
        rows.append(row)
        if not ok:
            failed.append(f"{name} {dtypes}")

    # the ragged last batch of an epoch: 640 rows at 256, two epochs
    batch, n_rows = 256, 640
    ragged = _family_experiment("tabular", batch, num_iterations=6, loss_fetch_every=WINDOW_K,
                                print_every=1000, output_dir=os.path.join(directory, "windows_ragged"))
    xs = ragged.family.synthetic_data(n_rows, ragged.model_cfg, SEED)
    ys = np.eye(10, dtype=np.float32)[np.arange(n_rows) % 10]
    result = ragged.run(DeviceResidentIterator(xs, ys, batch_size=batch, device=ragged.device))
    eager = _family_experiment("tabular", batch)
    want = np.concatenate([_eager_body(eager, xs[lo:lo + batch][None], ys[lo:lo + batch][None])
                           for _ in range(2) for lo in (0, 256, 512)])
    stats = ragged.graphs.entry_stats()
    tail = [v for k, v in stats.items() if k.startswith("features[128, ")]
    row = {"phase": "windows_ragged_tail", "family": "tabular", "batch": batch, "rows": n_rows,
           "iterations": result["iterations"], "losses_equal": bool(np.array_equal(
               _history(result), want, equal_nan=True)),
           "leaves_differing": _differing_leaves(ragged, eager)[:5],
           "captures": dict(ragged.graphs.capture_counts), "entries": stats, "card": card}
    print(json.dumps(row))
    rows.append(row)
    if not (row["losses_equal"] and not row["leaves_differing"] and len(tail) == 1
            and tail[0]["runs"] == 2 and set(row["captures"].values()) == {1}):
        failed.append("ragged tail")
    if failed:
        raise AssertionError(f"captured windows differ from the eager body: {failed}")
    return rows


#: (q)'s cases: the batches of (d), (h) and (l)
#: (q)'s dtypes: fp32 only since (v) joined the run (bf16's captured
#: timing is (l)'s; the uncaptured bf16 pass cost ~75 s of the 157)
CAPTURE_TIMING_DTYPES = ("fp32",)
CAPTURE_TIMING_CASES = (("mnist", 200), ("tabular", 256), ("tabular", 4096), ("cifar10", 64),
                        ("celeba64", 64), ("wgan_gp", 320))
#: host-side calls that put work on the card, as the profiler names them
_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                 "cudaGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync")


def _launch_calls(exp, batches) -> dict:
    """A profiler window over 5 iterations with host activity: the calls
    that launch work (kernels, graphs, copies) per iteration, by name."""
    cpu_cuda = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=cpu_cuda) as prof:
        for xb, yb in batches:
            exp.train_iteration(xb, yb)
        torch.cuda.synchronize()
    calls: dict = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CPU and ev.name in _LAUNCH_CALLS:
            calls[ev.name] = calls.get(ev.name, 0) + 1 / len(batches)
    return calls


def _resident_window_ms(exp, xb, yb) -> dict:
    """A window of ``RESIDENT_K`` iterations over one batch already on the
    card (as bench.py times the JAX scan): host ms with a synchronize and
    CUDA-event ms, per iteration, the median of 3 windows after one; then
    one more window under the profiler (card only): its busy share and
    kernel ms per iteration."""
    from gan_deeplearning4j_tpu_torch.serving.profile import _union_us

    feats = torch.from_numpy(np.stack([xb] * RESIDENT_K)).to(exp.device)
    labels = torch.from_numpy(np.stack([yb] * RESIDENT_K)).to(exp.device)
    exp.train_iterations(feats, labels)
    torch.cuda.synchronize()
    host, event = [], []
    for _ in range(3):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        exp.train_iterations(feats, labels)
        end.record()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3 / RESIDENT_K)
        event.append(start.elapsed_time(end) / RESIDENT_K)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        exp.train_iterations(feats, labels)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = [(ev.time_range.start, ev.time_range.end) for ev in prof.events()
             if ev.device_type == torch.autograd.DeviceType.CUDA]
    return {"host_ms_per_iteration": statistics.median(host),
            "event_ms_per_iteration": statistics.median(event),
            "profiled_busy_share": _union_us(spans) / wall_us,
            "profiled_kernel_ms_per_iteration": _union_us(spans) / RESIDENT_K / 1e3}


def _host_split(exp, batches) -> dict:
    """Host ms per ``train_iteration`` call (one per batch, each followed by
    a synchronize outside the clock), split by wrapping its pieces: the
    window's draws (drawn on the host, pinned, copied), the runner
    (``graphs.run``: bookkeeping, input copies, the replay, the loss copy),
    and inside it the graph launch itself; the rest is the batch's copy to
    the card."""
    spent = {"call": 0.0, "draws": 0.0, "runner": 0.0, "graph_launch": 0.0}

    def timed(key, fn):
        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                spent[key] += time.perf_counter() - t0
        return wrapper

    real_replay = torch.cuda.CUDAGraph.replay
    exp._window_draws = timed("draws", exp._window_draws)
    exp.graphs.run = timed("runner", exp.graphs.run)
    torch.cuda.CUDAGraph.replay = timed("graph_launch", real_replay)
    try:
        for xb, yb in batches:
            t0 = time.perf_counter()
            exp.train_iteration(xb, yb)
            spent["call"] += time.perf_counter() - t0
            torch.cuda.synchronize()
    finally:
        torch.cuda.CUDAGraph.replay = real_replay
        del exp._window_draws, exp.graphs.run
    out = {k: v / len(batches) * 1e3 for k, v in spent.items()}
    out["batch_to_device_and_rest"] = out["call"] - out["draws"] - out["runner"]
    return out


def _phase_capture_timing(x, y, card: str) -> list:
    """(q) The iteration uncaptured (the device body launched op by op on
    the card, ``graphs.captured = False``) against captured (one graph
    replay and its copies), in the same call, back to back, at the batches
    of (d), (h) and (l), in ``CAPTURE_TIMING_DTYPES``: the first call's seconds
    (for captured: warmup and capture of the init and steady entries),
    host and CUDA-event ms, rows/s, busy share, kernels per iteration,
    launch calls per iteration, peak memory, each entry's private pool,
    and for captured calls a window of 16 over one resident batch (timed,
    then profiled) and the host time split into draws, runner and graph
    launch."""
    rows = []
    for dtype in CAPTURE_TIMING_DTYPES:
        dtypes = {"compute_dtype": "bf16"} if dtype == "bf16" else {}
        for name, batch in CAPTURE_TIMING_CASES:
            pair = {}
            for mode in ("uncaptured", "captured"):
                exp = _experiment_for(name, batch, **dtypes)
                exp.graphs.captured = mode == "captured"
                if name == "mnist":
                    batches = _mnist_batches(x, y, batch, 35)
                else:
                    distinct = _family_batches(exp, 4, batch)
                    batches = [distinct[i % 4] for i in range(35)]
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                exp.train_iteration(*batches[0])
                exp.train_iteration(*batches[1])
                torch.cuda.synchronize()
                first_two_s = time.perf_counter() - t0
                peak = ("bf16", BF16_FLOP_PER_S) if dtype == "bf16" else ("fp32", FP32_FLOP_PER_S)
                measured = _measure_iterations(exp, batches[2:32], batch, top_n=3, peak=peak)
                runs0 = exp.graphs.runs
                calls = _launch_calls(exp, batches[30:35])
                graph_launches = (exp.graphs.runs - runs0) / 5 if exp.graphs.captured else 0.0
                if exp.graphs.captured:
                    measured["host_ms_split"] = _host_split(exp, batches[30:35])
                pair[mode] = {
                    "first_two_iterations_s": first_two_s, **measured,
                    "launch_calls_per_iteration": calls,
                    "launch_calls_total_per_iteration": sum(calls.values()),
                    "graph_launches_per_iteration": graph_launches,
                    # uncaptured, the window is the same eager iterations
                    # again: only the captured one is timed
                    "resident_window": _resident_window_ms(exp, *batches[0]) if exp.graphs.captured else None,
                    "captures": dict(exp.graphs.capture_counts),
                    "entries": exp.graphs.entry_stats(),
                }
                del exp
                gc.collect()
                torch.cuda.empty_cache()
            row = {"phase": "capture_timing", "family": name, "batch": batch, "dtype": dtype,
                   "host_ms_uncaptured_to_captured": [pair["uncaptured"]["iteration_ms_host_median"],
                                                      pair["captured"]["iteration_ms_host_median"]],
                   **pair, "card": card}
            print(json.dumps(row))
            rows.append(row)
            if any(v != 1 for v in pair["captured"]["captures"].values()) or not pair["captured"]["captures"]:
                raise AssertionError(f"(q) {name} {dtype}: captures {pair['captured']['captures']}")
    return rows


# -- int8: the quant_dense kernel, int8 bundles served, cost and canary -------

#: H100 SXM data sheet: HBM3 rate, dense int8 tensor-core rate (no sparsity)
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
#: n of (m)'s kernel-against-plain checks, and of the timings
QUANT_SIZES = (1, 3, 8, 21, 32, 128)
#: graph replays of (m)'s timings: launches captured per graph, replays timed
GRAPH_LAUNCHES, GRAPH_REPLAYS = 20, 10
#: bytes written before each call of a cold timing: 2.5x the H100's 50 MB
#: L2, so the call reads its operands from HBM, as the bound assumes
L2_FLUSH_BYTES = 128 << 20
#: (n) drift of the int8 variant from the fp32 bundle, relative to the
#: largest |fp32 output| of the kind
INT8_SERVE_REL = 5e-2
#: the full-width int8 bundle's resident param bytes (BENCH_quant_r01.json)
INT8_RESIDENT, FP32_RESIDENT = 28_694_660, 32_260_188


def _graph_ms(fn, cold: bool = False) -> float:
    """Device time of one call of ``fn``: ``GRAPH_LAUNCHES`` calls captured
    in one CUDA graph, replayed ``GRAPH_REPLAYS`` times between two CUDA
    events (the host's launch cost is out of the measurement). Warm, the
    operands stay in the 50 MB L2 between calls. ``cold``: each call comes
    after an ``L2_FLUSH_BYTES`` fill, so its operands come from HBM; the
    time is that of fill and call less that of the fill alone."""
    if cold:
        scratch = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device="cuda")
        both = _graph_ms(lambda: (scratch.zero_(), fn()))
        return both - _graph_ms(scratch.zero_)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_LAUNCHES):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(GRAPH_REPLAYS):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (GRAPH_LAUNCHES * GRAPH_REPLAYS)


def _quant_bound(n: int, k: int, m: int, with_bias: bool) -> dict:
    """The least time an H100 could take for one quant_dense call: x (fp32)
    and W_q (int8) read once, w_scale and b (fp32) read once, y (fp32)
    written once, at 3.35 TB/s; 2·n·k·m int8 operations at 1,979 TOP/s."""
    moved = n * k * 4 + k * m + m * 4 * (2 if with_bias else 1) + n * m * 4
    ops = 2 * n * k * m
    bytes_ms, ops_ms = moved / HBM_BYTES_PER_S * 1e3, ops / INT8_OPS_PER_S * 1e3
    return {"bytes": moved, "int8_ops": ops, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def _ptxas_by_kernel(log: str) -> dict:
    """What ``ptxas -v`` said of each instance of the kernel (``nt`` =
    8-row groups per row tile): registers, static shared memory and spill
    bytes. The kernel's shared memory is dynamic: the plan's
    ``smem_bytes``."""
    out, current = {}, None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '.*quant_dense_kernelILi(\d+)E", line)
        if entry:
            current = out.setdefault(f"nt={entry.group(1)}", {})
        elif current is not None and "spill stores" in line:
            stores, loads = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line).groups()
            current.update(spill_store_bytes=int(stores), spill_load_bytes=int(loads))
        elif current is not None and "Used" in line and "registers" in line:
            current["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            current["static_smem_bytes"] = int(smem.group(1)) if smem else 0
    return out


def _quant_inputs(k: int, act_scale: float, n: int, rng):
    """``(x, half codes per row)``: (n, k) float32 rows uniform over
    ±1.2·127·act_scale (past the clip in 1/6 of the range), each row also
    holding values exactly on half codes (x·float32(1/act_scale) == m + 0.5
    in float32) and far past ±127·act_scale."""
    a32, inv = np.float32(act_scale), np.float32(1.0 / act_scale)
    x = (rng.uniform(-1.2, 1.2, (n, k)) * 127 * act_scale).astype(np.float32)
    halves = []
    for code in range(-127, 127):
        cand = np.float32((code + 0.5) * act_scale)
        for _ in range(4):
            if np.float32(cand * inv) == np.float32(code + 0.5):
                halves.append(cand)
                break
            cand = np.nextafter(cand, np.float32(np.inf) if cand * inv < code + 0.5 else np.float32(-np.inf))
    halves = np.array(halves, np.float32)
    extremes = np.array([1.0001, 1.5, 3.0, 1e6], np.float32) * np.float32(127) * a32
    special = np.concatenate([halves, extremes, -extremes])
    for i in range(n):
        x[i, : min(k, special.size)] = np.roll(special, i)[:k]
    return x, halves.size


def _phase_quant_kernel(fp32_dir: str, int8_dir: str, card: str) -> dict:
    """(m) The hand-written ``quant_dense`` kernel against its plain PyTorch
    version on the card, at both quantized layers of the int8 bundle
    (``dis_dense_layer_6``: 1152 → 1024, ``dis_output_layer_7``: 1024 → 10)
    and n in ``QUANT_SIZES``, on inputs with half codes and values past the
    clip: equal bit for bit. Then, per shape, device times by CUDA-graph
    replay (``_graph_ms``) of the kernel, the plain version, ``torch._int_mm``
    with the same quantize and dequantize in torch ops (where ``_int_mm``
    takes the shape), and the fp32 ``torch.addmm`` of the float layer int8
    replaces, each with its operands cold in HBM (``cold=True``), beside the
    bound, which assumes HBM; and the kernel's time with its operands warm
    in L2, and its eager time per call (CUDA events around one launch, the
    host's launch cost included). Each row carries the shape's launch plan;
    the phase carries ``ptxas``'s registers, static shared memory and
    spills per kernel instance (``_ptxas_by_kernel``)."""
    from gan_deeplearning4j_tpu_torch.ops import _native, linear
    from gan_deeplearning4j_tpu_torch.utils.serializer import read_model

    qgraph, qparams, _, _ = read_model(os.path.join(int8_dir, "cv.zip"), device="cuda")
    _, fparams, _, _ = read_model(os.path.join(fp32_dir, "cv.zip"), device="cuda")
    rng = np.random.default_rng(SEED)
    rows, worst = [], 0.0
    for name in ("dis_dense_layer_6", "dis_output_layer_7"):
        layer, p = qgraph.vertex(name).layer, qparams[name]
        a = float(layer.act_scale)
        k, m = p["W_q"].shape
        w_col_major = p["W_q"].t().contiguous().t()
        for n in QUANT_SIZES:
            host_x, n_halves = _quant_inputs(k, a, n, rng)
            x = torch.from_numpy(host_x).cuda()
            y = linear.quant_dense(x, p["W_q"], p["w_scale"], p["b"], a)
            plain = linear.quant_dense_plain(x, p["W_q"], p["w_scale"], p["b"], a)
            torch.cuda.synchronize()
            err = float((y - plain).abs().max())
            if not torch.equal(y, plain) or y.shape != (n, m):
                raise AssertionError(f"quant_dense {name} n={n}: kernel differs from plain by {err}")
            worst = max(worst, err)
            codes = linear.quantize_activations(x, a)
            lib_ms, lib_note = None, None

            def library(w=p["W_q"]):
                acc = torch._int_mm(linear.quantize_activations(x, a), w)
                scale = p["w_scale"] * torch.full((), a, dtype=torch.float32, device=x.device)
                return acc.to(torch.float32) * scale + p["b"]

            for w, layout in ((p["W_q"], "row-major"), (w_col_major, "column-major")):
                try:
                    lib_y = library(w)
                    torch.cuda.synchronize()
                except RuntimeError as exc:
                    lib_note = f"_int_mm refuses ({layout} W_q): {str(exc).splitlines()[0][:160]}"
                    continue
                if not torch.equal(lib_y, plain):
                    raise AssertionError(f"_int_mm yardstick {name} n={n} differs from plain")
                lib_ms, lib_note = _graph_ms(lambda w=w: library(w), cold=True), f"_int_mm, {layout} W_q"
                break
            w_f32, b_f32 = fparams[name]["W"], fparams[name]["b"]
            bound = _quant_bound(n, k, m, with_bias=True)

            def kernel():
                return linear.quant_dense(x, p["W_q"], p["w_scale"], p["b"], a)

            plan = linear.quant_dense_plan(n, k, m)
            row = {"layer": name, "n": n, "in": k, "out": m, "act_scale": a,
                   "plan": {**dataclasses.asdict(plan), "ctas": plan.ctas},
                   "half_code_inputs_per_row": n_halves,
                   "codes_at_clip": int((codes.abs() == 127).sum()),
                   "max_abs_err_vs_plain": err,
                   "kernel_ms": _graph_ms(kernel, cold=True),
                   "kernel_l2_warm_ms": _graph_ms(kernel),
                   "kernel_eager_ms": _event_median_ms(kernel),
                   "plain_ms": _graph_ms(lambda: linear.quant_dense_plain(x, p["W_q"], p["w_scale"], p["b"], a),
                                         cold=True),
                   "library_ms": lib_ms, "library": lib_note,
                   "addmm_fp32_ms": _graph_ms(lambda: torch.addmm(b_f32, x, w_f32), cold=True),
                   **bound}
            row["kernel_share_of_bound"] = row["bound_ms"] / row["kernel_ms"]
            rows.append(row)
    out = {"phase": "quant_kernel", "shapes": rows, "max_abs_err": worst, "tolerance": "bit-equal",
           "ptxas": _ptxas_by_kernel(_native.build_log()), "card": card}
    print(json.dumps({"phase": "quant_kernel_ptxas", "ptxas": out["ptxas"], "card": card}))
    for row in rows:
        print(json.dumps({"phase": "quant_kernel", **row, "card": card}))
    return out


@functools.lru_cache(maxsize=None)
def _code_step(bundle_dir: str) -> float:
    """The most one moved activation code can change a quantized layer's
    output by: max over the int8 classifier's layers of
    127 · max(w_scale) · act_scale."""
    from gan_deeplearning4j_tpu_torch.quant import QuantDenseLayer
    from gan_deeplearning4j_tpu_torch.utils.serializer import read_model

    graph, params, _, _ = read_model(os.path.join(bundle_dir, "cv.zip"), device="cpu")
    return max(127.0 * float(params[v.name]["w_scale"].max()) * v.layer.act_scale
               for v in graph.vertices if isinstance(v.layer, QuantDenseLayer))


#: the profiler range each dense vertex's apply runs in, inside
#: ``_serving_breakdown``'s second window only
DENSE_RANGE = "chip_smoke.dense_vertex"


@contextlib.contextmanager
def _dense_ranges():
    """While the block is open, every dense vertex's apply (``DenseLayer``,
    ``OutputLayer``, ``QuantDenseLayer``) runs inside a
    ``record_function(DENSE_RANGE)`` range. The served path carries no range
    outside the block."""
    from gan_deeplearning4j_tpu_torch.nn.layers import DenseLayer
    from gan_deeplearning4j_tpu_torch.quant import QuantDenseLayer

    saved = {cls: cls.__dict__["apply"] for cls in (DenseLayer, QuantDenseLayer)}

    def ranged(apply):
        def apply_in_range(self, *args, **kwargs):
            with torch.profiler.record_function(DENSE_RANGE):
                return apply(self, *args, **kwargs)
        return apply_in_range

    try:
        for cls, apply in saved.items():
            cls.apply = ranged(apply)
        yield
    finally:
        for cls, apply in saved.items():
            cls.apply = apply


def _range_kernels(event) -> list:
    """The device kernels that the profiler links to a CPU-side event and its
    children, as ``(name, µs)``; copies, fills, the range's own device
    annotation and ``quant_dense`` left out (``_serving_breakdown`` counts
    that one from its device events)."""
    out = [(k.name, k.duration) for k in event.kernels
           if k.name != DENSE_RANGE and "quant_dense" not in k.name
           and not k.name.startswith(("Memcpy", "Memset"))]
    for child in event.cpu_children:
        out += _range_kernels(child)
    return out


def _serving_breakdown(engines: dict, runs: int = 10) -> list:
    """Per engine (fp32 / int8), kind (``classify``, ``features``) and bucket
    of the ladder: ``engine.run``'s median time by CUDA events, taken in
    turns (fp32, int8, int8, fp32); then a ``torch.profiler`` window of
    ``runs`` runs at each bucket tracing the card only: device-busy share,
    kernels per run, and the device ms per run of the quant_dense kernel.
    Then a second window, tracing host and card, with every dense vertex in
    a ``DENSE_RANGE`` range (``_dense_ranges``): the device ms per run of
    the kernels launched inside the ranges, i.e. of the two dense vertices
    (their product, bias and activation), fp32 against int8, and how many
    kernels that is per run. A replay runs no host code, so this window
    runs the forward uncaptured (``engine.captured = False``)."""
    from gan_deeplearning4j_tpu_torch.serving.profile import _union_us

    rng = np.random.default_rng(SEED)
    out = []
    for kind in ("classify", "features"):
        for bucket in engines["fp32"].buckets:
            rows = _rows(kind, bucket, rng)
            row = {"kind": kind, "bucket": bucket}
            for name in ("fp32", "int8", "int8", "fp32"):
                ms = _event_median_ms(lambda e=engines[name]: e.run(kind, rows))
                row.setdefault(f"{name}_run_ms", []).append(ms)
            for name, engine in engines.items():
                row[f"{name}_run_ms"] = statistics.median(row[f"{name}_run_ms"])
                with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    for _ in range(runs):
                        engine.run(kind, rows)
                    wall_us = (time.perf_counter() - t0) * 1e6
                spans, quant_us, launches = [], 0.0, 0
                for ev in prof.events():
                    if ev.device_type != torch.autograd.DeviceType.CUDA:
                        continue
                    spans.append((ev.time_range.start, ev.time_range.end))
                    us = ev.time_range.end - ev.time_range.start
                    if not (ev.name.startswith("Memcpy") or ev.name.startswith("Memset")):
                        launches += 1
                        quant_us += us if "quant_dense" in ev.name else 0.0
                row[f"{name}_device_busy_share"] = _union_us(spans) / wall_us
                row[f"{name}_kernels_per_run"] = launches / runs
                row[f"{name}_quant_dense_ms_per_run"] = quant_us / runs / 1e3
                engine.captured = False
                try:
                    with _dense_ranges(), torch.profiler.profile(activities=[
                            torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]) as prof:
                        for _ in range(runs):
                            engine.run(kind, rows)
                finally:
                    engine.captured = True
                events = prof.events()
                kernels = [k for ev in events
                           if ev.name == DENSE_RANGE and ev.device_type == torch.autograd.DeviceType.CPU
                           for k in _range_kernels(ev)]
                # the profiler links a kernel to a range through the aten op
                # that launched it; quant_dense is launched through ctypes, by
                # no op, so it is linked to none. Only the dense ranges launch
                # it, so its device events are all theirs.
                kernels += [(ev.name, ev.time_range.end - ev.time_range.start) for ev in events
                            if ev.device_type == torch.autograd.DeviceType.CUDA and "quant_dense" in ev.name]
                row[f"{name}_dense_layers_ms_per_run"] = sum(us for _, us in kernels) / runs / 1e3
                row[f"{name}_dense_layers_kernels_per_run"] = len(kernels) / runs
                row[f"{name}_dense_layers_kernel_names"] = sorted({k for k, _ in kernels})
            out.append(row)
    return out


def _phase_int8_serve(fp32_dir: str, int8_dir: str, card: str) -> dict:
    """(n) The main path of the int8 slice: ``ServingEngine.from_bundle`` of
    the int8 variant on the card, warmed up, serving ``classify`` and
    ``features`` through the kernel at the ladder (1, 8, 32, 128), and one
    HTTP ``classify``. The kernel's launch count is zeroed just before and
    read just after: the wrapper's count (warmup's forward runs and captures,
    ``run_host``) plus the replays' (``engine.kernel_launches()``: replays ×
    launches captured per graph). Checks: staged ``run`` equals
    ``run_host``; no capture after warmup; every run replays the kernel
    twice per chunk (two quantized layers); the card against a CPU engine of
    the same bundle for
    n in (1, 3, 8, 21, 130) within ``CPU_TOL`` + two code steps
    (``_code_step``: the card's float32 convolutions differ from the CPU's in
    the last ulp, which moves an activation code wherever x / act_scale lies
    that close to a half code); resident bytes exactly 28,694,660; the
    generator checkpoint byte-identical to the source's; the drift from the
    fp32 bundle within ``INT8_SERVE_REL`` of the largest output. Then
    ``_serving_breakdown`` against the fp32 bundle's engine."""
    from gan_deeplearning4j_tpu_torch.ops import linear
    from gan_deeplearning4j_tpu_torch.serving import InferenceService, ServingEngine, make_server
    from gan_deeplearning4j_tpu_torch.serving.engine import WARMUP_RUNS

    linear.KERNEL_LAUNCHES["quant_dense"] = 0
    engine = ServingEngine.from_bundle(int8_dir, device="cuda")
    engine.warmup()
    warm_launches = linear.KERNEL_LAUNCHES["quant_dense"]

    def replayed():
        return engine.kernel_launches().get("quant_dense", 0)

    cpu = ServingEngine.from_bundle(int8_dir, device="cpu")
    fp32 = ServingEngine.from_bundle(fp32_dir, device="cuda")
    tol = CPU_TOL + 2.0 * _code_step(int8_dir)
    rng = np.random.default_rng(SEED)
    vs_cpu, vs_fp32, per_run = {}, {}, set()
    for kind in ("classify", "features"):
        for n in SIZES:
            rows = _rows(kind, n, rng)
            before = replayed()
            staged = engine.run(kind, rows)
            per_run.add((replayed() - before) / -(-n // engine.buckets[-1]))
            if not np.array_equal(staged, engine.run_host(kind, rows)) or not np.all(np.isfinite(staged)):
                raise AssertionError(f"int8 {kind} n={n}: run differs from run_host, or non-finite")
            ref = cpu.run_host(kind, rows)
            if staged.shape != ref.shape:
                raise AssertionError(f"int8 {kind} n={n}: shape {staged.shape} vs {ref.shape}")
            vs_cpu[kind] = max(vs_cpu.get(kind, 0.0), float(np.max(np.abs(staged - ref))))
            want = fp32.run(kind, rows)
            scale = max(float(np.max(np.abs(want))), 1e-6)
            vs_fp32[kind] = max(vs_fp32.get(kind, 0.0), float(np.max(np.abs(staged - want))) / scale)
    service = InferenceService(engine, warmup="sync")
    server = make_server(service, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        rows = _rows("classify", 5, np.random.default_rng(SEED + 1))
        status, body, http_s = _post(f"http://127.0.0.1:{server.server_address[1]}", "classify", rows)
    finally:
        server.shutdown()
        server.server_close()
        service.close()
        thread.join(timeout=30)
    launches = linear.KERNEL_LAUNCHES["quant_dense"] + replayed()
    breakdown = _serving_breakdown({"fp32": fp32, "int8": engine})
    http_rows = np.asarray(body.get("data"))
    with open(os.path.join(fp32_dir, "gen.zip"), "rb") as a, open(os.path.join(int8_dir, "gen.zip"), "rb") as b:
        generator_identical = a.read() == b.read()
    resident = {"int8": engine.resident_param_bytes(), "fp32": fp32.resident_param_bytes()}
    row = {"phase": "int8_serve", "kernel_launches": launches, "warmup_launches": warm_launches,
           "launches_per_run_chunk": sorted(per_run), "card_vs_cpu_max_abs_err": vs_cpu,
           "card_vs_cpu_tolerance": tol, "drift_vs_fp32_rel": vs_fp32,
           "resident_param_bytes": resident, "generator_byte_identical": generator_identical,
           "precision": engine.stats()["precision"], "serve_compile_counts": engine.serve_compile_counts,
           "http_classify": {"status": status, "shape": list(http_rows.shape), "ms": http_s * 1e3},
           "card": card}
    print(json.dumps(row))
    for line in breakdown:
        print(json.dumps({"phase": "int8_serve_breakdown", **line, "card": card}))
    row["breakdown"] = breakdown
    ranged = [(line[f"{name}_dense_layers_kernels_per_run"], line[f"{name}_dense_layers_kernel_names"])
              for line in breakdown for name in ("fp32", "int8")]
    if any(count < 2 for count, _ in ranged) or any(
            not any("quant_dense" in k for k in line["int8_dense_layers_kernel_names"]) for line in breakdown):
        raise AssertionError(f"int8 serving: the dense-vertex ranges hold too few kernels: {ranged}")
    if (per_run != {2.0} or warm_launches != (WARMUP_RUNS + 1) * 2 * len(engine.buckets) * 2
            or launches <= warm_launches
            or max(vs_cpu.values()) > tol or max(vs_fp32.values()) > INT8_SERVE_REL
            or resident != {"int8": INT8_RESIDENT, "fp32": FP32_RESIDENT} or not generator_identical
            or row["precision"] != "int8" or any(engine.serve_compile_counts.values())
            or status != 200 or http_rows.shape != (5, 10)
            or np.max(np.abs(http_rows.sum(axis=1) - 1.0)) > 1e-5):
        raise AssertionError(f"int8 serving: {row}")
    return row


def _confident_dense_bundle(directory: str) -> str:
    """The tiny fp32 bundle of tests/test_quant.py's canary cases: a dense
    generator (4 → 8 → 6) and classifier (6 → 5 → 3) whose 2-D weights are
    drawn wide (numpy, seed 7, × 2), so int8 rounding flips no argmax, and a
    calibration on rows × 1e9 zeroes every code of its first layer."""
    from gan_deeplearning4j_tpu_torch.nn import DenseLayer, GraphBuilder, GraphConfig, InputType, OutputLayer
    from gan_deeplearning4j_tpu_torch.utils import write_model

    os.makedirs(directory, exist_ok=True)
    g = GraphBuilder(GraphConfig(seed=1))
    g.add_inputs("z").set_input_types(InputType.feed_forward(4))
    g.add_layer("g_dense_1", DenseLayer(n_out=8, activation="tanh"), "z")
    g.add_layer("g_out", OutputLayer(n_out=6, activation="sigmoid", loss="xent"), "g_dense_1")
    g.set_outputs("g_out")
    gen = g.build()
    c = GraphBuilder(GraphConfig(seed=2))
    c.add_inputs("x").set_input_types(InputType.feed_forward(6))
    c.add_layer("feat_1", DenseLayer(n_out=5, activation="tanh"), "x")
    c.add_layer("cv_out", OutputLayer(n_out=3, activation="softmax", loss="mcxent"), "feat_1")
    c.set_outputs("cv_out")
    cv = c.build()
    rng = np.random.default_rng(7)
    cv_params = {layer: {k: (torch.from_numpy(rng.standard_normal(tuple(t.shape)).astype(np.float32) * 2.0)
                             if t.dim() == 2 else t) for k, t in sorted(leaves.items())}
                 for layer, leaves in sorted(cv.init(device="cpu").items())}
    write_model(os.path.join(directory, "gen.zip"), gen, gen.init(device="cpu"), save_updater=False)
    write_model(os.path.join(directory, "cv.zip"), cv, cv_params, save_updater=False)
    with open(os.path.join(directory, "serving.json"), "w") as fh:
        json.dump({"format_version": 1, "generator": "gen.zip", "classifier": "cv.zip",
                   "feature_vertex": "feat_1", "generation": 0, "step": 0}, fh)
    return directory


def _phase_cost_and_canary(fp32_dir: str, int8_dir: str, directory: str, card: str) -> dict:
    """(o) ``measure_bundle_cost`` of the fp32 bundle and its bf16 and int8
    variants on the card (ladder (1, 8, 32, 128), min of 5 rounds): the
    resident-bytes ratios are exactly 0.5 and 28,694,660 / 32,260,188, and
    the cost ratios are recorded. Then ``CanaryGate`` (256 seeded samples)
    against the fp32 incumbent, with labels from the incumbent on
    synthetic rows: it admits the bf16 and int8 variants of the full-width
    bundle; and on the tiny dense bundle of tests/test_quant.py, served on
    the card, it admits the sane int8 variant and rejects the one calibrated
    on rows × 1e9, with "accuracy" in the reason. (On the full-width
    classifier rows × 1e9 reach no dense layer: its tanh convolutions
    saturate; that variant's decision is recorded, not gated.)"""
    from gan_deeplearning4j_tpu_torch.data import synthetic_mnist
    from gan_deeplearning4j_tpu_torch.deploy import CanaryGate
    from gan_deeplearning4j_tpu_torch.quant import build_bf16_variant, build_int8_variant, measure_bundle_cost
    from gan_deeplearning4j_tpu_torch.serving import ServingEngine

    bf16_dir = os.path.join(directory, "cost_bf16")
    build_bf16_variant(fp32_dir, bf16_dir)
    costs = {name: measure_bundle_cost(d, device="cuda")
             for name, d in (("fp32", fp32_dir), ("bf16", bf16_dir), ("int8", int8_dir))}
    ratios = {name: {"bytes_ratio": costs[name]["resident_param_bytes"] / costs["fp32"]["resident_param_bytes"],
                     "cost_ratio": costs[name]["scalar"] / costs["fp32"]["scalar"],
                     "per_row_s_ratio": costs[name]["per_row_s"] / costs["fp32"]["per_row_s"]}
              for name in ("bf16", "int8")}

    def decide(candidate_dir, incumbent_dir, rows, labels):
        incumbent = ServingEngine.from_bundle(incumbent_dir, device="cuda", export_gauge=False)
        candidate = ServingEngine.from_bundle(candidate_dir, device="cuda", export_gauge=False)
        gate = CanaryGate(rows, labels, num_samples=256, seed=SEED)
        decision = gate.evaluate(candidate, incumbent)
        return {"passed": decision.passed, "reason": decision.reason,
                "candidate": decision.candidate, "incumbent": decision.incumbent}

    (rows, _), _ = synthetic_mnist(num_train=64, num_test=1, seed=SEED)
    fp32 = ServingEngine.from_bundle(fp32_dir, device="cuda", export_gauge=False)
    labels = np.argmax(fp32.run("classify", rows), axis=1)
    degraded_full = os.path.join(directory, "int8_rows_x1e9")
    build_int8_variant(fp32_dir, degraded_full, calibration_rows=rows * 1e9)
    full = {"bf16": decide(bf16_dir, fp32_dir, rows, labels),
            "int8": decide(int8_dir, fp32_dir, rows, labels),
            "int8_rows_x1e9": decide(degraded_full, fp32_dir, rows, labels)}

    tiny = _confident_dense_bundle(os.path.join(directory, "tiny_fp32"))
    tiny_rows = np.random.default_rng(11).random((48, 6)).astype(np.float32)
    tiny_labels = np.argmax(ServingEngine.from_bundle(tiny, device="cuda").run("classify", tiny_rows), axis=1)
    build_int8_variant(tiny, os.path.join(directory, "tiny_int8"), calibration_rows=tiny_rows)
    build_int8_variant(tiny, os.path.join(directory, "tiny_int8_x1e9"), calibration_rows=tiny_rows * 1e9)
    small = {"int8": decide(os.path.join(directory, "tiny_int8"), tiny, tiny_rows, tiny_labels),
             "int8_rows_x1e9": decide(os.path.join(directory, "tiny_int8_x1e9"), tiny, tiny_rows, tiny_labels)}
    row = {"phase": "cost_and_canary",
           "cost": {name: {k: costs[name][k] for k in ("scalar", "per_row_s", "per_bucket_s",
                                                         "resident_param_bytes", "precision", "platform")}
                    for name in costs},
           "ratios": ratios, "canary_full_width": full, "canary_tiny_dense": small,
           "tiny_label_counts": np.bincount(tiny_labels, minlength=3).tolist(), "card": card}
    print(json.dumps(row))
    if (ratios["bf16"]["bytes_ratio"] != 0.5 or ratios["int8"]["bytes_ratio"] != INT8_RESIDENT / FP32_RESIDENT
            or any(c["cost_schema"] != 1 or c["platform"] != "gpu" for c in costs.values())
            or not full["bf16"]["passed"] or not full["int8"]["passed"] or not small["int8"]["passed"]
            or small["int8_rows_x1e9"]["passed"] or "accuracy" not in small["int8_rows_x1e9"]["reason"]):
        raise AssertionError(f"cost / canary: {row}")
    return row


# -- serving captured, the mux, the reload plane (r)-(t) ------------------------

#: (r) host-clock runs per (kind, bucket) and mode, taken in turns
SERVE_TIMED = 20
#: (r) runs per profiler window
SERVE_PROFILED = 10
#: (s), (t) closed-loop HTTP clients; (s) seconds of load
HTTP_CLIENTS, MUX_LOAD_S = 6, 3.0
#: (s) the variants' routing weights
MUX_WEIGHTS = {"fp32": 0.5, "bf16": 0.3, "int8": 0.2}


def _serving_bundles(fp32_dir: str, int8_dir: str, directory: str) -> dict:
    """The serving bundle in its three precisions: the fp32 bundle, its
    ``build_bf16_variant`` and its int8 variant."""
    from gan_deeplearning4j_tpu_torch.quant import build_bf16_variant

    bf16_dir = os.path.join(directory, "serve_bf16")
    if not os.path.exists(os.path.join(bf16_dir, "serving.json")):
        build_bf16_variant(fp32_dir, bf16_dir)
    return {"fp32": fp32_dir, "bf16": bf16_dir, "int8": int8_dir}


def _serve_limit(precision: str, bundle_dir: str, ref: np.ndarray) -> float:
    """How far a served row may lie from its reference on another device or
    in another bucket: fp32 ``CPU_TOL``; bf16 ``BF16_SERVE_REL`` of the
    largest output ((k)'s limit); int8 ``CPU_TOL`` + two code steps ((n)'s)."""
    if precision == "bf16":
        return BF16_SERVE_REL * max(float(np.max(np.abs(ref))), 1e-6)
    if precision == "int8":
        return CPU_TOL + 2.0 * _code_step(bundle_dir)
    return CPU_TOL


@contextlib.contextmanager
def _plain_quant_dense():
    """While open, ``QuantDenseLayer`` computes with ``quant_dense_plain``,
    the kernel's plain PyTorch version, instead of launching the kernel."""
    from gan_deeplearning4j_tpu_torch.ops import linear

    kernel = linear.quant_dense
    linear.quant_dense = linear.quant_dense_plain
    try:
        yield
    finally:
        linear.quant_dense = kernel


def _host_ms(engine, kind: str, rows: np.ndarray, runs: int) -> list:
    out = []
    for _ in range(runs):
        t0 = time.perf_counter()
        engine.run(kind, rows)
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def _serve_windows(engine, kind: str, rows: np.ndarray) -> dict:
    """Two profiler windows of ``SERVE_PROFILED`` runs: the card only (the
    device-busy share of the host's wall time, kernels and ``quant_dense``
    kernels per run; a window in which the profiler recorded no kernel at
    all, as happened once on the card, is taken again, up to twice), then
    host and card (the host's calls that put work on the card, per run, by
    name)."""
    from gan_deeplearning4j_tpu_torch.serving.profile import _union_us

    cuda = torch.autograd.DeviceType.CUDA
    for attempt in range(3):  # a window that recorded no kernel is taken again
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(SERVE_PROFILED):
                engine.run(kind, rows)
            wall_us = (time.perf_counter() - t0) * 1e6
        spans, kernels, quant = [], 0, 0
        for ev in prof.events():
            if ev.device_type != cuda:
                continue
            spans.append((ev.time_range.start, ev.time_range.end))
            if not ev.name.startswith(("Memcpy", "Memset")):
                kernels += 1
                quant += "quant_dense" in ev.name
        if kernels:
            break
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(SERVE_PROFILED):
            engine.run(kind, rows)
    calls: dict = {}
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CPU and ev.name in _LAUNCH_CALLS:
            calls[ev.name] = calls.get(ev.name, 0) + 1 / SERVE_PROFILED
    return {"device_busy_share": _union_us(spans) / wall_us, "device_ms_per_run": _union_us(spans) / SERVE_PROFILED / 1e3,
            "empty_windows_retaken": attempt,
            "kernels_per_run": kernels / SERVE_PROFILED, "quant_dense_kernels_per_run": quant / SERVE_PROFILED,
            "launch_calls_per_run": calls, "launch_calls_total_per_run": sum(calls.values())}


def _phase_serving_captured(fp32_dir: str, int8_dir: str, directory: str, card: str) -> dict:
    """(r) Serving as CUDA-graph replays, for the fp32 bundle, its bf16 and
    its int8 variant (the kernel's launch count zeroed before, read after):
    every (kind, bucket) captured once in warmup and none after; staged
    ``run`` (H2D into the static input, replay, D2H) bit-equal to
    ``run_host`` (eager, default stream) for every kind and n in ``SIZES``
    (130 spans two chunks); the card against the CPU within ``_serve_limit``;
    for int8, the replayed graphs bit-equal to the same forward with
    ``quant_dense_plain`` in place of the kernel. Then per (kind, bucket),
    captured and uncaptured (``engine.captured = False``: the forward op by
    op on the engine stream) in one call: ``run`` host ms (median of
    ``SERVE_TIMED``, in turns), ``_serve_windows``, the capture's seconds
    and its graph pool's bytes. The kernel's launches are counted as
    replays × the launches captured into each graph; the profiler's
    ``quant_dense`` kernels per captured run are beside, and must be
    nonzero exactly where the graph holds the kernel."""
    from gan_deeplearning4j_tpu_torch.ops import linear
    from gan_deeplearning4j_tpu_torch.serving import ServingEngine

    dirs = _serving_bundles(fp32_dir, int8_dir, directory)
    rng = np.random.default_rng(SEED)
    linear.KERNEL_LAUNCHES["quant_dense"] = 0
    engines, summary, timing = {}, {}, []
    for name, bundle in dirs.items():
        engine = ServingEngine.from_bundle(bundle, device="cuda", export_gauge=False)
        t0 = time.perf_counter()
        engine.warmup()
        warm_s = time.perf_counter() - t0
        once = {k: len(engine.buckets) for k in engine.kinds}
        if engine.compile_counts != once or not engine.stats()["captured"]:
            raise AssertionError(f"(r) {name}: captures {engine.compile_counts}, want {once}")
        cpu = ServingEngine.from_bundle(bundle, device="cpu", export_gauge=False)
        vs_cpu, vs_plain = {}, {}
        for kind in engine.kinds:
            for n in SIZES:
                rows = _rows(kind, n, rng)
                staged = engine.run(kind, rows)
                if not np.array_equal(staged, engine.run_host(kind, rows)) or not np.all(np.isfinite(staged)):
                    raise AssertionError(f"(r) {name} {kind} n={n}: replay differs from run_host, or non-finite")
                ref = cpu.run_host(kind, rows)
                err = float(np.max(np.abs(staged - ref)))
                if staged.shape != ref.shape or err > _serve_limit(name, bundle, ref):
                    raise AssertionError(f"(r) {name} {kind} n={n}: card vs CPU {err}")
                vs_cpu[kind] = max(vs_cpu.get(kind, 0.0), err)
                if name == "int8" and kind != "sample":
                    with _plain_quant_dense():
                        plain = engine.run_host(kind, rows)
                    vs_plain[kind] = max(vs_plain.get(kind, 0.0), float(np.max(np.abs(staged - plain))))
        if any(vs_plain.values()):
            raise AssertionError(f"(r) int8: quant_dense replayed differs from its plain version: {vs_plain}")
        engines[name] = engine
        summary[name] = {"warmup_and_capture_s": warm_s, "compile_counts": engine.compile_counts,
                         "card_vs_cpu_max_abs_err": vs_cpu, "replay_vs_plain_quant_dense_max_abs_err": vs_plain,
                         "graph_pool_bytes": engine.stats()["graph_pool_bytes"],
                         "resident_param_bytes": engine.resident_param_bytes()}
    for name, engine in engines.items():
        for kind in engine.kinds:
            for bucket in engine.buckets:
                rows = _rows(kind, bucket, rng)
                ms = {"captured": [], "uncaptured": []}
                for mode in ("captured", "uncaptured", "uncaptured", "captured"):
                    engine.captured = mode == "captured"
                    _host_ms(engine, kind, rows, 3)
                    ms[mode] += _host_ms(engine, kind, rows, SERVE_TIMED // 2)
                graph = engine.graph_stats()[f"{kind}/{bucket}"]
                row = {"phase": "serving_captured_timing", "precision": name, "kind": kind, "bucket": bucket,
                       "capture_s": graph["capture_s"], "pool_bytes": graph["pool_bytes"],
                       "launches_per_replay": graph["launches_per_replay"]}
                for mode in ("uncaptured", "captured"):
                    engine.captured = mode == "captured"
                    row[mode] = {"run_ms": statistics.median(ms[mode]), **_serve_windows(engine, kind, rows)}
                engine.captured = True
                row["run_ms_uncaptured_to_captured"] = [row["uncaptured"]["run_ms"], row["captured"]["run_ms"]]
                row["card"] = card
                print(json.dumps(row))
                timing.append(row)
                # the profiler may drop a record at a window's edge (it saw
                # 19 of 20 once): it must see the kernel, and no more of it
                # than the graphs hold
                seen, held = (row["captured"]["quant_dense_kernels_per_run"],
                              graph["launches_per_replay"].get("quant_dense", 0))
                if (seen > 0) != (held > 0) or seen > held:
                    raise AssertionError(f"(r) {name} {kind}/{bucket}: the profiler's quant_dense kernels per "
                                         f"replay {seen}, captured {graph['launches_per_replay']}")
    launches = linear.KERNEL_LAUNCHES["quant_dense"] + sum(
        e.kernel_launches().get("quant_dense", 0) for e in engines.values())
    serve = {name: e.serve_compile_counts for name, e in engines.items()}
    for engine in engines.values():
        engine.close()
    out = {"phase": "serving_captured", "precisions": summary, "serve_compile_counts": serve,
           "kernel_launches": launches, "card": card}
    print(json.dumps(out))
    out["timing"] = timing
    if any(v for counts in serve.values() for v in counts.values()) or launches <= 0:
        raise AssertionError(f"(r) captures after warmup {serve}, or quant_dense launched {launches} times")
    return out


def _phase_mux(fp32_dir: str, int8_dir: str, directory: str, card: str) -> dict:
    """(s) One ``MuxRegistry`` on the card holding the fp32, bf16 and int8
    bundles with one ``SharedStagingPool`` (each bundle's ``cost`` block
    measured anew), behind ``make_server`` on port 0.
    ``HTTP_CLIENTS`` closed-loop clients send keyed requests for
    ``MUX_LOAD_S`` seconds. Then a ramp of the int8 variant 1% → 100% on a
    healthy signal, a ramp of the bf16 variant rolled back by an injected
    failing one, brownout levels 1 and 2 forced, and the int8 variant
    demoted and made resident again while a client keeps the others busy.
    The kernel's launch count (wrapper and replays) is zeroed before and
    read after. Checks: every answer ok; each key answered by
    ``WeightedSplitter.assign``'s variant; each answer within
    ``_serve_limit`` of its variant's own ``run_host`` (a rider shares its
    flush, and so its bucket, with other riders; bit-equal ones are
    counted); the pool allocates fewer buffers than the flushes it stages
    for all three variants, and none for one flush of each variant in turn
    after the load; the ramp completes, the rollback restores the other
    weights exactly and zeroes the candidate's; the costliest variant sheds
    first; the
    re-warmed engine captured every (kind, bucket) with no fault, and no
    engine captured after warmup."""
    from gan_deeplearning4j_tpu_torch.ops import linear
    from gan_deeplearning4j_tpu_torch.quant import measure_bundle_cost
    from gan_deeplearning4j_tpu_torch.serving import make_server
    from gan_deeplearning4j_tpu_torch.serving.mux import MuxRegistry, MuxService, SharedStagingPool

    dirs = _serving_bundles(fp32_dir, int8_dir, directory)
    # measured here, each on its own engine: a variant built from a bundle
    # that carries a cost block carries its source's block (both packages)
    for bundle in dirs.values():
        measure_bundle_cost(bundle, device="cuda")
    linear.KERNEL_LAUNCHES["quant_dense"] = 0
    pool = SharedStagingPool()
    registry = MuxRegistry(budget=3, device="cuda", staging_pool=pool,
                           batcher_kwargs={"max_latency": 0.002, "default_timeout": 60.0})
    t0 = time.perf_counter()
    for name, bundle in dirs.items():
        registry.add(name, bundle_path=bundle, weight=MUX_WEIGHTS[name])
    warm_s = time.perf_counter() - t0
    engines = {name: [registry.engine_for(name)] for name in dirs}
    service = MuxService(registry)
    server = make_server(service, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    results, errors, stop = [], [], threading.Event()

    def client(i: int, pinned=None) -> None:
        rng = np.random.default_rng(SEED + 100 + i)
        j = 0
        try:
            while not stop.is_set():
                kind = ("sample", "classify", "features")[(i + j) % 3]
                rows = _rows(kind, (1, 3, 8, 21)[(i + 2 * j) % 4], rng)
                fields = {"model": pinned} if pinned else {"key": f"user-{i}-{j % 40}"}
                status, body, _ = _post(base, kind, rows, **fields)
                results.append((fields, kind, rows, status, body))
                j += 1
        except Exception as exc:  # reported below; the phase fails
            errors.append(repr(exc))

    try:
        clients = [threading.Thread(target=client, args=(i,)) for i in range(HTTP_CLIENTS)]
        for t in clients:
            t.start()
        time.sleep(MUX_LOAD_S)
        stop.set()
        for t in clients:
            t.join(timeout=120)
        loaded = list(results)
        assigned = {f["key"]: registry.splitter.assign(f["key"]) for f, _, _, _, _ in loaded}
        dispatches = sum(e.stats()["replica_dispatches"][0] for es in engines.values() for e in es)
        pool_stats = pool.stats()
        # one (bucket 8, width 784) flush per variant in turn: the pool
        # hands each the buffer the one before checked in
        x3 = _rows("classify", 3, np.random.default_rng(SEED))
        cross = [_post(base, "classify", x3, model=name)[0] for name in dirs for _ in range(2)]
        cross_allocated = pool.stats()["allocated_total"] - pool_stats["allocated_total"]

        rows = _rows("classify", 3, np.random.default_rng(SEED))
        ramp = service.start_ramp("int8", stages=(0.01, 0.1, 0.5, 1.0), hold_ticks=1, health=lambda: True)
        ramp_states = []  # (state after the tick, HTTP status of a request then)
        while ramp.state == "ramping" and len(ramp_states) < 10:
            ramp_states.append((ramp.tick(), _post(base, "classify", rows, key=f"ramp-{len(ramp_states)}")[0]))
        ramp_shares = registry.splitter.shares()
        registry.set_weights(MUX_WEIGHTS)
        script = iter([True, False])
        rollback = service.start_ramp("bf16", stages=(0.01, 0.1, 0.5, 1.0), hold_ticks=1,
                                      health=lambda: next(script, False))
        rollback_states = [rollback.tick(), rollback.tick()]
        rollback_weights = registry.splitter.weights()
        registry.set_weights(MUX_WEIGHTS)

        costs = registry.costs()
        by_cost = sorted(costs, key=lambda n: (-costs[n], n))  # ties by name, as the service ranks
        brownout = {}
        for level in (1, 2):
            service.set_brownout(level)
            brownout[level] = {name: _post(base, "classify", rows, model=name)[0] for name in dirs}
        service.set_brownout(0)

        stop.clear()
        busy = threading.Thread(target=client, args=(HTTP_CLIENTS, "fp32"))
        busy.start()
        try:
            demoted = registry.demote("int8")
            registry.ensure_resident("int8")
        finally:
            stop.set()
            busy.join(timeout=120)
        rewarmed = registry.engine_for("int8")
        engines["int8"].append(rewarmed)
        launches = linear.KERNEL_LAUNCHES["quant_dense"] + sum(
            e.kernel_launches().get("quant_dense", 0) for e in engines["int8"])

        bad = [(f, k, st, b.get("status")) for f, k, _, st, b in results if st != 200 or b.get("status") != "ok"]
        misrouted = [f["key"] for f, _, _, _, b in loaded if b.get("model") != assigned[f["key"]]]
        worst, equal, served = {}, 0, {}
        for fields, kind, x, _, body in loaded:
            model = body["model"]
            served[model] = served.get(model, 0) + 1
            want = engines[model][0].run_host(kind, x)
            got = np.asarray(body["data"], dtype=np.float32)
            if got.shape != want.shape:
                raise AssertionError(f"(s) {model} {kind}: shape {got.shape} vs {want.shape}")
            err = float(np.max(np.abs(got - want)))
            if err > _serve_limit(model, dirs[model], want):
                raise AssertionError(f"(s) {model} {kind} n={x.shape[0]}: {err} from its run_host")
            worst[model] = max(worst.get(model, 0.0), err)
            equal += bool(np.array_equal(got, want))
        rerun = {kind: bool(np.array_equal(rewarmed.run(kind, _rows(kind, 130, np.random.default_rng(1))),
                                           rewarmed.run_host(kind, _rows(kind, 130, np.random.default_rng(1)))))
                 for kind in rewarmed.kinds}
        serve = {name: [e.serve_compile_counts for e in es] for name, es in engines.items()}
        row = {"phase": "mux", "warmup_and_capture_s": warm_s, "requests": len(loaded),
               "requests_per_variant": served, "non_ok": bad[:5], "misrouted": misrouted[:5],
               "client_errors": errors[:5], "max_abs_err_vs_own_run_host": worst,
               "bit_equal_share": equal / max(len(loaded), 1), "pool": pool_stats,
               "flushes_staged": dispatches, "cross_variant_statuses": cross,
               "cross_variant_buffers_allocated": cross_allocated, "ramp_states": ramp_states, "ramp_shares": ramp_shares,
               "rollback_states": rollback_states, "rollback_weights": rollback_weights, "costs": costs,
               "cost_sources": registry.cost_sources(), "brownout_status": brownout,
               "demoted": demoted, "rewarmed_compile_counts": rewarmed.compile_counts,
               "rewarmed_warm_failed": rewarmed.warm_failed, "rewarmed_replay_equals_run_host": rerun,
               "serve_compile_counts": serve, "graph_pool_bytes": {
                   name: es[-1].stats()["graph_pool_bytes"] for name, es in engines.items()},
               "kernel_launches": launches, "card": card}
        print(json.dumps(row))
        if (bad or misrouted or errors or len(served) != 3 or pool_stats["allocated_total"] >= dispatches
                or cross != [200] * 6 or cross_allocated != 0
                or ramp.state != "complete" or ramp_shares != {"int8": 1.0}
                or rollback.state != "rolled_back" or rollback_weights != {**MUX_WEIGHTS, "bf16": 0.0}
                or brownout[1] != {n: 503 if n == by_cost[0] else 200 for n in dirs}
                or brownout[2] != {n: 200 if n == by_cost[-1] else 503 for n in dirs}
                or not demoted or rewarmed is engines["int8"][0] or rewarmed.warm_failed
                or rewarmed.compile_counts != {k: len(rewarmed.buckets) for k in rewarmed.kinds}
                or not all(rerun.values()) or launches <= 0
                or any(v for counts in serve.values() for c in counts for v in c.values())):
            raise AssertionError(f"(s) mux: {row}")
        return row
    finally:
        stop.set()
        server.shutdown()
        server.server_close()
        service.close()
        thread.join(timeout=30)


def _write_variant(src: str, dst: str, *, noise: float = 0.0, negate_output: bool = False,
                   generation=None) -> None:
    """A copy of the serving bundle ``src`` in ``dst``: the generator's float
    leaves plus ``noise`` × seeded normal draws, and with ``negate_output``
    the classifier's output layer negated (its argmax becomes its argmin)."""
    from gan_deeplearning4j_tpu_torch.utils import write_model
    from gan_deeplearning4j_tpu_torch.utils.serializer import read_model

    with open(os.path.join(src, "serving.json")) as fh:
        manifest = json.load(fh)
    g = torch.Generator().manual_seed(SEED + 7)
    gen, gen_params, _, _ = read_model(os.path.join(src, manifest["generator"]), load_updater=False, device="cpu")
    cv, cv_params, _, _ = read_model(os.path.join(src, manifest["classifier"]), load_updater=False, device="cpu")
    if noise:
        gen_params = {layer: {k: t + noise * torch.randn(t.shape, generator=g) if t.is_floating_point() else t
                              for k, t in leaves.items()} for layer, leaves in gen_params.items()}
    if negate_output:
        out = cv.output_names[0]
        cv_params[out] = {k: -t for k, t in cv_params[out].items()}
    write_model(os.path.join(dst, "gen.zip"), gen, gen_params, save_updater=False)
    write_model(os.path.join(dst, "cv.zip"), cv, cv_params, save_updater=False)
    keep = ("format_version", "family", "feature_vertex", "z_size", "num_features", "num_classes")
    with open(os.path.join(dst, "serving.json"), "w") as fh:
        json.dump({**{k: manifest[k] for k in keep if k in manifest}, "generator": "gen.zip",
                   "classifier": "cv.zip", "generation": generation}, fh)


def _phase_reload(fp32_dir: str, directory: str, card: str) -> dict:
    """(t) The reload plane on the card: a port ``CheckpointStore`` whose
    generation 0 is the serving bundle; an ``InferenceService`` booted from
    it behind ``make_server`` on port 0, with ``ReloadController`` and the
    real ``CanaryGate`` (64 synthetic MNIST rows labelled by the incumbent, 256
    samples, as in (o))
    attached and running. Under ``HTTP_CLIENTS`` closed-loop clients,
    generation 1 (the generator's weights moved by 1e-3 normal draws) is
    published and swapped in. Checks: zero non-ok answers; no capture on
    the new engine after its warmup; its ``run`` bit-equal to a fresh
    engine's ``run_host`` on generation 1 for every kind and n in
    ``SIZES``. Then a poisoned generation 2 (the classifier's output layer
    negated) is rejected by the canary and quarantined, and ``POST
    /debug/trace?ms=200&block=1`` leaves a ``torch.profiler`` trace."""
    from gan_deeplearning4j_tpu_torch.data import synthetic_mnist
    from gan_deeplearning4j_tpu_torch.deploy import CanaryGate, ReloadController, StoreWatcher
    from gan_deeplearning4j_tpu_torch.resilience import CheckpointStore
    from gan_deeplearning4j_tpu_torch.serving import InferenceService, ServingEngine, make_server

    store = CheckpointStore(os.path.join(directory, "reload_store"), keep_last=10)

    def publish(**kw):
        number = store.next_number()
        return store.publish(lambda d: _write_variant(fp32_dir, d, generation=number, **kw),
                             step=number, extra={"kind": "serving"})

    g0 = publish()
    engine = ServingEngine.from_bundle(g0.path, device="cuda")
    service = InferenceService(engine, warmup="sync", max_latency=0.002, default_timeout=60.0,
                               artifacts_dir=os.path.join(directory, "device_traces"))
    (rows, _), _ = synthetic_mnist(num_train=64, num_test=1, seed=SEED)
    labels = np.argmax(engine.run("classify", rows), axis=1)
    controller = ReloadController(service, StoreWatcher(store=store),
                                  canary=CanaryGate(rows, labels, num_samples=256, seed=SEED), poll_interval=0.1)
    service.attach_reloader(controller)
    server = make_server(service, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    results, errors, stop = [], [], threading.Event()

    def client(i: int) -> None:
        rng = np.random.default_rng(SEED + 200 + i)
        j = 0
        try:
            while not stop.is_set():
                kind = ("sample", "classify", "features")[(i + j) % 3]
                status, body, _ = _post(base, kind, _rows(kind, (1, 3, 8, 21)[(i + j) % 4], rng))
                results.append((kind, status, body.get("status")))
                j += 1
        except Exception as exc:  # reported below; the phase fails
            errors.append(repr(exc))

    controller.start()
    try:
        clients = [threading.Thread(target=client, args=(i,)) for i in range(HTTP_CLIENTS)]
        for t in clients:
            t.start()
        t0 = time.perf_counter()
        g1 = publish(noise=1e-3)
        while service.engine.generation != g1.number and time.perf_counter() - t0 < 300:
            time.sleep(0.02)
        swap_s = time.perf_counter() - t0
        before = len(results)
        while len(results) < before + 50 and time.perf_counter() - t0 < 300:
            time.sleep(0.02)
        stop.set()
        for t in clients:
            t.join(timeout=120)
        new = service.engine
        # the candidate was built on a ladder learned from the incumbent's traffic
        fresh = ServingEngine.from_bundle(g1.path, buckets=new.buckets, device="cuda", export_gauge=False)
        rng = np.random.default_rng(SEED)
        swapped_equal = {kind: all(np.array_equal(new.run(kind, x), fresh.run_host(kind, x))
                                   for x in (_rows(kind, n, rng) for n in SIZES))
                         for kind in new.kinds}
        g2 = publish(negate_output=True)
        poisoned = controller.poll_now(wait=True, timeout=300)
        entry = store.entry(g2.number)
        code, trace = _post_path(base, "/debug/trace?ms=200&block=1")
        trace_file = os.path.join(trace.get("artifact", ""), "trace.json")
        trace_bytes = os.path.getsize(trace_file) if os.path.exists(trace_file) else 0
        bad = [r for r in results if r[1] != 200 or r[2] != "ok"]
        row = {"phase": "reload", "requests": len(results), "non_ok": bad[:5], "client_errors": errors[:5],
               "swap_wait_s": swap_s, "swap_events": [e for e in controller.events if e["event"] == "swap"],
               "served_generation": new.generation, "new_engine_compile_counts": new.compile_counts,
               "new_engine_serve_compile_counts": new.serve_compile_counts,
               "swapped_equals_fresh_run_host": swapped_equal,
               "poisoned": {"status": entry.get("status"), "reason": entry.get("reason"),
                            "rejected": poisoned["rejected"], "generation_after": service.engine.generation},
               "debug_trace": {"http": code, "bytes": trace_bytes}, "reload": service.healthz().get("reload"),
               "card": card}
        print(json.dumps(row))
        if (bad or errors or new.generation != g1.number or any(new.serve_compile_counts.values())
                or new.compile_counts != {k: len(new.buckets) for k in new.kinds}
                or not all(swapped_equal.values()) or entry.get("status") != "quarantined"
                or poisoned["rejected"] != 1 or service.engine.generation != g1.number
                or code != 200 or trace_bytes <= 0):
            raise AssertionError(f"(t) reload: {row}")
        return row
    finally:
        stop.set()
        controller.stop()
        server.shutdown()
        server.server_close()
        service.close()
        thread.join(timeout=30)


# -- the model zoo: class conditioning, streaming input, the drill -----------

#: (u2): the conditional MNIST DCGAN at (d)'s batch and the conditional image
#: family (``cifar_shaped``) at (e)'s
ZOO_WINDOW_CASES = (("mnist", 200, {"conditioning": "class"}),
                    ("cifar10", 64, {"conditioning": "class"}))
#: (u4): the batch, rows the iterators feed, iterations timed through ``run()``
ZOO_BATCH, ZOO_STREAM_ROWS, ZOO_STREAM_ITERATIONS = 200, 8000, 32


def _zoo_windows(x, y, directory: str, card: str) -> list:
    """(u2) (p)'s check on ``ZOO_WINDOW_CASES``: the conditional iteration
    captured, its one-hot read from the window's static labels, bit-equal
    to the eager body in every leaf and loss, each key captured once."""
    rows, failed = [], []
    for i, (name, batch, overrides) in enumerate(ZOO_WINDOW_CASES):
        row, ok = _window_case(name, batch, overrides, x, y, os.path.join(directory, f"zoo_windows_{i}"),
                               card)
        rows.append(row)
        if not ok:
            failed.append(name)
    if failed:
        raise AssertionError(f"(u2) conditional captured windows differ from the eager body: {failed}")
    return rows


def _zoo_drill(directory: str, card: str) -> dict:
    """(u3) The port's zoo drill at full width on the card: the conditional
    MNIST DCGAN (z 2 + a 10-wide one-hot) trained at batch 200 through
    ``StreamingDataSetIterator``, published and served over HTTP, every
    class bit-equal to ``run_host``, no capture after warmup, the 400
    contract; WGAN-GP ``cifar_shaped`` at batch 320, one round; both behind
    one mux with the conditional bundle's int8 variant (its ``classify``
    requests replay ``quant_dense``), every answer ok. The kernel's launch
    count is zeroed before the drill and read after it (captures and eager
    calls, plus the mux's int8 replays, which must be some). Then the int8
    variant apart: its ``classify`` / ``features`` replays bit-equal to the
    same forward with ``quant_dense_plain``, and ``sample?class=k`` served
    for every class bit-equal to ``run_host`` (the variant inherits the zoo
    block)."""
    from gan_deeplearning4j_tpu_torch.ops import linear
    from gan_deeplearning4j_tpu_torch.serving import InferenceService, ServingEngine
    from gan_deeplearning4j_tpu_torch.zoo import drill

    workdir = os.path.join(directory, "zoo_drill")
    args = drill.parse_args(["--iterations", "2", "--batch-size", "200", "--wgan-batch-size", "320",
                             "--buckets", "1,8,32,128", "--mux-requests", "96", "--device", "cuda",
                             "--workdir", workdir])
    linear.KERNEL_LAUNCHES["quant_dense"] = 0
    payload = drill.run_drill(args)
    replayed = payload["results"]["mux"]["kernel_launches"]["cond_mnist_int8"].get("quant_dense", 0)
    launches = linear.KERNEL_LAUNCHES["quant_dense"] + replayed

    engine = ServingEngine.from_bundle(os.path.join(workdir, "bundle_cond_mnist_int8"), device="cuda",
                                       export_gauge=False)
    engine.warmup()
    rng = np.random.default_rng(SEED)
    vs_plain = {}
    for kind in ("classify", "features"):
        for n in SIZES:
            rows = _rows(kind, n, rng)
            staged = engine.run(kind, rows)
            with _plain_quant_dense():
                plain = engine.run_host(kind, rows)
            vs_plain[kind] = max(vs_plain.get(kind, 0.0), float(np.max(np.abs(staged - plain))))
    service = InferenceService(engine, warmup=False)
    int8_classes = []
    try:
        for k in range(engine.class_count):
            z = rng.random((3, engine.latent_width("sample")), dtype=np.float32) * 2.0 - 1.0
            status, body = service.handle("POST", f"/v1/sample?class={k}", {"data": z.tolist()})
            onehot = np.zeros((3, engine.class_count), dtype=np.float32)
            onehot[:, k] = 1.0
            int8_classes.append(status == 200 and np.array_equal(
                np.asarray(body["data"], dtype=np.float32),
                engine.run_host("sample", np.concatenate([z, onehot], axis=1))))
    finally:
        service.close()
    serve = dict(engine.serve_compile_counts)
    engine.close()
    row = {"phase": "zoo_drill", "ok": payload["ok"], "invariants": payload["invariants"],
           "config": payload["config"], "wall_seconds": payload["wall_seconds"],
           "results": payload["results"], "kernel_launches": launches,
           "kernel_launches_replayed_in_the_mux": replayed,
           "int8_replay_vs_plain_quant_dense_max_abs_err": vs_plain,
           "int8_sample_class_parity": int8_classes, "int8_serve_compile_counts": serve, "card": card}
    print(json.dumps(row))
    if not (payload["ok"] and replayed > 0 and not any(vs_plain.values()) and all(int8_classes)
            and len(int8_classes) == 10 and not any(serve.values())):
        raise AssertionError(f"(u3) the zoo drill failed: {row}")
    return row


def _zoo_stream_iterator(kind: str, xs, ys):
    from gan_deeplearning4j_tpu_torch.data import ArrayDataSetIterator
    from gan_deeplearning4j_tpu_torch.zoo import StreamingDataSetIterator, array_source

    if kind == "streaming":
        source, n = array_source(xs, ys)
        return StreamingDataSetIterator(source, n, batch_size=ZOO_BATCH, shuffle=True, seed=SEED,
                                        device="cuda")
    return ArrayDataSetIterator(xs, ys, batch_size=ZOO_BATCH, shuffle=True, seed=SEED)


def _zoo_feed_rows_per_s(kind: str, xs, ys) -> float:
    """Rows a second one epoch of the iterator puts on the card at
    ``ZOO_BATCH`` (the in-memory iterator's batches copied as ``run()`` copies them)."""
    it = _zoo_stream_iterator(kind, xs, ys)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = 0
    while it.has_next():
        batch = it.next()
        if kind != "streaming":
            batch = batch.to_device("cuda")
        rows += batch.num_examples()
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    if kind == "streaming":
        it.close()
    return rows / elapsed


def _zoo_train_rows_per_s(kind: str, xs, ys, directory: str) -> float:
    """Rows a second of conditional training at ``ZOO_BATCH`` through ``run()``
    fed by the iterator: 8 iterations first (captures), then
    ``ZOO_STREAM_ITERATIONS`` timed, ended by the loss read-back."""
    from gan_deeplearning4j_tpu_torch.harness import GanExperiment

    exp = GanExperiment(_config(conditioning="class", batch_size_train=ZOO_BATCH, num_iterations=8,
                                print_every=1000,
                                output_dir=os.path.join(directory, f"zoo_stream_{kind}")))
    it = _zoo_stream_iterator(kind, xs, ys)
    exp.run(it)
    exp.config.num_iterations = 8 + ZOO_STREAM_ITERATIONS
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = exp.run(it)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    if kind == "streaming":
        it.close()
    if result["iterations"] != 8 + ZOO_STREAM_ITERATIONS:
        raise AssertionError(f"(u4) {kind}: run() stopped at {result['iterations']}")
    return ZOO_STREAM_ITERATIONS * ZOO_BATCH / elapsed


def _zoo_timing(x, y, directory: str, card: str) -> dict:
    """(u4) Recorded, not gated; each pair in turns (A, B, B, A) in this
    call. The captured iteration of conditional and unconditional MNIST at
    batch 200 (``_measure_iterations``: host and event ms, rows/s, busy
    share); the streaming iterator against the in-memory one, feeding alone
    and feeding conditional training through ``run()`` (rows/s); ``run`` ms
    captured of conditional ``sample`` (the drill's bundle, full-width
    rows) against the unconditional fp32 bundle, buckets 1, 8, 32, 128."""
    from gan_deeplearning4j_tpu_torch.harness import GanExperiment
    from gan_deeplearning4j_tpu_torch.serving import ServingEngine
    from gan_deeplearning4j_tpu_torch.zoo import load_dataset

    batches = _mnist_batches(x, y, ZOO_BATCH, 30)
    iterations = {"unconditional": [], "conditional": []}
    for mode in ("unconditional", "conditional", "conditional", "unconditional"):
        cond = {"conditioning": "class"} if mode == "conditional" else {}
        exp = GanExperiment(_config(batch_size_train=ZOO_BATCH, **cond))
        measured = _measure_iterations(exp, batches, ZOO_BATCH, top_n=3)
        iterations[mode].append({k: measured[k] for k in (
            "iteration_ms_host_median", "iteration_ms_event_median", "rows_per_s", "device_busy_share",
            "kernels_per_iteration", "peak_memory_mib")})
        del exp
        gc.collect()
        torch.cuda.empty_cache()

    (xs, labels), _ = load_dataset("mnist", num_train=ZOO_STREAM_ROWS, num_test=1, seed=SEED)
    ys = np.eye(10, dtype=np.float32)[labels]
    feed = {"in_memory": [], "streaming": []}
    train = {"in_memory": [], "streaming": []}
    for kind in ("in_memory", "streaming", "streaming", "in_memory"):
        feed[kind].append(_zoo_feed_rows_per_s(kind, xs, ys))
        train[kind].append(_zoo_train_rows_per_s(kind, xs, ys, directory))
        gc.collect()
        torch.cuda.empty_cache()

    engines = {"unconditional": ServingEngine.from_bundle(directory, device="cuda", export_gauge=False),
               "conditional": ServingEngine.from_bundle(os.path.join(directory, "zoo_drill", "bundle_cond_mnist"),
                                                        device="cuda", export_gauge=False)}
    for engine in engines.values():
        engine.warmup()
    rng = np.random.default_rng(SEED)
    sample = {}
    for bucket in engines["conditional"].buckets:
        ms = {name: [] for name in engines}
        for name in ("unconditional", "conditional", "conditional", "unconditional"):
            engine = engines[name]
            rows = rng.uniform(-1, 1, (bucket, engine.input_width("sample"))).astype(np.float32)
            _host_ms(engine, "sample", rows, 3)
            ms[name] += _host_ms(engine, "sample", rows, SERVE_TIMED // 2)
        sample[bucket] = {name: statistics.median(v) for name, v in ms.items()}
    captures = {name: (e.compile_counts, e.serve_compile_counts) for name, e in engines.items()}
    for engine in engines.values():
        engine.close()
    row = {"phase": "zoo_timing", "batch": ZOO_BATCH, "iterations": iterations,
           "feed_rows_per_s": feed, "train_rows_per_s": train,
           "sample_run_ms_captured": sample, "serving_captures": captures, "card": card}
    print(json.dumps(row))
    return row


def _phase_zoo(x, y, directory: str, card: str) -> dict:
    """(u) The model zoo on the card: (u1) the conditional MNIST DCGAN card
    vs CPU, (u2) its captured windows and the conditional image family's,
    (u3) the zoo drill at full width with the int8 variant, (u4) timing.
    Every part runs; any failure fails the phase."""
    out, failed = {}, []
    for key, run in (("card_vs_cpu", lambda: _phase_card_vs_cpu(x, y, card, frozen_apart=True,
                                                                conditioning="class")),
                     ("windows", lambda: _zoo_windows(x, y, directory, card)),
                     ("drill", lambda: _zoo_drill(directory, card)),
                     ("timing", lambda: _zoo_timing(x, y, directory, card))):
        try:
            out[key] = run()
        except Exception:  # reported, and the phase fails below
            traceback.print_exc()
            failed.append(key)
    if failed:
        raise AssertionError(f"(u) zoo: {failed} failed")
    return out


# -- (v) parallel training on the card ------------------------------------------------

#: (v1) cases at the reference's batches: (name, family, batch, overrides, window)
PARALLEL_CASES = (
    ("pmean", "mnist", 200, {"distributed": "pmean"}, 4),
    ("pmean_update_sharding", "mnist", 200, {"distributed": "pmean", "update_sharding": True}, 4),
    ("param_averaging", "mnist", 200, {"distributed": "param_averaging",
                                       "batch_size_per_worker": 200}, 4),
    ("wgan_gp_pmean", "wgan_gp", 320, {"distributed": "pmean"}, 2),
)
#: (v1)'s limits where the synchronised BatchNorm's reduction (the mesh
#: mean of the ranks' means and variances) takes another route than the
#: single path's mean and population variance
SYNC_BN_LOSS_RTOL, SYNC_BN_LEAF_REL = 1e-6, 1e-5
#: (v2) the reference's local[4]: ranks sharing the card, rows a rank
WORKERS, WORKER_ROWS = 4, 200
#: (v4) warm and timed iterations
PARALLEL_WARM, PARALLEL_TIMED = 5, 20


def _parallel_experiment(family: str, batch: int, mesh=None, **overrides):
    from gan_deeplearning4j_tpu_torch.harness import make_experiment

    shape = {} if family == "mnist" else FAMILIES[family]
    return make_experiment(_config(**shape, batch_size_train=batch, **overrides), mesh=mesh)


def _parallel_batches(family: str, x, y, batch: int, count: int, seed: int = SEED):
    """``count`` batches ``(count, batch, F)`` and their one-hot labels."""
    if family == "mnist":
        pairs = _mnist_batches(np.tile(x, (-(-count * batch // x.shape[0]), 1)),
                               np.tile(y, (-(-count * batch // y.shape[0]), 1)), batch, count)
    else:
        pairs = _family_batches(_parallel_experiment(family, 10), count, batch, seed)
    return np.stack([p[0] for p in pairs]), np.stack([p[1] for p in pairs])


def _flat(exp) -> dict:
    """``flatten_states`` of the experiment, copied to the host (the
    static buffers change in place later)."""
    from gan_deeplearning4j_tpu_torch.harness.experiment import flatten_states

    return {k: (v.detach().cpu().clone() if isinstance(v, torch.Tensor) else torch.tensor(v))
            for k, v in flatten_states(exp.digest_states()).items()}


def _not_bit_equal(a: dict, b: dict) -> list:
    """Keys whose dtype or bits differ between two flat states."""
    a = {k: torch.as_tensor(v) for k, v in a.items()}
    b = {k: torch.as_tensor(v) for k, v in b.items()}
    return sorted(set(a) ^ set(b)) + [k for k in a if k in b and not (
        a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]))]


def _window_losses(out: dict) -> np.ndarray:
    return torch.stack([out[k] for k in ("d_loss", "g_loss", "cv_loss")], dim=1).cpu().numpy()


def _loss_rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    keep = np.isfinite(b)
    return float(np.max(np.abs(a[keep] - b[keep]) / np.abs(b[keep]))) if keep.any() else 0.0


def _device_kernels(fn, runs: int) -> dict:
    """A profiler window (card only) over ``runs`` calls of ``fn``: kernels
    per call, NCCL's among them, and NCCL's share of the kernel time."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    total = nccl = 0.0
    kernels = nccl_kernels = 0
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA or ev.name.startswith(("Memcpy", "Memset")):
            continue
        span = ev.time_range.end - ev.time_range.start
        kernels += 1
        total += span
        if "nccl" in ev.name.lower():
            nccl_kernels += 1
            nccl += span
    return {"kernels_per_iteration": kernels / runs, "nccl_kernels_per_iteration": nccl_kernels / runs,
            "nccl_share_of_kernel_time": nccl / total if total else None,
            "kernel_ms_per_iteration": total / runs / 1e3}


def _parallel_case(mesh, name: str, family: str, batch: int, overrides: dict, k: int, x, y,
                   card: str) -> tuple:
    """(v1) one case on the NCCL world-1 mesh: a window of ``k`` captured,
    the same window uncaptured (the eager distributed body), and the
    single-card experiment (no mesh) from the same init and draws; each key
    captured once, a second window capturing nothing; the NCCL kernels of
    an iteration. ``(row, ok)``."""
    feats, labels = _parallel_batches(family, x, y, batch, 2 * k)
    exps = {"captured": _parallel_experiment(family, batch, mesh, **overrides),
            "eager": _parallel_experiment(family, batch, mesh, **overrides),
            "single": _parallel_experiment(family, batch)}
    exps["eager"].graphs.captured = False
    from gan_deeplearning4j_tpu_torch.parallel import collectives

    losses, states = {}, {}
    for mode, exp in exps.items():
        collectives.reset_calls()
        losses[mode] = _window_losses(exp.train_iterations(feats[:k], labels[:k]))
        states[mode] = _flat(exp)
        if mode == "eager":  # the body's collectives, issued by every run
            calls = {kind: n / k for kind, n in collectives.CALLS.items() if n}
    cap = exps["captured"]
    counts = dict(cap.graphs.capture_counts)
    cap.train_iterations(feats[k:], labels[k:])
    from gan_deeplearning4j_tpu_torch.harness.experiment import state_divergence

    rounding = exps["single"].rounding_only_keys()
    single_div = state_divergence(states["captured"], states["single"], rounding)
    row = {
        "phase": "parallel_nccl_world1", "case": name, "family": family, "batch": batch,
        **overrides, "window": k, "backend": mesh.backend,
        "captures": counts, "second_window_captured": cap.graphs.capture_counts != counts,
        "replays_equal_eager_losses": bool(np.array_equal(losses["captured"], losses["eager"],
                                                          equal_nan=True)),
        "replays_equal_eager_leaves_differing": _not_bit_equal(states["captured"], states["eager"])[:5],
        "single_card_leaves_differing": len(_not_bit_equal(states["captured"], states["single"])),
        "single_card_losses_bit_equal": bool(np.array_equal(losses["captured"], losses["single"],
                                                            equal_nan=True)),
        "single_card_loss_max_rel": _loss_rel(losses["captured"], losses["single"]),
        "single_card_max_leaf_rel": single_div["max_leaf_rel"],
        "single_card_max_abs": single_div["max_abs"],
        "single_card_rounding_only": {"leaves": rounding,
                                      "max_abs": single_div["rounding_only_max_abs"]},
        # the route by which world 1 may differ from the single path
        "route": ("synchronised BatchNorm: the mean of the ranks' torch.mean, and the "
                  "mean of the ranks' torch.var plus their means' squared distance from it"
                  if overrides["distributed"] == "pmean" else "none"),
        "collectives_per_iteration": calls,
        # NCCL at one rank runs an in-place all-reduce without a kernel
        "nccl": _device_kernels(lambda: cap.train_iterations(feats[:1], labels[:1]), 1),
        "entries": cap.graphs.entry_stats(), "card": card,
    }
    print(json.dumps(row))
    bit_equal = row["single_card_leaves_differing"] == 0 and row["single_card_losses_bit_equal"]
    ok = (row["replays_equal_eager_losses"] and not row["replays_equal_eager_leaves_differing"]
          and counts and set(counts.values()) == {1} and not row["second_window_captured"]
          and (bit_equal or (overrides["distributed"] == "pmean"
                             and row["single_card_loss_max_rel"] <= SYNC_BN_LOSS_RTOL
                             and row["single_card_max_leaf_rel"] <= SYNC_BN_LEAF_REL))
          and sum(calls.values()) > 0 and np.isfinite(losses["captured"][:, :2]).all())
    del exps, cap
    gc.collect()
    torch.cuda.empty_cache()
    return row, ok


def _iteration_timing(exp, feats, labels) -> dict:
    """``PARALLEL_WARM`` warm iterations, then the median of
    ``PARALLEL_TIMED`` by the host clock to the device's end and by CUDA
    events, and the kernels of 5 more under the profiler."""
    batch = feats.shape[0] if feats.ndim == 2 else feats.shape[1]
    for _ in range(PARALLEL_WARM):
        exp.train_iteration(feats, labels)
    torch.cuda.synchronize()
    host, event = [], []
    for _ in range(PARALLEL_TIMED):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        exp.train_iteration(feats, labels)
        end.record()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        event.append(start.elapsed_time(end))
    return {"iterations_timed": PARALLEL_TIMED, "iteration_ms_host_median": statistics.median(host),
            "iteration_ms_event_median": statistics.median(event),
            "rows_per_s": batch / statistics.median(host) * 1e3,
            **_device_kernels(lambda: exp.train_iteration(feats, labels), 5)}


def _state_limits(a: dict, b: dict, rounding_only=(), apart=()) -> dict:
    from gan_deeplearning4j_tpu_torch.harness.experiment import state_divergence

    div = state_divergence(a, b, list(rounding_only) + list(apart))
    out = {"max_leaf_rel": div["max_leaf_rel"], "max_abs": div["max_abs"],
           "rounding_only_max_abs": div["rounding_only_max_abs"]}
    if apart:
        out["apart"] = {"leaves": len(apart), "max_leaf_rel": state_divergence(
            {k: a[k] for k in apart}, {k: b[k] for k in apart})["max_leaf_rel"]}
    return out


def _loss_row(losses: dict) -> list:
    return [float(losses[k]) for k in ("d_loss", "g_loss", "cv_loss")]


def _host_flat(flat: dict) -> dict:
    return {k: v.detach().cpu() if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
            for k, v in flat.items()}


def _ranks_differing(ranks: list, key: str, field: str = "states") -> list:
    """Keys on which some rank's ``field`` of scenario ``key`` differs from
    rank 0's, bit for bit."""
    from gan_deeplearning4j_tpu_torch.harness.experiment import flatten_states

    def flat(r):
        value = r[key][field]
        return _host_flat(value if field == "states" else flatten_states({"s": value}))

    first = flat(ranks[0])
    return sorted({k for r in ranks[1:] for k in _not_bit_equal(flat(r), first)})[:5]


def _first_steps(rank: dict, losses: dict, grads: dict) -> dict:
    """A rank's first-step losses and mesh-mean gradients against others:
    the worst loss relative error and the worst gradient leaf (normwise)."""
    from gan_deeplearning4j_tpu_torch.harness.experiment import flatten_states, state_divergence

    return {"loss_max_rel": max(abs(rank["losses"][k] - losses[k]) / abs(losses[k]) for k in losses),
            "max_leaf_rel": state_divergence(_host_flat(flatten_states(rank["grads"])),
                                             _host_flat(flatten_states(grads)))["max_leaf_rel"]}


def _phase_parallel(x, y, directory: str, card: str) -> dict:
    """(v) Parallel training on the card: (v1) NCCL at world size 1,
    captured; (v2) the reference's local[4], four gloo ranks sharing the
    card; (v3) mesh checkpoints; (v4) timing, recorded."""
    import torch.distributed as dist

    from gan_deeplearning4j_tpu_torch.runtime.environment import initialize_distributed, make_mesh

    # (v1) one in-process NCCL rank on cuda:0, rendezvous by a FileStore;
    # the group is destroyed before the directory that holds its store
    initialize_distributed(rank=0, world_size=1, init_file=os.path.join(directory, "pg_store"),
                           backend="nccl")
    try:
        return _parallel_phases(make_mesh(use_accelerator=True), x, y, directory, card)
    finally:
        dist.destroy_process_group()


def _parallel_phases(mesh, x, y, directory: str, card: str) -> dict:
    from gan_deeplearning4j_tpu_torch.parallel import drill
    from gan_deeplearning4j_tpu_torch.parallel.launch import spawn

    out, failed = {}, []
    t0 = time.perf_counter()
    out["nccl_world1"] = []
    for name, family, batch, overrides, k in PARALLEL_CASES:
        row, ok = _parallel_case(mesh, name, family, batch, overrides, k, x, y, card)
        out["nccl_world1"].append(row)
        if not ok:
            failed.append(f"v1 {name}")
    out["seconds"] = {"v1": time.perf_counter() - t0}

    # (v2) four gloo ranks sharing the card, every scenario in one spawn;
    # the same pmean and WGAN-GP runs on four CPU ranks; one card alone
    t0 = time.perf_counter()
    gen_dir = os.path.join(directory, "parallel_generation")
    os.makedirs(gen_dir, exist_ok=True)
    rows = WORKERS * WORKER_ROWS
    fx, fy = _parallel_batches("mnist", x, y, rows, 3)
    wx, _ = _parallel_batches("wgan_gp", x, y, 320, 1)
    dis = _parallel_experiment("mnist", 8).dis
    dis_params = {l: {n: t.cpu().numpy() for n, t in lp.items()}
                  for l, lp in dis.init(SEED, device="cpu").items()}
    freq = 10
    rounds_x = np.tile(x, (-(-WORKERS * freq * WORKER_ROWS // x.shape[0]), 1))[
        :WORKERS * freq * WORKER_ROWS][None]
    soft = np.full(rounds_x.shape[:2] + (1,), 0.95, np.float32)
    mnist = {"save_models": False, "batch_size_train": rows}
    wgan = {**FAMILIES["wgan_gp"], "save_models": False, "batch_size_train": 320,
            "distributed": "pmean"}
    scen = {
        "rounds": ("averaging_rounds", dict(topology=dis.to_dict(), params=dis_params,
                                            rounds_x=rounds_x, rounds_y=soft, freq=freq,
                                            batch=WORKER_ROWS, use_accelerator=True)),
        "averaging": ("experiment_run", dict(
            config={**mnist, "distributed": "param_averaging",
                    "batch_size_per_worker": WORKER_ROWS, "averaging_frequency": freq},
            states=None, batches=fx[:2], labels=fy[:2])),
        "pmean": ("experiment_run", dict(config={**mnist, "distributed": "pmean"}, states=None,
                                         batches=fx[:1], labels=fy[:1], shards_dir=gen_dir,
                                         warm=2, timed=5)),
        "pmean_update_sharding": ("experiment_run", dict(
            config={**mnist, "distributed": "pmean", "update_sharding": True}, states=None,
            batches=fx[:1], labels=fy[:1])),
        "wgan_gp": ("experiment_run", dict(config=wgan, states=None, batches=wx[:1])),
        "wgan_first_steps": ("wgan_first_steps", dict(config=wgan, batch=wx[0])),
        "dis_steps": ("graph_steps", dict(topology=dis.to_dict(), params=dis_params, features=fx[0],
                                          labels=soft[0, :rows], steps=3, shard_updates=True,
                                          use_accelerator=True)),
    }
    card_ranks = spawn(drill.run_all, WORKERS, (scen,), backend="gloo", use_accelerator=True,
                       timeout=600, threads=2)
    cpu_scen = {
        "pmean": ("experiment_run", dict(config={**mnist, "distributed": "pmean",
                                                 "use_accelerator": False},
                                         states=None, batches=fx[:1], labels=fy[:1])),
        "wgan_gp": ("experiment_run", dict(config={**wgan, "use_accelerator": False}, states=None,
                                           batches=wx[:1])),
        "wgan_first_steps": ("wgan_first_steps", dict(config={**wgan, "use_accelerator": False},
                                                      batch=wx[0])),
    }
    cpu_ranks = spawn(drill.run_all, WORKERS, (cpu_scen,), backend="gloo", use_accelerator=False,
                      timeout=600, threads=2)
    out["seconds"]["v2_spawns"] = time.perf_counter() - t0
    single = _parallel_experiment("mnist", rows)
    single_losses = _loss_row(single.train_iteration(fx[0], fy[0]))
    single_flat = _flat(single)
    single_wgan = _parallel_experiment("wgan_gp", 320)
    first_losses, first_grads = _wgan_first_step_grads(single_wgan, wx[0])
    single_wgan_losses = _loss_row(single_wgan.train_iteration(wx[0], None))
    single_wgan_flat = _flat(single_wgan)
    r0, c0 = card_ranks[0], cpu_ranks[0]
    pmean_card = _host_flat(r0["pmean"]["states"])
    apart = _frozen_updater_keys(single, pmean_card)
    rounding = single_wgan.rounding_only_keys()

    def compare(losses_a, flat_a, losses_b, flat_b, rounding_only=(), apart_keys=()):
        return {"loss_max_rel": _loss_rel(losses_a, losses_b),
                **_state_limits(flat_a, flat_b, rounding_only, apart_keys)}

    checks = {
        "ranks_differing": {key: _ranks_differing(card_ranks, key) for key in
                            ("averaging", "pmean", "pmean_update_sharding", "wgan_gp")},
        "rounds_ranks_differing": _ranks_differing(card_ranks, "rounds", "state"),
        "pmean_world4_vs_one_card": compare(_loss_row(r0["pmean"]["losses"][0]), pmean_card,
                                            single_losses, single_flat, (), apart),
        "pmean_world4_card_vs_cpu": compare(_loss_row(r0["pmean"]["losses"][0]), pmean_card,
                                            _loss_row(c0["pmean"]["losses"][0]),
                                            _host_flat(c0["pmean"]["states"]), (), apart),
        # (e)'s limits: the first critic step and a generator step from one
        # state; the round (five Adam steps at beta1 = 0) is reported
        "wgan_first_steps_world4_vs_one_card": _first_steps(r0["wgan_first_steps"], first_losses,
                                                            first_grads),
        "wgan_first_steps_world4_card_vs_cpu": _first_steps(
            r0["wgan_first_steps"], c0["wgan_first_steps"]["losses"],
            c0["wgan_first_steps"]["grads"]),
        "wgan_world4_vs_one_card": compare(
            _loss_row(r0["wgan_gp"]["losses"][0])[:2], _host_flat(r0["wgan_gp"]["states"]),
            single_wgan_losses[:2], single_wgan_flat, rounding),
        "wgan_world4_card_vs_cpu": compare(
            _loss_row(r0["wgan_gp"]["losses"][0])[:2], _host_flat(r0["wgan_gp"]["states"]),
            _loss_row(c0["wgan_gp"]["losses"][0])[:2], _host_flat(c0["wgan_gp"]["states"]), rounding),
        "update_sharding_vs_replicated_leaves_differing": _not_bit_equal(
            _host_flat(r0["pmean_update_sharding"]["states"]), pmean_card)[:5],
        "update_sharding_losses_bit_equal": _loss_row(r0["pmean_update_sharding"]["losses"][0])
        == _loss_row(r0["pmean"]["losses"][0]),
    }
    from gan_deeplearning4j_tpu_torch.harness.experiment import flatten_states, state_divergence

    steps = r0["dis_steps"]
    checks["dis_steps"] = {
        "exact_sharded_leaves_differing": _not_bit_equal(
            _host_flat(flatten_states({"s": steps["sharded"]["state"]})),
            _host_flat(flatten_states({"s": steps["pmean"]["state"]})))[:5],
        # gloo's reduce-scatter may add the ranks' sums in another order
        # than its all-reduce (ring chunks differ with the buffer's layout)
        "reduce_scatter_vs_replicated_max_leaf_rel": state_divergence(
            _host_flat(flatten_states({"s": steps["sharded_reduce_scatter"]["state"]})),
            _host_flat(flatten_states({"s": steps["pmean"]["state"]})))["max_leaf_rel"],
        "reduce_scatter_loss_max_rel": _loss_rel(steps["sharded_reduce_scatter"]["losses"],
                                                 steps["pmean"]["losses"]),
        "resident_updater_bytes_per_rank": {m: steps[m]["resident_bytes"] for m in
                                            ("pmean", "sharded", "sharded_reduce_scatter")},
    }
    checks["resident_updater_bytes_per_rank"] = {
        "replicated": r0["pmean"]["resident_bytes"],
        "update_sharding": [r["pmean_update_sharding"]["resident_bytes"] for r in card_ranks]}
    checks["averaging_losses"] = r0["averaging"]["losses"]
    checks["rounds_losses"] = np.asarray(r0["rounds"]["losses"]).tolist()
    checks["no_child_loads_jax"] = not any(s["jax_loaded"] for r in card_ranks + cpu_ranks
                                           for s in r.values())
    row = {"phase": "parallel_gloo_world4", "ranks": WORKERS, "rows_per_rank": WORKER_ROWS,
           "backend": "gloo", "device": "cuda:0 (shared)", **checks, "card": card}
    print(json.dumps(row, default=float))
    out["gloo_world4"] = row
    limits_ok = all(
        checks[key]["loss_max_rel"] <= ITER_LOSS_RTOL and checks[key]["max_leaf_rel"] <= ITER_LEAF_REL
        for key in ("pmean_world4_vs_one_card", "pmean_world4_card_vs_cpu",
                    "wgan_first_steps_world4_vs_one_card", "wgan_first_steps_world4_card_vs_cpu"))
    if not (limits_ok and not any(checks["ranks_differing"].values())
            and not checks["rounds_ranks_differing"]
            and not checks["update_sharding_vs_replicated_leaves_differing"]
            and checks["update_sharding_losses_bit_equal"]
            and not checks["dis_steps"]["exact_sharded_leaves_differing"]
            and max(checks["resident_updater_bytes_per_rank"]["update_sharding"])
            <= checks["resident_updater_bytes_per_rank"]["replicated"] * 1.35 / WORKERS
            and checks["no_child_loads_jax"]):
        failed.append("v2")

    # (v3) the four ranks' mesh checkpoint, restored at world 1 (NCCL, this
    # process) and world 2 (gloo on the card); two iterations from it
    # against two from a whole-file checkpoint of the same state
    t0 = time.perf_counter()
    pmean = {**mnist, "distributed": "pmean"}
    from_shards = _parallel_experiment("mnist", rows, mesh, distributed="pmean")
    from_shards.load_models(gen_dir)
    restored = _flat(from_shards)
    whole_dir = os.path.join(directory, "parallel_whole")
    from_shards.save_models(whole_dir)
    from_whole = _parallel_experiment("mnist", rows, mesh, distributed="pmean")
    from_whole.load_models(whole_dir)
    two = []
    for exp in (from_shards, from_whole):
        two.append([_loss_row(exp.train_iteration(fx[1 + i], fy[1 + i])) for i in range(2)])
    world2 = spawn(drill.load_generation, 2, (pmean | {"use_accelerator": True}, gen_dir),
                   backend="gloo", use_accelerator=True, timeout=300, threads=2)
    row = {"phase": "parallel_checkpoints", "shards": sorted(os.listdir(gen_dir)),
           "world1_nccl_leaves_differing": _not_bit_equal(restored, pmean_card)[:5],
           "world2_gloo_leaves_differing": sorted({k for r in world2 for k in _not_bit_equal(
               _host_flat(r["states"]), pmean_card)})[:5],
           "two_more_from_shards_equal_from_whole_file_losses": two[0] == two[1],
           "two_more_leaves_differing": _not_bit_equal(_flat(from_shards), _flat(from_whole))[:5],
           "card": card}
    print(json.dumps(row))
    out["checkpoints"] = row
    out["seconds"]["v3"] = time.perf_counter() - t0
    if (row["world1_nccl_leaves_differing"] or row["world2_gloo_leaves_differing"]
            or not row["two_more_from_shards_equal_from_whole_file_losses"]
            or row["two_more_leaves_differing"] or len(row["shards"]) != WORKERS):
        failed.append("v3")
    del from_shards, from_whole, single, single_wgan
    gc.collect()
    torch.cuda.empty_cache()

    # (v4) timing, recorded: MNIST at 200 a rank, the single card captured
    # against NCCL world 1 captured; gloo world 4 (eager) from (v2)
    t0 = time.perf_counter()
    tx, ty = fx[0][:WORKER_ROWS], fy[0][:WORKER_ROWS]
    timing = {}
    for label, exp in (("single_card_captured", _parallel_experiment("mnist", WORKER_ROWS)),
                       ("nccl_world1_captured", _parallel_experiment("mnist", WORKER_ROWS, mesh,
                                                                     distributed="pmean"))):
        timing[label] = _iteration_timing(exp, tx, ty)
        del exp
        gc.collect()
        torch.cuda.empty_cache()
    per_rank = [statistics.median(r["pmean"]["iteration_s"]) * 1e3 for r in card_ranks]
    staging = [r["pmean"]["staging"] for r in card_ranks]
    timing["gloo_world4_eager"] = {
        "iteration_ms_median_by_rank": per_rank,
        "rows_per_s_over_four_ranks": rows / max(per_rank) * 1e3,
        "host_staging_share_by_rank": [s["seconds"] / sum(r["pmean"]["iteration_s"])
                                       for s, r in zip(staging, card_ranks)],
        "host_staging_calls_per_iteration": staging[0]["calls"] / len(r0["pmean"]["iteration_s"]),
        "host_staging_mib_per_iteration": staging[0]["bytes"] / len(r0["pmean"]["iteration_s"]) / 2**20,
    }
    row = {"phase": "parallel_timing", **timing, "card": card}
    print(json.dumps(row))
    out["timing"] = row
    out["seconds"]["v4"] = time.perf_counter() - t0
    if failed:
        raise AssertionError(f"(v) failed: {failed}")
    return out


def _post_path(base: str, path: str):
    req = urllib.request.Request(f"{base}{path}", data=b"{}", headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, json.loads(r.read())


# -- (w) evaluation on the card ----------------------------------------------------------

#: (w) the quality run's settings: the reference's width, a short run
QUALITY_ARGS = ["--iterations", "100", "--export-every", "25", "--select-samples", "2048",
                "--fid-samples", "10000"]
EVAL_TOL = 1e-4
FID_CPU_RTOL = 1e-3


def _feature_errors(card_fn, cpu_fn, rows) -> dict:
    """The card's features against the CPU's on the same rows, relative to
    the largest CPU feature."""
    card, cpu = card_fn(rows), cpu_fn(rows)
    if card.shape != cpu.shape or not np.isfinite(card).all():
        raise AssertionError(f"features {card.shape} on the card, {cpu.shape} on the CPU")
    return {"rows": int(len(rows)), "features": int(card.shape[1]),
            "max_rel_err": float(np.abs(card - cpu).max() / np.abs(cpu).max())}


def _eval_interpreter(x, directory: str, card: str) -> dict:
    """(w1) The schema interpreter and the frozen extractor, card vs CPU."""
    from gan_deeplearning4j_tpu_torch.eval.fid import frozen_feature_fn, inception_feature_fn
    from gan_deeplearning4j_tpu_torch.eval.inception_schema import inception_v3_stem, write_schema
    from gan_deeplearning4j_tpu_torch.harness import ExperimentConfig
    from gan_deeplearning4j_tpu_torch.models import registry

    celeba = registry.get("celeba64")
    celeba_rows = celeba.synthetic_data(
        16, celeba.make_model_config(ExperimentConfig(**FAMILIES["celeba64"])), SEED)
    paths = {side: write_schema(os.path.join(directory, f"inception_{side}.npz"),
                                *inception_v3_stem(side, side, seed=SEED)) for side in (299, 32)}
    cases = {
        "stem_299_from_mnist_28x28x1": (paths[299], (28, 28, 1), x[:16]),
        "stem_32_from_celeba64_64x64x3": (paths[32], (64, 64, 3), celeba_rows),
    }
    errors = {}
    for name, (path, (h, w, c), rows) in cases.items():
        errors[name] = _feature_errors(inception_feature_fn(h, w, c, path=path, batch_size=8),
                                       inception_feature_fn(h, w, c, path=path, batch_size=8,
                                                            device="cpu"), rows)
    errors["frozen_seed7_64x64x3"] = _feature_errors(
        frozen_feature_fn(64, 64, 3, seed=7, batch_size=8),
        frozen_feature_fn(64, 64, 3, seed=7, batch_size=8, device="cpu"), celeba_rows)
    out = {"schemas": paths, "limit": EVAL_TOL, "card_vs_cpu": errors}
    print(json.dumps({"phase": "eval_interpreter", **out, "card": card}))
    bad = {k: v for k, v in errors.items() if v["max_rel_err"] > EVAL_TOL}
    if bad:
        raise AssertionError(f"(w1) card vs CPU features past {EVAL_TOL}: {bad}")
    return out


def _report_keys() -> tuple:
    """``scripts/quality_run.py``'s report keys (top level, best checkpoint),
    read from its source: the reference the port's report is held to."""
    import ast

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts", "quality_run.py")
    tree = ast.parse(open(path).read())
    report = next(n.value for n in ast.walk(tree) if isinstance(n, ast.Assign)
                  and any(isinstance(t, ast.Name) and t.id == "report" for t in n.targets))
    keys = [k.value for k in report.keys]
    return keys, [k.value for k in report.values[keys.index("best_checkpoint")].orelse.keys]


class _Generator:
    """What ``quick_fid_scorer`` reads of an experiment, for params held
    apart from one."""

    def __init__(self, exp, params, device):
        self.model_cfg, self.gen, self._compute_dtype = exp.model_cfg, exp.gen, exp._compute_dtype
        self.gen_params, self.device = params, torch.device(device)


def _clone_tree(tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    return tree.detach().clone()


def _fit_vs_steps(exp, x, y) -> dict:
    """``GraphTrainer.fit`` over an in-memory record reader against as many
    ``train_step``s, on the card, from a copy of the trained classifier."""
    from gan_deeplearning4j_tpu_torch.data import InMemoryRecordReader, RecordReaderDataSetIterator
    from gan_deeplearning4j_tpu_torch.harness.experiment import flatten_states
    from gan_deeplearning4j_tpu_torch.parallel import GraphTrainer, TrainState

    batch, steps = 200, 4
    rows = np.concatenate([x[:batch * steps], y[:batch * steps].argmax(1)[:, None]], axis=1)
    trainer = GraphTrainer(exp.cv)

    def start():
        st = exp.cv_state
        return TrainState(_clone_tree(st.params), _clone_tree(st.opt_state), st.step)

    it = RecordReaderDataSetIterator(InMemoryRecordReader(rows), batch, label_index=784,
                                     num_classes=10)
    fitted, losses = trainer.fit(start(), it, num_batches=steps)
    stepped, step_losses = start(), []
    it.reset()
    for _ in range(steps):
        b = it.next().to_device(exp.device)
        stepped, loss = trainer.train_step(stepped, b.features, b.labels)
        step_losses.append(float(loss))
    a = flatten_states({"cv": {"params": fitted.params, "opt_state": fitted.opt_state}})
    b = flatten_states({"cv": {"params": stepped.params, "opt_state": stepped.opt_state}})
    differing = sorted(k for k in b if not torch.equal(a[k], b[k]))
    return {"batches": steps, "batch": batch, "losses": losses,
            "losses_equal": losses == step_losses, "leaves": len(b), "differing": differing}


def _eval_quality_run(x, y, directory: str, card: str, schema_299: str) -> dict:
    """(w2) The quality run on the card and its checks; (w3)'s timings of it."""
    from gan_deeplearning4j_tpu_torch.eval import quality_run
    from gan_deeplearning4j_tpu_torch.eval.accuracy import evaluate_classifier
    from gan_deeplearning4j_tpu_torch.eval.fid import (
        FeatureStats,
        frozen_feature_fn,
        inception_feature_fn,
        quick_fid_scorer,
    )
    from gan_deeplearning4j_tpu_torch.ops import linear
    from gan_deeplearning4j_tpu_torch.utils.serializer import read_model

    out_dir = os.path.join(directory, "quality_run")
    previous = os.environ.get("INCEPTION_WEIGHTS")
    os.environ["INCEPTION_WEIGHTS"] = schema_299
    linear.KERNEL_LAUNCHES["quant_dense"] = 0
    try:
        report, parts = quality_run.run(quality_run.build_parser().parse_args(
            QUALITY_ARGS + ["--out", out_dir]))
    finally:
        if previous is None:
            os.environ.pop("INCEPTION_WEIGHTS", None)
        else:
            os.environ["INCEPTION_WEIGHTS"] = previous
    quant_launches = linear.KERNEL_LAUNCHES["quant_dense"]
    exp, best = parts["experiment"], parts["best"]
    failed = []
    keys, best_keys = _report_keys()
    if list(report) != keys or list(report["best_checkpoint"]) != best_keys:
        failed.append(f"report keys {list(report)} / {list(report['best_checkpoint'])}")
    if report["platform"] != "gpu" or report["device_kind"] != torch.cuda.get_device_name(0):
        failed.append(f"platform {report['platform']!r}, {report['device_kind']!r}")
    if not isinstance(report["fid_inception"], float) or \
            not str(report["fid_inception_source"]).startswith("inception:"):
        failed.append(f"fid_inception {report['fid_inception']!r} "
                      f"({report['fid_inception_source']!r})")

    # the saved best generator scores its curve entry again, bit for bit
    seed, select = 666 + 13, int(QUALITY_ARGS[QUALITY_ARGS.index("--select-samples") + 1])
    best_params = (read_model(parts["best_zip"], load_updater=False)[1] if parts["best_zip"]
                   else best["gen_params"])
    rescore = quick_fid_scorer(exp, parts["frozen_fn"], parts["real_stats"], num_samples=select,
                               seed=seed)
    best_again = rescore(_Generator(exp, best_params, exp.device), best["iteration"])
    curve_entry = dict(map(tuple, best["curve"]))[best["iteration"]]
    if best_again != best["fid"] or round(best_again, 3) != curve_entry:
        failed.append(f"best rescored {best_again!r}, tracked {best['fid']!r} ({curve_entry})")

    # the final generator's quick FID, card against CPU from the same params
    (xtr, _), (xte, yte) = parts["data"]
    final_card = quick_fid_scorer(exp, parts["frozen_fn"], parts["real_stats"],
                                  num_samples=select, seed=seed)(exp, -1)
    cpu_frozen = frozen_feature_fn(28, 28, 1, seed=666, batch_size=2500, device="cpu")
    cpu_params = {k: {n: t.cpu() for n, t in lp.items()} for k, lp in exp.gen_params.items()}
    final_cpu = quick_fid_scorer(_Generator(exp, cpu_params, "cpu"), cpu_frozen,
                                 FeatureStats.from_features(cpu_frozen(xtr)), num_samples=select,
                                 seed=seed)(_Generator(exp, cpu_params, "cpu"), -1)
    fid_rel = abs(final_card - final_cpu) / abs(final_cpu)
    if fid_rel > FID_CPU_RTOL:
        failed.append(f"final quick FID {final_card} on the card, {final_cpu} on the CPU")

    # in-process accuracy against the exported predictions'
    t0 = time.perf_counter()
    acc = evaluate_classifier(exp.cv, exp.cv_state.params, xte, yte)
    eval_s = time.perf_counter() - t0
    if acc != parts["accuracy"]:
        failed.append(f"evaluate_classifier {acc} against export_predictions {parts['accuracy']}")
    t0 = time.perf_counter()
    evaluate_classifier(exp.cv, exp.cv_state.params, xtr, parts["data"][0][1])
    eval_train_s = time.perf_counter() - t0

    fit = _fit_vs_steps(exp, x, y)
    if fit["differing"] or not fit["losses_equal"]:
        failed.append(f"fit against train_step: {fit['differing'][:5]}")

    # (w3) timings
    score_ms = []
    for i in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rescore(exp, 10_000 + i)
        score_ms.append((time.perf_counter() - t0) * 1e3)
    z = torch.from_numpy(np.random.default_rng(seed).random((select, 2), dtype=np.float32) * 2 - 1)
    z = z.to(exp.device)

    def quick_device():
        with torch.inference_mode():
            parts["frozen_fn"].forward(exp.gen.output(exp.gen_params, z, train=False))

    inc = inception_feature_fn(28, 28, 1, path=schema_299, batch_size=2500)
    inc_rows = xtr[:2500]
    inc(inc_rows)  # warm: cuDNN's plans
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    inc(inc_rows)
    inc_s = time.perf_counter() - t0
    x_dev = torch.from_numpy(inc_rows).to(exp.device)
    with torch.inference_mode():
        inc_device_ms = _event_median_ms(lambda: inc.forward(x_dev), runs=3, warm=1)
    timing = {
        "quick_fid_score_ms": statistics.median(score_ms),
        "quick_fid_device_ms": _event_median_ms(quick_device, runs=20, warm=1),
        "quick_fid_rows": select,
        "inception_299_rows_per_s": len(inc_rows) / inc_s,
        "inception_299_device_rows_per_s": len(inc_rows) / inc_device_ms * 1e3,
        "inception_rows": len(inc_rows),
        "evaluate_classifier_rows_per_s": len(xtr) / eval_train_s,
        "evaluate_classifier_test_s": eval_s,
        "phase_seconds": parts["phase_seconds"],
    }
    out = {"report": report, "best_rescored": best_again, "final_quick_fid_card": final_card,
           "final_quick_fid_cpu": final_cpu, "final_quick_fid_rel": fid_rel,
           "accuracy_in_process": acc, "accuracy_exported": parts["accuracy"], "fit": fit,
           "quant_dense_launches": quant_launches, "timing": timing}
    print(json.dumps({"phase": "eval_quality_run", **{k: v for k, v in out.items() if k != "timing"},
                      "card": card}))
    print(json.dumps({"phase": "eval_timing", **timing, "card": card}))
    if failed:
        raise AssertionError(f"(w2) quality run: {failed}")
    return out


def _phase_eval(x, y, directory: str, card: str) -> dict:
    """(w) Evaluation on the card: (w1) the interpreters card vs CPU, (w2)
    the quality run and its checks, (w3) their timings."""
    gc.collect()
    torch.cuda.empty_cache()
    interp = _eval_interpreter(x, directory, card)
    out = {"interpreter": interp,
           "quality_run": _eval_quality_run(x, y, directory, card, interp["schemas"][299])}
    gc.collect()
    torch.cuda.empty_cache()
    return out


#: the training phases ``--only`` can run by themselves: (x, y, directory, card)
_TRAINING_ONLY = {"windows": lambda *a: _phase_windows(*a),
                  "capture_timing": lambda x, y, d, card: _phase_capture_timing(x, y, card),
                  "zoo": lambda *a: _phase_zoo(*a),
                  "parallel": lambda *a: _phase_parallel(*a),
                  "eval": lambda *a: _phase_eval(*a)}


def _run_only(names, card: str) -> int:
    """A rehearsal of some training phases on the card: each phase's rows,
    and their seconds; no result line."""
    failed = []
    with tempfile.TemporaryDirectory() as directory:
        x, y, _, _ = _training_data(os.path.join(directory, "data"))
        for name in names:
            t0 = time.perf_counter()
            try:
                _TRAINING_ONLY[name](x, y, directory, card)
            except Exception:
                traceback.print_exc()
                failed.append(name)
            print(json.dumps({"phase": "phase_seconds", name: time.perf_counter() - t0, "card": card}))
    if failed:
        print(f"chip_smoke: phases failed: {failed}", file=sys.stderr)
    return 1 if failed else 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--json", default=None, help="also write every measurement to this file")
    parser.add_argument("--only", nargs="+", default=None, choices=sorted(_TRAINING_ONLY),
                        help="rehearse only these training phases (prints no result line)")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    # cuBLAS reads this when it makes its handle: needed for phase (b)'s
    # deterministic-algorithms check to judge cuBLAS calls
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    from gan_deeplearning4j_tpu_torch.serving import ServingEngine

    t_start = time.perf_counter()
    card = _card()
    print(f"card: {card}")
    if args.only:
        return _run_only(args.only, card)
    # the port's hand-written kernel, built from the checkout's source
    from gan_deeplearning4j_tpu_torch.ops import _native

    t0 = time.perf_counter()
    _native.quant_dense()
    build = {"phase": "kernel_build", "seconds": time.perf_counter() - t0,
             "libraries": {"quant_dense": os.path.relpath(_native.library_path())},
             "ptxas": {"quant_dense": [line.strip() for line in _native.build_log().splitlines()
                                       if "registers" in line or "spill" in line]}}
    print(json.dumps(build))
    with tempfile.TemporaryDirectory() as directory:
        models = _build_bundle(directory)
        engine = ServingEngine.from_bundle(directory, device="cuda")
        cpu_engine = ServingEngine.from_bundle(directory, device="cpu")
        t0 = time.perf_counter()
        engine.warmup()
        warmup_s = time.perf_counter() - t0
        want = {k: engine.expected_max_compiles for k in engine.kinds}
        if engine.compile_counts != want or engine.serve_compile_counts != {k: 0 for k in want}:
            raise AssertionError(f"first runs {engine.compile_counts} (want {want}), "
                                 f"after warmup {engine.serve_compile_counts}")
        errs = _check_outputs(engine, cpu_engine)
        print(json.dumps({"phase": "parity", "card_vs_cpu_max_abs_err": errs, "tolerance": CPU_TOL,
                          "staged_equals_host": True, "card": card}))
        http = _check_http(engine)
        ladder = _time_ladder(engine, models)
        x, y, make_train, make_test = _training_data(os.path.join(directory, "data"))
        seconds = {"serving": time.perf_counter() - t_start}
        training = {}
        for key, run in (("card_vs_cpu", lambda: _phase_card_vs_cpu(x, y, card)),
                         ("resume", lambda: _phase_resume(x, y, os.path.join(directory, "ckpt"), card)),
                         ("run_publish", lambda: _phase_run_and_publish(make_train, make_test, directory,
                                                                        card)),
                         ("timing", lambda: _phase_timing(x, y, card))):
            t0 = time.perf_counter()
            training[key] = run()
            seconds[key] = time.perf_counter() - t0
        # the int8 variant of the serving bundle, for phases (m)-(o)
        from gan_deeplearning4j_tpu_torch.quant import build_int8_variant

        int8_dir = os.path.join(directory, "int8_variant")
        build_int8_variant(directory, int8_dir)
        # each family, bf16, window and int8 phase runs even when an
        # earlier one failed; a failure still fails the run
        families, failed = {}, []
        for key, run in (("card_vs_cpu", lambda: _phase_family_card_vs_cpu(card)),
                         ("resume", lambda: _phase_family_resume(directory, card)),
                         ("run_publish", lambda: _phase_family_run_publish(directory, card)),
                         ("timing", lambda: _phase_family_timing(card)),
                         ("bf16_card_vs_cpu", lambda: _phase_bf16_card_vs_cpu(x, y, card)),
                         ("bf16_resume", lambda: _phase_bf16_resume(x, y, directory, card)),
                         ("bf16_publish_serve",
                          lambda: _phase_bf16_publish_serve(x, y, directory, directory, card)),
                         ("bf16_timing", lambda: _phase_bf16_timing(x, y, card)),
                         ("windows", lambda: _phase_windows(x, y, directory, card)),
                         ("capture_timing", lambda: _phase_capture_timing(x, y, card)),
                         ("quant_kernel", lambda: _phase_quant_kernel(directory, int8_dir, card)),
                         ("int8_serve", lambda: _phase_int8_serve(directory, int8_dir, card)),
                         ("cost_and_canary",
                          lambda: _phase_cost_and_canary(directory, int8_dir, directory, card)),
                         ("serving_captured",
                          lambda: _phase_serving_captured(directory, int8_dir, directory, card)),
                         ("mux", lambda: _phase_mux(directory, int8_dir, directory, card)),
                         ("reload", lambda: _phase_reload(directory, directory, card)),
                         ("zoo", lambda: _phase_zoo(x, y, directory, card)),
                         ("parallel", lambda: _phase_parallel(x, y, directory, card)),
                         ("eval", lambda: _phase_eval(x, y, directory, card))):
            t0 = time.perf_counter()
            try:
                families[key] = run()
            except Exception:  # reported, and the run fails below
                traceback.print_exc()
                failed.append(key)
            seconds[key] = time.perf_counter() - t0
    if failed:
        print(f"chip_smoke: family / bf16 / window / int8 / serving / zoo / parallel / eval phases "
              f"failed: {failed}",
              file=sys.stderr)
        return 1
    top = engine.buckets[-1]
    for row in ladder:
        print(json.dumps({"phase": "latency", **row, "card": card}))
        if row["bucket"] == top:
            print(json.dumps({"phase": "throughput", "kind": row["kind"], "bucket": top,
                              "rows_per_s_run": top / row["run_ms"] * 1e3,
                              "rows_per_s_forward": top / row["forward_ms"] * 1e3, "card": card}))
    print(json.dumps({"phase": "http", **http, "warmup_s": warmup_s, "card": card}))
    print(json.dumps({"phase": "phase_seconds", **seconds, "total": time.perf_counter() - t_start,
                      "card": card}))
    if args.json:
        with open(args.json, "w") as fh:
            json.dump({"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
                       "parity": errs, "http": http, "warmup_s": warmup_s, "ladder": ladder,
                       "training": training, "families": families, "kernel_build": build,
                       "phase_seconds": seconds},
                      fh, indent=2)
    quant = families["quant_kernel"]
    top = next(r for r in quant["shapes"] if r["layer"] == "dis_dense_layer_6" and r["n"] == 128)
    print(json.dumps({"kernels": [{
        "name": "quant_dense", "route": "cuda",
        "source": "gan_deeplearning4j_tpu_torch/csrc/quant_dense.cu",
        "replaces": "gan_deeplearning4j_tpu/ops/linear.py:34",
        "launches": families["zoo"]["drill"]["kernel_launches"],
        "launches_by_path": {"int8_serve (n)": families["int8_serve"]["kernel_launches"],
                             "serving_captured (r)": families["serving_captured"]["kernel_launches"],
                             "mux (s)": families["mux"]["kernel_launches"],
                             "zoo (u)": families["zoo"]["drill"]["kernel_launches"],
                             "eval (w)": families["eval"]["quality_run"]["quant_dense_launches"]},
        "max_abs_err": quant["max_abs_err"], "ms": top["kernel_ms"], "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"], "bound_by": top["bound_by"], "library_ms": top["library_ms"],
        "shape": "x (128, 1152) fp32 · W_q (1152, 1024) int8 (dis_dense_layer_6)",
        "addmm_fp32_ms": top["addmm_fp32_ms"], "ms_l2_warm": top["kernel_l2_warm_ms"],
        "eager_ms": top["kernel_eager_ms"]}],
        "reason": (
            "the JAX package has no Pallas kernel (no pl.pallas_call anywhere in the repo); "
            "its one op that stock torch cannot fuse, the int8 quant_dense (XLA-lowered), "
            "is the port's one hand-written kernel; every other op runs through PyTorch "
            "(cuDNN, cuBLAS, ATen), as the JAX package leaves it to XLA")}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
