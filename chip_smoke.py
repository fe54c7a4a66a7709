"""Smoke test of the PyTorch port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Drives the port (``gan_deeplearning4j_tpu_torch``) at the full width of the
DCGAN-MNIST model and of the tabular, image and WGAN-GP families, with
random weights from seed 666, and fails (non-zero exit, no result line) if
any phase fails. First the serving path:

1. print the card's ``name, power.limit`` as ``nvidia-smi`` reports them;
2. build ``gen`` and the transfer classifier ``cv`` and write a serving
   bundle with the port's serializer;
3. load it with ``ServingEngine.from_bundle(..., device="cuda")``, warm up,
   and check that every (kind, bucket) ran once and none after warmup;
4. for every kind and n in (1, 3, 8, 21, 130): the card's rows match the
   same bundle served on the CPU within 1e-4 (TF32 off), and the staged
   ``run`` equals ``run_host`` bit for bit on the card;
5. serve it over HTTP (``make_server`` on an ephemeral port), send
   concurrent ``sample``/``classify``/``features`` requests and check status,
   shapes, softmax row sums and ``/healthz``;
6. time each (kind, bucket) with CUDA events over 50 runs — the model's
   forward pass on device-resident rows, and the engine's whole ``run`` —
   and the HTTP round trip.

Then the training path (``GanExperiment``, the reference's settings, data
from ``prepare_mnist(source="synthetic")``):

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
   ``step.*`` ranges, host and device time), and the fp32 bound of the
   iteration's convolution and GEMM FLOPs at 67 TFLOP/s.

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

Every number is printed beside the card's name and power limit. The JAX
package has no Pallas kernel, so the port has no hand-written kernel; the
``kernels`` line says so. The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
``--json PATH`` also writes every measurement to PATH.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import traceback
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


def _post(base: str, kind: str, rows: np.ndarray):
    req = urllib.request.Request(
        f"{base}/v1/{kind}", data=json.dumps({"data": rows.tolist()}).encode(),
        headers={"Content-Type": "application/json"},
    )
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=60) as r:
        body = json.loads(r.read())
        status = r.status
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


def _event_median_ms(fn) -> float:
    """Median of ``TIMED_RUNS`` single runs of ``fn``, each between two CUDA
    events on the current stream, after five untimed runs."""
    for _ in range(5):
        fn()
    times = []
    for _ in range(TIMED_RUNS):
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


def _phase_card_vs_cpu(x, y, card: str) -> list:
    from gan_deeplearning4j_tpu_torch.harness import GanExperiment
    from gan_deeplearning4j_tpu_torch.harness.experiment import flatten_states, state_divergence

    gpu = GanExperiment(_config(batch_size_train=64))
    cpu = GanExperiment(_config(batch_size_train=64, use_accelerator=False))
    rows = []
    for it in range(2):
        xb, yb = x[it * 64:(it + 1) * 64], y[it * 64:(it + 1) * 64]
        lg, lc = gpu.train_iteration(xb, yb), cpu.train_iteration(xb, yb)
        loss_rel = max(abs(float(lg[k]) - float(lc[k])) / abs(float(lc[k])) for k in lc)
        loss_abs = max(abs(float(lg[k]) - float(lc[k])) for k in lc)
        a, b = flatten_states(gpu.digest_states()), flatten_states(cpu.digest_states())
        div = state_divergence(a, b)
        row = {"phase": "train_card_vs_cpu", "iteration": it + 1, "batch": 64,
               "losses_max_abs_err": loss_abs, "losses_max_rel_err": loss_rel,
               **{f"{k}_max_abs_err": v for k, v in _split_errors(a, b).items()},
               "max_leaf_rel_err": div["max_leaf_rel"], "card": card}
        print(json.dumps(row))
        rows.append(row)
        if it == 0 and (loss_rel > ITER_LOSS_RTOL or div["max_leaf_rel"] > ITER_LEAF_REL):
            raise AssertionError(f"card vs CPU after one iteration: {row}")
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
    # their kernels
    cpu_cuda = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=cpu_cuda) as prof:
        for xb, yb in batches[25:30]:
            exp.train_iteration(xb, yb)
        torch.cuda.synchronize()
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
    zs, epsilons, gen_z = exp._round_draws(int(exp.gen_state.step), batches.shape[1])
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



def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--json", default=None, help="also write every measurement to this file")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    # cuBLAS reads this when it makes its handle: needed for phase (b)'s
    # deterministic-algorithms check to judge cuBLAS calls
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    from gan_deeplearning4j_tpu_torch.serving import ServingEngine

    card = _card()
    print(f"card: {card}")
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
        training = {
            "card_vs_cpu": _phase_card_vs_cpu(x, y, card),
            "resume": _phase_resume(x, y, os.path.join(directory, "ckpt"), card),
            "run_publish": _phase_run_and_publish(make_train, make_test, directory, card),
            "timing": _phase_timing(x, y, card),
        }
        # each family and bf16 phase runs even when an earlier one failed;
        # a failure still fails the run
        families, failed = {}, []
        for key, run in (("card_vs_cpu", lambda: _phase_family_card_vs_cpu(card)),
                         ("resume", lambda: _phase_family_resume(directory, card)),
                         ("run_publish", lambda: _phase_family_run_publish(directory, card)),
                         ("timing", lambda: _phase_family_timing(card)),
                         ("bf16_card_vs_cpu", lambda: _phase_bf16_card_vs_cpu(x, y, card)),
                         ("bf16_resume", lambda: _phase_bf16_resume(x, y, directory, card)),
                         ("bf16_publish_serve",
                          lambda: _phase_bf16_publish_serve(x, y, directory, directory, card)),
                         ("bf16_timing", lambda: _phase_bf16_timing(x, y, card))):
            try:
                families[key] = run()
            except Exception:  # reported, and the run fails below
                traceback.print_exc()
                failed.append(key)
    if failed:
        print(f"chip_smoke: family / bf16 phases failed: {failed}", file=sys.stderr)
        return 1
    top = engine.buckets[-1]
    for row in ladder:
        print(json.dumps({"phase": "latency", **row, "card": card}))
        if row["bucket"] == top:
            print(json.dumps({"phase": "throughput", "kind": row["kind"], "bucket": top,
                              "rows_per_s_run": top / row["run_ms"] * 1e3,
                              "rows_per_s_forward": top / row["forward_ms"] * 1e3, "card": card}))
    print(json.dumps({"phase": "http", **http, "warmup_s": warmup_s, "card": card}))
    if args.json:
        with open(args.json, "w") as fh:
            json.dump({"card": card, "torch": torch.__version__, "cuda": torch.version.cuda,
                       "parity": errs, "http": http, "warmup_s": warmup_s, "ladder": ladder,
                       "training": training, "families": families}, fh, indent=2)
    print(json.dumps({"kernels": [], "reason": (
        "the JAX package has no Pallas kernel (no pl.pallas_call anywhere in the repo); "
        "the serving path and the training of every family (mnist, tabular, image, "
        "wgan_gp), in fp32 and in bf16 (mixed precision and bf16 storage, and bf16 "
        "bundles served), run convolutions, transposed convolutions, GEMMs, pooling, "
        "their backward passes and the gradient penalty's double backward through "
        "PyTorch (cuDNN, cuBLAS incl. its bf16 GEMM with an fp32 output, ATen) by "
        "autograd, and the optimizer updates as torch ops, as the JAX package leaves "
        "them to XLA")}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
