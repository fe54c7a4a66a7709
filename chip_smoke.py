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


def _phase_resume(x, y, directory: str, card: str) -> dict:
    import warnings

    from gan_deeplearning4j_tpu_torch.harness import GanExperiment
    from gan_deeplearning4j_tpu_torch.harness.experiment import flatten_states

    batches = [(x[i * 200:(i + 1) * 200], y[i * 200:(i + 1) * 200]) for i in range(4)]
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            straight = GanExperiment(_config())
            for xb, yb in batches:
                straight.train_iteration(xb, yb)
            first = GanExperiment(_config())
            for xb, yb in batches[:2]:
                first.train_iteration(xb, yb)
            first.save_models(directory)
            resumed = GanExperiment(_config())
            if resumed.load_models(directory) != 2:
                raise AssertionError("load_models did not restore iteration 2")
            for xb, yb in batches[2:]:
                resumed.train_iteration(xb, yb)
    finally:
        torch.use_deterministic_algorithms(False)
    a, b = flatten_states(straight.digest_states()), flatten_states(resumed.digest_states())
    differ = [k for k in a if not (torch.equal(a[k], b[k]) if isinstance(a[k], torch.Tensor)
                                   else a[k] == b[k])]
    if differ:
        raise AssertionError(f"resume is not bit-exact on the card: {differ[:5]}")
    flagged = sorted({str(w.message).split("\n")[0][:160] for w in caught
                      if "deterministic" in str(w.message)})
    row = {"phase": "train_resume", "batch": 200, "bit_exact": True, "leaves": len(a),
           "nondeterministic_ops_flagged": flagged, "card": card}
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


def _measure_iterations(exp, batches, batch: int, top_n: int) -> dict:
    """Steady-state cost of ``exp.train_iteration`` over ``batches`` (30
    ``(x, y)`` pairs): 5 warm iterations, the median of 20 by the host clock
    (with a synchronize) and by CUDA events, peak memory, then a
    ``torch.profiler`` window of 5 iterations tracing the card only
    (device-busy share, kernels per iteration, the ``top_n`` kernels), and
    the fp32 bound of the iteration's FLOPs from shapes at 67 TFLOP/s."""
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
    spans, by_name, launches = [], {}, 0
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        span = (ev.time_range.start, ev.time_range.end)
        spans.append(span)
        if not (ev.name.startswith("Memcpy") or ev.name.startswith("Memset")):
            launches += 1
            by_name[ev.name] = by_name.get(ev.name, 0.0) + span[1] - span[0]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:top_n]
    flops = exp.flops_per_iteration(batch)
    median_host, median_event = statistics.median(host_ms), statistics.median(event_ms)
    bound_ms = flops / FP32_FLOP_PER_S * 1e3
    return {"batch": batch, "iterations_timed": 20,
            "iteration_ms_host_median": median_host,
            "iteration_ms_event_median": median_event,
            "rows_per_s": batch / median_host * 1e3,
            "peak_memory_mib": peak_mib, "resident_before_mib": resident_mib,
            "profiled_iterations": 5,
            "device_busy_share": _union_us(spans) / wall_us,
            "kernels_per_iteration": launches / 5,
            "top_kernels": [{"name": k[:90], "ms_per_iteration": us / 5 / 1e3} for k, us in top],
            "flops_per_iteration": flops, "fp32_bound_ms": bound_ms,
            "roofline_share": bound_ms / median_event}


def _phase_timing(x, y, card: str) -> dict:
    from gan_deeplearning4j_tpu_torch.harness import GanExperiment

    exp = GanExperiment(_config())
    n = x.shape[0] // 200
    batches = [(x[(i % n) * 200:(i % n + 1) * 200], y[(i % n) * 200:(i % n + 1) * 200]) for i in range(30)]
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
    both at the experiment's current state and the round's draws."""
    batches = exp._critic_batches(exp._to_device(xb))
    zs, epsilons, gen_z = exp._round_draws(int(exp.gen_state.step), batches.shape[1])
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
    import warnings

    from gan_deeplearning4j_tpu_torch.harness.experiment import flatten_states

    rows = []
    for name, batch in (("cifar10", 64), ("wgan_gp", 320)):
        ckpt = os.path.join(directory, f"resume_{name}")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                straight = _family_experiment(name, batch)
                batches = _family_batches(straight, 4, batch)
                for xb, yb in batches:
                    straight.train_iteration(xb, yb)
                first = _family_experiment(name, batch)
                for xb, yb in batches[:2]:
                    first.train_iteration(xb, yb)
                first.save_models(ckpt)
                resumed = _family_experiment(name, batch)
                if resumed.load_models(ckpt) != 2:
                    raise AssertionError(f"{name}: load_models did not restore iteration 2")
                for xb, yb in batches[2:]:
                    resumed.train_iteration(xb, yb)
        finally:
            torch.use_deterministic_algorithms(False)
        a, b = flatten_states(straight.digest_states()), flatten_states(resumed.digest_states())
        differ = [k for k in a if not (torch.equal(a[k], b[k]) if isinstance(a[k], torch.Tensor)
                                       else a[k] == b[k])]
        flagged = sorted({str(w.message).split("\n")[0][:160] for w in caught
                          if "deterministic" in str(w.message)})
        row = {"phase": "family_resume", "family": name, "batch": batch, "bit_exact": not differ,
               "leaves": len(a), "differing_leaves": differ[:5],
               "nondeterministic_ops_flagged": flagged, "card": card}
        print(json.dumps(row))
        rows.append(row)
        if differ:
            raise AssertionError(f"{name}: resume is not bit-exact on the card: {differ[:5]}")
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
        # each family phase runs even when an earlier one failed; a failure
        # still fails the run
        families, failed = {}, []
        for key, run in (("card_vs_cpu", lambda: _phase_family_card_vs_cpu(card)),
                         ("resume", lambda: _phase_family_resume(directory, card)),
                         ("run_publish", lambda: _phase_family_run_publish(directory, card)),
                         ("timing", lambda: _phase_family_timing(card))):
            try:
                families[key] = run()
            except Exception:  # reported, and the run fails below
                traceback.print_exc()
                failed.append(key)
    if failed:
        print(f"chip_smoke: family phases failed: {failed}", file=sys.stderr)
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
        "wgan_gp) run convolutions, transposed convolutions, GEMMs, pooling, their "
        "backward passes and the gradient penalty's double backward through PyTorch "
        "(cuDNN, cuBLAS, ATen) by autograd, and the optimizer updates as torch ops, "
        "as the JAX package leaves them to XLA")}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
