"""Smoke test of the PyTorch port on one NVIDIA GPU: ``python3 chip_smoke.py``.

Drives the port's serving path (``gan_deeplearning4j_tpu_torch``) at the
full width of the DCGAN-MNIST model, with random weights from seed 666, and
fails (non-zero exit, no result line) if any phase fails:

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
   and the HTTP round trip, each printed beside the card's name and power
   limit.

The JAX package has no Pallas kernel, so this slice ports none; the
``kernels`` line says so. The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
``--json PATH`` also writes every measurement to PATH.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch

SEED = 666
SIZES = (1, 3, 8, 21, 130)
CPU_TOL = 1e-4
TIMED_RUNS = 50


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


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--json", default=None, help="also write every measurement to this file")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
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
                       "parity": errs, "http": http, "warmup_s": warmup_s, "ladder": ladder}, fh,
                      indent=2)
    print(json.dumps({"kernels": [], "reason": (
        "the JAX package has no Pallas kernel (no pl.pallas_call anywhere in the repo); "
        "this slice runs convolutions, GEMMs and pooling through PyTorch (cuDNN, cuBLAS), "
        "as the JAX package leaves them to XLA")}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
