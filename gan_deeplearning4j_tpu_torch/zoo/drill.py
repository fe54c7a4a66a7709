"""zoo drill — the model zoo end to end on the PyTorch port, counterpart of
the JAX package's ``scripts/zoo_drill.py``, with its JSON keys.

One scenario manifest drives each part, in one process:

1. **conditional dcgan-mnist** (z 2 plus a 10-wide one-hot, the
   reference's width): ``ScenarioManifest`` → ``experiment_config``
   → a training window fed through ``StreamingDataSetIterator`` (batches
   placed on the drill's device) → ``publish_for_serving`` (the bundle's
   ``serving.json`` carries the zoo block) → an ``InferenceService`` behind
   the stdlib HTTP front end. Every class is served through ``POST
   /v1/sample?class=k`` and must equal the engine's eager ``run_host`` on
   the same latent + one-hot rows bit for bit; after warmup no (kind,
   bucket) is captured again (the one-hot rides the padded buckets); and
   the error contract holds: bare latent-wide rows, an out-of-range class
   and ``?class=`` on ``classify`` answer 400.
2. **wgan_gp cifar_shaped**: manifest → config → one critic round through
   the same streaming iterator → publish → the engine boots the bundle as
   family ``wgan_gp`` and samples.
3. **mux**: both bundles and the int8 variant of the conditional bundle
   (which inherits its zoo block and serves through the hand-written
   ``quant_dense`` kernel on the card) behind one ``MuxRegistry`` /
   ``MuxService``, each priced by ``measure_bundle_cost`` on the ladder it
   serves, driven by concurrent clients pinned to a variant (``sample``
   rows, and every other request ``classify`` where the variant serves
   it): every request answered ok, none lost.

It runs on the card unless ``--device cpu`` asks for the CPU::

    python -m gan_deeplearning4j_tpu_torch.zoo.drill --smoke --device cpu

``--smoke`` is the small shape (a window of 2, batch 8, a short mux
load). Exit 0 when every invariant holds; the bundles are kept in the
work directory on a breach. ``--output PATH`` writes the JSON payload.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import threading
import time

import numpy as np
import torch


def log(msg: str) -> None:
    print(f"[zoo-drill] {msg}", file=sys.stderr, flush=True)


def _streamed_window(dataset: str, batch_size: int, iterations: int, num_classes: int,
                     seed: int, device):
    """A ``(K, B, F)`` training window and its ``(K, B, classes)`` one-hot
    labels, pulled through the streaming iterator onto ``device``."""
    from gan_deeplearning4j_tpu_torch.zoo.datasets import load_dataset
    from gan_deeplearning4j_tpu_torch.zoo.streaming import StreamingDataSetIterator, array_source

    rows_needed = batch_size * iterations
    (x, y), _ = load_dataset(dataset, num_train=max(rows_needed, 64), num_test=16, seed=seed)
    source, n = array_source(x, y)
    it = StreamingDataSetIterator(source, n, batch_size=batch_size, shuffle=True, seed=seed,
                                  block_batches=2, device=device)
    feats, labels = [], []
    try:
        while len(feats) < iterations:
            if not it.has_next():
                it.reset()
            batch = it.next()
            if batch.features.shape[0] < batch_size:  # ragged tail: next epoch
                continue
            feats.append(batch.features)
            labels.append(torch.nn.functional.one_hot(batch.labels.long(), num_classes).float())
    finally:
        it.close()
    return torch.stack(feats), torch.stack(labels)


def train_conditional(workdir: str, args) -> tuple:
    """Part 1a: scenario → streamed training window → published zoo bundle."""
    from gan_deeplearning4j_tpu_torch.harness import GanExperiment
    from gan_deeplearning4j_tpu_torch.zoo import ScenarioManifest

    scenario = ScenarioManifest(architecture="dcgan", conditioning="class", dataset="mnist",
                                resolution=28, num_classes=10)
    cfg = scenario.experiment_config(seed=args.seed, batch_size_train=args.batch_size,
                                     use_accelerator=args.device != "cpu")
    feats, labels = _streamed_window("mnist", cfg.batch_size_train, args.iterations,
                                     cfg.num_classes, args.seed, args.device)
    exp = GanExperiment(cfg)
    t0 = time.perf_counter()
    losses = exp.train_iterations(feats, labels)
    finite = bool(all(torch.isfinite(v).all() for k, v in losses.items() if k != "cv_loss"))
    train_s = time.perf_counter() - t0
    bundle_dir = os.path.join(workdir, "bundle_cond_mnist")
    manifest = exp.publish_for_serving(bundle_dir)
    log(f"conditional bundle published ({args.iterations} streamed iterations, "
        f"{train_s:.1f}s): zoo={manifest.get('zoo')}")
    return bundle_dir, scenario, {"iterations": args.iterations, "train_s": train_s,
                                  "losses_finite": finite, "zoo_block": manifest.get("zoo"),
                                  "captures": dict(exp.graphs.capture_counts)}


def _post(base: str, path: str, payload: dict):
    import urllib.error
    import urllib.request

    req = urllib.request.Request(f"{base}{path}", data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as exc:  # a 400 still answers JSON
        return exc.code, json.loads(exc.read() or b"{}")


def serve_conditional(bundle_dir: str, args, results: dict, invariants: dict) -> None:
    """Part 1b: ``sample?class=k`` over HTTP for every class, bit-equal to
    ``run_host``; no capture after warmup; the 400 contract."""
    from gan_deeplearning4j_tpu_torch.serving import InferenceService, ServingEngine, make_server

    engine = ServingEngine.from_bundle(bundle_dir, device=args.device)
    engine.warmup()
    service = InferenceService(engine, warmup=False)
    server = make_server(service, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    classes = engine.class_count
    latent = engine.latent_width("sample")
    rng = np.random.default_rng(args.seed + 7)
    parity, statuses = [], []
    try:
        for k in range(classes):
            z = rng.random((3, latent), dtype=np.float32) * 2.0 - 1.0
            status, body = _post(base, f"/v1/sample?class={k}", {"data": z.tolist()})
            statuses.append(status)
            if status != 200:
                parity.append(False)
                continue
            staged = np.asarray(body["data"], dtype=np.float32)
            onehot = np.zeros((3, classes), dtype=np.float32)
            onehot[:, k] = 1.0
            host = engine.run_host("sample", np.concatenate([z, onehot], axis=1))
            parity.append(bool(np.array_equal(staged, np.asarray(host))))
        serve_compiles = dict(engine.serve_compile_counts)
        z = rng.random((2, latent), dtype=np.float32)
        st_bare, body_bare = _post(base, "/v1/sample", {"data": z.tolist()})
        st_range, _ = _post(base, f"/v1/sample?class={classes + 2}", {"data": z.tolist()})
        st_kind, _ = _post(base, "/v1/classify?class=1",
                           {"data": np.zeros((1, engine.input_width("classify"))).tolist()})
    finally:
        server.shutdown()
        server.server_close()
        service.close()
    results["conditional"] = {
        "classes": classes,
        "latent_width": latent,
        "parity_per_class": parity,
        "parity_classes": sum(parity),
        "compile_counts": dict(engine.compile_counts),
        "expected_max_compiles": engine.expected_max_compiles,
        "serve_compile_counts": serve_compiles,
        "serve_compiles_total": sum(serve_compiles.values()),
        "bare_latent_status": st_bare,
        "out_of_range_status": st_range,
        "class_on_classify_status": st_kind,
    }
    invariants["per_class_parity"] = (len(parity) == classes and all(parity)
                                      and all(s == 200 for s in statuses))
    invariants["zero_serve_time_compiles"] = all(c == 0 for c in serve_compiles.values())
    invariants["conditional_error_contract"] = (
        st_bare == 400 and st_range == 400 and st_kind == 400
        and "class" in (body_bare or {}).get("error", ""))
    log(f"conditional serving: parity {sum(parity)}/{classes}, serve compiles "
        f"{serve_compiles}, 400s ({st_bare}, {st_range}, {st_kind})")


def train_wgan(workdir: str, args) -> tuple:
    """Part 2: WGAN-GP on ``cifar_shaped``, one streamed window of critic
    rounds, published and booted."""
    from gan_deeplearning4j_tpu_torch.harness.wgan_experiment import WganGpExperiment
    from gan_deeplearning4j_tpu_torch.serving import ServingEngine
    from gan_deeplearning4j_tpu_torch.zoo import ScenarioManifest

    scenario = ScenarioManifest(architecture="wgan_gp", conditioning="none",
                                dataset="cifar_shaped", resolution=32)
    batch = args.wgan_batch_size or args.batch_size
    cfg = scenario.experiment_config(seed=args.seed + 1, batch_size_train=batch, n_critic=2,
                                     use_accelerator=args.device != "cpu")
    feats, _ = _streamed_window("cifar_shaped", cfg.batch_size_train,
                                max(1, args.iterations // 2), cfg.num_classes, args.seed + 1,
                                args.device)
    exp = WganGpExperiment(cfg)
    t0 = time.perf_counter()
    exp.train_iterations(feats)
    train_s = time.perf_counter() - t0
    bundle_dir = os.path.join(workdir, "bundle_wgan_cifar")
    manifest = exp.publish_for_serving(bundle_dir)
    engine = ServingEngine.from_bundle(bundle_dir, device=args.device)
    sample = engine.run_host("sample", np.zeros((2, engine.input_width("sample")), dtype=np.float32))
    boots = sample.shape == (2, cfg.num_features) and bool(np.isfinite(sample).all())
    log(f"wgan bundle published ({train_s:.1f}s): family {manifest.get('family')}, "
        f"zoo={manifest.get('zoo')}, boot sample {sample.shape}")
    return bundle_dir, scenario, {"train_s": train_s, "family": manifest.get("family"),
                                  "zoo_block": manifest.get("zoo"), "boot_sample_ok": boots}


def run_mux(variants: dict, args, results: dict, invariants: dict) -> None:
    """Part 3: the variants (``{name: bundle dir}``) behind one mux, priced
    by measurement, under concurrent clients pinned to a variant (every
    other request ``classify`` where the variant serves it, so an int8
    variant's quantized layers run); every request answered ok, none
    lost."""
    from gan_deeplearning4j_tpu_torch.quant import measure_bundle_cost
    from gan_deeplearning4j_tpu_torch.serving.mux import MuxRegistry, MuxService
    from gan_deeplearning4j_tpu_torch.zoo import scenario_from_bundle

    ladder = tuple(int(b) for b in args.buckets.split(","))
    for bundle in variants.values():
        measure_bundle_cost(bundle, buckets=ladder, rounds=2, device=args.device)
    registry = MuxRegistry(buckets=ladder, budget=len(variants), device=args.device,
                           batcher_kwargs={"max_latency": 0.002, "max_queue": 64,
                                           "default_timeout": 60.0})
    for name, bundle in variants.items():
        registry.add(name, bundle_path=bundle, cost=1.0, weight=1.0 / len(variants))
        registry.ensure_resident(name)
    svc = MuxService(registry)
    engines = {name: registry.engine_for(name) for name in variants}
    widths = {name: e.input_width("sample") for name, e in engines.items()}

    per_thread = max(1, args.mux_requests // (len(variants) * args.mux_threads))
    counts_lock = threading.Lock()
    counts = {"sent": 0, "ok": 0, "errors": 0, "answered": 0}

    def client(tid: int, name: str) -> None:
        rng = np.random.default_rng(args.seed + 100 + tid)
        engine = engines[name]
        for i in range(per_thread):
            n = int(rng.integers(1, ladder[-1] + 1))
            kind = "classify" if i % 2 and "classify" in engine.kinds else "sample"
            if kind == "classify":
                rows = rng.random((n, engine.input_width(kind)), dtype=np.float32)
            elif engine.conditional:
                classes = engine.class_count
                z = rng.random((n, widths[name] - classes), dtype=np.float32) * 2 - 1
                onehot = np.eye(classes, dtype=np.float32)[rng.integers(classes, size=n)]
                rows = np.concatenate([z, onehot], axis=1)
            else:
                rows = rng.random((n, widths[name]), dtype=np.float32) * 2 - 1
            with counts_lock:
                counts["sent"] += 1
            status, body = svc.handle("POST", f"/v1/{kind}", {"data": rows.tolist(), "model": name})
            with counts_lock:
                counts["answered"] += 1
                if status == 200 and len(body.get("data", [])) == n:
                    counts["ok"] += 1
                else:
                    counts["errors"] += 1

    threads = [threading.Thread(target=client, args=(i, name), daemon=True)
               for i, name in enumerate(list(variants) * args.mux_threads)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    elapsed = time.perf_counter() - t0
    hung = sum(t.is_alive() for t in threads)

    launches = {name: e.kernel_launches() for name, e in engines.items()}
    costs = registry.costs()
    sources = registry.cost_sources()
    arch = {name: getattr(scenario_from_bundle(bundle), "architecture", None)
            for name, bundle in variants.items()}
    served = _served_per_model()
    svc.close()
    results["mux"] = {
        "ladder": list(ladder),
        "widths": widths,
        "architectures": arch,
        "costs": costs,
        "cost_sources": sources,
        "sent": counts["sent"],
        "answered": counts["answered"],
        "ok": counts["ok"],
        "errors": counts["errors"],
        "lost": counts["sent"] - counts["answered"],
        "elapsed_s": elapsed,
        "served_per_model": {name: served.get(name, 0) for name in variants},
        # the hand-written kernels' launches by the variants' graph replays
        "kernel_launches": launches,
    }
    invariants["mux_architectures_distinct"] = (
        arch["cond_mnist"] == "dcgan" and arch["wgan_cifar"] == "wgan_gp"
        and widths["cond_mnist"] != widths["wgan_cifar"])
    invariants["mux_costs_measured_and_distinct"] = (
        all(sources.get(name) == "measured" for name in variants)
        and costs["cond_mnist"] != costs["wgan_cifar"])
    invariants["mux_both_variants_serve"] = all(served.get(name, 0) > 0 for name in variants)
    invariants["mux_zero_lost"] = (counts["sent"] == counts["answered"] == counts["ok"]
                                   and counts["errors"] == 0 and hung == 0)
    log(f"mux: {counts['ok']}/{counts['sent']} ok in {elapsed:.1f}s, costs {costs} "
        f"({sources}), architectures {arch}")


def _served_per_model() -> dict:
    from gan_deeplearning4j_tpu_torch.telemetry.registry import get_registry

    out: dict = {}
    for s in get_registry().snapshot().get("mux_requests_total", {}).get("series", []):
        labels = s.get("labels", {})
        if labels.get("status") == "ok":
            out[labels.get("model")] = out.get(labels.get("model"), 0) + float(s.get("value", 0))
    return out


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--smoke", action="store_true",
                   help="small shape: a window of 2, a short mux load")
    p.add_argument("--iterations", type=int, default=4,
                   help="conditional training window length K (WGAN-GP: K // 2 rounds)")
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--wgan-batch-size", type=int, default=None,
                   help="WGAN-GP batch (default: --batch-size); 2 critic steps a round")
    p.add_argument("--buckets", default="1,8",
                   help="mux ladder (comma ints); variants are priced on it")
    p.add_argument("--mux-requests", type=int, default=96)
    p.add_argument("--mux-threads", type=int, default=3,
                   help="client threads per variant in the mux part")
    p.add_argument("--seed", type=int, default=666)
    p.add_argument("--device", default=None,
                   help="torch device (default: the card, cuda:0); 'cpu' asks for the CPU")
    p.add_argument("--workdir", default=None, help="keep bundles here instead of a temp dir")
    p.add_argument("--output", default=None, metavar="PATH")
    args = p.parse_args(argv)
    if args.smoke:
        args.iterations = min(args.iterations, 2)
        args.mux_requests = min(args.mux_requests, 48)
        args.mux_threads = min(args.mux_threads, 2)
    return args


def run_drill(args: argparse.Namespace) -> dict:
    """The three parts; returns the JSON payload (``ok`` and the
    invariants, results per part). The work directory is removed when
    every invariant holds and the drill made it."""
    from gan_deeplearning4j_tpu_torch.runtime.device import resolve_device

    args.device = str(resolve_device(args.device))
    workdir = args.workdir or tempfile.mkdtemp(prefix="zoo_drill_")
    cleanup = args.workdir is None
    os.makedirs(workdir, exist_ok=True)
    results: dict = {}
    invariants: dict = {}
    t_start = time.monotonic()

    cond_dir, _, cond_info = train_conditional(workdir, args)
    results["conditional_train"] = cond_info
    invariants["conditional_bundle_declares_zoo"] = (
        (cond_info["zoo_block"] or {}).get("conditioning") == "class"
        and cond_info["losses_finite"])
    serve_conditional(cond_dir, args, results, invariants)

    wgan_dir, _, wgan_info = train_wgan(workdir, args)
    results["wgan_train"] = wgan_info
    invariants["wgan_bundle_is_wgan_family"] = (
        wgan_info["family"] == "wgan_gp"
        and (wgan_info["zoo_block"] or {}).get("architecture") == "wgan_gp"
        and wgan_info["boot_sample_ok"])

    from gan_deeplearning4j_tpu_torch.quant import build_int8_variant

    int8_dir = os.path.join(workdir, "bundle_cond_mnist_int8")
    manifest = build_int8_variant(cond_dir, int8_dir, device=args.device)
    invariants["int8_variant_inherits_zoo"] = manifest.get("zoo") == cond_info["zoo_block"]
    run_mux({"cond_mnist": cond_dir, "wgan_cifar": wgan_dir, "cond_mnist_int8": int8_dir},
            args, results, invariants)

    ok = all(invariants.values()) and bool(invariants)
    payload = {
        "bench": "zoo_drill",
        "config": {
            "smoke": bool(args.smoke),
            "seed": args.seed,
            "iterations": args.iterations,
            "batch_size": args.batch_size,
            "wgan_batch_size": args.wgan_batch_size or args.batch_size,
            "buckets": args.buckets,
            "mux_requests": args.mux_requests,
            "platform": "gpu" if args.device.startswith("cuda") else "cpu",
            "device": (torch.cuda.get_device_name(torch.device(args.device))
                       if args.device.startswith("cuda") else "cpu"),
        },
        "wall_seconds": time.monotonic() - t_start,
        "results": results,
        "invariants": invariants,
        "ok": ok,
    }
    if cleanup and ok:
        shutil.rmtree(workdir, ignore_errors=True)
    elif not ok:
        log(f"INVARIANT BREACH — bundles kept at {workdir}")
    for name, good in sorted(invariants.items()):
        log(f"invariant {name}: {'ok' if good else 'BREACH'}")
    return payload


def main(argv=None) -> int:
    args = parse_args(argv)
    payload = run_drill(args)
    text = json.dumps(payload, indent=2)
    print(text)
    if args.output:
        os.makedirs(os.path.dirname(os.path.abspath(args.output)), exist_ok=True)
        with open(args.output, "w") as fh:
            fh.write(text + "\n")
    return 0 if payload["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
