"""Long training run + quality eval — the port of ``scripts/quality_run.py``:
``python -m gan_deeplearning4j_tpu_torch.eval.quality_run`` (``--cpu`` asks
for the CPU; the card otherwise).

Trains the MNIST-family DCGAN and its transfer classifier on the best
available data (``data/mnist.py::load_mnist``: real MNIST on disk, else
scikit-learn's digits, else the synthetic glyphs), then records the
quality artifacts the reference implies (gan.ipynb cells 5-6 and
``DCGAN_Generated_Images.png``):

- the 10×10 latent-manifold PNG;
- the transfer classifier's accuracy on the held-out test split;
- FID@N under the frozen extractor (comparable across runs), the
  discriminator's features (a model-space diagnostic) and, when
  ``$INCEPTION_WEIGHTS`` names a schema ``.npz``, the Inception schema
  (``eval/fid.py::inception_feature_fn``);
- per-iteration throughput.

Generator quality is not monotone in training time, so the run tracks a
quick frozen-feature FID at every export boundary (``GanExperiment.run``'s
``eval_callback``; ``eval/fid.py::quick_fid_scorer``: the generator and
the extractor in one device pass over a fixed z set) and snapshots the
best generator. On the card the trained states are buffers of captured
graphs, updated in place by every replay (``harness/graphs.py``), so the
snapshot is ``clone()``s of ``gen_params``, never references: otherwise
"best" would silently follow the final model. The headline manifold PNG
and ``{prefix}_gen_model_best.zip`` come from the best snapshot (put in
``gen_params`` for the export, then the captured buffers put back), while
``fid_frozen_features`` stays bound to the final model: selection
minimises that very metric, so a best-of-N headline would carry its bias.

A malformed ``$INCEPTION_WEIGHTS`` does not discard a finished run: its
error is recorded in the report's ``fid_inception_source``.

Writes ``<out>/quality_run.json`` (the reference's keys) and the PNGs, and
prints the report as the last line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from gan_deeplearning4j_tpu_torch.data import DeviceResidentIterator
from gan_deeplearning4j_tpu_torch.data.dataset import one_hot_np
from gan_deeplearning4j_tpu_torch.data.mnist import load_mnist, write_mnist_csv
from gan_deeplearning4j_tpu_torch.eval.accuracy import accuracy_score
from gan_deeplearning4j_tpu_torch.eval.fid import (
    FeatureStats,
    fid_from_stats,
    fid_score,
    frozen_feature_fn,
    graph_feature_fn,
    inception_feature_fn,
    quick_fid_scorer,
)
from gan_deeplearning4j_tpu_torch.eval.images import render_manifold
from gan_deeplearning4j_tpu_torch.eval.quality import sample_generator_rows
from gan_deeplearning4j_tpu_torch.harness import ExperimentConfig, GanExperiment
from gan_deeplearning4j_tpu_torch.utils.serializer import write_model


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iterations", type=int, default=300)
    ap.add_argument("--batch", type=int, default=200)
    ap.add_argument("--num-train", type=int, default=10000)
    ap.add_argument("--num-test", type=int, default=1000)
    ap.add_argument("--fid-samples", type=int, default=50000)
    ap.add_argument("--out", default="artifacts")
    ap.add_argument("--export-every", type=int, default=50)
    ap.add_argument("--compute-dtype", default=None)
    # G/D-balance levers; the defaults are the reference configuration
    ap.add_argument("--resample-label-noise", action="store_true")
    ap.add_argument("--dis-lr-decay-every", type=int, default=0)
    ap.add_argument("--dis-lr-decay-rate", type=float, default=1.0)
    ap.add_argument("--dis-lr", type=float, default=0.002)
    ap.add_argument("--gen-lr", type=float, default=0.004)
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    ap.add_argument("--seed", type=int, default=666)
    ap.add_argument("--no-select-best", action="store_true",
                    help="skip in-training FID tracking / best-checkpoint selection")
    ap.add_argument("--select-samples", type=int, default=2048,
                    help="generator samples per in-training quick-FID eval; the quick FID "
                         "fits a 224-dim covariance, so fewer samples let noise decide the "
                         "selection")
    return ap


def _clone_params(params: Dict) -> Dict:
    """A copy of a params tree that no replay writes into."""
    return {layer: {name: t.detach().clone() for name, t in lp.items()}
            for layer, lp in params.items()}


def _platform(device: torch.device) -> Tuple[str, str]:
    """``(platform, device_kind)`` as the reference reports them."""
    if device.type == "cuda":
        return "gpu", torch.cuda.get_device_name(device)
    return "cpu", "cpu"


def run(args: argparse.Namespace) -> Tuple[dict, dict]:
    """The quality run. Returns the report and the run's parts (the
    experiment, the extractors, the real features' stats, the quick-FID
    scorer and the best snapshot) for callers that check it further."""
    t_start = time.time()
    os.makedirs(args.out, exist_ok=True)
    tag, ((xtr, ytr), (xte, yte)) = load_mnist(num_train=args.num_train, num_test=args.num_test,
                                               seed=args.seed)
    print(f"data source: {tag}  train={xtr.shape}  test={xte.shape}", flush=True)

    cfg = ExperimentConfig(
        batch_size_train=args.batch,
        batch_size_pred=500,
        num_iterations=args.iterations,
        print_every=args.export_every,
        save_every=args.export_every,
        save_models=False,  # checkpoint once at the end, not per iteration
        output_dir=args.out,
        compute_dtype=args.compute_dtype,
        resample_label_noise=args.resample_label_noise,
        dis_lr_decay_every=args.dis_lr_decay_every,
        dis_lr_decay_rate=args.dis_lr_decay_rate,
        dis_learning_rate=args.dis_lr,
        gen_learning_rate=args.gen_lr,
        seed=args.seed,
        use_accelerator=not args.cpu,
    )
    exp = GanExperiment(cfg)
    dev = exp.device
    # the whole set resident on the device once: no host-to-device copies
    # in the steady state
    train_it = DeviceResidentIterator(xtr, one_hot_np(ytr, 10), batch_size=args.batch, device=dev)
    test_it = DeviceResidentIterator(xte, one_hot_np(yte, 10), batch_size=500, device=dev)
    # the accuracy CSV contract needs the test file on disk
    write_mnist_csv(os.path.join(args.out, "quality_test.csv"), xte, yte)

    phases: Dict[str, float] = {}
    t0 = time.perf_counter()
    frozen_fn = frozen_feature_fn(cfg.height, cfg.width, cfg.channels, seed=666,
                                  batch_size=2500, device=dev)
    # the real set's frozen-feature stats, computed once for the tracker
    # and both frozen FIDs
    real_stats = FeatureStats.from_features(frozen_fn(xtr))
    phases["real_frozen_stats"] = time.perf_counter() - t0

    best = {"iteration": None, "fid": None, "gen_params": None, "curve": []}
    score = None
    if not args.no_select_best:
        score = quick_fid_scorer(exp, frozen_fn, real_stats, num_samples=args.select_samples,
                                 seed=args.seed + 13)
        best["curve"] = score.curve

        def score_and_track(e, index):
            t = time.perf_counter()
            fid_q = score(e, index)
            if best["fid"] is None or fid_q < best["fid"]:
                best.update(iteration=index, fid=fid_q, gen_params=_clone_params(e.gen_params))
            phases["quick_fid"] = phases.get("quick_fid", 0.0) + time.perf_counter() - t

    t0 = time.perf_counter()
    result = exp.run(train_it, test_it, eval_callback=None if score is None else score_and_track)
    phases["run"] = time.perf_counter() - t0
    if score is not None:
        # the cadence usually misses the last iteration; the scorer returns
        # the cached value when it landed on it
        score_and_track(exp, result["iterations"])
    ips = [h["images_per_sec"] for h in result["history"]]
    print(f"trained {result['iterations']} iterations; median {np.median(ips):.1f} images/sec",
          flush=True)
    t0 = time.perf_counter()
    exp.save_models()
    phases["save_models"] = time.perf_counter() - t0
    selection_ran = best["iteration"] is not None
    best_is_final = not selection_ran or best["iteration"] == result["iterations"]

    t0 = time.perf_counter()
    manifold_csv = exp.export_manifold(result["iterations"])
    final_png = "DCGAN_Generated_Images.png" if best_is_final else "DCGAN_Generated_Images_final.png"
    png = render_manifold(manifold_csv, os.path.join(args.out, final_png),
                          grid=cfg.latent_grid, side=cfg.height, channels=cfg.channels)
    print(f"final-iteration manifold: {png}", flush=True)
    best_zip = None
    if not best_is_final:
        final_gen_params = exp.gen_params  # the captured graphs' buffers
        exp.gen_params = best["gen_params"]
        try:
            best_csv = exp.export_manifold(f"best_{best['iteration']}")
            png = render_manifold(best_csv, os.path.join(args.out, "DCGAN_Generated_Images.png"),
                                  grid=cfg.latent_grid, side=cfg.height, channels=cfg.channels)
            # the generator the headline artifacts come from; the
            # save_models() zips hold the final state
            best_zip = os.path.join(args.out, f"{cfg.file_prefix}_gen_model_best.zip")
            write_model(best_zip, exp.gen, exp.gen_params, save_updater=False)
        finally:
            exp.gen_params = final_gen_params
        print(f"best-checkpoint manifold (iteration {best['iteration']}, "
              f"quick-FID {best['fid']:.2f}): {png}  saved: {best_zip}", flush=True)

    preds_csv = exp.export_predictions(test_it, result["iterations"])
    acc = accuracy_score(np.loadtxt(preds_csv, delimiter=",", ndmin=2), yte)
    phases["exports"] = time.perf_counter() - t0
    print(f"transfer-classifier accuracy: {acc * 100:.2f}%", flush=True)

    def sample_fakes(params) -> np.ndarray:
        return sample_generator_rows(
            lambda z: exp.gen.output(params, z, train=False), cfg.z_size, args.fid_samples,
            args.seed + 7, num_features=cfg.num_features, compute_dtype=exp._compute_dtype,
            device=dev)

    def frozen_fid(fakes) -> float:
        return fid_from_stats(real_stats, FeatureStats.from_features(frozen_fn(fakes)))

    t_fid = time.perf_counter()
    fakes = sample_fakes(exp.gen_params)
    phases["sample_fakes"] = time.perf_counter() - t_fid
    t0 = time.perf_counter()
    fid = frozen_fid(fakes)
    phases["fid_frozen"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    dis_fn = graph_feature_fn(exp.dis, exp.dis_state.params, "dis_dense_layer_6", batch_size=2500)
    fid_dis = fid_score(xtr, fakes, dis_fn)
    phases["fid_dis"] = time.perf_counter() - t0
    fid_inception = inc_source = None
    inc_path = os.environ.get("INCEPTION_WEIGHTS")
    if inc_path and os.path.exists(inc_path):
        t0 = time.perf_counter()
        try:
            inc_fn = inception_feature_fn(cfg.height, cfg.width, cfg.channels, path=inc_path,
                                          batch_size=2500, device=dev)
            fid_inception = fid_score(xtr, fakes, inc_fn)
            inc_source = inc_fn.source
            print(f"inception FID ({inc_source}): {fid_inception:.2f}", flush=True)
        except Exception as exc:  # a finished run outlives malformed weights
            inc_source = f"error: {type(exc).__name__}: {exc}"
            print(f"inception FID skipped — {inc_source}", flush=True)
        phases["fid_inception"] = time.perf_counter() - t0
    fid_best: Optional[float] = None
    if not best_is_final:
        t0 = time.perf_counter()
        fid_best = frozen_fid(sample_fakes(best["gen_params"]))
        phases["fid_best"] = time.perf_counter() - t0
        print(f"FID@{args.fid_samples} best checkpoint (iteration {best['iteration']}): "
              f"{fid_best:.2f}", flush=True)
    elif selection_ran:
        fid_best = fid
    print(f"FID@{args.fid_samples} frozen-features (final): {fid:.2f}  dis-features "
          f"(diagnostic): {fid_dis:.2f} ({time.perf_counter() - t_fid:.0f}s)", flush=True)

    platform, device_kind = _platform(dev)
    timings = {k: round(v, 2) for k, v in result["timings"].items()}
    timings.update({k: round(v, 2) for k, v in phases.items()})
    report = {
        "data_source": tag,
        "iterations": result["iterations"],
        "batch_size": args.batch,
        "compute_dtype": args.compute_dtype or "f32",
        "levers": {
            "resample_label_noise": args.resample_label_noise,
            "dis_lr_decay_every": args.dis_lr_decay_every,
            "dis_lr_decay_rate": args.dis_lr_decay_rate,
            "dis_lr": args.dis_lr,
            "gen_lr": args.gen_lr,
        },
        "platform": platform,
        "device_kind": device_kind,
        "accuracy": round(float(acc), 4),
        "fid_at": args.fid_samples,
        # always the final model: the figure comparable across runs
        "fid_frozen_features": round(float(fid), 3),
        "fid_frozen_features_best": None if fid_best is None else round(float(fid_best), 3),
        "fid_dis_features": round(float(fid_dis), 3),
        "fid_inception": None if fid_inception is None else round(float(fid_inception), 3),
        "fid_inception_source": inc_source,
        "best_checkpoint": None if not selection_ran else {
            "iteration": best["iteration"],
            "is_final": best_is_final,
            "quick_fid": round(float(best["fid"]), 3),
            "fid_frozen_features": round(float(fid_best), 3),
            "quick_fid_curve": best["curve"],
        },
        "images_per_sec_median": round(float(np.median(ips)), 2),
        "d_loss_final": result["history"][-1]["d_loss"],
        "g_loss_final": result["history"][-1]["g_loss"],
        "cv_loss_final": result["history"][-1]["cv_loss"],
        "wall_seconds": round(time.time() - t_start, 1),
        "timings": timings,
    }
    with open(os.path.join(args.out, "quality_run.json"), "w") as fh:
        json.dump(report, fh, indent=2)
    parts = {"experiment": exp, "frozen_fn": frozen_fn, "real_stats": real_stats, "score": score,
             "best": best, "best_zip": best_zip, "result": result, "test_iterator": test_it,
             "data": ((xtr, ytr), (xte, yte)), "accuracy": acc, "phase_seconds": phases}
    return report, parts


def main(argv=None) -> int:
    report, _ = run(build_parser().parse_args(argv))
    print(json.dumps(report), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
