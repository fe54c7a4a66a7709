"""tune sweep — the DCGAN-MNIST quality run's G/D-balance grid; the port's
``scripts/tune_sweep.py``, with its arms, flags and JSON keys::

    python -m gan_deeplearning4j_tpu_torch.eval.tune_sweep                  # on the card
    python -m gan_deeplearning4j_tpu_torch.eval.tune_sweep --cpu --iterations 2 --batch 8 \\
        --eval-every 1 --num-train 64 --num-test 16 --select-samples 32 --no-levers

The grid is ``--dis-lrs`` × ``--gen-lrs``, then (unless ``--no-levers``)
the four lever arms of ``LEVER_ARMS`` at the reference learning rates:
per-batch label-noise resampling, two discriminator learning-rate
staircases, and both together. ``--resume-from`` merges the arms of an
earlier (partial) sweep that match an arm's whole signature
(``_arm_key``), marked ``resumed``, so only the arms that never ran are
trained.

Each arm trains ``--iterations`` iterations at ``--batch`` from
``data/mnist.py::load_mnist`` through a ``DeviceResidentIterator``, with
the in-training quick-FID tracker (``eval/fid.py::quick_fid_scorer``: one
frozen feature space, ``frozen_feature_fn(28, 28, 1, seed=666)``, and one
z set shared by every arm, so arms differ by their models only) called
every ``--eval-every`` iterations and at the end, and records the best
quick FID and where, the final one, the final losses, the transfer
classifier's accuracy on the test split and the curve. The output ranks
the arms by best and by final quick FID. The arms' predictions CSVs go to
``output/tune`` under the working directory, as in the JAX script.

It runs on ``cuda:0`` unless given ``--cpu``; without a card it exits 2
and loads nothing. It prints one line per arm and the output as JSON,
and writes a file only where asked: ``--out PATH``, or ``--record TAG``
(``BENCH_torch_tune_sweep_<TAG>.json`` at the repo root).

What differs from the JAX script, and why: ``--out`` and ``--resume-from``
have no default (the JAX script writes ``artifacts/tuning_sweep.json`` and
resumes from ``artifacts/tuning_sweep_partial.json``, a file of the JAX
package's own runs, on every run); ``--record`` is added; ``platform`` is
``gpu`` or ``cpu`` and ``device_kind`` the card's name. Every key of an
arm and of the output is the JAX script's.
"""

from __future__ import annotations

import argparse
import itertools
import json
import os
import sys
import time

import numpy as np

REF_DIS_LR, REF_GEN_LR = 0.002, 0.004

# lever arms, all at the reference learning rates; the decay cadences end
# the 1200-iteration screen at a well decayed scale (0.7^6 ≈ 0.12, 0.5^3 =
# 0.125) without freezing the discriminator early
LEVER_ARMS = [
    {"label": "resample_noise", "resample_label_noise": True},
    {"label": "dis_decay_0.7@200", "dis_lr_decay_every": 200,
     "dis_lr_decay_rate": 0.7},
    {"label": "dis_decay_0.5@400", "dis_lr_decay_every": 400,
     "dis_lr_decay_rate": 0.5},
    {"label": "resample+dis_decay_0.7@200", "resample_label_noise": True,
     "dis_lr_decay_every": 200, "dis_lr_decay_rate": 0.7},
]

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _arm_key(a: dict) -> tuple:
    return (
        a.get("dis_lr", REF_DIS_LR), a.get("gen_lr", REF_GEN_LR),
        bool(a.get("resample_label_noise", False)),
        int(a.get("dis_lr_decay_every", 0)),
        float(a.get("dis_lr_decay_rate", 1.0)),
    )


def arm_specs(dis_lrs: str, gen_lrs: str, levers: bool = True) -> list:
    """The grid's arms, then the lever arms."""
    specs = [
        {"label": f"lr_{dis_lr}x{gen_lr}", "dis_lr": dis_lr, "gen_lr": gen_lr}
        for dis_lr, gen_lr in itertools.product(
            [float(x) for x in dis_lrs.split(",")],
            [float(x) for x in gen_lrs.split(",")],
        )
    ]
    if levers:
        specs += [dict(a) for a in LEVER_ARMS]
    return specs


def _resumed_arms(path) -> dict:
    """``{_arm_key: arm}`` of an earlier sweep's output at ``path`` (none
    when there is no path or file, or it cannot be read)."""
    resumed = {}
    if path and os.path.exists(path):
        try:
            with open(path) as fh:
                for a in json.load(fh).get("arms", []):
                    resumed[_arm_key(a)] = a
        except (OSError, ValueError) as exc:
            print(f"resume-from unreadable ({exc}); running all arms", flush=True)
    return resumed


def run(args) -> dict:
    import torch

    from gan_deeplearning4j_tpu_torch.data import DeviceResidentIterator
    from gan_deeplearning4j_tpu_torch.data.dataset import one_hot_np
    from gan_deeplearning4j_tpu_torch.data.mnist import load_mnist
    from gan_deeplearning4j_tpu_torch.eval.accuracy import accuracy_score
    from gan_deeplearning4j_tpu_torch.eval.fid import (
        FeatureStats,
        frozen_feature_fn,
        quick_fid_scorer,
    )
    from gan_deeplearning4j_tpu_torch.harness import ExperimentConfig, GanExperiment

    device = torch.device("cpu" if args.cpu else "cuda:0")
    t_start = time.time()
    tag, ((xtr, ytr), (xte, yte)) = load_mnist(
        num_train=args.num_train, num_test=args.num_test, seed=args.seed
    )
    print(f"data source: {tag}  train={xtr.shape}", flush=True)

    # one frozen feature space and one paired z set for every arm
    frozen_fn = frozen_feature_fn(28, 28, 1, seed=666, batch_size=2500, device=device)
    real_stats = FeatureStats.from_features(frozen_fn(xtr))

    specs = arm_specs(args.dis_lrs, args.gen_lrs, not args.no_levers)
    resumed = _resumed_arms(args.resume_from)
    arms = []
    for spec in specs:
        if _arm_key(spec) in resumed:
            arm = dict(resumed[_arm_key(spec)])
            arm.setdefault("label", spec["label"])
            arm["resumed"] = True
            arms.append(arm)
            print(json.dumps({"resumed": arm["label"]}), flush=True)
            continue
        cfg = ExperimentConfig(
            batch_size_train=args.batch, batch_size_pred=500,
            num_iterations=args.iterations,
            print_every=args.eval_every, save_every=10 ** 9,
            save_models=False, output_dir="output/tune",
            dis_learning_rate=spec.get("dis_lr", REF_DIS_LR),
            gen_learning_rate=spec.get("gen_lr", REF_GEN_LR),
            resample_label_noise=spec.get("resample_label_noise", False),
            dis_lr_decay_every=spec.get("dis_lr_decay_every", 0),
            dis_lr_decay_rate=spec.get("dis_lr_decay_rate", 1.0),
            seed=args.seed, use_accelerator=not args.cpu,
        )
        exp = GanExperiment(cfg)
        track = quick_fid_scorer(
            exp, frozen_fn, real_stats,
            num_samples=args.select_samples, seed=args.seed + 13,
        )
        curve = track.curve

        train_it = DeviceResidentIterator(xtr, one_hot_np(ytr, 10), batch_size=args.batch,
                                          device=device)
        test_it = DeviceResidentIterator(xte, one_hot_np(yte, 10), batch_size=500, device=device)
        t0 = time.time()
        result = exp.run(train_it, test_it, eval_callback=track)
        track(exp, result["iterations"])  # the scorer returns a cadence-landed final's value
        preds_csv = exp.export_predictions(test_it, result["iterations"])
        acc = accuracy_score(np.loadtxt(preds_csv, delimiter=",", ndmin=2), yte)
        best_i, best_fid = min(curve, key=lambda p: p[1])
        arm = {
            "label": spec["label"],
            "dis_lr": cfg.dis_learning_rate, "gen_lr": cfg.gen_learning_rate,
            "resample_label_noise": cfg.resample_label_noise,
            "dis_lr_decay_every": cfg.dis_lr_decay_every,
            "dis_lr_decay_rate": cfg.dis_lr_decay_rate,
            "best_quick_fid": best_fid, "best_at_iteration": best_i,
            "final_quick_fid": curve[-1][1],
            "accuracy": round(float(acc), 4),
            "d_loss_final": result["history"][-1]["d_loss"],
            "g_loss_final": result["history"][-1]["g_loss"],
            "quick_fid_curve": curve,
            "wall_seconds": round(time.time() - t0, 1),
        }
        exp.close()
        arms.append(arm)
        print(json.dumps({k: v for k, v in arm.items() if k != "quick_fid_curve"}),
              flush=True)

    ranked = sorted(arms, key=lambda a: a["best_quick_fid"])
    by_final = sorted(arms, key=lambda a: a["final_quick_fid"])
    return {
        "data_source": tag,
        "iterations": args.iterations,
        "batch_size": args.batch,
        "platform": "gpu" if device.type == "cuda" else "cpu",
        "device_kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "reference_point": {"dis_lr": REF_DIS_LR, "gen_lr": REF_GEN_LR},
        "arms": arms,
        "ranking_by_best_quick_fid": [
            [a.get("label"), a["best_quick_fid"]] for a in ranked
        ],
        "ranking_by_final_quick_fid": [
            [a.get("label"), a["final_quick_fid"]] for a in by_final
        ],
        "wall_seconds": round(time.time() - t_start, 1),
    }


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m gan_deeplearning4j_tpu_torch.eval.tune_sweep",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--iterations", type=int, default=1200)
    ap.add_argument("--batch", type=int, default=200)
    ap.add_argument("--num-train", type=int, default=10000)
    ap.add_argument("--num-test", type=int, default=1000)
    ap.add_argument("--eval-every", type=int, default=100)
    ap.add_argument("--select-samples", type=int, default=2048)
    ap.add_argument("--dis-lrs", default="0.001,0.002,0.004")
    ap.add_argument("--gen-lrs", default="0.002,0.004,0.008")
    ap.add_argument("--no-levers", action="store_true", help="grid arms only")
    ap.add_argument("--resume-from", default="",
                    help="merge completed arms from an earlier (partial) sweep's output "
                         "(matched on the full arm signature) instead of training them again")
    ap.add_argument("--out", default=None, help="write the output to this file")
    ap.add_argument("--record", default=None, metavar="TAG",
                    help="also write BENCH_torch_tune_sweep_<TAG>.json at the repo root")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    ap.add_argument("--seed", type=int, default=666)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    if not args.cpu and not torch.cuda.is_available():
        sys.stderr.write("tune sweep: no CUDA device is available; pass --cpu to run on the "
                         "CPU\n")
        return 2
    out = run(args)
    paths = [args.out] if args.out else []
    if args.record:
        paths.append(os.path.join(_REPO, f"BENCH_torch_tune_sweep_{args.record}.json"))
    for path in paths:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as fh:
            json.dump(out, fh, indent=2)
        print(f"wrote {path}", flush=True)
    print(json.dumps({k: out[k] for k in ("ranking_by_best_quick_fid",
                                          "ranking_by_final_quick_fid", "wall_seconds")}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
