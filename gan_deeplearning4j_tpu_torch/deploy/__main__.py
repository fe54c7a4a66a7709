"""Deploy-plane CLI — ``python -m gan_deeplearning4j_tpu_torch.deploy probe``;
the counterpart of ``gan_deeplearning4j_tpu/deploy/__main__.py``.

The fleet-admission sidecar (docs/FLEET.md): measure one serving bundle's
quality probe in its OWN process and print the probe dict as one JSON
line. The fleet manager runs this against the candidate and the incumbent
bundle, then decides admission once per fleet via
:func:`~.canary.compare_probes` — serving workers never pay the probe's
captures or device time, and a poisoned candidate is rejected before any
worker process ever loads it.

    python -m gan_deeplearning4j_tpu_torch.deploy probe \\
        --bundle store/generations/gen-00000007 --data workload.npz

``--feature dis_features`` embeds both real rows and generated samples in
the discriminator-feature space of ``--feature-bundle``'s classifier (the
incumbent, so candidate and incumbent probes share one feature space);
the default is raw-row FID. The probe runs on the card unless
``--device cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import json
import sys


def _probe(args) -> dict:
    import numpy as np

    from gan_deeplearning4j_tpu_torch.deploy.canary import (
        classifier_from_bundle,
        feature_fn_from_checkpoint,
    )
    from gan_deeplearning4j_tpu_torch.eval.quality import quality_probe
    from gan_deeplearning4j_tpu_torch.serving.engine import ServingEngine

    with np.load(args.data) as npz:
        features = npz["features"]
        labels = npz["labels"] if "labels" in npz.files else None
    feature_fn = None
    if args.feature == "dis_features":
        ref_bundle = args.feature_bundle or args.bundle
        resolved = classifier_from_bundle(ref_bundle)
        if resolved is None:
            raise ValueError(
                f"--feature dis_features needs a classifier with a feature "
                f"vertex in {ref_bundle}/serving.json")
        feature_fn = feature_fn_from_checkpoint(*resolved, device=args.device)
    # one replica, no gauge claim, lazy captures: a sidecar probe must
    # never look like a serving process to the telemetry plane
    engine = ServingEngine.from_bundle(args.bundle, replicas=1,
                                       device=args.device,
                                       export_gauge=False)
    classify_fn = None
    if "classify" in engine.kinds and labels is not None:
        classify_fn = lambda rows: engine.run("classify", rows)  # noqa: E731
    probe = quality_probe(
        lambda z: engine.run("sample", z),
        features,
        z_size=engine.input_width("sample"),
        num_samples=min(args.samples, features.shape[0]),
        seed=args.seed,
        classify_fn=classify_fn,
        labels=labels,
        feature_fn=feature_fn,
    )
    probe["generation"] = engine.generation
    probe["feature"] = args.feature
    return probe


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m gan_deeplearning4j_tpu_torch.deploy",
        description="deploy-plane sidecar tools",
    )
    sub = p.add_subparsers(dest="command", required=True)
    pr = sub.add_parser(
        "probe", help="measure one bundle's quality probe; print JSON")
    pr.add_argument("--bundle", required=True,
                    help="serving bundle directory (contains serving.json)")
    pr.add_argument("--data", required=True,
                    help="npz with 'features' (and optionally 'labels')")
    pr.add_argument("--samples", type=int, default=256)
    pr.add_argument("--seed", type=int, default=666)
    pr.add_argument("--feature", choices=("raw", "dis_features"),
                    default="raw",
                    help="FID feature space: raw rows, or the "
                         "discriminator features of --feature-bundle's "
                         "classifier")
    pr.add_argument("--feature-bundle", default=None,
                    help="bundle whose classifier defines the dis-feature "
                         "space (default: --bundle; the fleet manager "
                         "passes the incumbent)")
    pr.add_argument("--device", default="cuda",
                    help="torch device to probe on (default: cuda; there "
                         "is no fallback to the CPU)")
    args = p.parse_args(argv)
    try:
        probe = _probe(args)
    except Exception as exc:  # one JSON error line, nonzero exit
        print(json.dumps({"error": f"{type(exc).__name__}: {exc}"}))
        return 1
    print(json.dumps(probe))
    return 0


if __name__ == "__main__":
    sys.exit(main())
