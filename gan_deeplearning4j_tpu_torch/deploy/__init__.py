"""deploy/ of the PyTorch port — counterpart of
``gan_deeplearning4j_tpu/deploy/``: zero-downtime generation reload, the
train→serve loop closed.

- :mod:`.watcher` — polls a checkpoint store (``resilience/store.py``) or a
  bare bundle directory for a newer digest-valid serving generation,
  quarantining corrupt generations and skipping them;
- :mod:`.canary` — the quality bar every candidate bundle (a retrained
  generation, or a bf16 / int8 variant) must clear against the incumbent;
- :mod:`.reloader` — builds the candidate engine off-thread, warms it (on
  the card: captures every (kind, bucket) graph) against the live engine's
  ladder and device, canaries it, then swaps it in under the batcher (or,
  in mux mode, adopts it into a ``serving.mux.MuxRegistry``), with zero
  requests shed or lost;
- ``python -m gan_deeplearning4j_tpu_torch.deploy probe`` — one bundle's
  quality probe in its own process.
"""

from gan_deeplearning4j_tpu_torch.deploy.canary import (
    CanaryDecision,
    CanaryGate,
    CanaryThresholds,
    classifier_from_bundle,
    compare_probes,
    feature_fn_from_checkpoint,
)
from gan_deeplearning4j_tpu_torch.deploy.reloader import (
    STATES,
    ReloadBusy,
    ReloadController,
)
from gan_deeplearning4j_tpu_torch.deploy.watcher import BundleCandidate, StoreWatcher

__all__ = [
    "BundleCandidate",
    "CanaryDecision",
    "CanaryGate",
    "CanaryThresholds",
    "ReloadBusy",
    "ReloadController",
    "STATES",
    "StoreWatcher",
    "classifier_from_bundle",
    "compare_probes",
    "feature_fn_from_checkpoint",
]
