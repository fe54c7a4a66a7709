"""deploy/ of the PyTorch port — counterpart of
``gan_deeplearning4j_tpu/deploy/``: so far the canary gate
(:mod:`.canary`), the quality bar every candidate bundle (a retrained
generation, or a bf16 / int8 variant) must clear against the incumbent.
The store watcher and the reloader (zero-downtime generation swap) wait
for ROADMAP.md queue 1, 'The operations planes'.
"""

from gan_deeplearning4j_tpu_torch.deploy.canary import (
    CanaryDecision,
    CanaryGate,
    CanaryThresholds,
    classifier_from_bundle,
    compare_probes,
    feature_fn_from_checkpoint,
)

__all__ = [
    "CanaryDecision",
    "CanaryGate",
    "CanaryThresholds",
    "classifier_from_bundle",
    "compare_probes",
    "feature_fn_from_checkpoint",
]
