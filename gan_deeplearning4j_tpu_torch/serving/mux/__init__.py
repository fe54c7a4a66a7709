"""serving/mux — the multi-model multiplexing plane (docs/MULTIPLEX.md).

The PyTorch port's counterpart of ``gan_deeplearning4j_tpu/serving/mux``.

Serves N model variants — distinct store generations, or cheap bf16
siblings of one generation — behind ONE request surface:

- :mod:`.splitter` — deterministic weighted-rendezvous traffic
  assignment per request key: sticky across restarts, exactly
  weight-proportional, minimal reassignment under live weight updates;
- :mod:`.registry` — the variant table: each variant wraps a
  :class:`~..engine.ServingEngine` + micro-batcher while *resident*,
  sharing one pinned staging pool across engines; a residency budget
  demotes least-weighted variants to cold manifests and re-warms them
  through the reload plane's build path when their weight returns;
- :mod:`.ramp` — the continuous canary ramp (1% → 10% → 50% → 100%)
  generalizing the deploy canary's single admission decision, with
  auto-rollback on the candidate's per-variant SLO burn;
- :mod:`.service` — the request surface (duck-types the single-model
  ``InferenceService`` handler contract, so ``serving.make_server``
  fronts it) with per-model metric labels, per-variant SLO trackers,
  and per-model brownout tiering: under overload the most expensive
  variant's traffic sheds first, the cheapest's last.
"""

from gan_deeplearning4j_tpu_torch.serving.mux.ramp import (
    RampController,
    health_from_tracker,
)
from gan_deeplearning4j_tpu_torch.serving.mux.registry import (
    MuxRegistry,
    MuxVariant,
    SharedStagingPool,
)
from gan_deeplearning4j_tpu_torch.serving.mux.service import (
    BrownoutController,
    MuxService,
)
from gan_deeplearning4j_tpu_torch.serving.mux.splitter import WeightedSplitter

__all__ = [
    "BrownoutController",
    "MuxRegistry",
    "MuxService",
    "MuxVariant",
    "RampController",
    "SharedStagingPool",
    "WeightedSplitter",
    "health_from_tracker",
]
