"""serving/ of the PyTorch port — counterpart of
``gan_deeplearning4j_tpu/serving``: the trained generator and transfer
classifier answer ``sample``, ``classify`` and ``features`` requests
through one dynamic micro-batcher, on the card.

- :mod:`.engine` — restores the graphs from checkpoint zips or a bundle,
  pads requests to a bucket ladder, stages them through pinned buffers and
  runs them on its own CUDA stream (dispatch/finalize split);
- :mod:`.batcher` — the JAX package's micro-batcher, copied: max-latency /
  max-batch triggers, a bounded two-stage pipeline, deadlines and
  backpressure;
- :mod:`.service` — the in-process API and the stdlib HTTP JSON endpoint;
- :mod:`.ladder` — the flush-size histogram and the manifest's ladder;
- ``python -m gan_deeplearning4j_tpu_torch.serving`` — the server CLI.
"""

from gan_deeplearning4j_tpu_torch.serving.batcher import MicroBatcher, ServeResult
from gan_deeplearning4j_tpu_torch.serving.engine import ServingEngine
from gan_deeplearning4j_tpu_torch.serving.ladder import SizeHistogram, manifest_ladder
from gan_deeplearning4j_tpu_torch.serving.service import InferenceService, make_server

__all__ = [
    "MicroBatcher",
    "ServeResult",
    "ServingEngine",
    "InferenceService",
    "make_server",
    "SizeHistogram",
    "manifest_ladder",
]
