"""serving/ of the PyTorch port — counterpart of
``gan_deeplearning4j_tpu/serving``: the trained generator and transfer
classifier answer ``sample``, ``classify`` and ``features`` requests
through one dynamic micro-batcher, on the card.

- :mod:`.engine` — restores the graphs from checkpoint zips or a bundle,
  pads requests to a bucket ladder, stages them through pinned buffers and
  replays one captured CUDA graph per (kind, bucket) on its own CUDA
  stream (dispatch/finalize split);
- :mod:`.batcher` — the JAX package's micro-batcher, copied: max-latency /
  max-batch triggers, a bounded two-stage pipeline, deadlines and
  backpressure;
- :mod:`.service` — the in-process API and the stdlib HTTP JSON endpoint;
- :mod:`.ladder` — the flush-size histogram, the learned ladder's solver
  and the manifest's ladder block;
- :mod:`.mux` — N variants (generations, bf16 / int8 siblings) behind one
  request surface: weighted splitting, residency, ramps, brownout;
- ``python -m gan_deeplearning4j_tpu_torch.serving`` — the server CLI.
"""

from gan_deeplearning4j_tpu_torch.serving.batcher import MicroBatcher, ServeResult
from gan_deeplearning4j_tpu_torch.serving.engine import ServingEngine
from gan_deeplearning4j_tpu_torch.serving.ladder import (
    SizeHistogram,
    expected_waste,
    manifest_histogram,
    manifest_ladder,
    solve_ladder,
    write_ladder_block,
)
from gan_deeplearning4j_tpu_torch.serving.service import InferenceService, make_server

__all__ = [
    "MicroBatcher",
    "ServeResult",
    "ServingEngine",
    "InferenceService",
    "make_server",
    "SizeHistogram",
    "expected_waste",
    "manifest_histogram",
    "manifest_ladder",
    "solve_ladder",
    "write_ladder_block",
]
