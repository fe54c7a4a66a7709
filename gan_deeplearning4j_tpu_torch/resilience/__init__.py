"""resilience/ of the PyTorch port — counterpart of
``gan_deeplearning4j_tpu/resilience``. So far the generation-ledgered
checkpoint store (:mod:`.store`), which the reload plane's watcher reads; a
store that either package writes reads in the other. The supervisor, the
mesh commit, fault injection and the worker CLI wait for ROADMAP.md
queue 1, 'The operations planes'.
"""

from gan_deeplearning4j_tpu_torch.resilience.store import (
    CheckpointStore,
    Generation,
    gen_dirname,
    tree_digest,
)

__all__ = ["CheckpointStore", "Generation", "gen_dirname", "tree_digest"]
