"""Trainers of the PyTorch port, one device or a data mesh — counterpart
of ``gan_deeplearning4j_tpu/parallel``.

The reference scales with Spark (``SparkComputationGraph`` +
``ParameterAveragingTrainingMaster``, dl4jGANComputerVision.java:317-333);
the JAX package with one SPMD program over a ``jax.sharding.Mesh``. The
port runs one process per rank over ``torch.distributed``, on a
``runtime/environment.py::DataMesh``:

- :class:`GraphTrainer` with a mesh: per-step gradient sync (each rank's
  rows, BatchNorm over the global batch, the gradient mean);
- :class:`ParameterAveragingTrainer`: k local steps per worker, then the
  mean of params and updater state;
- :mod:`~gan_deeplearning4j_tpu_torch.parallel.update_sharding`
  (``GraphTrainer(shard_updates=True)``): reduce-scatter, owned-keys
  update, all-gather;
- :mod:`~gan_deeplearning4j_tpu_torch.parallel.collectives`: the
  collectives they make; :mod:`~gan_deeplearning4j_tpu_torch.parallel.
  launch`: N ranks spawned on one host.
"""

from gan_deeplearning4j_tpu_torch.parallel.trainer import GraphTrainer, TrainState, make_train_state
from gan_deeplearning4j_tpu_torch.parallel.param_averaging import ParameterAveragingTrainer
from gan_deeplearning4j_tpu_torch.parallel.update_sharding import (
    ShardedGraphOptimizer,
    UpdateShardingPlan,
)

__all__ = [
    "GraphTrainer",
    "ParameterAveragingTrainer",
    "ShardedGraphOptimizer",
    "TrainState",
    "UpdateShardingPlan",
    "make_train_state",
]
