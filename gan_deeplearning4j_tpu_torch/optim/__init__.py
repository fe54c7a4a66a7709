"""Optimizers of the PyTorch port: the per-leaf updater rules (DL4J
RmsProp, Adam, Sgd, NoOp) and ``GraphOptimizer``, which applies each
layer's updater after gradient clipping."""

from gan_deeplearning4j_tpu_torch.optim.optimizer import GraphOptimizer
from gan_deeplearning4j_tpu_torch.optim.updaters import (
    Adam,
    NoOp,
    RmsProp,
    Sgd,
    UpdaterSpec,
    updater_from_dict,
)

__all__ = ["Adam", "GraphOptimizer", "NoOp", "RmsProp", "Sgd", "UpdaterSpec", "updater_from_dict"]
