"""Updater specs of the PyTorch port (configuration only; the update rules
come with the training slice)."""

from gan_deeplearning4j_tpu_torch.optim.updaters import (
    Adam,
    NoOp,
    RmsProp,
    Sgd,
    UpdaterSpec,
    updater_from_dict,
)

__all__ = ["Adam", "NoOp", "RmsProp", "Sgd", "UpdaterSpec", "updater_from_dict"]
