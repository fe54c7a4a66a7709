"""Experiment harness of the PyTorch port — counterpart of
``gan_deeplearning4j_tpu/harness``: :class:`ExperimentConfig` (the
reference's constant block, CLI/JSON overridable), :class:`GanExperiment`
(the alternating training loop) and, for WGAN-GP, ``WganGpExperiment``."""

from gan_deeplearning4j_tpu_torch.harness.config import ExperimentConfig
from gan_deeplearning4j_tpu_torch.harness.experiment import GanExperiment


def make_experiment(config: ExperimentConfig, mesh=None):
    """Experiment factory, as in the JAX package: the family's own
    experiment class where it has one (``wgan_gp``), else the three-graph
    :class:`GanExperiment`."""
    from gan_deeplearning4j_tpu_torch.models import registry

    family = registry.get(config.model_family)
    if family.make_experiment is not None:
        return family.make_experiment(config, mesh)
    return GanExperiment(config, mesh=mesh)


__all__ = ["ExperimentConfig", "GanExperiment", "make_experiment"]
