"""Experiment harness of the PyTorch port — counterpart of
``gan_deeplearning4j_tpu/harness``: :class:`ExperimentConfig` (the
reference's constant block, CLI/JSON overridable) and
:class:`GanExperiment` (the alternating training loop)."""

from gan_deeplearning4j_tpu_torch.harness.config import ExperimentConfig
from gan_deeplearning4j_tpu_torch.harness.experiment import GanExperiment


def make_experiment(config: ExperimentConfig, mesh=None) -> GanExperiment:
    """Experiment factory, as in the JAX package. The port's only family,
    ``mnist``, runs the standard three-graph :class:`GanExperiment`."""
    return GanExperiment(config, mesh=mesh)


__all__ = ["ExperimentConfig", "GanExperiment", "make_experiment"]
