"""Model-zoo scenario identity of the PyTorch port (the part of
``gan_deeplearning4j_tpu/zoo`` that ``serving.json`` needs)."""

from gan_deeplearning4j_tpu_torch.zoo.manifest import ScenarioManifest, scenario_from_config

__all__ = ["ScenarioManifest", "scenario_from_config"]
