"""ScenarioManifest — the minimal copy of
``gan_deeplearning4j_tpu/zoo/manifest.py`` that a serving bundle needs.

``GanExperiment.publish_for_serving`` writes ``scenario.to_dict()`` under
the ``"zoo"`` key of ``serving.json``; the serving engines of both
packages read it to decide whether ``sample?class=k`` is legal. The fields,
their validation and ``scenario_from_config`` are the JAX package's, so
the block is key for key the same. The dataset loaders, the streaming
input and class conditioning wait for ROADMAP.md queue 1, 'Class
conditioning'.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

ARCHITECTURES = ("dcgan", "wgan_gp")
CONDITIONINGS = ("none", "class")
DATASETS = ("mnist", "fashion_mnist", "cifar_shaped")

# dataset -> (height, width, channels): the native shape of its real rows
DATASET_SHAPES: Dict[str, tuple] = {
    "mnist": (28, 28, 1),
    "fashion_mnist": (28, 28, 1),
    "cifar_shaped": (32, 32, 3),
}


@dataclasses.dataclass(frozen=True)
class ScenarioManifest:
    architecture: str = "dcgan"
    conditioning: str = "none"
    dataset: str = "mnist"
    resolution: int = 28
    num_classes: int = 10
    z_size: int = 2

    def __post_init__(self) -> None:
        if self.architecture not in ARCHITECTURES:
            raise ValueError(
                f"unknown architecture {self.architecture!r} (want one of {ARCHITECTURES})"
            )
        if self.conditioning not in CONDITIONINGS:
            raise ValueError(
                f"unknown conditioning {self.conditioning!r} (want one of {CONDITIONINGS})"
            )
        if self.dataset not in DATASETS:
            raise ValueError(f"unknown dataset {self.dataset!r} (want one of {DATASETS})")
        native = DATASET_SHAPES[self.dataset][0]
        if self.resolution != native:
            raise ValueError(
                f"dataset {self.dataset!r} is {native}x{native}; "
                f"resolution {self.resolution} is not an independent axis"
            )
        if self.architecture == "wgan_gp":
            if self.dataset != "cifar_shaped":
                raise ValueError(
                    "wgan_gp's conv stem needs power-of-two sides — dataset "
                    f"{self.dataset!r} is {native}x{native}; use dataset='cifar_shaped'"
                )
            if self.conditioning == "class":
                raise ValueError("wgan_gp + conditioning='class' is not supported")
        if self.conditioning == "class" and self.num_classes < 2:
            raise ValueError("class-conditional scenarios need num_classes >= 2")
        if self.z_size < 1:
            raise ValueError(f"z_size {self.z_size} must be >= 1")

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def scenario_from_config(cfg) -> Optional[ScenarioManifest]:
    """The scenario a config trains, or None when the config falls outside
    the zoo's axes (the tabular family, an unknown family, or a shape that
    is not its dataset's native one): such a bundle is published without a
    zoo block. ``wgan_gp`` is architecture "wgan_gp"; ``mnist`` and
    ``image`` are "dcgan"."""
    from gan_deeplearning4j_tpu_torch.models import registry

    try:
        family = registry.get(cfg.model_family).name
    except KeyError:
        return None
    if family == "wgan_gp":
        architecture = "wgan_gp"
    elif family in ("mnist", "image"):
        architecture = "dcgan"
    else:
        return None
    dataset = getattr(cfg, "dataset", "mnist")
    if (cfg.height, cfg.width, cfg.channels) != DATASET_SHAPES.get(dataset):
        return None
    try:
        return ScenarioManifest(
            architecture=architecture,
            conditioning=getattr(cfg, "conditioning", "none"),
            dataset=dataset,
            resolution=DATASET_SHAPES[dataset][0],
            num_classes=cfg.num_classes,
            z_size=cfg.z_size,
        )
    except ValueError:
        return None
