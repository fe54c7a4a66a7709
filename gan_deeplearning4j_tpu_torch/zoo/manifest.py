"""ScenarioManifest — counterpart of ``gan_deeplearning4j_tpu/zoo/manifest.py``:
the model zoo's one typed scenario descriptor.

Everything downstream of training keys off it: ``experiment_config()``
builds the run's ``ExperimentConfig``; ``GanExperiment.publish_for_serving``
writes ``to_dict()`` under the ``"zoo"`` key of ``serving.json``; the
serving engine reads the block back to decide whether
``POST /v1/sample?class=k`` is legal; and the canary gate refuses to score
a candidate against real rows of another dataset. The fields, their
validation, the messages and ``scenario_from_config`` /
``scenario_from_bundle`` are the JAX package's, so the block is key for key
the same in both packages.

The axes:

- ``architecture``: ``"dcgan"`` (the reference's alternating XENT loop) or
  ``"wgan_gp"`` (the critic-round program);
- ``conditioning``: ``"none"`` or ``"class"``: a class-conditional
  generator takes ``[z | one-hot(class)]``; the discriminator stays
  unconditional;
- ``dataset``: ``"mnist"`` | ``"fashion_mnist"`` | ``"cifar_shaped"``, the
  identity of the real rows (``zoo/datasets.py``). The resolution is the
  dataset's native side, not a free axis.

``wgan_gp`` builds only at the 32×32 ``cifar_shaped`` dataset (its stem
needs power-of-two sides) and is unconditional; the 28×28 datasets train
the ``mnist`` DCGAN family and power-of-two sides the ``image`` family.
"""

from __future__ import annotations

import dataclasses
import json
import os
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
                f"unknown architecture {self.architecture!r} "
                f"(want one of {ARCHITECTURES})"
            )
        if self.conditioning not in CONDITIONINGS:
            raise ValueError(
                f"unknown conditioning {self.conditioning!r} "
                f"(want one of {CONDITIONINGS})"
            )
        if self.dataset not in DATASETS:
            raise ValueError(
                f"unknown dataset {self.dataset!r} (want one of {DATASETS})"
            )
        native = DATASET_SHAPES[self.dataset][0]
        if self.resolution != native:
            raise ValueError(
                f"dataset {self.dataset!r} is {native}x{native}; "
                f"resolution {self.resolution} is not an independent axis"
            )
        if self.architecture == "wgan_gp":
            if self.dataset != "cifar_shaped":
                raise ValueError(
                    "wgan_gp's conv stem (stages_for) needs power-of-two "
                    f"sides — dataset {self.dataset!r} is "
                    f"{native}x{native}; use dataset='cifar_shaped'"
                )
            if self.conditioning == "class":
                raise ValueError(
                    "wgan_gp + conditioning='class' is queued (ROADMAP.md); "
                    "the critic-round program is unconditional"
                )
        if self.conditioning == "class" and self.num_classes < 2:
            raise ValueError(
                "class-conditional scenarios need num_classes >= 2"
            )
        if self.z_size < 1:
            raise ValueError(f"z_size {self.z_size} must be >= 1")

    # -- derived identities ----------------------------------------------------
    @property
    def shape(self) -> tuple:
        """(height, width, channels) of the dataset's rows."""
        return DATASET_SHAPES[self.dataset]

    @property
    def num_features(self) -> int:
        h, w, c = self.shape
        return h * w * c

    @property
    def family_name(self) -> str:
        """The ``models/registry.py`` family this scenario trains under: the
        28×28 datasets run the reference's fixed-28×28 MNIST graphs,
        power-of-two sides the shape-generic image family."""
        if self.architecture == "wgan_gp":
            return "wgan_gp"
        return "mnist" if self.shape[0] == 28 else "image"

    @property
    def conditional(self) -> bool:
        return self.conditioning == "class"

    @property
    def sample_input_width(self) -> int:
        """The width of a served ``sample`` row: z, plus the one-hot label
        block of a conditional scenario."""
        return self.z_size + (self.num_classes if self.conditional else 0)

    # -- config / dict plumbing ------------------------------------------------
    def experiment_config(self, **overrides: Any):
        """A validated ``ExperimentConfig`` for this scenario (``overrides``
        on top). The import is lazy: ``harness/config.py`` validates against
        the model registry, which must not import the zoo at module scope."""
        from gan_deeplearning4j_tpu_torch.harness.config import ExperimentConfig

        h, w, c = self.shape
        base = dict(
            model_family=self.family_name,
            conditioning=self.conditioning,
            dataset=self.dataset,
            height=h,
            width=w,
            channels=c,
            num_features=h * w * c,
            num_classes=self.num_classes,
            z_size=self.z_size,
        )
        base.update(overrides)
        return ExperimentConfig(**base).validate()

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(doc: Dict[str, Any]) -> "ScenarioManifest":
        fields = {f.name for f in dataclasses.fields(ScenarioManifest)}
        unknown = set(doc) - fields
        if unknown:
            raise ValueError(f"unknown scenario manifest keys {sorted(unknown)}")
        return ScenarioManifest(**doc)


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


def scenario_from_bundle(directory: str) -> Optional[ScenarioManifest]:
    """The scenario block of a serving bundle's ``serving.json``, or None
    for a bundle without one (it serves unconditionally)."""
    with open(os.path.join(directory, "serving.json")) as fh:
        manifest = json.load(fh)
    doc = manifest.get("zoo")
    return None if doc is None else ScenarioManifest.from_dict(doc)
