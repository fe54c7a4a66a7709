"""The model zoo of the PyTorch port — counterpart of
``gan_deeplearning4j_tpu/zoo``: the scenario manifest that the harness,
the serializer, the serving engine and the canary gate key off
(``manifest.py``), the dataset loaders (``datasets.py``), the
double-buffered input pipeline (``streaming.py``), and the drill that runs
them end to end (``python -m gan_deeplearning4j_tpu_torch.zoo.drill``)."""

from gan_deeplearning4j_tpu_torch.zoo.datasets import (
    load_cifar_shaped,
    load_dataset,
    load_fashion_mnist,
    load_mnist,
)
from gan_deeplearning4j_tpu_torch.zoo.manifest import (
    ARCHITECTURES,
    CONDITIONINGS,
    DATASET_SHAPES,
    DATASETS,
    ScenarioManifest,
    scenario_from_bundle,
    scenario_from_config,
)
from gan_deeplearning4j_tpu_torch.zoo.streaming import (
    StreamingDataSetIterator,
    array_source,
    npz_source,
)

__all__ = [
    "ARCHITECTURES",
    "CONDITIONINGS",
    "DATASETS",
    "DATASET_SHAPES",
    "ScenarioManifest",
    "StreamingDataSetIterator",
    "array_source",
    "load_cifar_shaped",
    "load_dataset",
    "load_fashion_mnist",
    "load_mnist",
    "npz_source",
    "scenario_from_bundle",
    "scenario_from_config",
]
