"""DataSet — the (features, labels) batch value type, counterpart of
``gan_deeplearning4j_tpu/data/dataset.py``. Here a batch holds host numpy
arrays."""

from __future__ import annotations

import numpy as np


class DataSet:
    """A batch of ``features`` and (optionally one-hot) ``labels``."""

    def __init__(self, features, labels=None):
        self.features = features
        self.labels = labels

    def num_examples(self) -> int:
        return int(self.features.shape[0])

    def __len__(self) -> int:
        return self.num_examples()

    def __repr__(self) -> str:
        f = tuple(self.features.shape)
        l = tuple(self.labels.shape) if self.labels is not None else None
        return f"DataSet(features={f}, labels={l})"


def one_hot_np(labels: np.ndarray, num_classes: int, dtype=np.float32) -> np.ndarray:
    """Integer labels → one-hot rows (RecordReaderDataSetIterator's labelization)."""
    labels = np.asarray(labels).astype(np.int64).reshape(-1)
    out = np.zeros((labels.shape[0], num_classes), dtype=dtype)
    out[np.arange(labels.shape[0]), labels] = 1.0
    return out
