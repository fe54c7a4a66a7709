"""DataSet — the (features, labels) batch value type, counterpart of
``gan_deeplearning4j_tpu/data/dataset.py``. A batch holds host numpy
arrays, or torch tensors once ``to_device`` has placed it."""

from __future__ import annotations

import numpy as np
import torch

from gan_deeplearning4j_tpu_torch.runtime.device import DeviceLike, resolve_device

_PARALLEL_WAITS = "ROADMAP.md queue 1, 'Parallel training'"


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

    def to_device(self, device: DeviceLike = None, non_blocking: bool = True,
                  sharding=None) -> "DataSet":
        """The batch as tensors on ``device`` (the card unless the caller
        asks for another). Host rows bound for the card go through pinned
        memory, so with ``non_blocking`` the copy is asynchronous on the
        current stream. ``sharding`` (the JAX package's mesh placement)
        raises."""
        if sharding is not None:
            raise NotImplementedError(f"sharded batches are not ported yet: {_PARALLEL_WAITS}")
        dev = resolve_device(device)

        def put(x):
            t = torch.as_tensor(x)
            if dev.type == "cuda" and t.device.type == "cpu":
                t = t.pin_memory()
            return t.to(dev, non_blocking=non_blocking)

        return DataSet(put(self.features), None if self.labels is None else put(self.labels))


def one_hot_np(labels: np.ndarray, num_classes: int, dtype=np.float32) -> np.ndarray:
    """Integer labels → one-hot rows (RecordReaderDataSetIterator's labelization)."""
    labels = np.asarray(labels).astype(np.int64).reshape(-1)
    out = np.zeros((labels.shape[0], num_classes), dtype=dtype)
    out[np.arange(labels.shape[0]), labels] = 1.0
    return out
