"""DataSet — the (features, labels) batch value type, counterpart of
``gan_deeplearning4j_tpu/data/dataset.py``. A batch holds host numpy
arrays, or torch tensors once ``to_device`` has placed it.

On a data mesh (``runtime/environment.py::DataMesh``) a global batch is
split by rows, the JAX package's ``PartitionSpec("data")``: rank r holds
the r-th contiguous block (``shard_batch`` first truncates the batch to a
multiple of the mesh size)."""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from gan_deeplearning4j_tpu_torch.runtime.device import DeviceLike, resolve_device


class DataSet:
    """A batch of ``features`` and (optionally one-hot) ``labels``."""

    def __init__(self, features, labels=None):
        self.features = features
        self.labels = labels

    def get_features(self):
        return self.features

    def get_labels(self):
        return self.labels

    def num_examples(self) -> int:
        return int(self.features.shape[0])

    def __len__(self) -> int:
        return self.num_examples()

    def __repr__(self) -> str:
        f = tuple(self.features.shape)
        l = tuple(self.labels.shape) if self.labels is not None else None
        return f"DataSet(features={f}, labels={l})"

    @staticmethod
    def merge(datasets: Sequence["DataSet"]) -> "DataSet":
        """Row-concatenate several DataSets (Nd4j.vstack over a
        List<DataSet>): tensors stay on their device, numpy rows on the
        host."""
        feats = _concat([d.features for d in datasets])
        if datasets[0].labels is None:
            return DataSet(feats)
        return DataSet(feats, _concat([d.labels for d in datasets]))

    def shard_batch(self, n: int) -> "DataSet":
        """The batch truncated to a multiple of ``n`` (the mesh size)."""
        b = self.num_examples()
        usable = (b // n) * n
        if usable == 0:
            raise ValueError(f"batch of {b} cannot be split over {n} shards")
        if usable == b:
            return self
        return DataSet(self.features[:usable], None if self.labels is None else self.labels[:usable])

    def rank_rows(self, mesh) -> "DataSet":
        """``mesh``'s rank's contiguous rows of this global batch (after
        :meth:`shard_batch`)."""
        batch = self.shard_batch(mesh.size)
        rows = mesh.rows(batch.num_examples())
        return DataSet(batch.features[rows], None if batch.labels is None else batch.labels[rows])

    def to_device(self, device: DeviceLike = None, non_blocking: bool = True,
                  mesh=None) -> "DataSet":
        """The batch as tensors on ``device`` (the card unless the caller
        asks for another). Host rows bound for the card go through pinned
        memory, so with ``non_blocking`` the copy is asynchronous on the
        current stream. With a ``mesh`` only its rank's rows are placed, on
        the mesh's device unless ``device`` names one."""
        if mesh is not None:
            return self.rank_rows(mesh).to_device(mesh.device if device is None else device,
                                                  non_blocking)
        dev = resolve_device(device)

        def put(x):
            t = torch.as_tensor(x)
            if dev.type == "cuda" and t.device.type == "cpu":
                t = t.pin_memory()
            return t.to(dev, non_blocking=non_blocking)

        return DataSet(put(self.features), None if self.labels is None else put(self.labels))


def _concat(parts):
    if any(isinstance(p, torch.Tensor) for p in parts):
        device = next(p.device for p in parts if isinstance(p, torch.Tensor))
        return torch.cat([torch.as_tensor(p, device=device) for p in parts], dim=0)
    return np.concatenate(parts, axis=0)


def one_hot(labels, num_classes: int, dtype=torch.float32, device: DeviceLike = None) -> torch.Tensor:
    """Integer labels → one-hot rows as a tensor (RecordReaderDataSetIterator's
    labelization), on ``device``: by default the labels' own when they are
    a tensor, else the card. A label outside ``[0, num_classes)`` is an
    all-zero row, as ``jax.nn.one_hot`` makes it."""
    if device is None and isinstance(labels, torch.Tensor):
        dev = labels.device
    else:
        dev = resolve_device(device)
    ids = torch.as_tensor(np.asarray(labels) if not isinstance(labels, torch.Tensor) else labels)
    ids = ids.to(dev).to(torch.int64).reshape(-1)
    return (ids[:, None] == torch.arange(num_classes, device=dev)).to(dtype)


def one_hot_np(labels: np.ndarray, num_classes: int, dtype=np.float32) -> np.ndarray:
    """Integer labels → one-hot rows (RecordReaderDataSetIterator's labelization)."""
    labels = np.asarray(labels).astype(np.int64).reshape(-1)
    out = np.zeros((labels.shape[0], num_classes), dtype=dtype)
    out[np.arange(labels.shape[0]), labels] = 1.0
    return out


def train_test_split(features, labels, test_fraction: float, seed: int = 666):
    """Deterministic host-side split: ``default_rng(seed).permutation``, the
    first ``round(n · test_fraction)`` rows for the test set, as the JAX
    package splits."""
    n = features.shape[0]
    perm = np.random.default_rng(seed).permutation(n)
    n_test = int(round(n * test_fraction))
    test_idx, train_idx = perm[:n_test], perm[n_test:]
    return (
        (features[train_idx], labels[train_idx]),
        (features[test_idx], labels[test_idx]),
    )
