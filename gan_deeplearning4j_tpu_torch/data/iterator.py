"""DataSet iterators — counterpart of
``gan_deeplearning4j_tpu/data/iterator.py``: batching, labelization and
reset over host arrays.

``RecordReaderDataSetIterator(reader, batch, label_index=784,
num_classes=10)`` turns CSV rows into ``DataSet{features (B, 784),
one-hot (B, 10)}`` batches; ``ArrayDataSetIterator`` batches in-memory
arrays with optional seeded per-epoch shuffling.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np

from gan_deeplearning4j_tpu_torch.data.dataset import DataSet, one_hot_np
from gan_deeplearning4j_tpu_torch.data.records import RecordReader


class DataSetIterator:
    """Iterator protocol (DL4J DataSetIterator): has_next / next / reset."""

    def has_next(self) -> bool:
        raise NotImplementedError

    def next(self) -> DataSet:
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError

    def __iter__(self) -> Iterator[DataSet]:
        self.reset()
        while self.has_next():
            yield self.next()


class RecordReaderDataSetIterator(DataSetIterator):
    """Rows → (features, one-hot labels) batches. ``label_index`` is the
    column holding the integer class; ``label_index=None`` yields unlabeled
    feature batches."""

    def __init__(self, reader: RecordReader, batch_size: int,
                 label_index: Optional[int] = None, num_classes: Optional[int] = None):
        if (label_index is None) != (num_classes is None):
            raise ValueError("label_index and num_classes must be given together")
        self.reader = reader
        self.batch_size = int(batch_size)
        self.label_index = label_index
        self.num_classes = num_classes

    def has_next(self) -> bool:
        return self.reader.has_next()

    def next(self) -> DataSet:
        if not self.has_next():
            raise StopIteration
        block = self.reader.next_block(self.batch_size)
        if self.label_index is None:
            return DataSet(block)
        li = self.label_index
        features = np.concatenate([block[:, :li], block[:, li + 1 :]], axis=1)
        return DataSet(features, one_hot_np(block[:, li], self.num_classes))

    def reset(self) -> None:
        self.reader.reset()


class ArrayDataSetIterator(DataSetIterator):
    """Iterator over in-memory (features, labels) arrays. Optional shuffling
    is seeded and re-derived per epoch."""

    def __init__(self, features: np.ndarray, labels: Optional[np.ndarray] = None,
                 batch_size: int = 128, shuffle: bool = False, seed: int = 666,
                 drop_remainder: bool = False):
        self.features = np.asarray(features, dtype=np.float32)
        self.labels = None if labels is None else np.asarray(labels, dtype=np.float32)
        if self.labels is not None and self.labels.shape[0] != self.features.shape[0]:
            raise ValueError("features/labels row mismatch")
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.seed = seed
        self.drop_remainder = drop_remainder
        self._epoch = 0
        self._order = self._make_order()
        self._cursor = 0

    def _make_order(self) -> np.ndarray:
        n = self.features.shape[0]
        if not self.shuffle:
            return np.arange(n)
        return np.random.default_rng(self.seed + self._epoch).permutation(n)

    def has_next(self) -> bool:
        remaining = self.features.shape[0] - self._cursor
        if self.drop_remainder:
            return remaining >= self.batch_size
        return remaining > 0

    def next(self) -> DataSet:
        if not self.has_next():
            raise StopIteration
        idx = self._order[self._cursor : self._cursor + self.batch_size]
        self._cursor += len(idx)
        if self.labels is None:
            return DataSet(self.features[idx])
        return DataSet(self.features[idx], self.labels[idx])

    def reset(self) -> None:
        self._epoch += 1
        self._order = self._make_order()
        self._cursor = 0
