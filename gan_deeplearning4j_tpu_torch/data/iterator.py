"""DataSet iterators — counterpart of
``gan_deeplearning4j_tpu/data/iterator.py``: batching, labelization,
reset, and device placement.

``RecordReaderDataSetIterator(reader, batch, label_index=784,
num_classes=10)`` turns CSV rows into ``DataSet{features (B, 784),
one-hot (B, 10)}`` batches; ``ArrayDataSetIterator`` batches in-memory
arrays with optional seeded per-epoch shuffling. Both yield host arrays.

Two iterators yield tensors on the device:
- ``DeviceResidentIterator`` puts the whole set on the device once and
  serves batches as slices, and ``next_window(k)`` a run of whole batches
  as one ``(k', B, …)`` slice (what ``GanExperiment.run`` feeds a window
  of captured iterations);
- ``DevicePrefetchIterator`` wraps any iterator and keeps ``depth``
  batches ahead on the device, each copied on a side stream while the
  consumer trains on the one before.

Shuffled orders are drawn on the host, ``np.random.default_rng(seed +
epoch).permutation(n)``, so every iterator here visits the rows in the
JAX package's order.

On a data mesh (``mesh=``) both put only this rank's contiguous rows of
each global batch on its device (the ``PartitionSpec("data")`` row split):
their batches and windows are ``B / N`` rows, and ``GanExperiment.run``
reads them as local. The resident iterator keeps the set on the host and
places the rank's rows of the epoch's batches once per epoch.
"""

from __future__ import annotations

from collections import deque
from typing import Iterator, Optional

import numpy as np
import torch

from gan_deeplearning4j_tpu_torch.data.dataset import DataSet, one_hot_np
from gan_deeplearning4j_tpu_torch.data.records import RecordReader
from gan_deeplearning4j_tpu_torch.runtime.device import DeviceLike, resolve_device


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
    feature batches. A reader with ``next_block`` is read a batch at a
    time; any other (``has_next`` / ``next_record`` / ``reset`` only) a
    record at a time."""

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
        if hasattr(self.reader, "next_block"):
            block = self.reader.next_block(self.batch_size)
        else:
            rows = []
            while self.reader.has_next() and len(rows) < self.batch_size:
                rows.append(self.reader.next_record())
            block = np.stack(rows)
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


class DeviceResidentIterator(DataSetIterator):
    """The whole set on ``device`` (the card unless the caller asks for the
    CPU), put there once; batches are slices of it, so the steady state
    moves no rows from the host. ``shuffle`` draws a seeded permutation per
    epoch on the host and gathers on the device."""

    def __init__(self, features, labels=None, batch_size: int = 128, shuffle: bool = False,
                 seed: int = 666, drop_remainder: bool = False, device: DeviceLike = None,
                 mesh=None):
        self.mesh = mesh
        if mesh is not None:
            self._init_mesh(features, labels, batch_size, shuffle, seed, drop_remainder)
            return
        self.device = resolve_device(device)

        def put(x):
            return torch.as_tensor(np.asarray(x, dtype=np.float32)).to(self.device)

        self.features = put(features)
        self.labels = None if labels is None else put(labels)
        if self.labels is not None and self.labels.shape[0] != self.features.shape[0]:
            raise ValueError("features/labels row mismatch")
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.seed = seed
        self.drop_remainder = drop_remainder
        self._epoch = 0
        self._order = self._make_order()
        self._cursor = 0

    # -- on a mesh: this rank's rows, placed once per epoch -------------------
    def _init_mesh(self, features, labels, batch_size, shuffle, seed, drop_remainder):
        self.device = self.mesh.device
        self._host = (np.asarray(features, dtype=np.float32),
                      None if labels is None else np.asarray(labels, dtype=np.float32))
        if self._host[1] is not None and self._host[1].shape[0] != self._host[0].shape[0]:
            raise ValueError("features/labels row mismatch")
        self.batch_size = int(batch_size)
        if self.batch_size % self.mesh.size:
            raise ValueError(f"batch {self.batch_size} does not split over {self.mesh.size} ranks")
        self.shuffle = shuffle
        self.seed = seed
        self.drop_remainder = drop_remainder
        self._epoch = 0
        self._place_epoch()

    def _place_epoch(self) -> None:
        """This rank's rows of every batch of the epoch, on the device:
        ``(nb, B/N, …)`` full batches and the ragged tail's rows."""
        n = self._host[0].shape[0]
        order = (np.random.default_rng(self.seed + self._epoch).permutation(n) if self.shuffle
                 else np.arange(n))
        b, size = self.batch_size, self.mesh.size
        nb = n // b
        full = order[: nb * b].reshape(nb, b)[:, self.mesh.rows(b)]
        tail = order[nb * b:]
        usable = tail.shape[0] // size * size
        tail = tail[:usable][self.mesh.rows(usable)] if usable and not self.drop_remainder \
            else tail[:0]

        def put(x, idx):
            return None if x is None else torch.from_numpy(x[idx]).to(self.device)

        self._windowed = (nb, put(self._host[0], full), put(self._host[1], full))
        self._tail = (put(self._host[0], tail), put(self._host[1], tail))
        self._at = 0  # batches served this epoch

    def _mesh_has_next(self) -> bool:
        nb = self._windowed[0]
        return self._at < nb or (self._at == nb and self._tail[0].shape[0] > 0)

    def _mesh_next(self) -> DataSet:
        if not self._mesh_has_next():
            raise StopIteration
        nb, wf, wl = self._windowed
        at, self._at = self._at, self._at + 1
        if at < nb:
            return DataSet(wf[at], None if wl is None else wl[at])
        return DataSet(*self._tail)

    def _make_order(self) -> Optional[torch.Tensor]:
        self._windowed = None  # the epoch's (nb, B, …) views, made on first use
        if not self.shuffle:
            return None  # sequential: slices, no gather
        order = np.random.default_rng(self.seed + self._epoch).permutation(self.features.shape[0])
        return torch.from_numpy(order).to(self.device)

    def _window_arrays(self):
        """``(nb, features (nb, B, …), labels (nb, B, …) or None)``: the
        epoch's full batches, with one ``index_select`` when shuffled."""
        if self._windowed is None:
            b = self.batch_size
            nb = self.features.shape[0] // b

            def batches(x):
                if x is None:
                    return None
                x = x[: nb * b] if self._order is None else x.index_select(0, self._order[: nb * b])
                return x.reshape((nb, b) + tuple(x.shape[1:]))

            self._windowed = (nb, batches(self.features), batches(self.labels))
        return self._windowed

    def next_window(self, k: int):
        """Up to ``k`` consecutive full batches as one ``(k', B, …)`` slice
        ``(features, labels or None)``: ``k'`` is the largest power of two
        at most ``min(k, full batches left)``, so a caller sees a bounded
        set of window sizes. None when the cursor is not on a batch
        boundary or no full batch is left (the caller then takes
        ``next()``)."""
        if self.mesh is not None:
            nb, wf, wl = self._windowed
            at = self._at
        else:
            if k < 1 or self._cursor % self.batch_size != 0:
                return None
            nb, wf, wl = self._window_arrays()
            at = self._cursor // self.batch_size
        avail = min(k, nb - at)
        if avail < 1:
            return None
        take = 1 << (avail.bit_length() - 1)
        if self.mesh is not None:
            self._at += take
        else:
            self._cursor += take * self.batch_size
        return wf[at: at + take], None if wl is None else wl[at: at + take]

    def has_next(self) -> bool:
        if self.mesh is not None:
            return self._mesh_has_next()
        remaining = self.features.shape[0] - self._cursor
        if self.drop_remainder:
            return remaining >= self.batch_size
        return remaining > 0

    def next(self) -> DataSet:
        if self.mesh is not None:
            return self._mesh_next()
        if not self.has_next():
            raise StopIteration
        lo = self._cursor
        hi = min(lo + self.batch_size, self.features.shape[0])
        self._cursor = hi
        if self._order is None:
            take = lambda x: None if x is None else x[lo:hi]  # noqa: E731
        else:
            idx = self._order[lo:hi]
            take = lambda x: None if x is None else x.index_select(0, idx)  # noqa: E731
        return DataSet(take(self.features), take(self.labels))

    def reset(self) -> None:
        self._epoch += 1
        if self.mesh is not None:
            self._place_epoch()
            return
        self._order = self._make_order()
        self._cursor = 0


class DevicePrefetchIterator(DataSetIterator):
    """Any iterator with ``depth`` batches kept ahead on ``device`` (the
    card unless the caller asks for the CPU). Each batch goes through
    ``transform`` (a host-side ``DataSet -> DataSet`` hook) and then
    ``to_device``; on the card the copy runs on a side stream, so it
    overlaps the step that consumes the batch before. ``next()`` makes the
    consumer's stream wait for that batch's copy and records the batch's
    tensors on the consumer's stream, so the allocator does not reuse
    their memory while the consumer still reads it."""

    def __init__(self, inner: DataSetIterator, depth: int = 2, device: DeviceLike = None,
                 transform=None, mesh=None):
        if depth < 1:
            raise ValueError("prefetch depth must be >= 1")
        self.inner = inner
        self.depth = depth
        self.mesh = mesh
        self.device = mesh.device if mesh is not None and device is None else resolve_device(device)
        self.transform = transform
        self._stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self._queue: deque = deque()  # (batch on the device, its copy's event or None)

    def _fill(self) -> None:
        while len(self._queue) < self.depth and self.inner.has_next():
            batch = self.inner.next()
            if self.transform is not None:
                batch = self.transform(batch)
            if self.mesh is not None:
                batch = batch.rank_rows(self.mesh)
            if self._stream is None:
                self._queue.append((batch.to_device(self.device), None))
                continue
            with torch.cuda.stream(self._stream):
                placed = batch.to_device(self.device, non_blocking=True)
                copied = torch.cuda.Event()
                copied.record(self._stream)
            self._queue.append((placed, copied))

    def has_next(self) -> bool:
        self._fill()
        return len(self._queue) > 0

    def next(self) -> DataSet:
        if not self.has_next():
            raise StopIteration
        batch, copied = self._queue.popleft()
        if copied is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(copied)
            for t in (batch.features, batch.labels):
                if t is not None:
                    t.record_stream(consumer)
        self._fill()  # keep the pipeline full while this batch is consumed
        return batch

    def reset(self) -> None:
        self._queue.clear()
        self.inner.reset()
