"""Streaming input pipeline — counterpart of
``gan_deeplearning4j_tpu/zoo/streaming.py``: host-side double buffering
behind the ``DataSetIterator`` contract.

``ArrayDataSetIterator`` holds the whole dataset as one float32 matrix.
``StreamingDataSetIterator`` keeps only two *blocks* (``block_batches``
batches each): the consumer slices batches out of the current block while
one background worker gathers the next block from the row ``source``. The
promotion fences on the worker's future before the consumer reads the
incoming block.

Batches are byte-identical to ``ArrayDataSetIterator``'s (and to the JAX
package's streaming iterator) at one seed: the epoch order is the same
``np.random.default_rng(seed + epoch).permutation``, rows are cast to
float32 the same way, and batches are the same ``order[cursor:cursor +
batch_size]`` slices. Blocks are batch-aligned, so no batch straddles two
blocks, and the ragged tail (``drop_remainder=False``) is the last block's
short final slice.

Batches are host arrays, as ``ArrayDataSetIterator``'s are; with
``device`` given they land there through ``DataSet.to_device`` (pinned,
non-blocking on the card), as the port's device iterators place theirs.
"""

from __future__ import annotations

from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, Optional, Tuple

import numpy as np

from gan_deeplearning4j_tpu_torch.data.dataset import DataSet
from gan_deeplearning4j_tpu_torch.data.iterator import DataSetIterator
from gan_deeplearning4j_tpu_torch.runtime.device import DeviceLike, resolve_device

# source(indices) -> (feature rows, label rows or None) for the given global
# row indices, in order; called from the worker thread (pure reads)
RowSource = Callable[[np.ndarray], Tuple[np.ndarray, Optional[np.ndarray]]]


def array_source(features: np.ndarray,
                 labels: Optional[np.ndarray] = None) -> Tuple[RowSource, int]:
    """In-memory arrays as a row source. The float32 cast happens here,
    once, as ``ArrayDataSetIterator``'s constructor casts."""
    feats = np.asarray(features, dtype=np.float32)
    labs = None if labels is None else np.asarray(labels, dtype=np.float32)
    if labs is not None and labs.shape[0] != feats.shape[0]:
        raise ValueError("features/labels row mismatch")

    def source(idx: np.ndarray):
        return feats[idx], (None if labs is None else labs[idx])

    return source, feats.shape[0]


def npz_source(path: str, features_key: str = "features",
               labels_key: str = "labels") -> Tuple[RowSource, int]:
    """A row source over an ``.npz`` file, opened once; row gathers run in
    the worker."""
    archive = np.load(path)
    feats = np.asarray(archive[features_key], dtype=np.float32)
    labs = (np.asarray(archive[labels_key], dtype=np.float32)
            if labels_key in archive.files else None)
    return array_source(feats, labs)


class StreamingDataSetIterator(DataSetIterator):
    """Double-buffered ``DataSetIterator`` over a row source: the current
    block (being consumed) and the pending block (being filled by the
    worker). ``_promote`` is the one place the pending block becomes
    readable, and it waits on the worker's future first."""

    def __init__(self, source: RowSource, num_rows: int, batch_size: int = 128,
                 shuffle: bool = False, seed: int = 666, drop_remainder: bool = False,
                 block_batches: int = 8, device: DeviceLike = None):
        if block_batches < 1:
            raise ValueError("block_batches must be >= 1")
        self._source = source
        self.num_rows = int(num_rows)
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.seed = seed
        self.drop_remainder = drop_remainder
        self.device = None if device is None else resolve_device(device)
        self._block_rows = block_batches * self.batch_size
        self._executor = ThreadPoolExecutor(max_workers=1, thread_name_prefix="zoo-stream")
        self._epoch = 0
        self._start_epoch()

    # -- epochs and blocks -------------------------------------------------------
    def _make_order(self) -> np.ndarray:
        # ArrayDataSetIterator._make_order: that identity is the byte-equality
        if not self.shuffle:
            return np.arange(self.num_rows)
        return np.random.default_rng(self.seed + self._epoch).permutation(self.num_rows)

    def _start_epoch(self) -> None:
        self._order = self._make_order()
        self._cursor = 0
        self._block: Optional[Tuple[int, np.ndarray, Optional[np.ndarray]]] = None
        self._pending: Optional[Tuple[int, Future]] = None
        self._issue(0)
        self._promote()

    def _materialize(self, idx: np.ndarray):
        feats, labs = self._source(idx)
        feats = np.asarray(feats, dtype=np.float32)
        labs = None if labs is None else np.asarray(labs, dtype=np.float32)
        return feats, labs

    def _issue(self, start: int) -> None:
        """Start filling the block that begins at ``start``."""
        if start >= len(self._order):
            self._pending = None
            return
        idx = self._order[start:start + self._block_rows]
        self._pending = (start, self._executor.submit(self._materialize, idx))

    def _promote(self) -> None:
        """The pending block becomes current; ``result()`` is the fence."""
        if self._pending is None:
            self._block = None
            return
        start, future = self._pending
        feats, labs = future.result()
        self._block = (start, feats, labs)
        self._issue(start + len(feats))

    # -- DataSetIterator ---------------------------------------------------------
    def has_next(self) -> bool:
        remaining = self.num_rows - self._cursor
        if self.drop_remainder:
            return remaining >= self.batch_size
        return remaining > 0

    def next(self) -> DataSet:
        if not self.has_next() or self._block is None:
            raise StopIteration
        start, feats, labs = self._block
        offset = self._cursor - start
        rows = feats[offset:offset + self.batch_size]
        self._cursor += len(rows)
        batch = DataSet(rows, None if labs is None else labs[offset:offset + len(rows)])
        if self._cursor >= start + len(feats):
            self._promote()
        if self.device is not None:
            batch = batch.to_device(self.device)
        return batch

    def reset(self) -> None:
        # fence any fill in flight before its block is dropped; the epoch
        # advances first, as ArrayDataSetIterator.reset's does
        if self._pending is not None:
            self._pending[1].result()
            self._pending = None
        self._epoch += 1
        self._start_epoch()

    def close(self) -> None:
        """Release the worker thread; the iterator is unusable afterwards.
        Safe to call more than once."""
        if self._pending is not None:
            self._pending[1].result()
            self._pending = None
        self._executor.shutdown(wait=True)
