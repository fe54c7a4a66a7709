"""Record readers — counterpart of ``gan_deeplearning4j_tpu/data/records.py``.

``CSVRecordReader(0, ",")`` over a
``FileSplit(ClassPathResource("mnist_train.csv"))`` parses the whole file
to one float32 matrix up front; the iterator layer batches and labelizes
it. ``InMemoryRecordReader`` reads a matrix already in memory. Parsing and
writing prefer the port's native C++ library (``native/csv_loader.py``,
built with g++ at first use), as the JAX package's records prefer its own;
where it cannot be built they use numpy and log so once. The fallback is
host I/O of the same values.
"""

from __future__ import annotations

import logging
import os
from typing import Iterator, List, Optional, Sequence

import numpy as np

_log = logging.getLogger(__name__)
_fallback_logged = False


def _native_csv():
    """The native CSV module when its library is available, else None (and
    the numpy fallback is logged, once a process)."""
    global _fallback_logged
    from gan_deeplearning4j_tpu_torch.native import csv_loader

    if csv_loader.available():
        return csv_loader
    if not _fallback_logged:
        _fallback_logged = True
        _log.warning("the native CSV library is unavailable (no g++, or its build failed): "
                     "CSV files are read and written with numpy")
    return None


class ClassPathResource:
    """Resolve a data file by name against a search path (DL4J's
    ``ClassPathResource`` resolved it on the JVM classpath): the explicit
    ``roots``, then ``$GAN_DL4J_TPU_DATA``, the working directory and its
    ``resources/``."""

    def __init__(self, name: str, roots: Optional[Sequence[str]] = None):
        self.name = name
        env_root = os.environ.get("GAN_DL4J_TPU_DATA")
        self.roots: List[str] = list(roots or [])
        if env_root:
            self.roots.append(env_root)
        self.roots.extend([os.getcwd(), os.path.join(os.getcwd(), "resources")])

    def get_file(self) -> str:
        if os.path.isabs(self.name) and os.path.exists(self.name):
            return self.name
        for root in self.roots:
            candidate = os.path.join(root, self.name)
            if os.path.exists(candidate):
                return candidate
        raise FileNotFoundError(f"resource {self.name!r} not found under {self.roots}")


class FileSplit:
    """Trivial split over one file (DL4J ``FileSplit``): a path, or a
    :class:`ClassPathResource` resolved now."""

    def __init__(self, path):
        self.path = path if isinstance(path, str) else path.get_file()


class RecordReader:
    """Iteration protocol shared by all readers: ``has_next`` /
    ``next_record`` / ``next_block`` / ``reset`` over a float32 matrix."""

    def __init__(self) -> None:
        self._data: Optional[np.ndarray] = None
        self._cursor = 0

    @property
    def data(self) -> np.ndarray:
        if self._data is None:
            raise RuntimeError(f"{type(self).__name__} not initialized (call initialize)")
        return self._data

    def has_next(self) -> bool:
        return self._cursor < self.data.shape[0]

    def next_record(self) -> np.ndarray:
        row = self.data[self._cursor]
        self._cursor += 1
        return row

    def next_block(self, n: int) -> np.ndarray:
        """Batched read: up to n rows at once."""
        block = self.data[self._cursor : self._cursor + n]
        self._cursor += block.shape[0]
        return block

    def remaining(self) -> int:
        return self.data.shape[0] - self._cursor

    def reset(self) -> None:
        self._cursor = 0

    def __iter__(self) -> Iterator[np.ndarray]:
        self.reset()
        while self.has_next():
            yield self.next_record()


def _parse_csv(path: str, skip_lines: int, delimiter: str) -> np.ndarray:
    """Parse a numeric CSV to float32, preferring the native parser."""
    native = _native_csv()
    if native is not None:
        return native.load_csv(path, skip_lines=skip_lines, delimiter=delimiter)
    return np.loadtxt(path, delimiter=delimiter, skiprows=skip_lines, dtype=np.float32, ndmin=2)


def write_csv(path: str, array: np.ndarray, precision: int = 6, delimiter: str = ",") -> str:
    """Write a float matrix as fixed-precision CSV, preferring the native
    writer."""
    native = _native_csv()
    if native is not None:
        return native.write_csv(path, array, delimiter=delimiter, precision=precision)
    np.savetxt(path, np.asarray(array), delimiter=delimiter, fmt=f"%.{precision}f")
    return path


class CSVRecordReader(RecordReader):
    """``CSVRecordReader(skipLines, delimiter)`` analog."""

    def __init__(self, skip_lines: int = 0, delimiter: str = ","):
        super().__init__()
        self.skip_lines = skip_lines
        self.delimiter = delimiter

    def initialize(self, split: FileSplit) -> None:
        self._data = _parse_csv(split.path, self.skip_lines, self.delimiter)
        self._cursor = 0


class InMemoryRecordReader(RecordReader):
    """Reader over an in-memory matrix (tests, synthetic data)."""

    def __init__(self, data: np.ndarray):
        super().__init__()
        self._data = np.asarray(data, dtype=np.float32)

    def initialize(self, split: Optional[FileSplit] = None) -> None:
        self._cursor = 0
