"""ctypes binding of the native CSV parser and writer (``src/csv_loader.cpp``):
parse a numeric CSV to a dense float32 matrix, multithreaded over row
chunks, and write one back at a fixed precision. ``available()`` is False
where the library cannot be built or loaded; ``data/records.py`` then uses
numpy."""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional

import numpy as np

from gan_deeplearning4j_tpu_torch.native import build as _build

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        path = _build.build()
        if path is None:
            _load_failed = True
            return None
        try:
            lib = ctypes.CDLL(path)
            lib.gdt_csv_read.restype = ctypes.c_int
            lib.gdt_csv_read.argtypes = [
                ctypes.c_char_p, ctypes.c_long, ctypes.c_char,
                ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
                ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_long),
            ]
            lib.gdt_csv_free.restype = None
            lib.gdt_csv_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
            for name, ctype in (("gdt_csv_write", ctypes.c_float), ("gdt_csv_write_f64", ctypes.c_double)):
                fn = getattr(lib, name)
                fn.restype = ctypes.c_int
                fn.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctype), ctypes.c_long, ctypes.c_long,
                               ctypes.c_char, ctypes.c_int]
        except (OSError, AttributeError):
            _load_failed = True
            return None
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the native library is built (now, if need be) and loaded."""
    return _load() is not None


_ERRORS = {
    1: "cannot open/read file",
    2: "ragged rows (inconsistent column counts)",
    3: "parse failure (non-numeric field)",
    4: "empty input",
}


def load_csv(path: str, skip_lines: int = 0, delimiter: str = ",") -> np.ndarray:
    """Parse a numeric CSV into an (N, C) float32 array."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native CSV library unavailable")
    data = ctypes.POINTER(ctypes.c_float)()
    rows, cols = ctypes.c_long(), ctypes.c_long()
    status = lib.gdt_csv_read(os.fspath(path).encode(), skip_lines, delimiter.encode()[:1],
                              ctypes.byref(data), ctypes.byref(rows), ctypes.byref(cols))
    if status != 0:
        raise ValueError(f"native CSV parse of {path!r} failed: {_ERRORS.get(status, status)}")
    try:
        # copy out of the library's malloc'd buffer into numpy-owned memory
        return np.ctypeslib.as_array(data, shape=(rows.value, cols.value)).copy()
    finally:
        lib.gdt_csv_free(data)


def write_csv(path: str, array: np.ndarray, delimiter: str = ",", precision: int = 6) -> str:
    """Write an (N, C) array as CSV (``%.{precision}f``). float64 input is
    formatted from float64 (as ``np.savetxt`` formats it, digit for digit);
    every other dtype goes through float32."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native CSV library unavailable")
    array = np.asarray(array)
    if array.dtype == np.float64:
        arr, fn, ctype = np.ascontiguousarray(array), lib.gdt_csv_write_f64, ctypes.c_double
    else:
        arr = np.ascontiguousarray(array.astype(np.float32, copy=False))
        fn, ctype = lib.gdt_csv_write, ctypes.c_float
    if arr.ndim != 2:
        raise ValueError(f"expected a 2-D array, got shape {arr.shape}")
    status = fn(os.fspath(path).encode(), arr.ctypes.data_as(ctypes.POINTER(ctype)),
                arr.shape[0], arr.shape[1], delimiter.encode()[:1], precision)
    if status != 0:
        raise ValueError(f"native CSV write to {path!r} failed")
    return path
