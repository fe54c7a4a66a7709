"""Build the native CSV library with the system toolchain.

One g++ invocation, at first use in a process (never at import):

    g++ -O3 -std=c++17 -shared -fPIC -pthread -o <lib> src/csv_loader.cpp

The library lands in ``gan_deeplearning4j_tpu_torch/native/build/``
(``.gitignore`` lists it), named by a digest of the source and the flags,
so an edited source is rebuilt and a stale library never loaded. The
compile writes a temporary file and renames it, so processes building at
once never load a half-written library. The ABI is plain C, bound with
ctypes (``csv_loader.py``)."""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import threading
from typing import Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "src", "csv_loader.cpp")
BUILD_DIR = os.path.join(_HERE, "build")
_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")
_lock = threading.Lock()


def library_path() -> str:
    """Where the library is (or will be) built."""
    with open(_SRC, "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libgdt_csv-{digest}.so")


def needs_build() -> bool:
    return not os.path.exists(library_path())


def build(force: bool = False) -> Optional[str]:
    """Compile if needed. Returns the library's path, or None when there is
    no g++ or the compile fails (the callers then use numpy)."""
    with _lock:
        lib = library_path()
        if not force and os.path.exists(lib):
            return lib
        compiler = shutil.which("g++")
        if compiler is None:
            return None
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{lib}.tmp.{os.getpid()}"
        try:
            subprocess.run([compiler, *_FLAGS, "-o", tmp, _SRC], check=True, capture_output=True,
                           timeout=120)
            os.replace(tmp, lib)
        except (OSError, subprocess.SubprocessError):
            if os.path.exists(tmp):
                os.unlink(tmp)
            return None
        return lib
