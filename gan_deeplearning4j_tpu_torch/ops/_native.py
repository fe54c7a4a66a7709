"""Builds and loads the port's hand-written CUDA kernel, ``quant_dense``.

The kernel is one source, ``gan_deeplearning4j_tpu_torch/csrc/quant_dense.cu``,
with a plain C interface. At its first use in a process, :func:`quant_dense`
compiles it with ``nvcc`` for ``sm_90a`` into a shared library and loads it
with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
         -shared -Xcompiler -fPIC -Xptxas -v -o <lib> <source>

(``-fmad=false``: the kernel rounds each product and sum on its own, as its
plain PyTorch version does.) The library lands in
``gan_deeplearning4j_tpu_torch/csrc/build/`` (``.gitignore`` lists it),
named by a digest of the source and the flags, so an edited source is
rebuilt and a stale library is never loaded; ``<lib>.log`` keeps what
``ptxas -v`` said (registers, shared memory, spills). ``nvcc`` is found
through ``$CUDA_HOME``, then ``PATH``, then ``/usr/local/cuda``.

Nothing here runs at import: the CPU has no ``nvcc``, and the tests import
every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import types

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(_CSRC, "build")
_SOURCE = os.path.join(_CSRC, "quant_dense.cu")

_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-fmad=false",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: the library's C entry points: (argtypes, restype)
_ENTRY_POINTS = {
    # (w_q, w_scale, b, b's dtype code, k, m, W_q's row length, act_scale,
    #  route, strip, cluster, k_chunk, k_stage, &err) -> layer handle or NULL
    "layer_new": ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)],
                  ctypes.c_void_p),
    "layer_free": ([ctypes.c_void_p], None),
    # (layer, x, y, n, x's dtype code, inv_act_scale, y in x's dtype, nt,
    #  row_tiles, smem_bytes, stream) -> cudaError_t
    "run": ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p], ctypes.c_int),
}

_lock = threading.Lock()
_loaded = None  # the loaded C entry points, after the first call


def nvcc_path() -> str:
    """The ``nvcc`` to build with; raises ``RuntimeError`` when there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        candidates.append(found)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError(
        "nvcc not found ($CUDA_HOME/bin, PATH, /usr/local/cuda/bin): the port's CUDA "
        "kernel builds at first use on a machine with the CUDA toolkit")


def library_path() -> str:
    """Where the kernel's library is (or will be) built."""
    with open(_SOURCE, "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libquant_dense-{digest}.so")


def _build(target: str) -> None:
    """Compile the source into ``target``, its ``nvcc`` output into
    ``<target>.log``; raises ``RuntimeError`` when ``nvcc`` fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{target}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run([nvcc_path(), *_FLAGS, "-o", tmp, _SOURCE], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, timeout=600)
    except subprocess.TimeoutExpired:
        raise RuntimeError("nvcc for quant_dense did not finish in 600 s") from None
    with open(f"{target}.log", "w") as fh:
        fh.write(proc.stdout)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for quant_dense (exit {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, target)  # another process may have won: same bytes


def build_log() -> str:
    """What ``nvcc``/``ptxas -v`` printed when the library was built (empty
    when it came from an earlier process)."""
    path = library_path() + ".log"
    if not os.path.exists(path):
        return ""
    with open(path) as fh:
        return fh.read()


def quant_dense() -> types.SimpleNamespace:
    """The kernel's C entry points ``layer_new``, ``layer_free`` and ``run``
    (``csrc/quant_dense.cu``; argtypes and restype set), its library built
    and loaded first when missing."""
    global _loaded
    with _lock:
        if _loaded is None:
            target = library_path()
            if not os.path.exists(target):
                _build(target)
            lib = ctypes.CDLL(target)
            entry = {}
            for name, (argtypes, restype) in _ENTRY_POINTS.items():
                fn = getattr(lib, f"gdt_quant_dense_{name}")
                fn.argtypes, fn.restype = argtypes, restype
                entry[name] = fn
            _loaded = types.SimpleNamespace(**entry)
        return _loaded
