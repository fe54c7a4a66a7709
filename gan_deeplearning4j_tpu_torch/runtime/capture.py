"""The process-wide CUDA-graph capture lock.

Training's captured iterations (``harness/graphs.py``) and every serving
engine's (kind, bucket) graphs (``serving/engine.py``) capture in one
process: ``chip_smoke.py`` trains, publishes and serves in one process, and
the mux holds several engines at once. Every capture takes
:data:`CAPTURE_LOCK`, so two captures never overlap; the release of an
engine's graphs and the profiler's start and stop (``telemetry/device.py``)
take it too.

Captures run in ``"thread_local"`` mode: a call that is unsafe during a
capture (a ``cudaHostAlloc`` for a new pinned buffer, a synchronize, the
destruction of another graph) ends the capture only when the capturing
thread makes it, so request threads that keep serving meanwhile cannot
break it. The capturing thread itself must make no such call:
:func:`capture_guard` collects Python's cyclic garbage before the capture
and holds the collector off during it, because a graph of an unreachable
object destroyed by the collector mid-capture ends the capture ("operation
not permitted when stream is capturing").
"""

from __future__ import annotations

import contextlib
import gc
import threading

#: held by every CUDA-graph capture in the process (module docstring)
CAPTURE_LOCK = threading.RLock()

#: the mode every capture in the port runs in
CAPTURE_ERROR_MODE = "thread_local"


@contextlib.contextmanager
def capture_guard():
    """Hold :data:`CAPTURE_LOCK` with Python's cyclic collector run first
    and held off until the block ends."""
    with CAPTURE_LOCK:
        gc.collect()
        collecting = gc.isenabled()
        gc.disable()
        try:
            yield
        finally:
            if collecting:
                gc.enable()
