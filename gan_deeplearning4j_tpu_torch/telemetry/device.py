"""On-demand device profiling — counterpart of
``gan_deeplearning4j_tpu/telemetry/device.py``, on ``torch.profiler``.

The span tracer (:mod:`.trace`) answers *which stage* took the time; the
device profiler answers *what the card did inside it*: which kernels ran,
for how long, and how busy the card was. A capture is expensive (a large
trace, some interference), so it is never ambient: a live process exposes
it as a momentary hook, the serving API's ``POST /debug/trace?ms=N``
(``serving/service.py``), which dumps one bounded capture into an
artifacts directory and returns to normal operation.

A capture records the host's operators and, when a card is present, its
kernels and copies (``ProfilerActivity.CPU`` and ``.CUDA``), and writes a
Chrome trace, ``trace.json``, loadable in Perfetto or
``chrome://tracing``, into a fresh stamped directory. The profiler is
started and stopped under the process-wide capture lock
(``runtime/capture.py``), so it never enables its tracing in the middle of
a CUDA-graph capture.

One capture at a time per process: ``torch.profiler`` refuses nested
sessions, so the hook refuses (``CaptureBusy``) instead of crashing the
serving thread that raced a second request in.
"""

from __future__ import annotations

import itertools
import logging
import os
import threading
import time
from typing import Optional, Tuple

logger = logging.getLogger(__name__)

_capture_lock = threading.Lock()
_capture_ids = itertools.count(1)

#: the Chrome trace a capture writes into its directory
TRACE_NAME = "trace.json"


class CaptureBusy(RuntimeError):
    """A device capture is already running in this process."""


def _capture_dir(artifacts_dir: str) -> str:
    # the counter keeps two captures started within the same wall-clock
    # second from landing (and overwriting) in one directory
    stamp = time.strftime("%Y%m%d-%H%M%S")
    return os.path.join(
        artifacts_dir,
        f"device-{stamp}-pid{os.getpid()}-{next(_capture_ids)}",
    )


def _capture_locked(out: str, duration_ms: int) -> str:
    """The capture itself. The CALLER holds ``_capture_lock``."""
    import torch

    from gan_deeplearning4j_tpu_torch.runtime.capture import CAPTURE_LOCK

    os.makedirs(out, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    with CAPTURE_LOCK:
        prof.start()
    try:
        time.sleep(duration_ms / 1000.0)
    finally:
        with CAPTURE_LOCK:
            prof.stop()
    path = os.path.join(out, TRACE_NAME)
    prof.export_chrome_trace(path)
    logger.info("device trace captured to %s (%d ms)", path, duration_ms)
    return out


def capture_device_trace(artifacts_dir: str, duration_ms: int = 1000,
                         out: Optional[str] = None) -> str:
    """Capture ``duration_ms`` of device activity into ``out`` (default: a
    fresh stamped directory under ``artifacts_dir``); returns that
    directory. Blocks the calling thread for the capture window PLUS
    profiler start/stop and the trace's export, so interactive callers use :func:`capture_async`
    (the serving hook answers 202 with the artifact path immediately)."""
    if duration_ms < 1:
        raise ValueError("duration_ms must be >= 1")
    out = out or _capture_dir(artifacts_dir)
    if not _capture_lock.acquire(blocking=False):
        raise CaptureBusy("a device capture is already in progress")
    try:
        return _capture_locked(out, duration_ms)
    finally:
        _capture_lock.release()


def capture_async(artifacts_dir: str, duration_ms: int = 1000
                  ) -> Tuple["threading.Thread", str]:
    """Start a capture on a daemon thread; returns ``(thread, out_dir)``
    so the caller can answer immediately with the path the artifact WILL
    land at (the serving hook's 202 contract). The lock is ACQUIRED here,
    before returning — two racing callers cannot both get a 202 whose
    artifact then silently never lands; the loser gets
    :class:`CaptureBusy` synchronously and the caller can 409. The spawned
    thread inherits lock ownership and releases it when the capture (or
    its failure) finishes."""
    if duration_ms < 1:
        raise ValueError("duration_ms must be >= 1")
    # the output path is composed BEFORE taking the capture lock: a
    # failure here must not strand the lock held with no thread to
    # release it (every later capture would 409 forever)
    out = _capture_dir(artifacts_dir)
    if not _capture_lock.acquire(blocking=False):
        raise CaptureBusy("a device capture is already in progress")
    t = threading.Thread(
        target=_swallow_owned, args=(out, duration_ms),
        name="device-trace-capture", daemon=True,
    )
    t.start()
    return t, out


def _swallow_owned(out: str, duration_ms: int) -> None:
    """Async capture body: lock already held by capture_async."""
    try:
        _capture_locked(out, duration_ms)
    except Exception:
        logger.exception("device capture failed")
    finally:
        _capture_lock.release()


def default_artifacts_dir(base: Optional[str] = None) -> str:
    """Where hook-triggered captures land unless configured:
    ``$GDT_TRACE_DIR``, else ``<base or cwd>/artifacts/device_traces``."""
    env = os.environ.get("GDT_TRACE_DIR")
    if env:
        return env
    return os.path.join(base or os.getcwd(), "artifacts", "device_traces")
