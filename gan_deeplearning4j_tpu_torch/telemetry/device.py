"""On-demand device profiling — counterpart of
``gan_deeplearning4j_tpu/telemetry/device.py``, on ``torch.profiler``.

The span tracer (:mod:`.trace`) answers *which stage* took the time; the
device profiler answers *what the card did inside it*: which kernels ran,
for how long, and how busy the card was. A capture is expensive (a large
trace, some interference), so it is never ambient: a live process exposes
it as a momentary hook —

- the serving API's ``POST /debug/trace?ms=N`` (``serving/service.py``), and
- ``SIGUSR2`` on the supervised worker CLI (``resilience/__main__.py``,
  :func:`install_signal_capture`) —

each dumping one bounded capture into an artifacts directory and
returning to normal operation.

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

The profiler's first session in a process must start on the main thread
(:func:`prime_profiler`), and both hooks run their captures on other
threads. SIGUSR2's handler already runs on the main thread and primes
there. The serving hook runs on a request thread, so it asks the main
thread to prime (:func:`request_prime`): the main thread of a server sits
in ``serve_forever``'s select loop (or, in a process that hosts the
server on a thread, in whatever it is doing), and a signal is the one
thing that makes Python run code there without the main thread's help.
The handler is installed when the server is made (:func:`
install_prime_handler`, cheap: priming itself costs seconds on the card
and so happens on the first ``/debug/trace`` only, never at a worker's
boot, most of a fleet relaunch's time).
"""

from __future__ import annotations

import itertools
import logging
import os
import signal
import threading
import time
from typing import List, Optional, Tuple

logger = logging.getLogger(__name__)

_capture_lock = threading.Lock()
_capture_ids = itertools.count(1)
#: the capture threads SIGUSR2 started (:func:`join_signal_captures`)
_signal_captures: List[threading.Thread] = []
#: whether :func:`prime_profiler` ran in this process
_primed = False

#: the Chrome trace a capture writes into its directory
TRACE_NAME = "trace.json"

#: the signal a request thread sends the main thread to prime the profiler
#: there: its default action is to be ignored, so one that arrives before
#: the handler is installed (or after it is replaced) harms nothing
PRIME_SIGNAL = signal.SIGURG
#: set by the main thread's handler once it has primed; a request thread
#: waits on it
_primed_event = threading.Event()
_prime_handler_installed = False


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
        if torch.cuda.is_available():
            # the window's device work ends inside the session, so its
            # kernel records are complete when it stops
            torch.cuda.synchronize()
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


def prime_profiler() -> None:
    """Start and stop one empty profiler session on the calling thread, once
    per process, when a card is present. The profiler sets up its CUDA
    tracing on its first session, and only on the thread that registered its
    client (the main thread, which loaded torch): a first session started on
    another thread records no device activity at all ("External init
    callback must run in same thread as registerClient", on the H100). On
    the card it takes seconds, so it runs when a capture is first asked
    for, not when a process starts."""
    global _primed
    if _primed:
        return
    import torch

    if torch.cuda.is_available():
        from gan_deeplearning4j_tpu_torch.runtime.capture import CAPTURE_LOCK

        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                  torch.profiler.ProfilerActivity.CUDA])
        with CAPTURE_LOCK:
            prof.start()
            prof.stop()
    _primed = True
    _primed_event.set()


def _prime_handler(signo, frame) -> None:
    """Runs on the main thread: prime unless a CUDA graph is being captured
    there (a profiler session must not start inside a capture); the
    request thread then asks again."""
    from gan_deeplearning4j_tpu_torch.runtime.capture import capturing

    if _primed or capturing():
        return
    try:
        prime_profiler()
    except Exception:
        logger.exception("priming the profiler on the main thread failed")


def install_prime_handler() -> bool:
    """Install the main thread's priming handler for :data:`PRIME_SIGNAL`.
    Only the main thread can install a signal handler: called from any
    other thread it installs nothing and answers False."""
    global _prime_handler_installed
    if threading.current_thread() is not threading.main_thread():
        return False
    signal.signal(PRIME_SIGNAL, _prime_handler)
    _prime_handler_installed = True
    return True


def request_prime(timeout_s: float = 120.0) -> bool:
    """Make sure the profiler is primed before a capture starts on this
    thread. On the main thread it primes here; on any other thread it
    signals the main thread (:func:`install_prime_handler`) and waits,
    asking again each second (the main thread may be inside a graph
    capture). False when no handler is installed or the wait ran out."""
    if _primed:
        return True
    if threading.current_thread() is threading.main_thread():
        prime_profiler()
        return True
    if not _prime_handler_installed:
        return False
    main_ident = threading.main_thread().ident
    deadline = time.monotonic() + timeout_s
    while not _primed and time.monotonic() < deadline:
        signal.pthread_kill(main_ident, PRIME_SIGNAL)
        _primed_event.wait(min(1.0, max(0.0, deadline - time.monotonic())))
    return _primed


def install_signal_capture(artifacts_dir: str,
                           duration_ms: int = 1000,
                           signum: int = signal.SIGUSR2) -> None:
    """SIGUSR2 → one background device capture. The handler only spawns a
    daemon thread (signal handlers must not block for the capture window,
    and Python runs them on the main thread, which may be inside a CUDA-graph
    capture: the capture thread's profiler start waits on the process
    capture lock); a signal landing mid-capture is logged and dropped
    (:class:`CaptureBusy`) — a stuck operator mashing SIGUSR2 must not
    stack captures. The first signal primes the profiler
    (:func:`prime_profiler`) in the handler, on the main thread, before the
    capture thread starts: that stalls the main thread once, for seconds; a
    first signal landing inside a CUDA-graph capture on the main thread is
    logged and dropped instead."""
    from gan_deeplearning4j_tpu_torch.runtime.capture import capturing

    def _worker() -> None:
        try:
            capture_device_trace(artifacts_dir, duration_ms)
        except CaptureBusy:
            logger.warning("SIGUSR2 ignored: a device capture is running")
        except Exception:
            logger.exception("SIGUSR2 device capture failed")

    def _handler(signo, frame) -> None:
        if not _primed:
            if capturing():
                logger.warning("SIGUSR2 ignored: a CUDA graph is being captured")
                return
            prime_profiler()
        thread = threading.Thread(
            target=_worker, name="device-trace-capture", daemon=True)
        _signal_captures.append(thread)
        thread.start()

    signal.signal(signum, _handler)
    logger.info("signal %d captures %d ms device traces into %s",
                signum, duration_ms, artifacts_dir)


def join_signal_captures(timeout_s: float = 120.0) -> None:
    """Wait (bounded) for the captures SIGUSR2 started. A process that exits
    mid-capture kills the profiler's threads in the middle of a trace (on
    the card a worker died by SIGSEGV that way) and loses the trace: the
    worker CLI calls this before it exits."""
    deadline = time.monotonic() + timeout_s
    for thread in list(_signal_captures):
        thread.join(max(0.0, deadline - time.monotonic()))


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
