"""Structured tracing — spans in a bounded ring buffer, Chrome trace export.

Answers the question none of the per-plane stats can: *where did this
request (or training step) spend its time, across module boundaries*. A
span is one named interval; spans carry small ``args`` dicts (generation
numbers, flush ids, correlation ids) and land in a process-wide ring
buffer whose export is Chrome trace-event JSON — loadable in Perfetto /
``chrome://tracing`` directly, and foldable into occupancy tables by
``scripts/trace_report.py``.

Disabled is the default and the contract: with tracing off the serve fast
path must not allocate or record anything. Every hot-path call site guards
on ``TRACER.enabled`` (one attribute read) before touching timestamps or
args, and ``span()`` returns a shared no-op context manager — the same
object every time, so even the disabled path creates no garbage.

Correlation across threads and processes:

- ``new_trace_id()`` mints process-unique ids; ``bind_trace_id`` /
  ``current_trace_id`` carry one through a thread via ``contextvars``.
  The batcher's pipeline crosses threads (submit → worker → completer),
  where contextvars do not follow — there the id rides the request object
  itself and every stage stamps it into its span args, which is the
  property the trace tests pin.
- Timestamps are wall-epoch microseconds (``perf_counter`` deltas pinned
  to an epoch captured at import), so traces from two processes on one
  host — a training supervisor and the serving replica consuming its
  generations — merge into a single coherent timeline by concatenating
  their event lists.

Async stages (a flush dispatched by one thread and finalized by another)
use Chrome async events (``ph: "b"``/``"e"``) keyed by a flush id;
same-thread intervals use complete events (``ph: "X"``).
"""

from __future__ import annotations

import contextvars
import itertools
import json
import os
import re
import threading
import time
from collections import deque
from typing import Dict, Optional

#: pins perf_counter deltas to the wall clock ONCE so every event in this
#: process (and any sibling process on the host) shares one timeline
_EPOCH = time.time() - time.perf_counter()

#: cached: os.getpid() is a real syscall (slow under syscall-
#: intercepting runtimes) and the pid cannot change under us — a fresh interpreter
#: (including multiprocessing spawn) re-imports this module
_PID = os.getpid()

_trace_ctx: contextvars.ContextVar = contextvars.ContextVar(
    "gdt_trace_id", default=None
)

_ids = itertools.count(1)


def new_trace_id() -> str:
    """Process-unique correlation id (pid-prefixed so ids from merged
    multi-process traces never collide)."""
    return f"{_PID:x}-{next(_ids):x}"


#: the X-Trace-Id header contract (docs/OBSERVABILITY.md): short, shell-
#: and log-safe. Anything else from a client is ignored, not echoed — a
#: header is attacker-controlled input and these ids land verbatim in
#: traces, logs, and span args.
_TRACE_ID_RE = re.compile(r"^[A-Za-z0-9._:\-]{1,128}$")


def sanitize_trace_id(value) -> Optional[str]:
    """A client/peer-supplied trace id, validated — or None. The router
    and the serving HTTP handler adopt a propagated id only through this
    gate; an invalid one falls back to minting."""
    if not isinstance(value, str):
        return None
    value = value.strip()
    return value if _TRACE_ID_RE.match(value) else None


def current_trace_id() -> Optional[str]:
    return _trace_ctx.get()


def bind_trace_id(trace_id: Optional[str]):
    """Bind the current thread's correlation id; returns a token for
    ``unbind_trace_id``."""
    return _trace_ctx.set(trace_id)


def unbind_trace_id(token) -> None:
    _trace_ctx.reset(token)


class _NoopSpan:
    """The disabled-path span: one shared instance, nothing allocated."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOOP_SPAN = _NoopSpan()


class _Span:
    """An enabled span: records a complete ("X") event on exit."""

    __slots__ = ("_tracer", "_name", "_args", "_t0")

    def __init__(self, tracer: "Tracer", name: str, args: Optional[dict]):
        self._tracer = tracer
        self._name = name
        self._args = args
        self._t0 = time.perf_counter()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self._tracer.complete(
            self._name, self._t0, time.perf_counter(), self._args
        )
        return False


class Tracer:
    """Bounded-ring-buffer span recorder. ``capacity`` bounds memory: the
    buffer keeps the newest events and silently drops the oldest (a
    long-lived server must never grow without bound because someone left
    tracing on); ``dropped`` counts what fell off."""

    def __init__(self, capacity: int = 65536, enabled: bool = False):
        self._lock = threading.Lock()
        self._events: deque = deque(maxlen=capacity)
        self._recorded = 0
        self.enabled = bool(enabled)

    # -- lifecycle ---------------------------------------------------------
    def enable(self, capacity: Optional[int] = None) -> None:
        with self._lock:
            if capacity is not None and capacity != self._events.maxlen:
                self._events = deque(self._events, maxlen=capacity)
            self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def clear(self) -> None:
        with self._lock:
            self._events.clear()
            self._recorded = 0

    @property
    def capacity(self) -> int:
        return self._events.maxlen

    @property
    def dropped(self) -> int:
        with self._lock:
            return max(0, self._recorded - len(self._events))

    def __len__(self) -> int:
        return len(self._events)

    # -- recording ---------------------------------------------------------
    def _record(self, name: str, ph: str, t_s: float, dur_s: Optional[float],
                args: Optional[dict], span_id: Optional[str]) -> None:
        event = {
            "name": name,
            "ph": ph,
            "ts": (t_s + _EPOCH) * 1e6,
            "pid": _PID,
            "tid": threading.get_ident() & 0x7FFFFFFF,
        }
        if dur_s is not None:
            event["dur"] = dur_s * 1e6
        if span_id is not None:
            event["id"] = span_id
            event["cat"] = "flight"
        trace_id = _trace_ctx.get()
        if args or trace_id:
            merged = dict(args) if args else {}
            if trace_id and "trace_id" not in merged:
                merged["trace_id"] = trace_id
            event["args"] = merged
        with self._lock:
            self._events.append(event)
            self._recorded += 1

    def span(self, name: str, **args):
        """Context manager timing one interval. Hot paths should guard on
        ``tracer.enabled`` before building kwargs; this method's own
        disabled path returns the shared no-op span."""
        if not self.enabled:
            return _NOOP_SPAN
        return _Span(self, name, args or None)

    def complete(self, name: str, t0_s: float, t1_s: float,
                 args: Optional[dict] = None) -> None:
        """Record an already-measured interval (perf_counter seconds) —
        the zero-overhead form for code that takes its own timestamps."""
        if not self.enabled:
            return
        self._record(name, "X", t0_s, max(0.0, t1_s - t0_s), args, None)

    def instant(self, name: str, args: Optional[dict] = None) -> None:
        if not self.enabled:
            return
        self._record(name, "i", time.perf_counter(), None, args, None)

    def async_begin(self, name: str, span_id: str,
                    args: Optional[dict] = None) -> None:
        """Open an interval that a DIFFERENT thread will close (the
        batcher's dispatched flush). ``span_id`` pairs begin with end."""
        if not self.enabled:
            return
        self._record(name, "b", time.perf_counter(), None, args, span_id)

    def async_end(self, name: str, span_id: str,
                  args: Optional[dict] = None) -> None:
        if not self.enabled:
            return
        self._record(name, "e", time.perf_counter(), None, args, span_id)

    # -- export ------------------------------------------------------------
    def events(self) -> list:
        with self._lock:
            return list(self._events)

    def chrome_trace(self, metadata: Optional[dict] = None) -> dict:
        """The Chrome trace-event JSON object (Perfetto-loadable)."""
        body = {
            "traceEvents": self.events(),
            "displayTimeUnit": "ms",
        }
        meta = {"dropped_events": self.dropped}
        if metadata:
            meta.update(metadata)
        body["metadata"] = meta
        return body

    def dump(self, path: str, metadata: Optional[dict] = None) -> str:
        """Write the Chrome trace JSON to ``path`` (dirs created)."""
        directory = os.path.dirname(os.path.abspath(path))
        os.makedirs(directory, exist_ok=True)
        with open(path, "w") as fh:
            json.dump(self.chrome_trace(metadata), fh)
            fh.write("\n")
        return path


#: the process-wide tracer every subsystem records into. Disabled by
#: default; CLIs enable it behind --telemetry / GDT_TELEMETRY=trace.
TRACER = Tracer()


def get_tracer() -> Tracer:
    return TRACER


def configure_from_env(env: Optional[Dict[str, str]] = None) -> bool:
    """Enable the process tracer when ``GDT_TELEMETRY`` contains ``trace``
    (comma-separated feature list). Returns whether tracing is enabled."""
    value = (env or os.environ).get("GDT_TELEMETRY", "")
    if "trace" in [part.strip() for part in value.split(",")]:
        TRACER.enable()
    return TRACER.enabled
