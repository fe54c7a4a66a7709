"""Dynamic micro-batcher — the serving throughput lever (μ-cuDNN-style).

Single-request dispatch wastes an accelerator: a batch-1 forward pays the
same dispatch latency as batch-128 for ~1% of the useful work. This module
coalesces concurrent requests of the same kind into one device batch under
two triggers — a full batch (``max_batch`` rows) or the oldest request
aging past ``max_latency`` — the classic throughput/latency trade of
server-side batching (*TensorFlow: a system for large-scale ML*, §4.3).

Execution is a TWO-STAGE PIPELINE (the continuous-batching shape of the
serving literature — Orca-style iteration-level scheduling in PAPERS.md):
a worker thread cuts a batch and *dispatches* it (host staging + async
device launch via ``engine.dispatch``), and completer threads *finalize*
it (block on the device, scatter rows back to callers). Because the
engine's dispatch only enqueues work on a CUDA stream, host assembly of
batch N+1 overlaps device execution of batch N. The in-flight window is bounded
(``pipeline_depth``): the worker will not cut a new batch while the window
is full, so requests keep queueing — which deepens coalescing exactly when
the device is the bottleneck — and device work is never launched for more
flushes than the window allows. With ``pipeline_depth=1`` the pipeline
degenerates to strictly serial flushes (the pre-pipeline behavior); that
is the default for plain ``run_fn`` engines, which have no async seam.

Completion runs in PER-REPLICA LANES: a multi-replica engine gets one
completer thread per replica, and every dispatched flush lands in the lane
of the replica it was routed to (``handle.lane``, stamped by the engine's
dispatch). Finalize order is preserved *within* a lane — the device
executes a replica's flushes in dispatch order, so lane order is the only
order that matters — but one replica's slow finalize no longer
head-of-line blocks another replica's already-finished flush behind it in
a global queue. A handle without a lane (run_fn mode, fakes) rides lane 0,
which with a single-replica engine reproduces the old single-completer
behavior exactly.

Backpressure is explicit, not emergent: the queue is bounded, and a submit
against a full queue returns an ``overloaded`` result IMMEDIATELY instead
of blocking or growing the queue without bound — under overload a serving
tier must shed load in O(1), because every queued request it cannot serve
within its deadline is work thrown away *after* paying for it. Requests
that expire while queued are likewise shed with ``deadline`` before any
device work is spent on them.

The batching policy itself stays engine-agnostic: pass ``run_fn`` for any
synchronous ``(kind, rows) -> rows`` callable (unit tests use fakes), or
``engine=`` for an object with the async ``dispatch(kind, rows_list)`` /
``finalize(handle)`` pair (``ServingEngine``, or a fake in the pipelining
tests).

Engine-mode batchers additionally expose the ZERO-DOWNTIME SWAP SEAM the
reload plane (``deploy/``, docs/DEPLOY.md) drives: :meth:`swap_engine`
atomically reroutes future flushes under the batcher lock, every cut
flush carries its dispatching engine on the flight record (in-flight work
finalizes on the OLD engine), and :meth:`flights_on` is the retirement
signal. All access to the swappable engine attribute goes through the
lock.

Observability (docs/OBSERVABILITY.md): counters/gauges and THE latency
histogram live in the process-wide telemetry registry (the per-instance
ints remain for the instance-scoped ``metrics()`` JSON), and with tracing
enabled every request leaves a correlated span chain — submit → cut →
dispatch → flight(b/e) → finalize → scatter — whose trace id is carried
on the request object across the worker/completer thread handoffs. With
tracing disabled (the default) the hot path takes one ``TRACER.enabled``
attribute read and allocates nothing.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import defaultdict, deque
from typing import Callable, Dict, Optional

import numpy as np

from gan_deeplearning4j_tpu_torch.telemetry.registry import get_registry
from gan_deeplearning4j_tpu_torch.telemetry.trace import (
    TRACER,
    current_trace_id,
    new_trace_id,
)
from gan_deeplearning4j_tpu_torch.utils.profiling import StageStats

#: pipeline stage names — the /metrics and serve_bench breakdown schema
STAGES = ("assemble", "device", "complete")


class _KindChildren:
    """Per-kind registry series resolved once and cached in a plain dict —
    the hot path does one dict lookup per update, never a labels() parse
    (and never allocates a new series after the first request of a kind)."""

    __slots__ = ("_family", "_fixed", "_cache")

    def __init__(self, family, **fixed):
        self._family = family
        self._fixed = fixed
        self._cache: Dict[str, object] = {}

    def __call__(self, kind: str):
        child = self._cache.get(kind)
        if child is None:
            child = self._family.labels(kind=kind, **self._fixed)
            self._cache[kind] = child
        return child


@dataclasses.dataclass
class ServeResult:
    """Outcome of one request. ``status`` is always one of:

    - ``ok``          — ``data`` holds the result rows;
    - ``overloaded``  — shed at submit time, queue full (backpressure);
    - ``deadline``    — expired while queued, never ran;
    - ``error``       — the engine raised; ``error`` holds the message.

    Every submitted request gets exactly one ServeResult — the zero-lost
    invariant the bench asserts."""

    status: str
    data: Optional[np.ndarray] = None
    error: Optional[str] = None
    latency_s: float = 0.0

    @property
    def ok(self) -> bool:
        return self.status == "ok"


@dataclasses.dataclass
class _Pending:
    kind: str
    rows: np.ndarray
    deadline: float
    enqueued: float
    event: threading.Event
    result: Optional[ServeResult] = None
    # correlation id carried ACROSS the pipeline's threads explicitly (a
    # contextvar would die at the worker handoff); None while tracing is off
    trace_id: Optional[str] = None

    def finish(self, result: ServeResult) -> None:
        result.latency_s = time.monotonic() - self.enqueued
        self.result = result
        self.event.set()


class _Inflight:
    """One dispatched flush traveling from worker to completer.

    ``engine`` is the engine that DISPATCHED this flush, pinned at cut
    time: after :meth:`MicroBatcher.swap_engine` an in-flight handle must
    finalize on the engine whose staging buffers and replica ledger it
    holds — finalizing it on the new engine would recycle foreign buffers
    and release phantom in-flight reservations."""

    __slots__ = ("riders", "handle", "total_rows", "flight_id", "engine")

    def __init__(self, riders, handle, total_rows, flight_id=None,
                 engine=None):
        self.riders = riders
        self.handle = handle
        self.total_rows = total_rows
        self.flight_id = flight_id  # async-span id; None while tracing is off
        self.engine = engine  # dispatching engine; None in run_fn mode


class MicroBatcher:
    """Queue-based micro-batcher over an engine or ``run_fn``.

    The worker thread drains a bounded FIFO: it picks the oldest request's
    kind, coalesces every queued request of that kind (submission order,
    up to ``max_batch`` rows), waits out the remainder of ``max_latency``
    (measured from the oldest request) for stragglers when the batch is
    not yet full — and only cuts a batch when the in-flight window has a
    free slot. Dispatched flushes are finalized by per-replica completer
    lanes, in dispatch order within each lane. ``close()`` drains what is
    queued, then stops every thread."""

    def __init__(
        self,
        run_fn: Optional[Callable[[str, np.ndarray], np.ndarray]] = None,
        *,
        engine=None,
        max_batch: int = 128,
        max_latency: float = 0.005,
        max_queue: int = 256,
        default_timeout: float = 5.0,
        max_samples: int = 65536,
        pipeline_depth: Optional[int] = None,
        size_histogram=None,
    ):
        if (run_fn is None) == (engine is None):
            raise ValueError("pass exactly one of run_fn or engine")
        if max_batch < 1 or max_queue < 1:
            raise ValueError("max_batch and max_queue must be >= 1")
        self._run_fn = run_fn
        self._engine = engine
        if pipeline_depth is None:
            # an async engine says how deep its device pipe usefully runs
            # (ServingEngine: 2/replica on accelerators, 1/replica on CPU);
            # a synchronous run_fn has no async seam to overlap
            pipeline_depth = (
                getattr(engine, "default_pipeline_depth", None)
                or 2 * getattr(engine, "replica_count", 1)
            ) if engine else 1
        if pipeline_depth < 1:
            raise ValueError("pipeline_depth must be >= 1")
        self.pipeline_depth = pipeline_depth
        self.max_batch = max_batch
        self.max_latency = max_latency
        self.max_queue = max_queue
        self.default_timeout = default_timeout
        # flush-size histogram (serving/ladder.py): recorded per ASSEMBLED
        # flush in the worker loop — the engine pads coalesced batches,
        # not individual submits, so the ladder solver must see post-
        # coalescing sizes (a ladder solved from submit sizes measurably
        # REGRESSES under concurrency: multi-request flushes land in the
        # gaps between learned buckets). Exported via metrics(), read by
        # the reload plane to solve the next generation's bucket ladder.
        # Injectable so the mux plane can hand each variant ITS OWN
        # histogram object that survives demote/promote cycles; a
        # swap_engine keeps this same batcher, so singleton reloads carry
        # it automatically.
        if size_histogram is None:
            from gan_deeplearning4j_tpu_torch.serving.ladder import SizeHistogram

            size_histogram = SizeHistogram()
        self.size_histogram = size_histogram

        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._queue: deque = deque()
        # completion lanes: one in-flight deque + completer thread per
        # replica of the INITIAL engine (run_fn mode: one lane). A swap to
        # an engine with more replicas folds extra replicas onto the
        # existing lanes (modulo) — correct, just less parallel.
        if engine is not None:
            lane_count = max(1, int(getattr(engine, "replica_count", 1) or 1))
        else:
            lane_count = 1
        self._lane_count = lane_count
        self._lanes = [deque() for _ in range(lane_count)]
        self._window_used = 0  # cut-or-dispatched flushes not yet completed
        self._closed = False
        self._worker_done = False
        self._swaps = 0
        # the flush the worker/completers are currently working OUTSIDE the
        # lock, attributed to its engine — with the lane queues these make
        # flights_on() exact, which is what engine retirement waits on
        self._dispatching_on = None
        self._finalizing_on = [None] * lane_count

        # -- counters (read under the lock; exported by metrics()) ----------
        self._submitted: Dict[str, int] = defaultdict(int)
        self._completed: Dict[str, int] = defaultdict(int)
        self._shed_overloaded = 0
        self._shed_deadline = 0
        self._errors = 0
        self._flushes = 0
        self._occupancy: Dict[int, int] = defaultdict(int)  # rows/flush -> n
        # -- telemetry registry series (docs/OBSERVABILITY.md catalogue).
        # The ints above stay per-batcher (the JSON metrics() contract is
        # instance-scoped); the registry series are the process-wide view a
        # scraper reads. Latency SAMPLES live only in the registry
        # histogram — the one stream metrics(), Prometheus, and serve_bench
        # all quote (no separate client-side collection anywhere).
        registry = get_registry()
        requests_total = registry.counter(
            "serve_requests_total", "request outcomes",
            labelnames=("kind", "status"),
        )
        self._c_request = {
            status: _KindChildren(requests_total, status=status)
            for status in ("ok", "overloaded", "deadline", "error")
        }
        self._c_latency = _KindChildren(registry.histogram(
            "serve_request_latency_seconds",
            "submit-to-result latency per request kind",
            labelnames=("kind",), max_samples=max_samples,
        ))
        self._c_flushes = registry.counter(
            "serve_flushes_total", "device flushes cut by the batcher")
        self._c_swaps = registry.counter(
            "serve_engine_swaps_total",
            "zero-downtime engine swaps performed by the batcher")
        self._c_flush_rows = registry.histogram(
            "serve_flush_rows", "rows per flush (batch occupancy)",
            max_samples=max_samples,
        )
        self._g_queue = registry.gauge(
            "serve_queue_depth", "requests waiting in the batcher queue")
        self._stages = StageStats(STAGES, max_samples=max_samples)

        self._worker = threading.Thread(
            target=self._worker_loop, name="micro-batcher", daemon=True
        )
        self._completers = [
            threading.Thread(
                target=self._completer_loop, args=(i,),
                name=f"micro-batcher-complete-{i}", daemon=True,
            )
            for i in range(lane_count)
        ]
        self._worker.start()
        for t in self._completers:
            t.start()

    # -- client side --------------------------------------------------------
    def submit(
        self, kind: str, rows: np.ndarray, timeout: Optional[float] = None
    ) -> ServeResult:
        """Block until the request completes or is shed. Bounded wait: the
        caller is back within ``timeout`` (+ scheduling noise) in EVERY
        case — full queue, expired deadline, engine error, or success."""
        timeout = self.default_timeout if timeout is None else timeout
        rows = np.asarray(rows)
        if rows.ndim != 2 or rows.shape[0] < 1:
            return ServeResult("error", error=f"expected (n, d) rows, got {rows.shape}")
        now = time.monotonic()
        req = _Pending(
            kind=kind,
            rows=rows,
            deadline=now + timeout,
            enqueued=now,
            event=threading.Event(),
        )
        if TRACER.enabled:
            # correlation id: reuse the caller's bound id (HTTP front end)
            # or mint one; it rides the request object through both
            # pipeline threads
            req.trace_id = current_trace_id() or new_trace_id()
            TRACER.instant("serve.batcher.submit", {
                "kind": kind, "rows": int(rows.shape[0]),
                "trace_id": req.trace_id,
            })
        with self._lock:
            self._submitted[kind] += 1
            if self._closed:
                self._shed_overloaded += 1
                self._c_request["overloaded"](kind).inc()
                return ServeResult("overloaded", error="batcher is closed")
            if len(self._queue) >= self.max_queue:
                # backpressure: shed NOW, in O(1) — never queue what cannot
                # be served, never block the client on a full queue
                self._shed_overloaded += 1
                self._c_request["overloaded"](kind).inc()
                return ServeResult("overloaded", error="queue full")
            self._queue.append(req)
            self._g_queue.set(len(self._queue))
            self._cv.notify_all()
        # the worker sheds expired requests, so this wait is bounded; the
        # grace covers flushes already in flight at deadline time — up to
        # pipeline_depth of them can sit ahead of this request's flush
        req.event.wait(timeout + self.max_latency + 1.0 * self.pipeline_depth)
        if req.result is None:  # worker wedged (engine hung) — still bounded
            return ServeResult("deadline", error="no result within deadline")
        return req.result

    def close(self, drain: bool = True) -> None:
        with self._lock:
            self._closed = True
            if not drain:
                while self._queue:
                    self._shed_overloaded += 1  # keep the zero-lost ledger
                    req = self._queue.popleft()
                    self._c_request["overloaded"](req.kind).inc()
                    req.finish(
                        ServeResult("overloaded", error="batcher is closed")
                    )
                self._g_queue.set(0)
            self._cv.notify_all()
        self._worker.join(timeout=10.0)
        for t in self._completers:
            t.join(timeout=10.0)

    @property
    def queue_depth(self) -> int:
        """Requests waiting in the queue right now — the cheap pressure
        signal (the mux brownout controller polls it every tick;
        ``metrics()`` would rebuild percentiles per poll)."""
        with self._lock:
            return len(self._queue)

    # -- the engine-swap seam (deploy/ reload plane) ------------------------
    @property
    def engine(self):
        """The engine NEW flushes dispatch on (None in run_fn mode). This
        lock-guarded accessor — and :meth:`swap_engine` — are the only
        places the swappable attribute may be touched."""
        with self._lock:
            return self._engine

    def swap_engine(self, engine):
        """Atomically route all FUTURE flushes to ``engine``; returns the
        previous engine. Zero-downtime by construction: flushes already
        cut or in flight carry their dispatching engine on the
        :class:`_Inflight` record and finalize on it, new cuts snapshot
        the new engine under the same lock that cuts the batch, and
        nothing is shed or drained in between. The caller retires the old
        engine once :meth:`flights_on` reports it drained."""
        if engine is None:
            raise ValueError("swap_engine needs an engine")
        if self._run_fn is not None:
            raise ValueError(
                "swap_engine requires an engine-mode batcher (run_fn mode "
                "has no engine to swap)")
        with self._lock:
            old, self._engine = self._engine, engine
            self._swaps += 1
            self._cv.notify_all()
        self._c_swaps.inc()
        return old

    def flights_on(self, engine) -> int:
        """Flushes currently owned by ``engine`` anywhere in the pipeline:
        queued between worker and completer, being dispatched, or being
        finalized. Zero means the engine's last flight has fully drained —
        the retirement condition after a swap."""
        with self._lock:
            n = sum(1 for lane in self._lanes
                    for ent in lane if ent.engine is engine)
            if self._dispatching_on is engine:
                n += 1
            n += sum(1 for fin in self._finalizing_on if fin is engine)
            return n

    # -- worker side --------------------------------------------------------
    def _take_batch(self):
        """Under the lock: wait for work AND a free in-flight slot, pick
        the oldest request's kind, and cut a same-kind batch (≤ max_batch
        rows, submission order). Reserves a window slot for the batch it
        returns."""
        while True:
            while ((not self._queue or self._window_used >= self.pipeline_depth)
                   and not self._closed):
                self._cv.wait()
            if not self._queue:
                return None  # closed and drained
            if self._window_used >= self.pipeline_depth:
                if self._closed:
                    # still drain on close — wait for the window to free up
                    self._cv.wait()
                continue
            oldest = self._queue[0]
            cut_kind = oldest.kind
            # not full yet: give stragglers a chance. Two regimes (the
            # continuous-batching policy): while the device already has
            # work in flight, a partial flush would only queue behind it —
            # hold for fullness instead (each completion re-wakes this
            # wait), but a FULL batch of ANY kind always cuts immediately
            # (it must not stall behind a partial oldest while window
            # slots sit free); once the device is hungry, wait out at most
            # the remainder of max_latency and then feed it whatever is
            # here. max_latency == 0 disables all batching delay, as
            # before.
            now = time.monotonic()
            age = now - oldest.enqueued
            if self.max_latency > 0 and not self._closed:
                kind_rows: Dict[str, int] = defaultdict(int)
                for r in self._queue:
                    kind_rows[r.kind] += r.rows.shape[0]
                if kind_rows[oldest.kind] < self.max_batch:
                    # fairness bound: once the oldest has burned half its
                    # deadline budget queued, its kind cuts NOW — neither
                    # a full batch of another kind nor a busy device may
                    # starve it further (sustained full-batch load would
                    # otherwise hold a sparse kind's partial forever)
                    overdue = age >= 0.5 * (oldest.deadline - oldest.enqueued)
                    if not overdue:
                        full = next((k for k, n in kind_rows.items()
                                     if n >= self.max_batch), None)
                        if full is not None:
                            cut_kind = full
                        elif self._window_used > 0:
                            # device fed: hold for fullness — but shed
                            # already-expired requests in place, so a hold
                            # can never pin dead entries in queue slots
                            if self._shed_expired():
                                continue
                            self._cv.wait(timeout=self.max_latency)
                            continue
                        elif age < self.max_latency:
                            self._cv.wait(timeout=self.max_latency - age)
                            continue
            if oldest.rows.shape[0] > self.max_batch:
                # a rider larger than max_batch can never coalesce: cut it
                # ALONE, now (the engine chunks it through the top bucket).
                # Skipping it for younger fitting riders would starve it
                # forever under sustained same-kind traffic.
                self._queue.popleft()
                self._g_queue.set(len(self._queue))
                self._window_used += 1
                return [oldest]
            batch, keep, total = [], deque(), 0
            for req in self._queue:
                if req.kind == cut_kind and total + req.rows.shape[0] <= self.max_batch:
                    batch.append(req)
                    total += req.rows.shape[0]
                else:
                    keep.append(req)
            if not batch:
                # cut_kind's first rider alone exceeds max_batch: cut THAT
                # rider by itself (the engine chunks it) rather than
                # falling back to the held partial oldest of another kind
                target = (oldest if cut_kind == oldest.kind else
                          next(r for r in self._queue if r.kind == cut_kind))
                batch.append(target)
                keep = deque(r for r in self._queue if r is not target)
            self._queue = keep
            self._g_queue.set(len(self._queue))
            self._window_used += 1
            return batch

    def _shed_expired(self) -> bool:
        """Under the lock: finish + remove queued requests already past
        their deadline (no device work was spent on them). True when
        anything was shed — the caller re-examines the queue."""
        now = time.monotonic()
        if not any(now > r.deadline for r in self._queue):
            return False
        keep: deque = deque()
        for req in self._queue:
            if now > req.deadline:
                self._shed_deadline += 1
                self._c_request["deadline"](req.kind).inc()
                req.finish(
                    ServeResult("deadline", error="expired while queued")
                )
            else:
                keep.append(req)
        self._queue = keep
        self._g_queue.set(len(self._queue))
        return True

    def _release_slot(self) -> None:
        with self._lock:
            self._window_used -= 1
            self._cv.notify_all()

    def _dispatch(self, engine, kind: str, rows_list):
        """Stage-A half of one flush, on the engine snapshotted AT CUT
        TIME (the swap seam: the live attribute is only read under the
        lock). For an async engine this stages, transfers, and launches
        without waiting; for a plain run_fn the handle defers ALL work to
        finalize (stage B), keeping the worker free to keep cutting
        batches."""
        if engine is not None:
            return engine.dispatch(kind, rows_list)
        return (kind, rows_list)

    def _finalize(self, engine, handle) -> np.ndarray:
        if engine is not None:
            return np.asarray(engine.finalize(handle))
        kind, rows_list = handle
        # the concatenate stays INSIDE the stage-B guard: a width-mismatched
        # rider must error its own batch, not kill the completer thread
        rows = rows_list[0] if len(rows_list) == 1 else np.concatenate(rows_list)
        return np.asarray(self._run_fn(kind, rows))

    def _worker_loop(self) -> None:
        try:
            while True:
                with self._lock:
                    batch = self._take_batch()
                    # snapshot the engine in the SAME critical section that
                    # cut the batch: a swap is atomic with respect to cuts,
                    # so every flush belongs to exactly one engine
                    engine = self._engine
                    if batch is not None:
                        self._dispatching_on = engine
                if batch is None:
                    return
                now = time.monotonic()
                live = []
                for req in batch:
                    if now > req.deadline:
                        with self._lock:
                            self._shed_deadline += 1
                        self._c_request["deadline"](req.kind).inc()
                        req.finish(
                            ServeResult("deadline", error="expired while queued")
                        )
                    else:
                        live.append(req)
                if not live:
                    with self._lock:
                        self._dispatching_on = None
                    self._release_slot()
                    continue
                flight_id = None
                if TRACER.enabled:
                    flight_id = new_trace_id()
                    TRACER.instant("serve.batcher.cut", {
                        "kind": live[0].kind, "flight": flight_id,
                        "riders": [r.trace_id for r in live],
                    })
                t0 = time.perf_counter()
                try:
                    handle = self._dispatch(
                        engine, live[0].kind, [r.rows for r in live]
                    )
                except Exception as exc:  # dispatch failure -> riders error
                    with self._lock:
                        self._errors += len(live)
                        self._dispatching_on = None
                    for req in live:
                        self._c_request["error"](req.kind).inc()
                        req.finish(ServeResult(
                            "error", error=f"{type(exc).__name__}: {exc}"))
                    self._release_slot()
                    continue
                total = sum(r.rows.shape[0] for r in live)
                # what the engine just padded: the ASSEMBLED flush, not
                # the individual submits — the ladder learner's only
                # footprint, one bounded dict increment per flush
                # (serving/ladder.py)
                self.size_histogram.record(live[0].kind, total)
                # lane = the replica this flush was routed to (stamped by
                # the engine's dispatch); run_fn handles and fakes without
                # one ride lane 0. Modulo guards a swap to a wider engine.
                # Computed BEFORE the flight span opens: nothing that can
                # raise sits between async_begin and the lane append, so
                # the span cannot be stranded open with riders unfinished.
                lane = getattr(handle, "lane", None)
                lane = 0 if lane is None else int(lane) % self._lane_count
                if flight_id is not None:
                    TRACER.complete(
                        "serve.batcher.dispatch", t0, time.perf_counter(),
                        {"kind": live[0].kind, "flight": flight_id,
                         "rows": total,
                         "riders": [r.trace_id for r in live]})
                    TRACER.async_begin("serve.flight", flight_id,
                                       {"kind": live[0].kind, "rows": total})
                with self._lock:
                    # append FIRST: once the entry is in the lane the
                    # completer owns the flight span, so a raise in the
                    # stats call below cannot strand it open
                    self._lanes[lane].append(
                        _Inflight(live, handle, total, flight_id, engine))
                    self._stages.add("assemble", time.perf_counter() - t0)
                    self._dispatching_on = None
                    self._cv.notify_all()
        finally:
            with self._lock:
                self._worker_done = True
                self._cv.notify_all()

    def _completer_loop(self, lane_idx: int) -> None:
        lane = self._lanes[lane_idx]
        while True:
            with self._lock:
                while not lane and not self._worker_done:
                    self._cv.wait()
                if not lane:
                    return  # worker exited and this lane is finalized
                ent = lane.popleft()
                self._finalizing_on[lane_idx] = ent.engine
            t0 = time.perf_counter()
            try:
                # finalize on the engine that DISPATCHED this flush — after
                # a swap the old engine's in-flight work still lands here
                out = self._finalize(ent.engine, ent.handle)
            except Exception as exc:  # engine failure -> every rider errors
                if ent.flight_id is not None:
                    TRACER.async_end("serve.flight", ent.flight_id,
                                     {"status": "error"})
                with self._lock:
                    self._errors += len(ent.riders)
                    self._finalizing_on[lane_idx] = None
                for req in ent.riders:
                    self._c_request["error"](req.kind).inc()
                    req.finish(ServeResult(
                        "error", error=f"{type(exc).__name__}: {exc}"))
                self._release_slot()
                continue
            t1 = time.perf_counter()
            offset = 0
            for req in ent.riders:
                n = req.rows.shape[0]
                req.finish(ServeResult("ok", data=out[offset:offset + n]))
                offset += n
            t2 = time.perf_counter()
            if ent.flight_id is not None:
                kind = ent.riders[0].kind
                TRACER.complete("serve.batcher.finalize", t0, t1,
                                {"kind": kind, "flight": ent.flight_id})
                TRACER.complete(
                    "serve.batcher.scatter", t1, t2,
                    {"kind": kind, "flight": ent.flight_id,
                     "riders": [r.trace_id for r in ent.riders]})
                TRACER.async_end("serve.flight", ent.flight_id,
                                 {"status": "ok"})
            with self._lock:
                self._finalizing_on[lane_idx] = None
                self._stages.add("device", t1 - t0)
                self._stages.add("complete", t2 - t1)
                self._flushes += 1
                self._c_flushes.inc()
                self._occupancy[ent.total_rows] += 1
                self._c_flush_rows.observe(ent.total_rows)
                for req in ent.riders:
                    self._completed[req.kind] += 1
                    self._c_request["ok"](req.kind).inc()
                    self._c_latency(req.kind).observe(req.result.latency_s)
            self._release_slot()

    # -- observability ------------------------------------------------------
    def metrics(self) -> dict:
        """Counter snapshot + latency percentiles + occupancy histogram +
        per-stage pipeline breakdown — the /metrics payload schema
        (docs/SERVING.md)."""
        # latency percentiles come from the ONE registry histogram stream
        # (serve_request_latency_seconds) — the same numbers a Prometheus
        # scrape and a serve_bench artifact quote. list() snapshots the
        # child cache in one GIL-atomic step: the pipeline threads insert a
        # kind's child concurrently with a scrape, and iterating the live
        # dict would raise mid-resize
        lat = {
            kind: {
                k: v * 1e3 for k, v in child.percentiles().items()
            }
            for kind, child in list(self._c_latency._cache.items())
        }
        with self._lock:
            return {
                "submitted": dict(self._submitted),
                "completed": dict(self._completed),
                "shed_overloaded": self._shed_overloaded,
                "shed_deadline": self._shed_deadline,
                "errors": self._errors,
                "flushes": self._flushes,
                "engine_swaps": self._swaps,
                "queue_depth": len(self._queue),
                "batch_occupancy": {str(k): v for k, v in sorted(self._occupancy.items())},
                "flush_sizes": self.size_histogram.stats(),
                "latency_ms": lat,
                "pipeline": {
                    "depth": self.pipeline_depth,
                    "in_flight": self._window_used,
                    "lanes": self._lane_count,
                    "mode": "engine" if self._engine is not None else "run_fn",
                    "stage_ms": self._stages.summary_ms(),
                    "stage_occupancy": self._stages.occupancy(),
                },
            }
