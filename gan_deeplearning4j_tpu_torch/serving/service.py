"""InferenceService of the PyTorch port — counterpart of
``gan_deeplearning4j_tpu/serving/service.py``, with the same wire contract.

Two front ends share one code path (``handle``): the in-process Python API
and a stdlib-only HTTP JSON endpoint (``http.server.ThreadingHTTPServer``).
Endpoints:

- ``POST /v1/sample``    {"data": [[z...], ...]}  -> {"status","data"}
- ``POST /v1/sample?class=k``  base-z rows of a conditional bundle; the
  service appends the one-hot of class k, so the rows ride the same
  (kind, bucket) graphs
- ``POST /v1/classify``  {"data": [[x...], ...]}  -> {"status","data"}
- ``POST /v1/features``  {"data": [[x...], ...]}  -> {"status","data"}
- ``GET  /healthz``      liveness + loaded kinds + served bundle generation
  (+ the bundle's zoo scenario)
- ``GET  /metrics``      request counters, p50/p95/p99 latency, batch-
  occupancy histogram, shed counts, per-kind compile counts, generation;
  ``?format=prom`` switches to Prometheus text exposition;
  ``?scope=registry`` returns the raw registry snapshot with samples
- ``X-Trace-Id`` on ``POST`` requests propagates a correlation id
- ``POST /debug/trace?ms=N``  on-demand ``torch.profiler`` capture into
  the service's artifacts dir (``telemetry/device.py``) — 202 + the
  artifact path (async; ``block=1`` waits for 200), 409 while one runs
- ``POST /admin/reload``  force an immediate reload-plane poll (202;
  ``block=1`` waits for the cycle and answers 200; 409 while a reload is
  in progress or when no reload plane is attached)
- ``POST /admin/drain``   mark this worker draining (``off=1`` clears):
  ``/healthz`` reports ``"draining"`` while requests already in the
  pipeline still finalize; the worker itself sheds nothing
- ``GET  /debug/spans``  the span tracer's Chrome trace JSON

Shed responses map to HTTP 503 (overloaded / deadline), engine errors to
500, bad requests to 400, unknown kinds and routes to 404. ``?class=``
answers 400 on another kind, on an unconditional bundle, for a class that
is not an integer in ``[0, classes)`` and for rows that are not
latent-wide; a conditional bundle's bare latent-wide ``sample`` rows
without ``?class=`` answer 400, and its full-width rows (the caller's own
one-hot) are served. Statuses and messages are the JAX service's.
"""

from __future__ import annotations

import json
import logging
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple
from urllib.parse import parse_qs

import numpy as np

from gan_deeplearning4j_tpu_torch.serving.batcher import MicroBatcher, ServeResult
from gan_deeplearning4j_tpu_torch.serving.engine import ServingEngine
from gan_deeplearning4j_tpu_torch.telemetry.registry import get_registry
from gan_deeplearning4j_tpu_torch.telemetry.trace import (
    TRACER,
    bind_trace_id,
    new_trace_id,
    sanitize_trace_id,
    unbind_trace_id,
)

logger = logging.getLogger(__name__)

_STATUS_HTTP = {"ok": 200, "overloaded": 503, "deadline": 503, "error": 500}


class InferenceService:
    """The in-process serving API. One micro-batcher fronts the engine;
    every public call goes through it, so in-process and HTTP callers share
    batching, deadlines, backpressure, and the dispatch/finalize pipeline.

    ``warmup`` controls when the engine makes its first runs:
    ``True``/``"sync"`` blocks construction until warm; ``"eager"`` warms
    on a background thread while ``/healthz`` reports ``"warming"``;
    ``False`` leaves first runs to the first request per bucket (tests and
    tools only)."""

    def __init__(
        self,
        engine: ServingEngine,
        *,
        max_batch: Optional[int] = None,
        max_latency: float = 0.005,
        max_queue: int = 256,
        default_timeout: float = 5.0,
        warmup="sync",
        pipeline_depth: Optional[int] = None,
        artifacts_dir: Optional[str] = None,
    ):
        # where POST /debug/trace dumps device captures (resolved lazily so
        # constructing a service never touches the filesystem)
        self.artifacts_dir = artifacts_dir
        # the reload control plane (deploy.ReloadController), when attached:
        # owns POST /admin/reload and the /healthz "reload" block
        self.reloader = None
        # POST /admin/drain: advisory — the worker keeps answering, but
        # /healthz stops reporting "ok" while its pipeline empties
        self.draining = False
        if warmup in (True, "sync"):
            engine.warmup()
        elif warmup in ("eager", "background"):
            engine.warmup(background=True)
        elif warmup not in (False, None, "off"):
            raise ValueError(f"unknown warmup mode {warmup!r}")
        self.batcher = MicroBatcher(
            engine=engine,
            max_batch=max_batch or engine.buckets[-1],
            max_latency=max_latency,
            max_queue=max_queue,
            default_timeout=default_timeout,
            pipeline_depth=pipeline_depth,
        )

    @property
    def engine(self) -> ServingEngine:
        """The engine currently serving, read through the batcher's
        lock-guarded seam."""
        return self.batcher.engine

    def attach_reloader(self, controller) -> None:
        """Wire a ``deploy.ReloadController``: enables POST /admin/reload
        and the /healthz candidate-state block."""
        self.reloader = controller

    # -- typed convenience wrappers ----------------------------------------
    def sample(self, z, timeout: Optional[float] = None) -> ServeResult:
        return self.batcher.submit("sample", z, timeout=timeout)

    def classify(self, x, timeout: Optional[float] = None) -> ServeResult:
        return self.batcher.submit("classify", x, timeout=timeout)

    def features(self, x, timeout: Optional[float] = None) -> ServeResult:
        return self.batcher.submit("features", x, timeout=timeout)

    # -- shared request handler --------------------------------------------
    def healthz(self) -> dict:
        engine = self.engine
        if engine.warm_failed:
            status = "error"
        elif self.draining:
            status = "draining"
        elif engine.warming:
            status = "warming"
        else:
            status = "ok"
        body = {
            "status": status,
            "kinds": list(engine.kinds),
            "buckets": list(engine.buckets),
            "replicas": engine.replica_count,
            "generation": engine.generation,
            "platform": engine.platform,
        }
        if engine.scenario is not None:
            body["scenario"] = dict(engine.scenario)
        if self.reloader is not None:
            body["reload"] = self.reloader.status()
        if status == "error":
            body["error"] = "engine warmup failed"
        return body

    def metrics(self) -> dict:
        """The JSON ``/metrics`` payload (the JAX service's schema)."""
        engine = self.engine
        return {
            **self.batcher.metrics(),
            "generation": engine.generation,
            "draining": self.draining,
            "engine": engine.stats(),
            "compile_counts": engine.compile_counts,
        }

    def metrics_text(self) -> str:
        """Prometheus text exposition of the process-wide registry —
        ``GET /metrics?format=prom``."""
        return get_registry().to_prometheus()

    def _debug_trace(self, params: dict) -> Tuple[int, dict]:
        """POST /debug/trace?ms=N — one bounded ``torch.profiler`` capture,
        dumped under the artifacts dir. Asynchronous by default (202 + the
        directory the trace will land in); ``block=1`` waits and answers
        200 once the trace is on disk."""
        from gan_deeplearning4j_tpu_torch.telemetry import device as _device

        try:
            ms = int(params.get("ms", ["1000"])[0])
            if ms < 1 or ms > 60_000:
                raise ValueError(ms)
        except (TypeError, ValueError):
            return 400, {"status": "error",
                         "error": f"bad 'ms': {params.get('ms')!r} (want 1..60000)"}
        block = params.get("block", ["0"])[0] not in ("0", "", "false")
        artifacts = self.artifacts_dir or _device.default_artifacts_dir()
        # the profiler's first session must start on the main thread, or it
        # records no device activity: this request thread has the main
        # thread prime it (telemetry/device.py::request_prime)
        if not _device.request_prime():
            return 503, {"status": "error",
                         "error": "the profiler could not be primed on the main "
                                  "thread (make the server with make_server on "
                                  "the main thread)"}
        try:
            if block:
                path = _device.capture_device_trace(artifacts, duration_ms=ms)
                return 200, {"status": "ok", "artifact": path, "duration_ms": ms}
            _, path = _device.capture_async(artifacts, duration_ms=ms)
        except _device.CaptureBusy as exc:
            return 409, {"status": "error", "error": str(exc)}
        return 202, {"status": "accepted", "artifact": path, "duration_ms": ms}

    def _admin_reload(self, params: dict) -> Tuple[int, dict]:
        """POST /admin/reload — force an immediate reload-plane poll: 202 +
        the reload state by default, ``block=1`` waits for the triggered
        cycle and answers 200 with its outcome, 409 while a cycle is
        running or when no reload plane is attached."""
        if self.reloader is None:
            return 409, {"status": "error",
                         "error": "no reload plane attached (start the "
                                  "server with --reload-store)"}
        from gan_deeplearning4j_tpu_torch.deploy.reloader import ReloadBusy

        block = params.get("block", ["0"])[0] not in ("0", "", "false")
        try:
            status = self.reloader.poll_now(wait=block)
        except ReloadBusy as exc:
            return 409, {"status": "error", "error": str(exc)}
        if block:
            return 200, {"status": "ok", "reload": status}
        return 202, {"status": "accepted", "reload": status}

    def handle(self, method: str, path: str, payload: Optional[dict] = None,
               trace_id: Optional[str] = None) -> Tuple[int, dict]:
        """(http_status, response_body) for one request — the routing table
        both front ends use. ``trace_id`` is a propagated correlation id
        (``X-Trace-Id``), adopted when valid."""
        path, _, query = path.partition("?")
        params = parse_qs(query) if query else {}
        if method == "GET" and path == "/healthz":
            return 200, self.healthz()
        if method == "GET" and path == "/metrics":
            if params.get("scope", [""])[0] == "registry":
                return 200, get_registry().snapshot(include_samples=True)
            return 200, self.metrics()
        if method == "GET" and path == "/debug/spans":
            return 200, TRACER.chrome_trace(
                {"source": "gan_deeplearning4j_tpu_torch.serving"})
        if method == "POST" and path == "/debug/trace":
            return self._debug_trace(params)
        if method == "POST" and path == "/admin/reload":
            return self._admin_reload(params)
        if method == "POST" and path == "/admin/drain":
            self.draining = params.get("off", ["0"])[0] in ("0", "", "false")
            return 200, {"status": "ok", "draining": self.draining}
        if method == "POST" and path.startswith("/v1/"):
            kind = path[len("/v1/"):]
            engine = self.engine  # one snapshot for the whole request
            if kind not in engine.kinds:
                return 404, {"status": "error",
                             "error": f"unknown request kind {kind!r}"}
            data = (payload or {}).get("data")
            if data is None:
                return 400, {"status": "error", "error": "missing 'data'"}
            try:
                rows = np.asarray(data, dtype=np.float32)
            except (TypeError, ValueError) as exc:
                return 400, {"status": "error", "error": f"bad 'data': {exc}"}
            if rows.ndim == 1:
                rows = rows[None, :]
            # sample?class=k takes base-z rows and appends the one-hot
            # here, so the widened rows go through the width check, the
            # batcher and the bucket graphs unchanged
            cls_param = params.get("class", [None])[0]
            if cls_param is not None:
                if kind != "sample":
                    return 400, {"status": "error",
                                 "error": f"?class= applies to the sample "
                                          f"kind, not {kind!r}"}
                if not engine.conditional:
                    return 400, {"status": "error",
                                 "error": "this bundle is unconditional — "
                                          "its manifest declares no class "
                                          "conditioning"}
                try:
                    label = int(cls_param)
                except ValueError:
                    return 400, {"status": "error",
                                 "error": f"bad 'class': {cls_param!r}"}
                if not 0 <= label < engine.class_count:
                    return 400, {
                        "status": "error",
                        "error": f"class {label} out of range "
                                 f"[0, {engine.class_count})",
                    }
                latent = engine.latent_width(kind)
                if rows.ndim != 2 or rows.shape[0] < 1 or rows.shape[1] != latent:
                    return 400, {
                        "status": "error",
                        "error": f"{kind}?class={label}: expected "
                                 f"(n >= 1, {latent}) latent rows, "
                                 f"got {tuple(rows.shape)}",
                    }
                onehot = np.zeros((rows.shape[0], engine.class_count), dtype=np.float32)
                onehot[:, label] = 1.0
                rows = np.concatenate([rows, onehot], axis=1)
            elif kind == "sample" and engine.conditional:
                # full-width rows (the caller's own one-hot) are served; a
                # bare latent-wide row without ?class= is a caller error
                if rows.ndim == 2 and rows.shape[1] == engine.latent_width(kind):
                    return 400, {
                        "status": "error",
                        "error": f"sample: got {rows.shape[1]}-wide latent "
                                 f"rows without ?class=k — pass ?class= or "
                                 f"supply full {engine.input_width(kind)}-"
                                 f"wide rows with the embedding",
                    }
            width = engine.input_width(kind)
            # reject malformed shapes HERE: a bad row must 400 its own
            # request, never reach the shared batch and error its riders
            if rows.ndim != 2 or rows.shape[0] < 1 or rows.shape[1] != width:
                return 400, {
                    "status": "error",
                    "error": f"{kind}: expected (n >= 1, {width}) rows, "
                             f"got {tuple(rows.shape)}",
                }
            timeout = (payload or {}).get("timeout")
            if timeout is not None:
                try:
                    timeout = float(timeout)
                except (TypeError, ValueError):
                    return 400, {"status": "error",
                                 "error": f"bad 'timeout': {timeout!r}"}
            if TRACER.enabled:
                token = bind_trace_id(
                    sanitize_trace_id(trace_id) or new_trace_id())
                try:
                    with TRACER.span("serve.request", kind=kind,
                                     rows=int(rows.shape[0])):
                        result = self.batcher.submit(
                            kind, rows, timeout=timeout)
                finally:
                    unbind_trace_id(token)
            else:
                result = self.batcher.submit(kind, rows, timeout=timeout)
            body = {"status": result.status,
                    "latency_ms": result.latency_s * 1e3}
            if result.ok:
                body["data"] = np.asarray(result.data).tolist()
            elif result.error:
                body["error"] = result.error
            return _STATUS_HTTP.get(result.status, 500), body
        return 404, {"status": "error", "error": f"no route {method} {path}"}

    def close(self) -> None:
        self.batcher.close()


# -- HTTP front end ---------------------------------------------------------

class _Handler(BaseHTTPRequestHandler):
    service: InferenceService = None  # bound by make_server

    def _respond(self, status: int, body: dict) -> None:
        data = json.dumps(body).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):  # noqa: N802 (http.server naming contract)
        try:
            route, _, query = self.path.partition("?")
            if (route == "/metrics"
                    and "prom" in parse_qs(query).get("format", [])):
                # the one non-JSON body: Prometheus text exposition
                data = self.service.metrics_text().encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4; charset=utf-8")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
                return
            status, body = self.service.handle("GET", self.path)
        except Exception as exc:  # a handler bug must answer 500, not reset
            logger.exception("GET %s failed", self.path)
            status, body = 500, {"status": "error",
                                 "error": f"{type(exc).__name__}: {exc}"}
        self._respond(status, body)

    def do_POST(self):  # noqa: N802
        try:
            length = int(self.headers.get("Content-Length") or 0)
            payload = json.loads(self.rfile.read(length) or b"{}")
        except (ValueError, json.JSONDecodeError) as exc:
            self._respond(400, {"status": "error", "error": f"bad JSON: {exc}"})
            return
        try:
            # the propagation header (docs/OBSERVABILITY.md): adopt the
            # router's/client's correlation id into this request's spans
            status, body = self.service.handle(
                "POST", self.path, payload,
                trace_id=self.headers.get("X-Trace-Id"))
        except Exception as exc:
            logger.exception("POST %s failed", self.path)
            status, body = 500, {"status": "error",
                                 "error": f"{type(exc).__name__}: {exc}"}
        self._respond(status, body)

    def log_message(self, fmt, *args):  # route to logging, not stderr
        logger.debug("%s - %s", self.address_string(), fmt % args)


def make_server(service: InferenceService, host: str = "127.0.0.1",
                port: int = 8000) -> ThreadingHTTPServer:
    """Bind (but do not start) the HTTP front end; ``port=0`` picks a free
    port (tests). Call ``serve_forever()`` or drive it from a thread."""
    from gan_deeplearning4j_tpu_torch.telemetry import device as _device

    # so that POST /debug/trace, served on a request thread, can have the
    # main thread prime the profiler (installs nothing off the main thread)
    _device.install_prime_handler()
    handler = type("BoundHandler", (_Handler,), {"service": service})
    return ThreadingHTTPServer((host, port), handler)


def serve_forever(service: InferenceService, host: str, port: int) -> None:
    server = make_server(service, host, port)
    logger.info("serving on http://%s:%d (kinds: %s)", host,
                server.server_address[1], ",".join(service.engine.kinds))
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        service.close()
