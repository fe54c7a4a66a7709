"""ServingEngine of the PyTorch port — counterpart of
``gan_deeplearning4j_tpu/serving/engine.py``: checkpoint-backed executor
with a padded bucket ladder, on the card unless the caller asks for the CPU.

Loads serializer checkpoints (``utils/serializer.read_model``), keeps the
weights on the device once, and pads every request up to the smallest
bucket of the ladder, so the device only ever sees bucket shapes.

- **Captures, the compile-ladder analog.** On the card each (kind, bucket)
  is one captured CUDA graph, the counterpart of the JAX engine's AOT
  executable (``_executable``): its static input is a device tensor of
  bucket shape and its static output the forward's result. ``warmup()``
  captures every (kind, bucket) before the first request (a request for an
  uncaptured one captures it first, under the capture lock, as JAX
  compiles on its ``_compile_lock``); ``compile_counts`` counts captures,
  ``serve_compile_counts`` the captures made after warmup (the fast-path
  contract: it stays 0), and ``expected_max_compiles`` is
  ``len(buckets) × replicas``. A capture runs the forward ``WARMUP_RUNS``
  times on a side stream (cuDNN and cuBLAS pick their kernels), then
  captures it into its replica's graph memory pool, under the process-wide
  ``runtime/capture.py::CAPTURE_LOCK`` in ``"thread_local"`` mode with
  Python's collector held off. A capture that fails raises and marks
  warmup failed (``warm_failed``, which ``/healthz`` shows): the engine
  never serves eager in its place. ``captured = False`` runs the same
  forward uncaptured on the engine stream (what ``chip_smoke.py`` times
  beside the replays); on the CPU the engine is always uncaptured, and
  ``compile_counts`` counts first runs.
- **Staging.** Each (kind, bucket) keeps a small pool of pinned host
  buffers whose pad tail is kept at zero by a high-water mark, so
  assembling a flush is one memcpy per rider and at most one memset of the
  shrink delta. The mux passes one ``staging_pool`` (``serving/mux/
  registry.py::SharedStagingPool``) that every resident engine shares.
- **dispatch / finalize.** ``dispatch()`` copies the staging buffer into
  the graph's static input with a non-blocking H2D copy on its replica's
  own CUDA stream, replays the graph there, copies the static output into
  a pinned per-flight output buffer with a non-blocking D2H copy and
  records an event; the three are enqueued under the replica's replay
  lock, so flights dispatched from several threads never interleave on
  the static buffers or on the replica's graph pool;
  ``finalize()`` waits on that event and slices the padding off. A staging
  buffer returns to the pool only after its flight's event, because the
  H2D copy reads it asynchronously. On the CPU the forward pass runs
  inside ``dispatch``.
- **Numerics.** Whatever runs in fp32 runs with TF32 off
  (``pin_fp32_precision``). A bundle without ``precision`` computes in
  fp32, bf16 param leaves included (a ``param_dtype="bf16"`` run's
  ``publish_for_serving`` bundle), as the JAX engine computes them. A
  ``precision: "bf16"`` bundle (``quant/variants.py::build_bf16_variant``)
  runs every forward pass inside ``compute_dtype_scope(bfloat16)``: the
  dense and convolution products in bf16 with fp32 accumulation, on half
  the resident param bytes (``resident_param_bytes()``). A
  ``precision: "int8"`` bundle (``quant/variants.py::build_int8_variant``)
  needs no scope: it computes in fp32, and its ``QuantDenseLayer``s keep
  their int8 ``W_q`` on the device (one byte each) and run the
  hand-written ``quant_dense`` kernel on the card. Any other ``precision``
  string (``"fp16"``, say) is recorded and served in fp32, as the JAX
  engine serves it.

- **Conditional bundles.** A bundle whose ``"zoo"`` block declares
  ``conditioning: "class"`` (``conditional``, ``class_count``) has a
  generator that takes ``[z | one-hot(class)]``; the engine checks that
  ``z_size + num_classes`` is the generator's input width, as the JAX
  engine does. The service appends the one-hot to base-z rows of
  ``sample?class=k`` (``latent_width``), so a conditional ``sample`` runs
  the same (kind, bucket) graphs as any other: no capture and no ladder
  entry of its own.

- **Replicas.** ``replicas`` (an int, or ``"all"`` / None for every
  device) and ``devices`` resolve through ``runtime/device.py::
  resolve_devices``, the counterpart of ``jax.local_devices()``: the cards
  ``cuda:0 … cuda:R-1``, or the first R of an explicit device pool in
  which a device may repeat (``devices=("cpu", "cpu"), replicas=2`` in the
  CPU tests, ``("cuda:0", "cuda:0")`` on a one-card host). Each replica has
  its params on its device, its own
  engine stream, capture stream, graph pool, captures keyed ``(kind,
  bucket, replica)`` and replay lock; every capture and replay runs under
  ``torch.cuda.device`` of its replica. Each flush goes to the
  least-loaded replica, ties broken round-robin (the JAX engine's
  ``_pick_replica``), and its flight's completion lane is that replica.
  A ``top × replicas`` slab from one rider rides the **bulk lane**: no
  CUDA graph spans cards, so instead of JAX's one mesh-sharded executable
  the engine enqueues, for each replica, the H2D of its ``top`` rows, a
  replay of its top-bucket graph, the D2H and an event on its stream, and
  ``finalize`` waits for every event. Bulk parts reserve no replica, as in
  JAX, and capture nothing of their own: ``expected_max_compiles`` is
  ``len(buckets) × replicas``, one less per kind than the JAX engine's
  ``len(buckets) × replicas + 1``.

Request kinds (a generator-only bundle, as the tabular, image and WGAN-GP
families publish, serves ``sample`` alone):

- ``sample``:   z (n, z_size), plus the one-hot of a conditional bundle
                                     -> generator images (n, num_features)
- ``classify``: x (n, num_features)  -> class probabilities (n, num_classes)
- ``features``: x (n, num_features)  -> activations at the classifier's
  feature vertex (mnist: ``dis_dense_layer_6``)
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from gan_deeplearning4j_tpu_torch.runtime.capture import (
    CAPTURE_ERROR_MODE,
    CAPTURE_LOCK,
    capture_guard,
)
from gan_deeplearning4j_tpu_torch.runtime.device import (
    DeviceLike,
    pin_fp32_precision,
    resolve_devices,
)
from gan_deeplearning4j_tpu_torch.runtime.dtype import compute_dtype_scope
from gan_deeplearning4j_tpu_torch.telemetry.registry import get_registry
from gan_deeplearning4j_tpu_torch.telemetry.trace import TRACER

DEFAULT_BUCKETS = (1, 8, 32, 128)

#: staging buffers kept per (kind, bucket)
_POOL_LIMIT = 4

#: forward runs on the side stream before a (kind, bucket) is captured
WARMUP_RUNS = 2


class _StagingBuf:
    """A reusable host buffer of bucket shape (pinned when the engine runs
    on the card) whose tail is kept at zero. ``high_water`` is the largest
    row count written since the last shrink: rows past it are known-zero,
    so a smaller flush only memsets ``[n, high_water)``."""

    __slots__ = ("tensor", "arr", "high_water")

    def __init__(self, bucket: int, width: int, pin: bool):
        self.tensor = torch.zeros((bucket, width), dtype=torch.float32, pin_memory=pin)
        self.arr = self.tensor.numpy()  # shares the tensor's memory
        self.high_water = 0

    def reset_tail(self, n: int) -> None:
        if self.high_water > n:
            self.arr[n:self.high_water] = 0.0
        self.high_water = n


class _Capture:
    """One (kind, bucket) captured on the card: the graph, its static input
    ``x`` and output ``y``, and what the capture cost. ``launches`` counts
    the port's hand-written kernels launched into the graph
    (``ops.linear.KERNEL_LAUNCHES`` moved by the capture): each replay
    launches them again, with no wrapper call to count it."""

    __slots__ = ("graph", "x", "y", "replays", "capture_s", "pool_bytes", "launches")

    def __init__(self, graph, x, y, capture_s: float, pool_bytes: int, launches: Dict[str, int]):
        self.graph = graph
        self.x = x
        self.y = y
        self.replays = 0
        self.capture_s = capture_s
        self.pool_bytes = pool_bytes
        self.launches = launches


class _Flight:
    """One dispatched flush. ``parts`` holds, per chunk, ``(out, n_real_rows,
    staging_buf, event, replica)``: ``out`` is the pinned host output (card)
    or the result tensor (CPU), ``event`` the CUDA event recorded after the
    D2H copy (None on the CPU), ``replica`` the replica the chunk reserved
    (None for a bulk-lane part, which reserves none). ``lane`` is the
    batcher's completion lane: the replica of the first replica-routed
    chunk, 0 for a flight that rode only the bulk lane."""

    __slots__ = ("kind", "parts", "lane")

    def __init__(self, kind: str, parts: list, lane: int = 0):
        self.kind = kind
        self.parts = parts
        self.lane = lane


class _Replica:
    """One replica's device state: its device, its params there, and on the
    card its engine stream (staged H2D, replay, D2H), capture stream and
    graph memory pool, and the lock its flights' enqueues take (its graphs
    share the pool and each its static buffers).

    ``Tensor.to(d)`` of a tensor already on ``d`` returns the tensor itself,
    so replicas on a repeated device share their params (read-only), and
    an int8 bundle's replicas there share one ``quant_dense`` prepared
    handle (``ops/linear.py::_PREPARED`` keys on ``W_q``'s id), launched
    from both replicas' streams. That is safe because the handle is host
    state read-only after it is made: each launch copies its ``Args`` and
    passes them and the TMA tensor map by value (``__grid_constant__``,
    ``csrc/quant_dense.cu::gdt_quant_dense_run``), so no launch writes
    state another reads. Replicas on distinct cards hold distinct ``W_q``
    tensors, so each gets its own handle, made on its card."""

    __slots__ = ("index", "device", "params", "stream", "capture_stream", "graph_pool",
                 "replay_lock")

    def __init__(self, index: int, device: torch.device, params: dict):
        cuda = device.type == "cuda"
        self.index = index
        self.device = device
        self.params = params
        self.stream = torch.cuda.Stream(device) if cuda else None
        self.capture_stream = torch.cuda.Stream(device) if cuda else None
        self.graph_pool = torch.cuda.graph_pool_handle() if cuda else None
        self.replay_lock = threading.Lock()


class ServingEngine:
    """Model-backed executor: ``run(kind, rows) -> rows``, or the async
    pair ``dispatch(kind, rows_list) -> flight`` / ``finalize(flight)``.

    ``models`` maps role ("generator"/"classifier") to a loaded
    ``(ComputationGraph, params)`` pair. Thread-safe: the staging pool,
    the first-run ledger, the routing and the counters are guarded by one
    lock; each replica's enqueues by its own replay lock."""

    def __init__(
        self,
        models: Dict[str, Tuple[object, dict]],
        *,
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        feature_vertex: Optional[str] = None,
        replicas=1,
        generation: Optional[int] = None,
        precision: Optional[str] = None,
        scenario: Optional[dict] = None,
        device: DeviceLike = None,
        export_gauge: bool = True,
        staging_pool=None,
        devices: Optional[Sequence[DeviceLike]] = None,
    ):
        if not models:
            raise ValueError("ServingEngine needs at least one model")
        devs = resolve_devices(device, replicas, devices)
        if len({d.type for d in devs}) != 1:
            raise ValueError(f"replica devices {devs} mix device types")
        #: the first replica's device: params are read there and
        #: ``run_host`` runs there
        self.device = devs[0]
        self._cuda = self.device.type == "cuda"
        if self._cuda:
            pin_fp32_precision()
        #: the bundle's zoo block (dataset identity, conditioning), the raw
        #: dict; None for a bundle without one (unconditional)
        self.scenario = dict(scenario) if scenario else None
        self.generation = generation
        self.precision = precision
        # a bf16 bundle computes its products in bf16; every other bundle
        # (int8 too: its quantized layers carry their own dtypes) in fp32
        # (None pins it, whatever the calling thread's scope)
        self._compute_dtype = torch.bfloat16 if precision == "bf16" else None
        buckets = tuple(sorted(set(int(b) for b in buckets)))
        if not buckets or buckets[0] < 1:
            raise ValueError(f"invalid bucket ladder {buckets!r}")
        self.buckets = buckets
        self.feature_vertex = feature_vertex

        self._graphs = {role: graph for role, (graph, _) in models.items()}
        for role, (_, params) in models.items():
            for layer, leaves in params.items():
                for name, t in leaves.items():
                    if t.dtype not in (torch.float32, torch.bfloat16, torch.int8):
                        raise ValueError(
                            f"{role} param {layer}/{name} is {t.dtype}: a bundle's leaves "
                            f"are float32, bfloat16 or int8"
                        )
        # weights cross to each replica's device once, here
        self._replicas = tuple(
            _Replica(r, d, {role: {layer: {name: t.to(d) for name, t in leaves.items()}
                                   for layer, leaves in params.items()}
                            for role, (_, params) in models.items()})
            for r, d in enumerate(devs))
        #: the first replica's params (what ``run_host`` computes with)
        self._params = self._replicas[0].params

        self._kinds: Dict[str, Tuple[str, object]] = {}  # kind -> (role, fn)
        if "generator" in models:
            gen = self._graphs["generator"]
            # NHWC images flatten to (n, features) rows: the wire contract
            self._kinds["sample"] = (
                "generator",
                lambda p, z: gen.output(p, z).reshape(z.shape[0], -1),
            )
        if "classifier" in models:
            cv = self._graphs["classifier"]
            self._kinds["classify"] = ("classifier", lambda p, x: cv.output(p, x))
            if feature_vertex is not None:
                if feature_vertex not in {v.name for v in cv.vertices}:
                    raise ValueError(
                        f"feature vertex {feature_vertex!r} is not a vertex of "
                        f"the classifier graph"
                    )
                self._kinds["features"] = (
                    "classifier",
                    lambda p, x: cv.feed_forward(p, x)[feature_vertex],
                )

        self._in_width = {
            kind: self._graphs[role].input_types[0].features
            for kind, (role, _) in self._kinds.items()
        }
        if self.conditional and "sample" in self._in_width:
            declared = int(self.scenario.get("z_size", 0)) + self.class_count
            if self._in_width["sample"] != declared:
                raise ValueError(
                    f"conditional bundle declares z_size+classes = {declared} "
                    f"but the generator takes {self._in_width['sample']} "
                    f"inputs — manifest and checkpoint disagree"
                )
        self._ran: set = set()  # (kind, bucket, replica) run at least once
        self._compile_counts: Dict[str, int] = {k: 0 for k in self._kinds}
        self._serve_compiles: Dict[str, int] = {k: 0 for k in self._kinds}
        self._padded_waste: Dict[str, int] = {k: 0 for k in self._kinds}
        _registry = get_registry()
        _compiles = _registry.counter(
            "serve_engine_compiles_total",
            "first runs per request kind and bucket (warmup + serve-time)",
            labelnames=("kind",),
        )
        _serve_c = _registry.counter(
            "serve_engine_serve_compiles_total",
            "post-warmup first runs per kind (fast-path contract: stays 0)",
            labelnames=("kind",),
        )
        self._c_compiles = {k: _compiles.labels(kind=k) for k in self._kinds}
        self._c_serve_compiles = {k: _serve_c.labels(kind=k) for k in self._kinds}
        _waste = _registry.counter(
            "serve_padded_rows_wasted_total",
            "rows padded past the request rows per kind",
            labelnames=("kind",),
        )
        self._c_waste = {k: _waste.labels(kind=k) for k in self._kinds}
        _dispatches = _registry.counter(
            "serve_engine_dispatches_total",
            "flush dispatches routed per replica",
            labelnames=("replica",),
        )
        self._c_dispatches = [_dispatches.labels(replica=str(r)) for r in range(len(devs))]
        self._g_generation = _registry.gauge(
            "serving_generation",
            "store generation of the served bundle (-1 = unversioned)",
        )
        if export_gauge:
            self.export_generation()
        # the mux passes one pool that every resident engine shares
        self._shared_staging = staging_pool
        self._staging: Dict[Tuple[str, int], List[_StagingBuf]] = {}
        self._outstanding = [0] * len(devs)  # dispatched-but-unfinalized chunks
        self._dispatches = [0] * len(devs)
        self._rr = 0  # round-robin tiebreak cursor
        self._warmed = False
        self._warm_thread: Optional[threading.Thread] = None
        self._warm_error: Optional[BaseException] = None
        self._lock = threading.Lock()
        #: replay the (kind, bucket, replica) graphs (the card only); False
        #: runs the same forward uncaptured on each replica's stream
        self.captured = self._cuda
        self._captures: Dict[Tuple[str, int, int], _Capture] = {}
        self._released_launches: Dict[str, int] = {}  # replays of closed graphs
        if self._cuda:
            # params were written on the default streams; the replica
            # streams must not read them before those copies land
            for d in set(devs):
                torch.cuda.synchronize(d)

    # -- constructors -------------------------------------------------------
    @classmethod
    def from_checkpoints(
        cls,
        generator: Optional[str] = None,
        classifier: Optional[str] = None,
        *,
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        feature_vertex: Optional[str] = None,
        replicas=1,
        generation: Optional[int] = None,
        precision: Optional[str] = None,
        scenario: Optional[dict] = None,
        device: DeviceLike = None,
        export_gauge: bool = True,
        staging_pool=None,
        devices: Optional[Sequence[DeviceLike]] = None,
    ) -> "ServingEngine":
        """Restore from serializer checkpoint zips onto the first replica's
        device. Updater state is never loaded — a serving replica has no
        optimizer."""
        from gan_deeplearning4j_tpu_torch.utils.serializer import read_model

        devs = resolve_devices(device, replicas, devices)
        models = {}
        with TRACER.span("serve.engine.restore", generation=generation):
            for role, path in (("generator", generator), ("classifier", classifier)):
                if path is None:
                    continue
                graph, params, _, _ = read_model(path, load_updater=False, device=devs[0])
                models[role] = (graph, params)
        return cls(models, buckets=buckets, feature_vertex=feature_vertex,
                   replicas=len(devs), generation=generation,
                   precision=precision, scenario=scenario, devices=devs,
                   export_gauge=export_gauge, staging_pool=staging_pool)

    @classmethod
    def from_bundle(
        cls, directory: str, *, buckets: Optional[Sequence[int]] = None,
        replicas=1, device: DeviceLike = None, export_gauge: bool = True,
        staging_pool=None, devices: Optional[Sequence[DeviceLike]] = None,
    ) -> "ServingEngine":
        """Load a ``serving.json`` bundle (as the JAX package's
        ``GanExperiment.publish_for_serving`` writes it). ``buckets=None``
        resolves the bundle's learned ladder when the manifest carries one,
        else :data:`DEFAULT_BUCKETS`. ``export_gauge=False`` builds an
        engine off to the side (a cost measurement, a canary candidate)
        without claiming the ``serving_generation`` gauge. ``replicas``,
        ``device`` and ``devices`` as for the constructor."""
        from gan_deeplearning4j_tpu_torch.serving.ladder import manifest_ladder

        with open(os.path.join(directory, "serving.json")) as fh:
            manifest = json.load(fh)
        if manifest.get("format_version", 0) > 1:
            raise ValueError(
                f"serving bundle format {manifest['format_version']} is newer "
                f"than supported"
            )
        if buckets is None:
            buckets = manifest_ladder(directory) or DEFAULT_BUCKETS

        def _path(key):
            name = manifest.get(key)
            return os.path.join(directory, name) if name else None

        return cls.from_checkpoints(
            generator=_path("generator"),
            classifier=_path("classifier"),
            buckets=buckets,
            feature_vertex=manifest.get("feature_vertex"),
            replicas=replicas,
            generation=manifest.get("generation"),
            precision=manifest.get("precision"),
            scenario=manifest.get("zoo"),
            device=device,
            export_gauge=export_gauge,
            staging_pool=staging_pool,
            devices=devices,
        )

    # -- introspection ------------------------------------------------------
    def export_generation(self) -> None:
        """Publish this engine's bundle generation to the process-wide
        ``serving_generation`` gauge."""
        self._g_generation.set(-1 if self.generation is None else self.generation)

    @property
    def in_flight(self) -> int:
        """Dispatched-but-unfinalized chunks over every replica (the reload
        plane retires an old engine once it drains to zero)."""
        with self._lock:
            return sum(self._outstanding)

    @property
    def kinds(self) -> Tuple[str, ...]:
        return tuple(self._kinds)

    def input_width(self, kind: str) -> int:
        return self._in_width[kind]

    # -- zoo scenario ---------------------------------------------------------
    @property
    def conditional(self) -> bool:
        """Whether the bundle's zoo block declares class conditioning (what
        makes ``sample?class=k`` legal)."""
        return bool(self.scenario) and self.scenario.get("conditioning") == "class"

    @property
    def class_count(self) -> int:
        """The number of condition classes (0 when unconditional)."""
        return int(self.scenario.get("num_classes", 0)) if self.conditional else 0

    def latent_width(self, kind: str) -> int:
        """The caller-facing latent width of a kind: the input width less
        the one-hot block the service appends to a conditional
        ``sample?class=k`` row; ``input_width`` for every other kind."""
        width = self._in_width[kind]
        if kind == "sample" and self.conditional:
            return width - self.class_count
        return width

    def scenario_manifest(self):
        """The bundle's zoo block parsed as a ``zoo/manifest.py::
        ScenarioManifest`` (None for a bundle without one). The engine keeps
        the raw dict, so the zoo is imported only here."""
        if self.scenario is None:
            return None
        from gan_deeplearning4j_tpu_torch.zoo.manifest import ScenarioManifest

        return ScenarioManifest.from_dict(self.scenario)

    @property
    def replica_count(self) -> int:
        return len(self._replicas)

    @property
    def devices(self) -> Tuple[torch.device, ...]:
        """The replicas' devices, in replica order (a device may repeat):
        what a candidate engine that takes this one's place is built on."""
        return tuple(rep.device for rep in self._replicas)

    @property
    def platform(self) -> str:
        """"gpu" on the card, "cpu" otherwise."""
        return "gpu" if self._cuda else self.device.type

    @property
    def default_pipeline_depth(self) -> int:
        """In-flight flush window the batcher uses unless overridden: two
        per replica on the card (one executing, one queued behind it), one
        per replica on the CPU, where the "device" shares the host's
        cores."""
        return (2 if self._cuda else 1) * len(self._replicas)

    @property
    def compile_counts(self) -> Dict[str, int]:
        """Captures per kind so far on the card (first runs on the CPU),
        warmup and serve-time; each stays ``<= expected_max_compiles``."""
        with self._lock:
            return dict(self._compile_counts)

    @property
    def serve_compile_counts(self) -> Dict[str, int]:
        """Captures (first runs) AFTER warmup completed; the contract is 0
        per kind."""
        with self._lock:
            return dict(self._serve_compiles)

    @property
    def expected_max_compiles(self) -> int:
        """One capture (first run) per (bucket, replica) per kind. The JAX
        engine's is one more per kind with more than one replica (its
        mesh-sharded bulk executable); the port's bulk lane replays the
        top-bucket graphs and captures nothing of its own."""
        return len(self.buckets) * len(self._replicas)

    @property
    def warming(self) -> bool:
        t = self._warm_thread
        return t is not None and t.is_alive()

    @property
    def warmed(self) -> bool:
        return self._warmed

    @property
    def warm_failed(self) -> bool:
        return self._warm_error is not None

    def resident_param_bytes(self) -> int:
        """Device bytes one replica's params pin, each leaf at its own
        element size: a bf16 bundle's are half an fp32 one's, and an int8
        bundle's ``W_q`` count one byte each."""
        return sum(t.numel() * t.element_size()
                   for params in self._params.values()
                   for leaves in params.values() for t in leaves.values())

    def graph_stats(self) -> Dict[str, dict]:
        """Per captured ``"kind/bucket"`` (``"kind/bucket/r"`` for replica
        r > 0): replays, capture seconds (warmup runs included), the graph
        pool's bytes reserved by the capture, and the hand-written kernels'
        launches per replay."""
        with self._lock:
            return {f"{k}/{b}" + (f"/{r}" if r else ""): {
                        "replays": c.replays, "capture_s": c.capture_s, "pool_bytes": c.pool_bytes,
                        "launches_per_replay": dict(c.launches)}
                    for (k, b, r), c in self._captures.items()}

    def kernel_launches(self) -> Dict[str, int]:
        """The hand-written kernels' launches made by replays so far: per
        kernel, replays × launches per replay, summed over every replica's
        graphs (those released by :meth:`close` included)."""
        with self._lock:
            out = dict(self._released_launches)
            for c in self._captures.values():
                for name, n in c.launches.items():
                    out[name] = out.get(name, 0) + n * c.replays
        return out

    def stats(self) -> dict:
        """Engine-side observability merged into the service /metrics (the
        JAX engine's keys; ``resident_param_bytes``, one replica's; on the
        card whether requests replay graphs and the bytes of every
        replica's graphs)."""
        with self._lock:
            per_replica = [0] * len(self._replicas)
            for (_, _, r) in self._ran:
                per_replica[r] += 1
            return {
                "replicas": len(self._replicas),
                "generation": self.generation,
                "precision": self.precision or "fp32",
                "resident_param_bytes": self.resident_param_bytes(),
                "replica_dispatches": list(self._dispatches),
                "replica_in_flight": list(self._outstanding),
                "compile_counts": dict(self._compile_counts),
                "serve_compile_counts": dict(self._serve_compiles),
                "padded_rows_wasted": dict(self._padded_waste),
                "buckets": list(self.buckets),
                "compiled_per_replica": per_replica,
                "captured": self.captured,
                "graph_pool_bytes": sum(c.pool_bytes for c in self._captures.values()),
                "warmup": "warm" if self._warmed else (
                    "warming" if self.warming else (
                        "failed" if self._warm_error is not None else "cold")),
            }

    # -- first runs and warmup ----------------------------------------------
    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        return self.buckets[-1]

    def _note_run(self, kind: str, bucket: int, replica: int) -> None:
        """Count the capture (first run, on the CPU) of (kind, bucket) on a
        replica; one after warmup finished (or failed) is a serve-time
        one."""
        with self._lock:
            if (kind, bucket, replica) in self._ran:
                return
            self._ran.add((kind, bucket, replica))
            self._compile_counts[kind] += 1
            self._c_compiles[kind].inc()
            if self._warmed or self._warm_error is not None:
                self._serve_compiles[kind] += 1
                self._c_serve_compiles[kind].inc()

    def _forward(self, kind: str, x: torch.Tensor, replica: int = 0) -> torch.Tensor:
        role, fn = self._kinds[kind]
        with torch.inference_mode(), compute_dtype_scope(self._compute_dtype):
            return fn(self._replicas[replica].params[role], x)

    def _warm_one(self, kind: str, bucket: int, replica: int) -> None:
        if self._cuda:
            self._capture(kind, bucket, replica)
            return
        with TRACER.span("serve.engine.warm", kind=kind, bucket=bucket, replica=replica):
            self._forward(kind, torch.zeros((bucket, self._in_width[kind]), dtype=torch.float32),
                          replica)
        self._note_run(kind, bucket, replica)

    def _capture(self, kind: str, bucket: int, replica: int) -> _Capture:
        """The (kind, bucket) graph of a replica, captured now unless it
        already is. A failure raises and marks warmup failed."""
        from gan_deeplearning4j_tpu_torch.ops.linear import KERNEL_LAUNCHES

        key = (kind, bucket, replica)
        rep = self._replicas[replica]
        with capture_guard():
            with self._lock:
                cap = self._captures.get(key)
            if cap is not None:
                return cap
            try:
                with TRACER.span("serve.engine.capture", kind=kind, bucket=bucket,
                                 replica=replica), torch.cuda.device(rep.device):
                    t0 = time.perf_counter()
                    side = rep.capture_stream
                    with torch.cuda.stream(rep.stream):
                        x = torch.zeros((bucket, self._in_width[kind]), dtype=torch.float32,
                                        device=rep.device)
                    side.wait_stream(rep.stream)
                    with torch.cuda.stream(side):
                        for _ in range(WARMUP_RUNS):
                            self._forward(kind, x, replica)
                    launched = dict(KERNEL_LAUNCHES)
                    reserved = torch.cuda.memory_reserved(rep.device)
                    graph = torch.cuda.CUDAGraph()
                    with torch.cuda.stream(side):
                        graph.capture_begin(pool=rep.graph_pool, capture_error_mode=CAPTURE_ERROR_MODE)
                        try:
                            y = self._forward(kind, x, replica)
                        finally:
                            graph.capture_end()
                    pool_bytes = torch.cuda.memory_reserved(rep.device) - reserved
                    launches = {k: v - launched.get(k, 0) for k, v in KERNEL_LAUNCHES.items()
                                if v != launched.get(k, 0)}
                    rep.stream.wait_stream(side)
                    side.synchronize()
                    cap = _Capture(graph, x, y, time.perf_counter() - t0, pool_bytes, launches)
            except BaseException as exc:
                self._warm_error = exc
                raise
            with self._lock:
                self._captures[key] = cap
        self._note_run(kind, bucket, replica)
        return cap

    def close(self) -> None:
        """Drop every replica's captured graphs (under the capture lock: a
        graph's destruction must not land inside another thread's
        capture). Call it once no flight is in flight; a later request
        captures again."""
        if not self._cuda:
            return
        with CAPTURE_LOCK:
            launched = self.kernel_launches()
            with self._lock:
                captures, self._captures = self._captures, {}
                self._released_launches = launched
                self._ran.clear()
            for (_, _, r), cap in captures.items():
                with torch.cuda.device(self._replicas[r].device):
                    cap.graph.reset()
            captures.clear()

    def warmup(self, background: bool = False):
        """Run every (kind, bucket, replica) once so that no request pays a
        first run. ``background=True`` runs it on a daemon thread (``warming`` is
        True until it finishes); otherwise blocks and returns per-kind
        counts."""
        if background:
            with self._lock:
                if self._warm_thread is not None and self._warm_thread.is_alive():
                    return self._warm_thread
                t = threading.Thread(target=self._warm_all_quiet, name="engine-warmup", daemon=True)
                self._warm_thread = t
            t.start()
            return t
        self._warm_all()
        return self.compile_counts

    def _warm_all_quiet(self) -> None:
        """Background-thread wrapper: the failure is stored (surfaced via
        ``wait_warm``/``warm_failed``/healthz), not re-raised."""
        try:
            self._warm_all()
        except Exception:
            pass

    def _warm_all(self) -> None:
        try:
            # on the card, one guard around every capture: one collection
            # per warmup, not one per (kind, bucket, replica)
            with capture_guard() if self._cuda else contextlib.nullcontext():
                for kind in self._kinds:
                    for r in range(len(self._replicas)):
                        for b in self.buckets:
                            if (kind, b, r) not in self._ran:
                                self._warm_one(kind, b, r)
            self._warm_error = None
        except BaseException as exc:  # surfaced by wait_warm/healthz
            self._warm_error = exc
            raise
        finally:
            self._warmed = self._warm_error is None

    def wait_warm(self, timeout: Optional[float] = None) -> bool:
        """Block until a background warmup finishes. True when warm; raises
        the warmup's error if it failed."""
        t = self._warm_thread
        if t is not None:
            t.join(timeout)
        if self._warm_error is not None:
            raise RuntimeError("engine warmup failed") from self._warm_error
        return self._warmed

    # -- staging pool -------------------------------------------------------
    def _checkout(self, kind: str, bucket: int) -> _StagingBuf:
        if self._shared_staging is not None:
            return self._shared_staging.checkout(bucket, self._in_width[kind])
        with self._lock:
            pool = self._staging.get((kind, bucket))
            if pool:
                return pool.pop()
        return _StagingBuf(bucket, self._in_width[kind], pin=self._cuda)

    def _release(self, kind: str, buf: _StagingBuf, replica: Optional[int]) -> None:
        """Return a chunk's staging buffer and, for a replica-routed chunk,
        its replica's reservation."""
        if self._shared_staging is not None:
            self._shared_staging.checkin(buf)
        else:
            with self._lock:
                pool = self._staging.setdefault((kind, buf.arr.shape[0]), [])
                if len(pool) < _POOL_LIMIT:
                    pool.append(buf)
        if replica is not None:
            with self._lock:
                self._outstanding[replica] -= 1

    def _pick_replica(self) -> int:
        """Reserve the least-loaded replica (fewest chunks in flight), ties
        broken round-robin, and count the dispatch."""
        with self._lock:
            load = min(self._outstanding)
            candidates = [r for r, o in enumerate(self._outstanding) if o == load]
            r = candidates[self._rr % len(candidates)]
            self._rr += 1
            self._outstanding[r] += 1
            self._dispatches[r] += 1
        self._c_dispatches[r].inc()
        return r

    # -- execution ----------------------------------------------------------
    def _validate(self, kind: str, rows_list) -> int:
        if kind not in self._kinds:
            raise KeyError(f"unknown request kind {kind!r}; serving {sorted(self._kinds)}")
        width = self._in_width[kind]
        total = 0
        for rows in rows_list:
            if rows.ndim != 2 or rows.shape[0] < 1 or rows.shape[1] != width:
                raise ValueError(f"{kind}: expected (n >= 1, {width}) rows, got {rows.shape}")
            total += rows.shape[0]
        if not rows_list:
            raise ValueError(f"{kind}: empty batch")
        return total

    def dispatch(self, kind: str, rows_list: Sequence[np.ndarray]) -> _Flight:
        """Assemble the riders into bucket-shaped staging buffers and launch
        the forward passes without waiting for them (on the card); collect
        with :meth:`finalize`. Batches larger than the top bucket go in
        top-bucket chunks, each to the least-loaded replica; a ``top ×
        replicas`` slab of one rider rides the bulk lane."""
        rows_list = [np.asarray(r, dtype=np.float32) for r in rows_list]
        total = self._validate(kind, rows_list)
        parts: list = []
        try:
            self._dispatch_chunks(kind, rows_list, total, parts)
        except BaseException:
            # a failed later chunk releases every earlier chunk's buffer and
            # replica reservation, or routing would count phantom load; a
            # buffer goes back only once the H2D copy reading it has landed
            for _, _, buf, event, r in parts:
                if event is not None:
                    with contextlib.suppress(RuntimeError):  # the first failure is what raises
                        event.synchronize()
                self._release(kind, buf, r)
            raise
        lane = next((r for *_, r in parts if r is not None), 0)
        return _Flight(kind, parts, lane)

    def _dispatch_chunks(self, kind, rows_list, total, parts) -> None:
        top = self.buckets[-1]
        slab = top * len(self._replicas)
        ri, roff = 0, 0  # rider cursor: (index into rows_list, row offset)
        remaining = total
        while remaining > 0:
            if (len(self._replicas) > 1 and remaining >= slab
                    and roff + slab <= rows_list[ri].shape[0]):
                self._dispatch_bulk(kind, rows_list[ri][roff:roff + slab], parts)
                roff += slab
                remaining -= slab
                if roff == rows_list[ri].shape[0]:
                    ri, roff = ri + 1, 0
                continue
            n = min(top, remaining)
            bucket = self._bucket_for(n)
            waste = bucket - n
            if waste:
                with self._lock:
                    self._padded_waste[kind] += waste
                self._c_waste[kind].inc(waste)
            buf = self._checkout(kind, bucket)
            filled = 0
            while filled < n:
                rider = rows_list[ri]
                take = min(n - filled, rider.shape[0] - roff)
                buf.arr[filled:filled + take] = rider[roff:roff + take]
                filled += take
                roff += take
                if roff == rider.shape[0]:
                    ri, roff = ri + 1, 0
            buf.reset_tail(n)
            r = self._pick_replica()
            try:
                out, event = self._launch(kind, bucket, buf, r)
            except BaseException:
                self._release(kind, buf, r)
                raise
            parts.append((out, n, buf, event, r))
            remaining -= n

    def _dispatch_bulk(self, kind: str, slab: np.ndarray, parts: list) -> None:
        """The bulk lane: replica r runs rows ``[r·top, (r+1)·top)`` of the
        slab through its top-bucket graph, all enqueued before any is
        waited for. The parts reserve no replica (as the JAX engine's bulk
        executable reserves none)."""
        top = self.buckets[-1]
        for r in range(len(self._replicas)):
            buf = self._checkout(kind, top)
            buf.arr[:] = slab[r * top:(r + 1) * top]
            buf.reset_tail(top)
            try:
                out, event = self._launch(kind, top, buf, r)
            except BaseException:
                self._release(kind, buf, None)
                raise
            parts.append((out, top, buf, event, None))

    def _launch(self, kind: str, bucket: int, buf: _StagingBuf, replica: int):
        """Run one staged bucket on a replica: ``(host_out, event)`` on the
        card, ``(result, None)`` on the CPU."""
        if not self._cuda:
            self._note_run(kind, bucket, replica)
            return self._forward(kind, buf.tensor, replica), None
        rep = self._replicas[replica]
        if self.captured:
            with self._lock:
                cap = self._captures.get((kind, bucket, replica))
            cap = cap or self._capture(kind, bucket, replica)
            host = torch.empty(cap.y.shape, dtype=cap.y.dtype, pin_memory=True)
            event = torch.cuda.Event()
            with rep.replay_lock, torch.cuda.device(rep.device), torch.cuda.stream(rep.stream):
                cap.x.copy_(buf.tensor, non_blocking=True)
                cap.graph.replay()
                host.copy_(cap.y, non_blocking=True)
                event.record(rep.stream)
                cap.replays += 1
            return host, event
        with torch.cuda.device(rep.device), torch.cuda.stream(rep.stream):
            x = buf.tensor.to(rep.device, non_blocking=True)
            y = self._forward(kind, x, replica)
            host = torch.empty(y.shape, dtype=y.dtype, pin_memory=True)
            host.copy_(y, non_blocking=True)
            event = torch.cuda.Event()
            event.record(rep.stream)
        return host, event

    def finalize(self, flight: _Flight) -> np.ndarray:
        """Wait for the flight's device work, slice the padding off, recycle
        the staging buffers, and return the result rows. Buffers are
        released for every part, even when a wait raises partway."""
        outs = []
        parts = list(flight.parts)
        flight.parts = []  # release exactly once, even if called twice
        try:
            for out, n, _, event, _ in parts:
                if event is not None:
                    event.synchronize()
                outs.append(out[:n].numpy().copy())
        finally:
            for _, _, buf, _, r in parts:
                self._release(flight.kind, buf, r)
        return outs[0] if len(outs) == 1 else np.concatenate(outs)

    def run(self, kind: str, rows: np.ndarray) -> np.ndarray:
        """Execute one batch synchronously: staged assembly, forward pass,
        unpad."""
        rows = np.asarray(rows, dtype=np.float32)
        return self.finalize(self.dispatch(kind, [rows]))

    def run_host(self, kind: str, rows: np.ndarray) -> np.ndarray:
        """Reference path: pad each chunk with a fresh ``np.zeros`` +
        ``np.concatenate``, copy it synchronously on the default stream of
        replica 0's device, run the forward eagerly there with replica 0's
        params and copy back. The bit-exactness oracle for the staged
        (captured) path and the bulk lane; it captures nothing."""
        rows = np.asarray(rows, dtype=np.float32)
        self._validate(kind, [rows])
        top = self.buckets[-1]
        outs = []
        for start in range(0, rows.shape[0], top):
            chunk = rows[start:start + top]
            bucket = self._bucket_for(chunk.shape[0])
            if chunk.shape[0] < bucket:
                pad = np.zeros((bucket - chunk.shape[0], chunk.shape[1]), np.float32)
                chunk = np.concatenate([chunk, pad])
            if not self._cuda:
                self._note_run(kind, bucket, 0)
            y = self._forward(kind, torch.from_numpy(chunk).to(self.device))
            outs.append(y.cpu().numpy()[: min(top, rows.shape[0] - start)])
        return outs[0] if len(outs) == 1 else np.concatenate(outs)
