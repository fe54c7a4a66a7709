"""MuxRegistry — counterpart of ``gan_deeplearning4j_tpu/serving/mux/
registry.py``: N named serving variants behind one residency budget.

The single-model serving process keeps exactly one :class:`ServingEngine`
alive and hot-swaps it on reload (docs/DEPLOY.md). The multiplexing plane
generalizes that singleton into a *registry* of named variants — distinct
store generations, or cheap (bf16-cast) siblings of one generation — each
wrapped in its own engine + micro-batcher, with three properties the
singleton never needed (docs/MULTIPLEX.md):

- **shared staging residency** — every resident engine stages its
  flushes through ONE :class:`SharedStagingPool` (buffers are keyed by
  ``(bucket, width)`` — model-agnostic pinned bytes), so N resident
  variants cost ~one engine's worth of staging instead of N: residency
  scales sub-linearly, which is the whole economic argument for keeping
  more variants resident on the card (the μ-cuDNN precision/residency
  trade, PAPERS.md).
- **a residency budget with least-weighted eviction** — ``budget``
  bounds how many engines stay resident. Admitting one more (adopt or
  re-warm) demotes the least-weighted demotable variant back to its
  *cold manifest* (bundle path + metadata; engine, batcher, and captured
  graphs dropped, the graphs under the process-wide capture lock). A cold
  variant re-warms through the same build path the reload plane uses
  (``from_bundle`` against the registry's ladder and devices, a sync warmup
  that captures every (kind, bucket), ``export_gauge=False``) when its
  weight returns.
- **one lock for every cross-variant access** — ``lock`` guards the
  variant table. Every read of another generation's engine/batcher goes
  through it (or through the accessors here, which take it).

Routing weights live in the registry's :class:`~.splitter.WeightedSplitter`
(so eviction can ask "least-weighted" of the same numbers requests are
split by); ``route(key)`` resolves a request key to a (name, batcher)
pair among *resident, positively-weighted* variants, falling back past
cold ones (counted — a fallback is a residency-budget miss, the signal an
operator sizes the budget with).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from gan_deeplearning4j_tpu_torch.runtime.device import DeviceLike
from gan_deeplearning4j_tpu_torch.serving.batcher import MicroBatcher
from gan_deeplearning4j_tpu_torch.serving.engine import (
    DEFAULT_BUCKETS,
    _StagingBuf,
)
from gan_deeplearning4j_tpu_torch.serving.ladder import (
    SizeHistogram,
    manifest_histogram,
    manifest_ladder,
)
from gan_deeplearning4j_tpu_torch.serving.mux.splitter import WeightedSplitter
from gan_deeplearning4j_tpu_torch.telemetry.registry import get_registry
from gan_deeplearning4j_tpu_torch.telemetry.trace import TRACER

logger = logging.getLogger(__name__)

#: buffers kept per (bucket, width) key in the shared pool — the same
#: depth a single engine keeps privately; shared, it serves EVERY
#: resident variant (that is the sub-linear part)
_SHARED_POOL_LIMIT = 4

#: variant lifecycle states (mux_variant_state gauge exports the index)
STATES = ("cold", "warming", "resident", "failed")
_STATE_CODE = {name: i for i, name in enumerate(STATES)}


class SharedStagingPool:
    """One pinned-staging-buffer pool shared by every resident engine.

    Buffers are plain ``(bucket, width)`` float32 host tensors with a
    high-water zero tail (:class:`~..engine._StagingBuf`), pinned when
    ``pin`` (default: when a card is present) — nothing about them is
    model-specific, so variants of any generation and precision can
    recycle each other's. ``checkout``/``checkin`` mirror the engine's
    private pool API; the pool never blocks (an empty pool allocates)."""

    def __init__(self, per_key_limit: int = _SHARED_POOL_LIMIT,
                 pin: Optional[bool] = None):
        if per_key_limit < 1:
            raise ValueError("per_key_limit must be >= 1")
        if pin is None:
            pin = torch.cuda.is_available()
        self.pin = bool(pin)
        self._limit = per_key_limit
        self._lock = threading.Lock()
        self._pools: Dict[Tuple[int, int], List[_StagingBuf]] = {}
        self._allocated = 0

    def checkout(self, bucket: int, width: int) -> _StagingBuf:
        key = (int(bucket), int(width))
        with self._lock:
            pool = self._pools.get(key)
            if pool:
                return pool.pop()
            self._allocated += 1
        return _StagingBuf(key[0], key[1], pin=self.pin)

    def checkin(self, buf: _StagingBuf) -> None:
        key = (buf.arr.shape[0], buf.arr.shape[1])
        with self._lock:
            pool = self._pools.setdefault(key, [])
            if len(pool) < self._limit:
                pool.append(buf)

    def stats(self) -> dict:
        with self._lock:
            pooled = sum(len(p) for p in self._pools.values())
            pooled_bytes = sum(
                b.arr.nbytes for p in self._pools.values() for b in p)
            return {
                "allocated_total": self._allocated,
                "pooled": pooled,
                "pooled_bytes": pooled_bytes,
                "keys": len(self._pools),
            }


class MuxVariant:
    """One named serving variant: a cold manifest always, an engine +
    batcher only while resident. Mutated ONLY under the registry lock.

    ``cost`` — the number eviction and brownout rank by — prefers the
    MEASURED scalar (a ``quant/cost.py`` block: residency-rent
    GiB·s/kilorow profiled on the live ladder) and falls back to the
    operator-declared bootstrap value until one lands. ``cost_source``
    names which of the two is live (``measured``/``declared``) so
    dashboards can tell economics from guesswork."""

    __slots__ = ("name", "bundle_path", "declared_cost", "measured",
                 "generation", "state", "engine", "batcher", "last_error",
                 "added_at", "warmed_at", "histogram")

    def __init__(self, name: str, *, bundle_path: Optional[str],
                 cost: float, generation):
        self.name = name
        self.bundle_path = bundle_path
        self.declared_cost = float(cost)
        #: measured cost block (quant/cost.py schema) or None (bootstrap)
        self.measured: Optional[dict] = None
        self.generation = generation
        self.state = "cold"
        self.engine = None
        self.batcher = None
        self.last_error: Optional[str] = None
        self.added_at = time.time()
        self.warmed_at: Optional[float] = None
        # per-variant flush-size histogram (serving/ladder.py): owned
        # by the VARIANT, not the batcher, so learned traffic shape
        # survives demote/re-warm cycles; each residency's batcher
        # records straight into it
        self.histogram = SizeHistogram()

    @property
    def cost(self) -> float:
        if self.measured is not None:
            return float(self.measured["scalar"])
        return self.declared_cost

    @property
    def cost_source(self) -> str:
        return "measured" if self.measured is not None else "declared"

    def set_measured(self, block: Optional[dict]) -> None:
        """Adopt (or clear, with None) a measured cost block. The block
        must carry a positive ``scalar`` — a zero/negative measurement
        would silently game shed ordering."""
        if block is not None:
            scalar = block.get("scalar")
            if not isinstance(scalar, (int, float)) or scalar <= 0:
                raise ValueError(
                    f"measured cost block for {self.name!r} needs a "
                    f"positive 'scalar', got {scalar!r}")
        self.measured = dict(block) if block is not None else None

    def snapshot(self, weight: float) -> dict:
        engine = self.engine
        measured = self.measured
        return {
            "name": self.name,
            "state": self.state,
            "cost": self.cost,
            "cost_source": self.cost_source,
            "declared_cost": self.declared_cost,
            "measured_cost": (
                None if measured is None else float(measured["scalar"])),
            "resident_param_bytes": (
                None if measured is None
                else measured.get("resident_param_bytes")),
            "precision": (
                None if measured is None else measured.get("precision")),
            "weight": weight,
            "generation": self.generation,
            "bundle_path": self.bundle_path,
            "resident": self.state == "resident",
            "warm": bool(engine is not None and engine.warmed),
            # the ladder this residency captured (None while cold) and
            # how much traffic shape the variant has accumulated — the
            # learned-ladder observability pair (serving/ladder.py)
            "buckets": (None if engine is None
                        else list(getattr(engine, "buckets", ()) or ())
                        or None),
            "histogram_rows": self.histogram.total(),
            "last_error": self.last_error,
        }


class MuxRegistry:
    """The variant table + splitter + residency policy (module docstring).

    ``build`` is injectable for tests: ``(variant) -> engine``; the
    default loads ``ServingEngine.from_bundle`` against the registry's
    bucket ladder, replica count, ``device`` (the card unless the caller
    asks for the CPU) and ``devices`` (an explicit device pool, as
    ``runtime/device.py::resolve_devices`` takes it) with the shared
    staging pool attached.
    ``batcher_kwargs`` applies to every variant's
    :class:`MicroBatcher` (``max_batch`` defaults to the ladder top)."""

    def __init__(self, *, buckets: Sequence[int] = DEFAULT_BUCKETS,
                 replicas: int = 1, budget: int = 2,
                 batcher_kwargs: Optional[dict] = None,
                 build: Optional[Callable] = None,
                 staging_pool: Optional[SharedStagingPool] = None,
                 device: DeviceLike = None,
                 devices: Optional[Sequence[DeviceLike]] = None):
        if budget < 1:
            raise ValueError("residency budget must be >= 1")
        self.buckets = tuple(sorted(set(int(b) for b in buckets)))
        self.replicas = int(replicas)
        self.budget = int(budget)
        self.device = device
        self.devices = None if devices is None else tuple(devices)
        self.pool = staging_pool or SharedStagingPool()
        self.splitter = WeightedSplitter()
        self._build = build or self._default_build
        self._batcher_kwargs = dict(batcher_kwargs or {})
        # THE cross-generation lock: every access to the
        # variant table — and through it to another generation's engine
        # or batcher — holds it. RLock: accessors compose (snapshot()
        # calls primary_name() and such under one acquisition).
        self.lock = threading.RLock()
        self._variants: Dict[str, MuxVariant] = {}
        self.events: List[dict] = []
        registry = get_registry()
        self._g_resident = registry.gauge(
            "mux_variants_resident",
            "engines currently resident in the mux registry")
        self._g_weight = registry.gauge(
            "mux_variant_weight",
            "live routing weight per variant (0 = no new traffic)",
            labelnames=("model",))
        self._g_state = registry.gauge(
            "mux_variant_state",
            "variant lifecycle: 0=cold 1=warming 2=resident 3=failed",
            labelnames=("model",))
        self._c_evictions = registry.counter(
            "mux_evictions_total",
            "variants demoted from resident engines to cold manifests by "
            "the residency budget", labelnames=("model",))
        self._c_warmups = registry.counter(
            "mux_warmups_total",
            "engine builds (adopt or cold re-warm) per variant",
            labelnames=("model",))
        self._c_fallbacks = registry.counter(
            "mux_route_fallbacks_total",
            "requests whose assigned variant was not resident and fell "
            "back to the resident pool (residency-budget misses)")
        self._g_cost = registry.gauge(
            "mux_variant_cost",
            "the cost eviction/brownout rank by (measured scalar when "
            "one landed, declared bootstrap otherwise)",
            labelnames=("model",))
        self._g_cost_source = registry.gauge(
            "mux_variant_cost_source",
            "1 = cost is a live-ladder measurement (quant/cost.py), "
            "0 = operator-declared bootstrap", labelnames=("model",))
        self._g_resident_bytes = registry.gauge(
            "mux_variant_resident_param_bytes",
            "measured device bytes one replica of the variant's params "
            "pins (0 until measured)", labelnames=("model",))

    # -- builds (the reloader's path, shared-pool edition) ----------------
    def build_engine(self, bundle_path: str,
                     fallback_buckets: Optional[Sequence[int]] = None):
        """THE build recipe for this registry's engines — the variant's
        own LEARNED ladder when its bundle manifest carries one
        (serving/ladder.py; each variant's traffic shapes its own
        buckets), else ``fallback_buckets`` (the reload plane passes a
        ladder solved from the incumbent's histogram), else the registry
        default; replica count, devices and the shared staging pool always. The
        registry-mode reload plane builds its candidates through this
        too, so adopted and re-warmed engines can never diverge in
        config."""
        from gan_deeplearning4j_tpu_torch.serving.engine import ServingEngine

        return ServingEngine.from_bundle(
            bundle_path,
            buckets=(manifest_ladder(bundle_path) or fallback_buckets
                     or self.buckets),
            replicas=self.replicas,
            device=self.device,
            devices=self.devices,
            export_gauge=False,
            staging_pool=self.pool,
        )

    def _default_build(self, variant: MuxVariant):
        if variant.bundle_path is None:
            raise ValueError(
                f"variant {variant.name!r} has no bundle manifest to "
                f"build from")
        return self.build_engine(variant.bundle_path)

    def _make_batcher(self, engine,
                      variant: Optional[MuxVariant] = None) -> MicroBatcher:
        kwargs = dict(self._batcher_kwargs)
        # the ENGINE's ladder top, not the registry default: a variant
        # warmed on its own learned ladder must batch to ITS top bucket
        # (registry default when the engine carries no ladder)
        ladder = getattr(engine, "buckets", None) or self.buckets
        kwargs.setdefault("max_batch", ladder[-1])
        if variant is not None:
            kwargs.setdefault("size_histogram", variant.histogram)
        return MicroBatcher(engine=engine, **kwargs)

    # -- variant management ----------------------------------------------
    def add(self, name: str, *, bundle_path: Optional[str] = None,
            engine=None, cost: float = 1.0, weight: float = 0.0,
            generation=None) -> MuxVariant:
        """Register a variant. With ``engine`` (already built + warmed —
        the adopt path) it becomes resident immediately; with only a
        ``bundle_path`` it stays a cold manifest until its weight asks
        for residency. ``cost`` is the DECLARED relative serve cost (bf16
        sibling < fp32 original) — a bootstrap default: when the bundle's
        manifest carries a measured ``cost`` block (quant/cost.py), the
        measurement is adopted immediately and eviction + brownout rank
        by it instead — highest cost sheds first (docs/MULTIPLEX.md,
        docs/QUANT.md)."""
        if bundle_path is None and engine is None:
            raise ValueError("a variant needs a bundle_path or an engine")
        if cost <= 0:
            raise ValueError("cost must be > 0")
        name = str(name)
        if generation is None and engine is not None:
            generation = engine.generation
        variant = MuxVariant(name, bundle_path=bundle_path, cost=cost,
                             generation=generation)
        if bundle_path is not None:
            from gan_deeplearning4j_tpu_torch.quant.cost import manifest_cost

            block = manifest_cost(bundle_path)
            if block is not None:
                variant.set_measured(block)
            # boot the variant's live histogram from the traffic shape
            # persisted with its bundle (serving/ladder.py), so learning
            # compounds across generations instead of restarting cold
            persisted = manifest_histogram(bundle_path)
            if persisted:
                variant.histogram.merge(persisted)
        with self.lock:
            if name in self._variants:
                raise ValueError(f"variant {name!r} already registered")
            self._variants[name] = variant
            if engine is not None:
                self._attach_locked(variant, engine)
        self.splitter.set_weight(name, weight)
        self._g_weight.labels(model=name).set(float(weight))
        self._export_cost_gauges(variant)
        if engine is not None:
            self._enforce_budget(protect=name)
        elif weight > 0.0:
            self.ensure_resident(name)
        return variant

    def adopt(self, name: str, engine, *, bundle_path: Optional[str] = None,
              cost: float = 1.0, weight: float = 0.0,
              generation=None) -> MuxVariant:
        """The reload plane's entry point (docs/DEPLOY.md): a newly
        warmed candidate engine joins the registry as a variant —
        typically at weight 0, ready for a ramp — instead of replacing a
        singleton. The residency budget applies immediately. The
        incumbent primary's flush-size histogram is folded into the
        newcomer's (on top of anything its bundle manifest persisted),
        so the generation that will inherit the traffic also inherits
        its learned shape."""
        incumbent = self.primary_name()
        variant = self.add(name, bundle_path=bundle_path, engine=engine,
                           cost=cost, weight=weight, generation=generation)
        if incumbent is not None and incumbent != name:
            with self.lock:
                prior = self._variants.get(incumbent)
                seed = prior.histogram.snapshot() if prior else None
            if seed:
                variant.histogram.merge(seed)
        with self.lock:
            self.events.append({"event": "adopt", "variant": name,
                                "generation": variant.generation})
        return variant

    def remove(self, name: str) -> None:
        """Drop a variant entirely (demoting it first when resident)."""
        self.demote(name)
        with self.lock:
            self._variants.pop(name, None)
        self.splitter.remove(name)

    def _attach_locked(self, variant: MuxVariant, engine) -> None:
        variant.engine = engine
        variant.batcher = self._make_batcher(engine, variant)
        variant.state = "resident"
        variant.warmed_at = time.time()
        variant.last_error = None
        if variant.generation is None:
            variant.generation = engine.generation
        self._g_state.labels(model=variant.name).set(
            _STATE_CODE["resident"])
        self._g_resident.set(
            sum(1 for v in self._variants.values()
                if v.state == "resident"))

    # -- residency --------------------------------------------------------
    def ensure_resident(self, name: str) -> MuxVariant:
        """Re-warm a cold variant through the reloader-style build path:
        engine from the cold manifest against the registry ladder +
        shared pool, sync warmup (every (kind, bucket) captured), then
        attach. The (multi-second)
        build runs OUTSIDE the lock — routing to other variants never
        stalls behind a warmup."""
        with self.lock:
            variant = self._variants[name]
            if variant.state == "resident":
                return variant
            if variant.state == "warming":
                raise RuntimeError(f"variant {name!r} is already warming")
            variant.state = "warming"
        self._g_state.labels(model=name).set(_STATE_CODE["warming"])
        try:
            with TRACER.span("mux.warm", variant=name):
                engine = self._build(variant)
                engine.warmup()
            self._c_warmups.labels(model=name).inc()
        except Exception as exc:
            with self.lock:
                variant.state = "failed"
                variant.last_error = f"{type(exc).__name__}: {exc}"
            self._g_state.labels(model=name).set(_STATE_CODE["failed"])
            raise
        with self.lock:
            self._attach_locked(variant, engine)
            self.events.append({"event": "warm", "variant": name,
                                "generation": variant.generation})
        self._enforce_budget(protect=name)
        return variant

    def demote(self, name: str) -> bool:
        """Resident → cold manifest: detach engine + batcher under the
        lock, then drain/close the batcher and drop the engine and its
        graphs outside it (in-flight requests finish on the detached
        pair; new route() calls no longer see the variant). False when
        not resident."""
        with self.lock:
            variant = self._variants.get(name)
            if variant is None or variant.state != "resident":
                return False
            batcher, engine = variant.batcher, variant.engine
            variant.batcher = None
            variant.engine = None
            variant.state = "cold"
            self.events.append({"event": "demote", "variant": name,
                                "generation": variant.generation})
            self._g_resident.set(
                sum(1 for v in self._variants.values()
                    if v.state == "resident"))
        self._g_state.labels(model=name).set(_STATE_CODE["cold"])
        if batcher is not None:
            batcher.close(drain=True)
        if engine is not None and hasattr(engine, "close"):
            # the graphs go under the process-wide capture lock
            engine.close()
        del engine  # device params released with it
        return True

    def _enforce_budget(self, protect: Optional[str] = None) -> None:
        """Demote least-weighted demotable residents until the count fits
        the budget. ``protect`` exempts the variant just admitted (the
        newcomer must not evict itself). A variant with no cold manifest
        (engine-only, nothing to re-warm from) is never demoted."""
        while True:
            weights = self.splitter.weights()
            with self.lock:
                residents = [v for v in self._variants.values()
                             if v.state == "resident"]
                if len(residents) <= self.budget:
                    return
                demotable = [
                    v for v in residents
                    if v.bundle_path is not None and v.name != protect]
                if not demotable:
                    return  # over budget but nothing safely demotable
                victim = min(
                    demotable,
                    key=lambda v: (weights.get(v.name, 0.0), -v.cost,
                                   v.name))
                victim_name = victim.name
            self._c_evictions.labels(model=victim_name).inc()
            self.demote(victim_name)

    # -- measured cost ------------------------------------------------------
    def _export_cost_gauges(self, variant: MuxVariant) -> None:
        measured = variant.measured
        self._g_cost.labels(model=variant.name).set(variant.cost)
        self._g_cost_source.labels(model=variant.name).set(
            1.0 if measured is not None else 0.0)
        self._g_resident_bytes.labels(model=variant.name).set(
            float(measured.get("resident_param_bytes") or 0)
            if measured is not None else 0.0)

    def set_measured_cost(self, name: str, block: dict) -> None:
        """Land a live-ladder measurement (quant/cost.py block) on a
        registered variant: ``cost`` flips from the declared bootstrap to
        the measured scalar, and every ranking that reads ``costs()`` —
        residency eviction, brownout shed order — follows on its next
        decision. Recorded in the event log (drills assert on it)."""
        with self.lock:
            variant = self._variants[name]
            variant.set_measured(block)
            self.events.append({
                "event": "cost_measured", "variant": name,
                "scalar": variant.cost,
                "resident_param_bytes": block.get("resident_param_bytes"),
            })
        self._export_cost_gauges(variant)

    # -- weights ----------------------------------------------------------
    def set_weight(self, name: str, weight: float,
                   warm: bool = True) -> None:
        """Live weight update. Raising a cold variant's weight above 0
        re-warms it first (``warm=False`` skips that — the caller will
        warm explicitly), so traffic is never assigned to a variant that
        cannot serve it without a fallback."""
        with self.lock:
            variant = self._variants[name]
            state = variant.state
        if weight > 0.0 and state == "cold" and warm:
            self.ensure_resident(name)
        self.splitter.set_weight(name, weight)
        self._g_weight.labels(model=name).set(float(weight))

    def set_weights(self, weights: Dict[str, float],
                    warm: bool = True) -> None:
        """Atomic multi-variant weight transition (one splitter lock —
        a ramp step is never observed half-applied). The weights land
        FIRST, then any cold variant gaining weight is re-warmed
        best-effort: a ramp rollback must restore the incumbents'
        traffic shares immediately even when one of them was
        budget-evicted mid-ramp and its multi-second re-warm (or a
        failing one) would otherwise delay — or worse, skip — the
        restore. Until the warm lands, that variant's keys take the
        counted fallback path (``mux_route_fallbacks_total``)."""
        self.splitter.set_weights(weights)
        for name, weight in weights.items():
            self._g_weight.labels(model=name).set(float(weight))
        if not warm:
            return
        with self.lock:
            cold = [n for n, w in weights.items()
                    if w > 0.0 and n in self._variants
                    and self._variants[n].state == "cold"]
        for name in cold:
            try:
                self.ensure_resident(name)
            except Exception:
                # the variant stays failed/cold and its traffic falls
                # back to the resident pool — degraded but serving,
                # never a lost weight transition
                logger.exception("re-warm of weighted variant %r failed",
                                 name)

    # -- routing ----------------------------------------------------------
    def route(self, key: str) -> Tuple[str, MicroBatcher]:
        """Resolve a request key to (variant name, its batcher) among
        resident, positively-weighted variants. When the key's
        *unrestricted* assignment names a non-resident variant, the
        request falls back to the resident pool by the same rendezvous
        order and the miss is counted (``mux_route_fallbacks_total``)."""
        weights = self.splitter.weights()
        with self.lock:
            resident = [n for n, v in self._variants.items()
                        if v.state == "resident"
                        and weights.get(n, 0.0) > 0.0]
            if not resident:
                raise LookupError(
                    "no resident variant carries positive weight")
            name = self.splitter.assign(key, among=resident)
            if any(w > 0.0 and n not in resident
                   for n, w in weights.items()):
                if self.splitter.assign(key) != name:
                    self._c_fallbacks.inc()
            return name, self._variants[name].batcher

    # -- accessors (all take the lock) -------------------------------------
    def names(self) -> List[str]:
        with self.lock:
            return list(self._variants)

    def resident_names(self) -> List[str]:
        with self.lock:
            return [n for n, v in self._variants.items()
                    if v.state == "resident"]

    def engine_for(self, name: str):
        with self.lock:
            return self._variants[name].engine

    def batcher_for(self, name: str) -> Optional[MicroBatcher]:
        with self.lock:
            return self._variants[name].batcher

    def variant(self, name: str) -> MuxVariant:
        with self.lock:
            return self._variants[name]

    def generations(self) -> Dict[str, object]:
        with self.lock:
            return {n: v.generation for n, v in self._variants.items()}

    def max_generation(self) -> Optional[int]:
        """The newest store generation any variant carries — what the
        registry-mode reload watcher polls against (docs/DEPLOY.md)."""
        with self.lock:
            gens = [v.generation for v in self._variants.values()
                    if isinstance(v.generation, int)]
        return max(gens) if gens else None

    def primary_name(self) -> Optional[str]:
        """The highest-weighted resident variant — the reload plane's
        incumbent for compatibility checks and canary probes."""
        weights = self.splitter.weights()
        with self.lock:
            residents = [n for n, v in self._variants.items()
                         if v.state == "resident"]
        if not residents:
            return None
        return max(residents, key=lambda n: (weights.get(n, 0.0), n))

    def reference_engine(self):
        name = self.primary_name()
        return None if name is None else self.engine_for(name)

    def costs(self) -> Dict[str, float]:
        with self.lock:
            return {n: v.cost for n, v in self._variants.items()}

    def cost_sources(self) -> Dict[str, str]:
        """Per-variant provenance of the ranking number —
        ``measured`` (live-ladder block) or ``declared`` (bootstrap)."""
        with self.lock:
            return {n: v.cost_source for n, v in self._variants.items()}

    def snapshot(self) -> dict:
        weights = self.splitter.weights()
        with self.lock:
            variants = {n: v.snapshot(weights.get(n, 0.0))
                        for n, v in self._variants.items()}
            resident = sum(1 for v in self._variants.values()
                           if v.state == "resident")
        return {
            "variants": variants,
            "resident": resident,
            "budget": self.budget,
            "buckets": list(self.buckets),
            "replicas": self.replicas,
            "shares": self.splitter.shares(),
            "staging_pool": self.pool.stats(),
        }

    def close(self) -> None:
        """Demote everything (drains every batcher) — shutdown path."""
        for name in self.resident_names():
            self.demote(name)
