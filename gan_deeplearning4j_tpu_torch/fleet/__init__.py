"""fleet/ of the PyTorch port — counterpart of ``gan_deeplearning4j_tpu/fleet``:
fault-tolerant multi-process serving.

The reload plane makes one serving process survive model updates; this
package makes the serving PLANE survive processes. One stdlib router
fronts N worker processes (each a ``python -m
gan_deeplearning4j_tpu_torch.serving`` instance on the card),
and three cooperating pieces keep every submitted request answered
exactly once while workers die, hang, warm, and upgrade underneath it —
the fault-tolerance-as-design-axis argument of the TensorFlow system
paper (PAPERS.md), applied to the serve side:

- :mod:`.router` — power-of-two-choices proxying over scraped worker
  ``/metrics``, per-request timeouts, and a token-bucket retry budget
  (shed/connect-failed attempts retry on a different worker with
  exponential backoff + jitter; an exhausted budget answers an honest
  503, never a retry storm);
- :mod:`.health` — active ``/healthz`` probing plus passive outlier
  ejection: consecutive failures or a windowed error rate trip a
  per-worker circuit breaker (ejected → half-open → one probe →
  re-admitted), so a SIGKILLed, hung, warming, or draining worker leaves
  and rejoins the pool without operator action;
- :mod:`.manager` — process lifecycle: spawn from a shared checkpoint
  store, relaunch on death (spawn failures back off, never a hot loop),
  force-restart on hang, **draining restarts** (unroute → drain via
  ``/metrics`` → SIGTERM → relaunch → re-admit warm), and rolling
  generation upgrades admitted by ONE fleet-level canary decision
  (sidecar probes + ``deploy.compare_probes``), with halt-and-quarantine
  on regression;
- :mod:`.autoscaler` — the SLO-driven elastic control loop: resize the
  fleet between min and max against burn-rate/queue/occupancy signals
  (hysteresis + cooldowns, fail-closed holds on missing data), scale
  down only through the drain path, and at max size under sustained
  overload enter tiered **brownout** admission control at the router
  instead of falling over.

``python -m gan_deeplearning4j_tpu_torch.fleet`` runs the whole plane;
``python -m gan_deeplearning4j_tpu_torch.fleet.drill`` proves the
invariants against real faults. Every module is the JAX file with its
imports rewritten; :mod:`.manager` and the CLI name their adaptations (the
workers' ``--device``, no compilation cache, the cycle claim). Architecture
notes: the JAX package's docs/FLEET.md.
"""

from gan_deeplearning4j_tpu_torch.fleet.autoscaler import (
    Autoscaler,
    AutoscalerConfig,
)
from gan_deeplearning4j_tpu_torch.fleet.health import (
    ADMITTABLE,
    CircuitBreaker,
    probe_worker,
)
from gan_deeplearning4j_tpu_torch.fleet.manager import (
    FleetManager,
    WorkerProcess,
    WorkerSlot,
)
from gan_deeplearning4j_tpu_torch.fleet.router import (
    FleetRouter,
    NoWorkerAvailable,
    RetryBudget,
    WorkerRef,
    make_router_server,
    scrape_metrics,
)

__all__ = [
    "ADMITTABLE",
    "Autoscaler",
    "AutoscalerConfig",
    "CircuitBreaker",
    "FleetManager",
    "FleetRouter",
    "NoWorkerAvailable",
    "RetryBudget",
    "WorkerProcess",
    "WorkerRef",
    "WorkerSlot",
    "make_router_server",
    "probe_worker",
    "scrape_metrics",
]
