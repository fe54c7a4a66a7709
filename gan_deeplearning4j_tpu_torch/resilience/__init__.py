"""resilience/ of the PyTorch port — counterpart of
``gan_deeplearning4j_tpu/resilience``: fault-tolerant training for
preemptible workers.

- :mod:`.store` — the generation-ledgered checkpoint store (temp + fsync +
  atomic rename, per-file digests, quarantine, retention GC); a store
  either package writes reads in the other;
- :mod:`.supervisor` — runs ``GanExperiment`` in resumable segments:
  restores from the newest valid generation, retries worker faults with
  bounded backoff, honours SIGTERM preemption at a step boundary, and
  resumes bit-exactly;
- :mod:`.mesh` — the multi-worker coordinated checkpoint: N workers stage
  their shards, worker 0 two-phase-commits the generation, and a
  generation written by M workers restores onto N;
- :mod:`.faults` — the seeded fault-injection plane the drill and the
  tests drive;
- ``python -m gan_deeplearning4j_tpu_torch.resilience`` — the supervised
  worker CLI, and ``python -m gan_deeplearning4j_tpu_torch.resilience.drill``
  — the drill that kills, relaunches and corrupts it.

Still to port: the fleet and the fleet and reload drills (ROADMAP.md
queue 1, 'The operations planes').
"""

from gan_deeplearning4j_tpu_torch.resilience.faults import (
    FaultInjector,
    FaultSchedule,
    FaultSpec,
    InjectedFault,
    corrupt_generation,
)
from gan_deeplearning4j_tpu_torch.resilience.mesh import (
    MeshCoordinator,
    MeshProtocolError,
    MeshTimeout,
    mesh_digest,
)
from gan_deeplearning4j_tpu_torch.resilience.store import (
    CheckpointStore,
    Generation,
    gen_dirname,
    tree_digest,
)
from gan_deeplearning4j_tpu_torch.resilience.supervisor import (
    RetryBudgetExceeded,
    SupervisorConfig,
    TrainingSupervisor,
    UnsupportedExperimentError,
)

__all__ = [
    "CheckpointStore",
    "Generation",
    "gen_dirname",
    "MeshCoordinator",
    "MeshProtocolError",
    "MeshTimeout",
    "mesh_digest",
    "tree_digest",
    "FaultInjector",
    "FaultSchedule",
    "FaultSpec",
    "InjectedFault",
    "corrupt_generation",
    "RetryBudgetExceeded",
    "SupervisorConfig",
    "TrainingSupervisor",
    "UnsupportedExperimentError",
]
