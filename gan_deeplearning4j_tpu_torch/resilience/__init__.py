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

The serving side of the operations planes lives beside it:
``fleet/`` (router, health, autoscaler, manager, the fleet CLI and its
drill) and ``deploy/drill.py`` (the reload drill).

The namespace is lazy (PEP 562): importing it imports no ``torch``, so
the store and its watchers load without it (the fleet's router process).
"""

# name -> the module it is imported from on first use
_LAZY_EXPORTS = {
    "FaultInjector": "gan_deeplearning4j_tpu_torch.resilience.faults",
    "FaultSchedule": "gan_deeplearning4j_tpu_torch.resilience.faults",
    "FaultSpec": "gan_deeplearning4j_tpu_torch.resilience.faults",
    "InjectedFault": "gan_deeplearning4j_tpu_torch.resilience.faults",
    "corrupt_generation": "gan_deeplearning4j_tpu_torch.resilience.faults",
    "MeshCoordinator": "gan_deeplearning4j_tpu_torch.resilience.mesh",
    "MeshProtocolError": "gan_deeplearning4j_tpu_torch.resilience.mesh",
    "MeshTimeout": "gan_deeplearning4j_tpu_torch.resilience.mesh",
    "mesh_digest": "gan_deeplearning4j_tpu_torch.resilience.mesh",
    "CheckpointStore": "gan_deeplearning4j_tpu_torch.resilience.store",
    "Generation": "gan_deeplearning4j_tpu_torch.resilience.store",
    "gen_dirname": "gan_deeplearning4j_tpu_torch.resilience.store",
    "tree_digest": "gan_deeplearning4j_tpu_torch.resilience.store",
    "RetryBudgetExceeded": "gan_deeplearning4j_tpu_torch.resilience.supervisor",
    "SupervisorConfig": "gan_deeplearning4j_tpu_torch.resilience.supervisor",
    "TrainingSupervisor": "gan_deeplearning4j_tpu_torch.resilience.supervisor",
    "UnsupportedExperimentError": "gan_deeplearning4j_tpu_torch.resilience.supervisor",
}

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


def __getattr__(name):
    try:
        module_name = _LAZY_EXPORTS[name]
    except KeyError:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}") from None
    import importlib

    value = getattr(importlib.import_module(module_name), name)
    globals()[name] = value  # cached: __getattr__ runs once per name
    return value


def __dir__():
    return sorted({*globals(), *_LAZY_EXPORTS})
