"""deploy/ of the PyTorch port — counterpart of
``gan_deeplearning4j_tpu/deploy/``: zero-downtime generation reload, the
train→serve loop closed.

- :mod:`.watcher` — polls a checkpoint store (``resilience/store.py``) or a
  bare bundle directory for a newer digest-valid serving generation,
  quarantining corrupt generations and skipping them;
- :mod:`.canary` — the quality bar every candidate bundle (a retrained
  generation, or a bf16 / int8 variant) must clear against the incumbent;
- :mod:`.reloader` — builds the candidate engine off-thread, warms it (on
  the card: captures every (kind, bucket) graph) against the live engine's
  ladder and device, canaries it, then swaps it in under the batcher (or,
  in mux mode, adopts it into a ``serving.mux.MuxRegistry``), with zero
  requests shed or lost;
- ``python -m gan_deeplearning4j_tpu_torch.deploy probe`` — one bundle's
  quality probe in its own process.

The namespace is lazy (PEP 562): importing it imports no ``torch``, so a
process that only decides (the fleet's router and manager) needs none.
"""

# name -> the module it is imported from on first use
_LAZY_EXPORTS = {
    "CanaryDecision": "gan_deeplearning4j_tpu_torch.deploy.canary",
    "CanaryGate": "gan_deeplearning4j_tpu_torch.deploy.canary",
    "CanaryThresholds": "gan_deeplearning4j_tpu_torch.deploy.canary",
    "classifier_from_bundle": "gan_deeplearning4j_tpu_torch.deploy.canary",
    "compare_probes": "gan_deeplearning4j_tpu_torch.deploy.canary",
    "feature_fn_from_checkpoint": "gan_deeplearning4j_tpu_torch.deploy.canary",
    "STATES": "gan_deeplearning4j_tpu_torch.deploy.reloader",
    "ReloadBusy": "gan_deeplearning4j_tpu_torch.deploy.reloader",
    "ReloadController": "gan_deeplearning4j_tpu_torch.deploy.reloader",
    "BundleCandidate": "gan_deeplearning4j_tpu_torch.deploy.watcher",
    "StoreWatcher": "gan_deeplearning4j_tpu_torch.deploy.watcher",
}

__all__ = [
    "BundleCandidate",
    "CanaryDecision",
    "CanaryGate",
    "CanaryThresholds",
    "ReloadBusy",
    "ReloadController",
    "STATES",
    "StoreWatcher",
    "classifier_from_bundle",
    "compare_probes",
    "feature_fn_from_checkpoint",
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
