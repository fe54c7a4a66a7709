"""Canary gate — counterpart of ``gan_deeplearning4j_tpu/deploy/canary.py``:
a candidate engine proves its quality against the incumbent before it
serves.

It runs the seeded quality probe (``eval/quality.py::quality_probe``, the
port's copy of the reference's) on a fixed batch against both engines and
admits the candidate only when its numbers hold up relative to the
incumbent's:

- **FID**: the Fréchet distance between the candidate's seeded samples and
  the real rows (raw-row features by default; ``feature_fn`` for another
  space, e.g. ``eval.fid.frozen_feature_fn`` or
  :func:`feature_fn_from_checkpoint`'s dis-feature space). Gate:
  ``candidate_fid <= incumbent_fid × fid_ratio_max + fid_slack``;
- **classifier accuracy** on labelled real rows. Gate:
  ``candidate_acc >= incumbent_acc - accuracy_drop_max``. Skipped when the
  bundle serves no classifier or no labels were given.

A quantized variant is admitted the same way: the quantization loss must
stay inside the same relative bars. The incumbent's probe is cached per
(engine, generation). Conditional zoo bundles (a class one-hot beside z)
wait for ROADMAP.md queue 1, 'Class conditioning', as the engine refuses
them.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Callable, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class CanaryThresholds:
    """Relative quality bars (module docstring)."""

    fid_ratio_max: float = 1.5
    fid_slack: float = 10.0
    accuracy_drop_max: float = 0.05


@dataclasses.dataclass
class CanaryDecision:
    """Outcome of one gate evaluation, with both probes for the record."""

    passed: bool
    reason: str
    candidate: dict
    incumbent: dict


def compare_probes(candidate: dict, incumbent: dict,
                   thresholds: Optional[CanaryThresholds] = None) -> CanaryDecision:
    """The admission decision on two measured probes
    (``{"fid": float, "accuracy": float | None}``)."""
    t = thresholds or CanaryThresholds()
    failures = []
    fid_limit = incumbent["fid"] * t.fid_ratio_max + t.fid_slack
    # not-<=, so that a NaN probe (degenerate samples) fails the gate
    if not (candidate["fid"] <= fid_limit):
        failures.append(
            f"fid {candidate['fid']:.4g} exceeds limit {fid_limit:.4g} "
            f"(incumbent {incumbent['fid']:.4g} × {t.fid_ratio_max} + {t.fid_slack})")
    if candidate.get("accuracy") is not None and incumbent.get("accuracy") is not None:
        floor = incumbent["accuracy"] - t.accuracy_drop_max
        if not (candidate["accuracy"] >= floor):
            failures.append(
                f"accuracy {candidate['accuracy']:.4f} below floor {floor:.4f} "
                f"(incumbent {incumbent['accuracy']:.4f} - {t.accuracy_drop_max})")
    return CanaryDecision(passed=not failures, reason="; ".join(failures) if failures else "ok",
                          candidate=candidate, incumbent=incumbent)


def feature_fn_from_checkpoint(classifier_path: str, vertex: str, batch_size: int = 500,
                               device=None):
    """Rows → activations at ``vertex`` of the checkpointed classifier (the
    dis-feature space), on ``device`` (the card unless the caller asks for
    the CPU). The weights are pinned at load, so candidate and incumbent
    are embedded in the same space."""
    from gan_deeplearning4j_tpu_torch.eval.fid import graph_feature_fn
    from gan_deeplearning4j_tpu_torch.utils.serializer import read_model

    graph, params, _, _ = read_model(classifier_path, load_updater=False, device=device)
    if vertex not in {v.name for v in graph.vertices}:
        raise ValueError(f"feature vertex {vertex!r} is not a vertex of the classifier graph")
    return graph_feature_fn(graph, params, vertex, batch_size=batch_size)


def classifier_from_bundle(directory: str) -> Optional[Tuple[str, str]]:
    """(classifier checkpoint path, feature vertex) from a bundle's
    ``serving.json``, or None when the bundle serves no dis-feature space."""
    with open(os.path.join(directory, "serving.json")) as fh:
        manifest = json.load(fh)
    name = manifest.get("classifier")
    vertex = manifest.get("feature_vertex")
    if name and vertex:
        return os.path.join(directory, name), vertex
    return None


class CanaryGate:
    """Probes engines with a fixed seeded batch and compares candidate with
    incumbent under :class:`CanaryThresholds`.

    ``features``/``labels`` are the real evaluation rows (labels optional:
    accuracy is then skipped). ``probe`` is injectable: any
    ``engine -> {"fid": float, "accuracy": float | None}``; the default runs
    :func:`~gan_deeplearning4j_tpu_torch.eval.quality.quality_probe`.
    ``dataset``, when set, rejects without probing a candidate whose
    manifest declares another zoo dataset."""

    def __init__(self, features, labels=None, *, num_samples: int = 256, seed: int = 666,
                 feature_fn=None, thresholds: Optional[CanaryThresholds] = None,
                 probe: Optional[Callable] = None, dataset: Optional[str] = None):
        self.features = np.asarray(features, dtype=np.float32)
        if self.features.ndim != 2 or self.features.shape[0] < 2:
            raise ValueError(f"canary needs (n >= 2, d) real rows, got {self.features.shape}")
        self.labels = None if labels is None else np.asarray(labels)
        self.dataset = dataset
        self.num_samples = int(num_samples)
        if self.num_samples < 2:
            raise ValueError("num_samples must be >= 2 (covariance fit)")
        self.seed = seed
        self.feature_fn = feature_fn
        self.thresholds = thresholds or CanaryThresholds()
        self._probe = probe
        # (engine, generation) -> probe; the strong ref keeps the engine's
        # id from being recycled
        self._incumbent_cache = None

    def probe(self, engine) -> dict:
        """One deterministic probe of ``engine``: the seeded z batch through
        ``run("sample")``, the labelled rows through ``run("classify")``
        when it serves one."""
        from gan_deeplearning4j_tpu_torch.eval.quality import quality_probe

        if self._probe is not None:
            return self._probe(engine)
        classify_fn = None
        if "classify" in engine.kinds and self.labels is not None:
            classify_fn = lambda rows: engine.run("classify", rows)  # noqa: E731
        return quality_probe(
            lambda z: engine.run("sample", z),
            self.features,
            z_size=engine.input_width("sample"),
            num_samples=self.num_samples,
            seed=self.seed,
            classify_fn=classify_fn,
            labels=self.labels,
            feature_fn=self.feature_fn,
        )

    def _incumbent_probe(self, incumbent) -> dict:
        key = (incumbent, getattr(incumbent, "generation", None))
        if self._incumbent_cache is not None and self._incumbent_cache[0] == key:
            return self._incumbent_cache[1]
        result = self.probe(incumbent)
        self._incumbent_cache = (key, result)
        return result

    def dataset_mismatch(self, engine) -> Optional[str]:
        """The rejection reason when ``engine``'s manifest declares a zoo
        dataset other than this gate's real rows, else None."""
        if self.dataset is None:
            return None
        scenario = getattr(engine, "scenario", None)
        declared = scenario.get("dataset") if scenario else None
        if declared is not None and declared != self.dataset:
            return (f"candidate bundle trains dataset {declared!r} but the gate's real rows "
                    f"are {self.dataset!r} — refusing to FID-score across datasets")
        return None

    def evaluate(self, candidate, incumbent) -> CanaryDecision:
        """Admit or reject ``candidate`` relative to ``incumbent``. An
        admitted candidate becomes the cached incumbent."""
        mismatch = self.dataset_mismatch(candidate)
        if mismatch is not None:
            return CanaryDecision(passed=False, reason=mismatch, candidate={}, incumbent={})
        inc = self._incumbent_probe(incumbent)
        cand = self.probe(candidate)
        decision = compare_probes(cand, inc, self.thresholds)
        if decision.passed:
            self._incumbent_cache = ((candidate, getattr(candidate, "generation", None)), cand)
        return decision
