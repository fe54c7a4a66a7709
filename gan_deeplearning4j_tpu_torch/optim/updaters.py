"""Updater specs — counterpart of ``gan_deeplearning4j_tpu/optim/updaters.py``,
for now only as configuration: the dataclasses, ``with_learning_rate``
(transfer learning freezes a layer with LR 0.0) and ``to_dict`` /
``updater_from_dict``, so that ``topology.json`` round-trips between the
two packages. The update rules (DL4J RmsProp with its cache starting at
eps, Adam) wait for the training slices (ROADMAP.md queue 1, Slice B).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class UpdaterSpec:
    learning_rate: float = 0.0

    @property
    def kind(self) -> str:
        return type(self).__name__.lower()

    def with_learning_rate(self, lr: float) -> "UpdaterSpec":
        return dataclasses.replace(self, learning_rate=lr)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["type"] = self.kind
        return d


@dataclasses.dataclass(frozen=True)
class Sgd(UpdaterSpec):
    learning_rate: float = 0.01


@dataclasses.dataclass(frozen=True)
class NoOp(UpdaterSpec):
    """Never updates (hard-freeze alternative to lr=0)."""


@dataclasses.dataclass(frozen=True)
class RmsProp(UpdaterSpec):
    """DL4J RmsPropUpdater. Reference config: RmsProp(lr, 1e-8, 1e-8)."""

    learning_rate: float = 0.001
    rms_decay: float = 0.95
    epsilon: float = 1e-8


@dataclasses.dataclass(frozen=True)
class Adam(UpdaterSpec):
    learning_rate: float = 0.001
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8


def updater_from_dict(d: dict) -> UpdaterSpec:
    d = dict(d)
    kind = d.pop("type")
    classes = {"sgd": Sgd, "noop": NoOp, "rmsprop": RmsProp, "adam": Adam}
    if kind not in classes:
        raise KeyError(f"unknown updater type {kind!r}")
    return classes[kind](**d)
