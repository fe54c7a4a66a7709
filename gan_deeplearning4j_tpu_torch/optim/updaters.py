"""Updater specs and update rules — counterpart of
``gan_deeplearning4j_tpu/optim/updaters.py``.

``RmsProp(lr, rmsDecay, epsilon)`` is DL4J's RmsPropUpdater:

    cache ← cache · decay + g² · (1 - decay)      (cache starts at eps)
    Δ     = g · lr / sqrt(cache + eps)

The reference runs it with decay = eps = 1e-8, so the cache is about g²
and the update about ``lr·sign(g)``. ``torch.optim.RMSprop`` starts its
cache at zero and adds eps outside the square root: a different optimizer
at these settings, so it is not used. ``1 - 1e-8`` rounds to 1.0 in fp32,
exactly as in the reference, and the expressions keep the reference's
order of operations.

Learning rate 0.0 is the reference's freezing mechanism: the update is
exactly zero, but the state still advances.

Updater state is made in the param's dtype and each rule runs in the
dtypes of its tensors, as the reference's does, so under bf16 storage the
RmsProp cache and the update are bf16 (each ``_foreach_*`` op computes in
fp32 and rounds once, where XLA may keep fp32 across a fusion: the two
agree within a few bf16 ulps, not bit for bit). A Python hyperparameter
meets a bf16 tensor rounded to bf16, as jnp's weak typing casts it
(``runtime/dtype.py::weak_scalar``). Adam's bias correction
divides by a 0-d float32 array in the reference, which promotes a bf16 m
and v to float32 in jnp; the port promotes them explicitly, so a bf16
param comes out of its first Adam step as float32 in both packages.

Specs are frozen dataclasses (hashable, ``to_dict``/``updater_from_dict``
round-trip through ``topology.json``). ``init_state(param)`` makes one
leaf's state; ``apply_group(states, grads, params)`` updates a list of
leaves that share the spec in one ``torch._foreach_*`` pass and returns
``(deltas, new_states)``; ``apply`` is the one-leaf form. Nothing is
written in place.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Sequence, Tuple

import torch

from gan_deeplearning4j_tpu_torch.runtime.dtype import weak_scalar as _w

State = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class UpdaterSpec:
    learning_rate: float = 0.0

    @property
    def kind(self) -> str:
        return type(self).__name__.lower()

    def init_state(self, param) -> State:
        return {}

    def init_state_packed(self, packed_param) -> State:
        """State for a flat run of trainable elements (the update-sharding
        layout): :meth:`init_state` of it, with a 0-d slot (Adam's ``t``)
        broadcast per element, so the update stays elementwise."""
        out = {}
        for field, value in self.init_state(packed_param).items():
            if value.ndim == 0:
                value = value.expand(packed_param.shape).clone()
            out[field] = value
        return out

    def apply_group(
        self, states: Sequence[State], grads: Sequence[torch.Tensor], params: Sequence[torch.Tensor]
    ) -> Tuple[List[torch.Tensor], List[State]]:
        raise NotImplementedError

    def apply(self, state: State, grad, param) -> Tuple[torch.Tensor, State]:
        """One leaf: ``(delta_to_subtract, new_state)``."""
        deltas, states = self.apply_group([state], [grad], [param])
        return deltas[0], states[0]

    def with_learning_rate(self, lr: float) -> "UpdaterSpec":
        return dataclasses.replace(self, learning_rate=lr)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["type"] = self.kind
        return d


@dataclasses.dataclass(frozen=True)
class Sgd(UpdaterSpec):
    learning_rate: float = 0.01

    def apply_group(self, states, grads, params):
        grads = list(grads)
        return torch._foreach_mul(grads, _w(self.learning_rate, grads[0].dtype)), list(states)


@dataclasses.dataclass(frozen=True)
class NoOp(UpdaterSpec):
    """Never updates (hard-freeze alternative to lr=0)."""

    def apply_group(self, states, grads, params):
        return [torch.zeros_like(p) for p in params], list(states)


@dataclasses.dataclass(frozen=True)
class RmsProp(UpdaterSpec):
    """DL4J RmsPropUpdater. Reference config: RmsProp(lr, 1e-8, 1e-8)."""

    learning_rate: float = 0.001
    rms_decay: float = 0.95
    epsilon: float = 1e-8

    def init_state(self, param):
        return {"cache": torch.full_like(param, self.epsilon)}

    def apply_group(self, states, grads, params):
        grads = list(grads)
        dt = grads[0].dtype  # a group shares one dtype; the caches have it
        caches = torch._foreach_add(
            torch._foreach_mul([s["cache"] for s in states], _w(self.rms_decay, dt)),
            torch._foreach_mul(torch._foreach_mul(grads, grads), _w(1.0 - self.rms_decay, dt)),
        )
        deltas = torch._foreach_div(
            torch._foreach_mul(grads, _w(self.learning_rate, dt)),
            torch._foreach_sqrt(torch._foreach_add(caches, _w(self.epsilon, dt))),
        )
        return deltas, [{"cache": c} for c in caches]


@dataclasses.dataclass(frozen=True)
class Adam(UpdaterSpec):
    """Adam (unused by the reference's RmsProp-only graphs; the wider
    configs use it). ``t`` is an int32 scalar per leaf."""

    learning_rate: float = 0.001
    beta1: float = 0.9
    beta2: float = 0.999
    epsilon: float = 1e-8

    def init_state(self, param):
        return {
            "m": torch.zeros_like(param),
            "v": torch.zeros_like(param),
            "t": torch.zeros((), dtype=torch.int32, device=param.device),
        }

    def apply_group(self, states, grads, params):
        deltas, new_states = [], []
        for state, grad in zip(states, grads):
            t = state["t"] + 1
            m0, v0 = state["m"], state["v"]
            m = _w(self.beta1, m0.dtype) * m0 + _w(1 - self.beta1, grad.dtype) * grad
            v = _w(self.beta2, v0.dtype) * v0 + _w(1 - self.beta2, grad.dtype) * grad ** 2
            tf = t.to(torch.float32)
            # the reference divides by a 0-d float32 array, which promotes
            # a bf16 m and v to float32 in jnp (and so the delta, and
            # ``p - delta``); a 0-d tensor promotes nothing in torch, so the
            # promotion is spelled out
            wide = torch.promote_types(m.dtype, tf.dtype)
            m_hat = m.to(wide) / (1 - torch.pow(self.beta1, tf))
            v_hat = v.to(wide) / (1 - torch.pow(self.beta2, tf))
            deltas.append(_w(self.learning_rate, wide) * m_hat
                          / (torch.sqrt(v_hat) + _w(self.epsilon, wide)))
            new_states.append({"m": m, "v": v, "t": t})
        return deltas, new_states


def updater_from_dict(d: dict) -> UpdaterSpec:
    d = dict(d)
    kind = d.pop("type")
    classes = {"sgd": Sgd, "noop": NoOp, "rmsprop": RmsProp, "adam": Adam}
    if kind not in classes:
        raise KeyError(f"unknown updater type {kind!r}")
    return classes[kind](**d)
