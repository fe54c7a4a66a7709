"""GraphTrainer — one optimizer step of one graph on one device,
counterpart of ``gan_deeplearning4j_tpu/parallel/trainer.py``.

A step is: forward in training mode → loss (+ L2) → ``autograd.grad`` of
every trainable leaf → ``GraphOptimizer.step``. The loss is taken at the
params; the update is applied to the params the forward pass returned,
which carry the new BatchNorm running stats.

Every trainable leaf gets a gradient, frozen ones (learning rate 0.0)
included: their RmsProp caches still advance and their L2 term still
enters the gradient, as in the reference. The step works on detached
copies of the leaves (``requires_grad`` is never set on the caller's
tensors) and returns new tensors, so states that share leaves with other
graphs (the weight-sync rebinds) are never written through.

Each gradient comes out in its param's dtype (bf16 under bf16 storage:
autograd casts it back through the compute scope's casts); nothing here
adds a float32 scalar or 0-d tensor to a leaf, so a leaf keeps its dtype
unless its updater changes it as the reference's does (Adam,
``optim/updaters.py``).

``TrainState.step`` is a Python int: the step counter lives on the host,
so reading it never waits for the device. The two halves of a step are
``torch.profiler.record_function`` ranges, ``step.grad`` (forward, loss and
backward) and ``step.update`` (clip and updater).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
from torch.profiler import record_function

from gan_deeplearning4j_tpu_torch.optim.optimizer import GraphOptimizer
from gan_deeplearning4j_tpu_torch.runtime.device import DeviceLike

_PARALLEL_WAITS = "ROADMAP.md queue 1, 'Parallel training'"


@dataclasses.dataclass
class TrainState:
    """Params + per-layer updater state + step counter: the unit a
    checkpoint with updater state holds."""

    params: Dict
    opt_state: Dict
    step: int


def make_train_state(graph, optimizer: GraphOptimizer, seed=None, params=None,
                     *, device: DeviceLike = None) -> TrainState:
    """Fresh TrainState (step 0)."""
    if params is None:
        params = graph.init(seed, device=device)
    return TrainState(params=params, opt_state=optimizer.init(params), step=0)


def grad_leaves(optimizer: GraphOptimizer, params: Dict):
    """``(params, keys, leaves)``: a copy of ``params`` whose trainable
    leaves are detached tensors with ``requires_grad`` set, their
    ``(layer, param)`` keys and the leaves themselves, in the optimizer's
    order. The caller's tensors are not touched."""
    keys = optimizer.trainable_keys(params)
    out = {layer: dict(lp) for layer, lp in params.items()}
    leaves = []
    for layer, pname in keys:
        leaf = out[layer][pname].detach().requires_grad_(True)
        out[layer][pname] = leaf
        leaves.append(leaf)
    return out, keys, leaves


def grads_by_layer(keys, flat) -> Dict:
    """``{layer: {param: grad}}`` from ``autograd.grad``'s flat tuple."""
    grads: Dict = {}
    for (layer, pname), g in zip(keys, flat):
        grads.setdefault(layer, {})[pname] = g
    return grads


def detach_params(params: Dict) -> Dict:
    return {layer: {n: t.detach() for n, t in lp.items()} for layer, lp in params.items()}


class GraphTrainer:
    """Single-device trainer for one ComputationGraph. ``mesh`` and
    ``shard_updates`` belong to the data-parallel trainers, which are not
    ported yet."""

    def __init__(self, graph, mesh=None, shard_updates: bool = False):
        if mesh is not None or shard_updates:
            raise NotImplementedError(
                f"mesh trainers and sharded updates are not ported yet: {_PARALLEL_WAITS}"
            )
        self.graph = graph
        self.optimizer = GraphOptimizer(graph)

    def init_state(self, seed: Optional[int] = None, params: Optional[Dict] = None,
                   *, device: DeviceLike = None) -> TrainState:
        return make_train_state(self.graph, self.optimizer, seed, params, device=device)

    def train_step(self, state: TrainState, features, labels,
                   lr_scale: Optional[float] = None) -> Tuple[TrainState, torch.Tensor]:
        """One optimizer step on one minibatch: ``(new_state, loss)``, the
        loss a device scalar (no host read)."""
        params, keys, leaves = grad_leaves(self.optimizer, state.params)
        with torch.enable_grad(), record_function("step.grad"):
            loss, (_, new_params) = self.graph.loss(params, features, labels, train=True)
            grads = grads_by_layer(keys, torch.autograd.grad(loss, leaves))
        new_params = detach_params(new_params)
        with record_function("step.update"):
            params, opt_state = self.optimizer.step(new_params, grads, state.opt_state, lr_scale=lr_scale)
        return TrainState(params, opt_state, state.step + 1), loss.detach()

    def output(self, state: TrainState, features):
        """Inference forward (DL4J ``graph.output``)."""
        with torch.no_grad():
            return self.graph.output(state.params, features, train=False)
