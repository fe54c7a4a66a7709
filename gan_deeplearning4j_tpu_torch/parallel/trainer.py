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

Data parallel (``mesh=``, a ``runtime/environment.py::DataMesh``): the
per-step gradient sync of the JAX package's data-sharded step, one process
per rank. Each rank runs the forward on its own rows, with training-mode
BatchNorm reading its statistics over the global batch
(``ops/norm.py::batch_norm_mesh``); its local mean loss (+ L2) is
differentiated; every gradient leaf and the loss are averaged over the
mesh (``parallel/collectives.py::mean``: one all-reduce per dtype); then
the optimizer clips and updates, so the elementwise clip sees the mean
gradient, as the JAX package's does, and the L2 term, which each rank's
loss carries, counts once. Every rank ends the step with the same bits.
``shard_updates=True`` replaces the all-reduce and the replicated update
by ``parallel/update_sharding.py``'s reduce-scatter, owned-keys update and
all-gather (``exact_grads=False``; by default the gradients are averaged
as here and each rank slices its keys out of the mean, so the sharded
step equals the replicated one bit for bit).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

import torch
from torch.profiler import record_function

from gan_deeplearning4j_tpu_torch.ops.norm import batch_norm_mesh
from gan_deeplearning4j_tpu_torch.optim.optimizer import GraphOptimizer
from gan_deeplearning4j_tpu_torch.parallel import collectives
from gan_deeplearning4j_tpu_torch.runtime.device import DeviceLike
from gan_deeplearning4j_tpu_torch.runtime.environment import DataMesh


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


def check_mesh(mesh) -> None:
    """A trainer's ``mesh`` is a ``DataMesh`` (``runtime/environment.py``)
    or None."""
    if mesh is not None and not isinstance(mesh, DataMesh):
        raise TypeError(
            f"mesh must be a DataMesh (runtime.environment.make_mesh), not "
            f"{type(mesh).__name__}")


class GraphTrainer:
    """Single-device or data-parallel trainer for one ComputationGraph.

    With ``mesh=None`` a step runs on this process's device alone. With a
    mesh, each rank feeds its own rows and the step is the per-step
    gradient sync of the module docstring; ``shard_updates`` partitions the
    update and the updater state over the mesh. ``model_name`` and
    ``global_state_keys`` name the flat key namespace the update-sharding
    partition is taken over (an experiment passes its own; standalone use
    derives one from this model)."""

    def __init__(self, graph, mesh=None, shard_updates: bool = False, model_name: str = "model",
                 global_state_keys=None, exact_grads: bool = True):
        check_mesh(mesh)
        if shard_updates and mesh is None:
            raise ValueError("shard_updates requires a mesh — there is no "
                             "data axis to shard the update over")
        self.graph = graph
        self.optimizer = GraphOptimizer(graph)
        self.mesh = mesh
        self.shard_updates = shard_updates
        self.model_name = model_name
        self._global_state_keys = global_state_keys
        self._exact_grads = exact_grads
        self.plan = None

    def init_state(self, seed: Optional[int] = None, params: Optional[Dict] = None,
                   *, device: DeviceLike = None) -> TrainState:
        if device is None and self.mesh is not None:
            device = self.mesh.device
        if not self.shard_updates:
            return make_train_state(self.graph, self.optimizer, seed, params, device=device)
        if params is None:
            params = self.graph.init(seed, device=device)
        self._ensure_plan(params)
        return TrainState(params, self.optimizer.init(params), 0)

    # -- update sharding ---------------------------------------------------
    def _ensure_plan(self, params: Dict) -> None:
        if self.plan is None:
            from gan_deeplearning4j_tpu_torch.parallel.update_sharding import UpdateShardingPlan

            self.enable_update_sharding(UpdateShardingPlan(
                self.graph, self.optimizer, params, self.mesh, model_name=self.model_name,
                global_keys=self._global_state_keys, exact_grads=self._exact_grads))

    def enable_update_sharding(self, plan) -> None:
        """Install an ``UpdateShardingPlan``: the optimizer becomes its
        ``ShardedGraphOptimizer`` (``base`` keeps the replicated one)."""
        from gan_deeplearning4j_tpu_torch.parallel.update_sharding import ShardedGraphOptimizer

        if isinstance(self.optimizer, ShardedGraphOptimizer):
            self.optimizer = self.optimizer.base
        self.plan = plan
        self.optimizer = ShardedGraphOptimizer(plan)
        self.shard_updates = True

    # -- the step ----------------------------------------------------------
    def sync_scope(self):
        """The scope of a training forward pass: BatchNorm statistics over
        the mesh's global batch (none without a mesh)."""
        return batch_norm_mesh(self.mesh)

    def reduce(self, grads: Dict, loss: torch.Tensor) -> Tuple[Dict, torch.Tensor]:
        """The mesh mean of the gradients and the loss (both as they are
        without a mesh). Under update sharding with ``exact_grads=False``
        only the loss: the sharded optimizer reduce-scatters the gradients
        itself."""
        if self.mesh is None:
            return grads, loss
        if self.shard_updates and not self.plan.exact_grads:
            return grads, collectives.mean([loss], self.mesh)[0]
        keys = [(layer, n) for layer, lp in grads.items() for n in lp]
        flat = collectives.mean([grads[l][n] for l, n in keys] + [loss], self.mesh)
        return grads_by_layer(keys, flat[:-1]), flat[-1]

    def train_step(self, state: TrainState, features, labels,
                   lr_scale: Union[float, torch.Tensor, None] = None) -> Tuple[TrainState, torch.Tensor]:
        """One optimizer step on one minibatch (this rank's rows on a mesh):
        ``(new_state, loss)``, the loss a device scalar (no host read), the
        mesh mean on a mesh. ``lr_scale`` is ``GraphOptimizer.step``'s: a
        float, a 0-d tensor, or None."""
        params, keys, leaves = grad_leaves(self.optimizer, state.params)
        with torch.enable_grad(), record_function("step.grad"), self.sync_scope():
            loss, (_, new_params) = self.graph.loss(params, features, labels, train=True)
            grads = grads_by_layer(keys, torch.autograd.grad(loss, leaves))
        new_params = detach_params(new_params)
        grads, loss = self.reduce(grads, loss.detach())
        with record_function("step.update"):
            params, opt_state = self.optimizer.step(new_params, grads, state.opt_state, lr_scale=lr_scale)
        return TrainState(params, opt_state, state.step + 1), loss

    def fit(self, state: TrainState, iterator,
            num_batches: Optional[int] = None) -> Tuple[TrainState, List[float]]:
        """Consume a DataSetIterator (DL4J ``fit(iterator)``): one
        :meth:`train_step` per batch, up to ``num_batches``, so a mesh and
        update sharding apply. Each batch goes to the params' device; on a
        mesh, this rank's rows of a global batch (a mesh iterator's batches
        are its rows already). Returns the new state and the per-batch
        losses, kept on the device until the end and read in one copy.
        There is no ``rng``: the port's step draws nothing."""
        device = next(t for lp in state.params.values() for t in lp.values()).device
        global_rows = self.mesh is not None and getattr(iterator, "mesh", None) is None
        losses = []
        while iterator.has_next() and (num_batches is None or len(losses) < num_batches):
            batch = iterator.next()
            batch = batch.to_device(mesh=self.mesh) if global_rows else batch.to_device(device)
            state, loss = self.train_step(state, batch.features, batch.labels)
            losses.append(loss)
        if not losses:
            return state, []
        return state, [float(v) for v in torch.stack(losses).float().cpu()]

    def output(self, state: TrainState, features):
        """Inference forward (DL4J ``graph.output``)."""
        with torch.no_grad():
            return self.graph.output(state.params, features, train=False)
