"""Synchronous parameter averaging over the data mesh — counterpart of
``gan_deeplearning4j_tpu/parallel/param_averaging.py``, the reference's
``ParameterAveragingTrainingMaster`` (dl4jGANComputerVision.java:325-330).

One round: every worker fits ``averaging_frequency`` minibatches of
``batch_size_per_worker`` rows locally (its params and updater state
diverging from the others', BatchNorm statistics over its own rows), then
params and updater state are averaged arithmetically over the mesh. Float
leaves take the mean; integer leaves (Adam's ``t``, equal on every worker
by construction) the maximum, as the JAX package's ``_average_tree`` takes
``pmax``. This is not the per-step gradient mean (``GraphTrainer`` on a
mesh): workers' params differ for k local steps before the average.

One process per rank. Every rank is handed the whole round, the global
rows laid out worker-major (worker 0's ``freq × b`` rows, then worker 1's,
…: what :meth:`_worker_major` makes of a row-major stream) and takes its
own contiguous block, as a ``shard_map`` shard sees its block. The round's
losses are the per-local-step means over the workers.

There is no dropout in the reference topologies, so a round takes no
random key (the JAX package folds one per worker for dropout-style
layers).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from gan_deeplearning4j_tpu_torch.parallel import collectives
from gan_deeplearning4j_tpu_torch.parallel.trainer import GraphTrainer, TrainState, check_mesh


def average_tree(trees: List[Dict], mesh) -> List[Dict]:
    """The mesh average of every leaf of ``trees`` (nested dicts of
    tensors): float leaves the mean, integer leaves the maximum, each kind
    in one collective per dtype. Returns new trees of the same structure."""
    paths, leaves = [], []

    def walk(node, path):
        for key, value in node.items():
            if isinstance(value, dict):
                walk(value, path + (key,))
            else:
                paths.append(path)
                leaves.append((key, value))

    for i, tree in enumerate(trees):
        walk(tree, (i,))
    floats = [j for j, (_, t) in enumerate(leaves) if t.is_floating_point()]
    ints = [j for j, (_, t) in enumerate(leaves) if not t.is_floating_point()]
    new = [None] * len(leaves)
    for idx, fn in ((floats, collectives.mean), (ints, collectives.maximum)):
        if idx:
            for j, t in zip(idx, fn([leaves[j][1] for j in idx], mesh)):
                new[j] = t
    out: List[Dict] = [{} for _ in trees]
    for path, (key, _), value in zip(paths, leaves, new):
        node = out[path[0]]
        for part in path[1:]:
            node = node.setdefault(part, {})
        node[key] = value
    # empty sub-dicts (a layer without updater state) keep their place
    for tree, o in zip(trees, out):
        _keep_empty(tree, o)
    return out


def _keep_empty(src: Dict, dst: Dict) -> None:
    for key, value in src.items():
        if isinstance(value, dict):
            _keep_empty(value, dst.setdefault(key, {}))


class ParameterAveragingTrainer:
    """DL4J ``ParameterAveragingTrainingMaster`` + ``SparkComputationGraph``
    over a ``DataMesh``: ``fit_round`` / ``fit_rounds`` / ``fit`` as in the
    JAX package. ``local`` is the worker's own single-device trainer."""

    def __init__(self, graph, mesh, batch_size_per_worker: int = 200,
                 averaging_frequency: int = 10):
        check_mesh(mesh)
        if mesh is None:
            raise ValueError("parameter averaging needs a mesh of workers")
        if averaging_frequency < 1:
            raise ValueError("averaging_frequency must be >= 1")
        if batch_size_per_worker < 1:
            raise ValueError("batch_size_per_worker must be >= 1")
        self.graph = graph
        self.mesh = mesh
        self.local = GraphTrainer(graph)
        self.optimizer = self.local.optimizer
        self.batch_size_per_worker = int(batch_size_per_worker)
        self.averaging_frequency = int(averaging_frequency)
        self.num_workers = int(mesh.size)

    @property
    def round_examples(self) -> int:
        """Rows consumed per full round: workers × frequency × local batch."""
        return self.num_workers * self.averaging_frequency * self.batch_size_per_worker

    def init_state(self, seed: Optional[int] = None, params: Optional[Dict] = None,
                   *, device=None) -> TrainState:
        """A fresh state on the mesh's device (``device`` is accepted for
        the ``GraphTrainer`` signature and must be that device or None)."""
        if device is not None and torch.device(device) != self.mesh.device:
            raise ValueError(f"the mesh computes on {self.mesh.device}, not {device}")
        return self.local.init_state(seed, params, device=self.mesh.device)

    def average(self, state: TrainState) -> TrainState:
        """Params and updater state averaged over the workers."""
        params, opt_state = average_tree([state.params, state.opt_state], self.mesh)
        return TrainState(params, opt_state, state.step)

    def local_fit(self, state: TrainState, features, labels, lr_scale=None):
        """This worker's local steps on ``(freq, b, …)`` minibatches, no
        averaging: ``(state, (freq,) losses)``."""
        losses = []
        for k in range(features.shape[0]):
            state, loss = self.local.train_step(state, features[k], labels[k], lr_scale)
            losses.append(loss)
        return state, torch.stack(losses)

    def _rows(self, x, freq: int, b: int) -> torch.Tensor:
        """This worker's ``(freq, b, …)`` block of a worker-major round."""
        lo = self.mesh.rank * freq * b
        block = torch.as_tensor(x[lo:lo + freq * b])
        if not block.is_floating_point():
            block = block.float()
        return block.to(self.mesh.device).reshape((freq, b) + tuple(block.shape[1:]))

    def fit_round(self, state: TrainState, features, labels, freq: Optional[int] = None,
                  batch_size: Optional[int] = None) -> Tuple[TrainState, torch.Tensor]:
        """One averaging round on ``workers × freq × batch`` rows laid out
        worker-major. Returns ``(state, (freq,) mean losses)``; the step
        advances by ``freq``."""
        freq = self.averaging_frequency if freq is None else freq
        b = self.batch_size_per_worker if batch_size is None else batch_size
        expected = self.num_workers * freq * b
        if features.shape[0] != expected or labels.shape[0] != expected:
            raise ValueError(
                f"round expects {expected} rows "
                f"({self.num_workers} workers × {freq} × {b}), "
                f"got features {features.shape[0]} / labels {labels.shape[0]}"
            )
        state, losses = self.local_fit(state, self._rows(features, freq, b),
                                       self._rows(labels, freq, b))
        state = self.average(state)
        return state, collectives.mean([losses], self.mesh)[0]

    def fit_rounds(self, state: TrainState, features, labels, freq: Optional[int] = None,
                   batch_size: Optional[int] = None) -> Tuple[TrainState, torch.Tensor]:
        """K rounds: ``features``/``labels`` are ``(K, workers × freq × b,
        …)``, each round worker-major. Equal to K ``fit_round`` calls.
        Returns ``(state, (K, freq) losses)``."""
        freq = self.averaging_frequency if freq is None else freq
        b = self.batch_size_per_worker if batch_size is None else batch_size
        expected = self.num_workers * freq * b
        if features.shape[1] != expected or labels.shape[1] != expected:
            raise ValueError(
                f"each round expects {expected} rows "
                f"({self.num_workers} workers × {freq} × {b}), got "
                f"features {features.shape[1]} / labels {labels.shape[1]}"
            )
        rows = []
        for k in range(features.shape[0]):
            state, losses = self.fit_round(state, features[k], labels[k], freq, b)
            rows.append(losses)
        return state, torch.stack(rows)

    @staticmethod
    def _worker_major(arr, freq: int, workers: int, b: int):
        """Regroup a row-major stream into worker-major ``(worker, freq,
        b)`` order, so each worker sees a contiguous run of minibatches."""
        used = freq * workers * b
        return (
            arr[:used]
            .reshape((freq, workers, b) + tuple(arr.shape[1:]))
            .swapaxes(0, 1)
            .reshape((used,) + tuple(arr.shape[1:]))
        )

    def fit(self, state: TrainState, iterator) -> Tuple[TrainState, List[float]]:
        """Consume a DataSetIterator of global batches in averaging rounds
        (the ``sparkGraph.fit(rdd)`` surface), as the JAX package does: full
        rounds at ``averaging_frequency``; leftovers as one round at a
        reduced frequency, then a ragged tail at a reduced per-worker batch,
        padded by cycling its own rows."""
        losses: List[float] = []
        rows = self.num_workers * self.batch_size_per_worker
        buf_f: List = []
        buf_l: List = []
        buffered = 0

        def cat(parts):
            if len(parts) == 1:
                return parts[0]
            if isinstance(parts[0], torch.Tensor):
                return torch.cat(parts)
            return np.concatenate(parts, axis=0)

        def run_round(state, feats, labs, freq, b):
            state, round_losses = self.fit_round(
                state, self._worker_major(feats, freq, self.num_workers, b),
                self._worker_major(labs, freq, self.num_workers, b), freq, b)
            losses.extend(float(x) for x in round_losses.cpu())
            return state

        while iterator.has_next():
            batch = iterator.next()
            buf_f.append(batch.features)
            buf_l.append(batch.labels)
            buffered += batch.num_examples()
            while buffered >= self.round_examples:
                feats, labs = cat(buf_f), cat(buf_l)
                state = run_round(state, feats, labs, self.averaging_frequency,
                                  self.batch_size_per_worker)
                feats, labs = feats[self.round_examples:], labs[self.round_examples:]
                buf_f = [feats] if feats.shape[0] else []
                buf_l = [labs] if labs.shape[0] else []
                buffered = feats.shape[0]

        if buffered > 0:
            feats, labs = cat(buf_f), cat(buf_l)
            n = feats.shape[0]
            freq = n // rows
            if freq >= 1:
                used = freq * rows
                state = run_round(state, feats, labs, freq, self.batch_size_per_worker)
                feats, labs, n = feats[used:], labs[used:], n - used
            if n > 0:
                b = max(1, -(-n // self.num_workers))
                need = self.num_workers * b
                if need > n:
                    idx = np.arange(need) % n
                    if isinstance(feats, torch.Tensor):
                        idx = torch.as_tensor(idx, device=feats.device)
                    feats, labs = feats[idx], labs[idx]
                state = run_round(state, feats, labs, 1, b)
        return state, losses
