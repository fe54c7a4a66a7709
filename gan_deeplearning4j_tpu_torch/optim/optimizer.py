"""GraphOptimizer — per-layer updater application, counterpart of
``gan_deeplearning4j_tpu/optim/optimizer.py``.

One step, in the reference's order:

1. gradient normalization per the graph config (the reference clips each
   element to ``[-1, 1]``);
2. each layer's updater on each trainable param; learning rate 0.0 gives
   a zero delta, but the leaf's updater state still advances;
3. ``lr_scale`` (the dis-LR decay factor) multiplies the delta, as a
   scalar of the delta's dtype: a Python float, or a 0-d tensor on the
   device (a captured iteration reads it from a buffer the host refills
   before each replay), which gives the same bits;
4. ``p - delta``.

BatchNorm running stats (role "state") are never touched here: they
change through the training forward pass. L2 enters through the loss
(``ComputationGraph.l2_penalty``), so the gradient already holds the
``l2·W`` term, as in DL4J.

Leaves that share an updater spec and a dtype are updated together, one
``torch._foreach_*`` pass per group. Nothing is written in place: the
step returns new params and a new state tree.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Tuple, Union

import torch

from gan_deeplearning4j_tpu_torch.ops import clipping
from gan_deeplearning4j_tpu_torch.runtime.dtype import weak_scalar


class GraphOptimizer:
    """Per-layer optimizer for a ComputationGraph's parameters."""

    def __init__(self, graph):
        self._updaters = graph.layer_updaters()
        self._roles = graph.param_roles()
        self._clip = graph.config.gradient_clip
        self._clip_value = graph.config.gradient_clip_value

    @property
    def updaters(self) -> Dict:
        return self._updaters

    def trainable(self, layer: str, pname: str) -> bool:
        return layer in self._updaters and self._roles.get(layer, {}).get(pname) != "state"

    def trainable_keys(self, params: Dict) -> List[Tuple[str, str]]:
        """``(layer, param)`` of every leaf the optimizer updates, in the
        params' order: the leaves to take gradients of."""
        return [
            (layer, pname)
            for layer in self._updaters
            for pname in params[layer]
            if self.trainable(layer, pname)
        ]

    def init(self, params: Dict) -> Dict:
        """Updater state tree ``{layer: {param: state}}`` for the trainable
        params."""
        return {
            layer: {
                pname: updater.init_state(p)
                for pname, p in params[layer].items()
                if self.trainable(layer, pname)
            }
            for layer, updater in self._updaters.items()
        }

    def clip_grads(self, grads):
        if self._clip == "elementwise":
            return clipping.clip_elementwise(grads, self._clip_value)
        if self._clip == "global_norm":
            return clipping.clip_by_global_norm(grads, self._clip_value)
        if self._clip is not None:
            raise ValueError(f"unknown gradient_clip {self._clip!r}")
        return grads

    def step(self, params: Dict, grads: Dict, opt_state: Dict,
             lr_scale: Union[float, torch.Tensor, None] = None) -> Tuple[Dict, Dict]:
        """One update: ``(new_params, new_opt_state)``. ``grads`` holds a
        gradient for every trainable leaf (``{layer: {param: grad}}``).
        ``lr_scale`` (a float, a 0-d float32 tensor, or None for no
        multiply) multiplies every delta: each updater's delta is linear in
        its learning rate, so this rescales the effective rate."""
        grads = self.clip_grads(grads)
        groups: Dict[tuple, List[Tuple[str, str]]] = defaultdict(list)
        for layer, pname in self.trainable_keys(params):
            p = params[layer][pname]
            groups[(self._updaters[layer], p.dtype)].append((layer, pname))

        new_params = {layer: dict(leaves) for layer, leaves in params.items()}
        new_state = {layer: dict(leaves) for layer, leaves in opt_state.items()}
        for (updater, _), keys in groups.items():
            ps = [params[l][n] for l, n in keys]
            deltas, states = updater.apply_group(
                [opt_state[l][n] for l, n in keys], [grads[l][n] for l, n in keys], ps
            )
            if lr_scale is not None:
                # the scale is rounded to the delta's dtype first, as the
                # reference casts it (an f32 scale must not promote a bf16
                # delta, and a bf16 product must see the bf16 scale)
                dt = deltas[0].dtype
                scale = (lr_scale.to(dt) if isinstance(lr_scale, torch.Tensor)
                         else weak_scalar(lr_scale, dt))
                deltas = torch._foreach_mul(deltas, scale)
            for (layer, pname), p, s in zip(keys, torch._foreach_sub(ps, deltas), states):
                new_params[layer][pname] = p
                new_state[layer][pname] = s
        return new_params, new_state
