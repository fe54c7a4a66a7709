"""Gradient normalization — counterpart of
``gan_deeplearning4j_tpu/ops/clipping.py``.

The reference clips every gradient element to ``[-1, 1]``
(``ClipElementWiseAbsoluteValue``) before the updater runs. Both functions
take a grad tree (nested dicts of tensors) and return one of the same
structure; the elementwise clip is one ``torch._foreach_*`` pass over all
leaves.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import torch


def _leaves(tree) -> Tuple[List[torch.Tensor], Callable]:
    """Leaves of a nested-dict tree in order, and a function that rebuilds
    the structure from new leaves."""
    paths: List[Tuple[str, ...]] = []
    leaves: List[torch.Tensor] = []

    def walk(node, path):
        for key, value in node.items():
            if isinstance(value, dict):
                walk(value, path + (key,))
            else:
                paths.append(path + (key,))
                leaves.append(value)

    walk(tree, ())

    def rebuild(new_leaves):
        out: dict = {}
        for path, leaf in zip(paths, new_leaves):
            node = out
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = leaf
        return out

    return leaves, rebuild


def clip_elementwise(grads, threshold: float):
    """Clamp every gradient element to ``[-threshold, threshold]``."""
    leaves, rebuild = _leaves(grads)
    if not leaves:
        return rebuild([])
    return rebuild(torch._foreach_clamp_max(torch._foreach_clamp_min(leaves, -threshold), threshold))


def clip_by_global_norm(grads, max_norm: float):
    leaves, rebuild = _leaves(grads)
    if not leaves:
        return rebuild([])
    global_norm = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in leaves))
    scale = torch.clamp(max_norm / (global_norm + 1e-12), max=1.0)
    return rebuild([(g * scale).to(g.dtype) for g in leaves])
