"""Batch normalization — counterpart of
``gan_deeplearning4j_tpu/ops/norm.py``.

Normalizes over every axis but the last (features for 2-D inputs, channels
for NHWC 4-D inputs), eps 1e-5 inside the square root, written out by the
same formula as the reference rather than through ``F.batch_norm``:

- ``batch_norm_train`` normalizes by the batch mean and the **population**
  variance (``correction=0``; torch's default is the unbiased estimate) and
  returns DL4J's running-stat update, ``decay·running + (1-decay)·batch``
  with decay 0.9. The running stats are computed outside autograd and cast
  back to their own dtype (bf16 under bf16 storage, with the decay
  rounded to bf16 as the reference's weak-typed Python scalar is).
  ``F.batch_norm`` would update ``running_var``
  with the unbiased variance, and its momentum is ``1-decay``;
- ``batch_norm_inference`` uses the running statistics.

With a ``mesh`` (per-step gradient sync, ``parallel/trainer.py``) the
statistics are those of the global batch, as XLA computes them for the
JAX package's data-sharded step; every rank holds the same number of
rows. The mean is the mean of the ranks' means (one all-reduce); the
population variance is the mean of squared deviations from that global
mean, taken as the mean over ranks of each rank's own population variance
plus the squared distance of its mean from the global one (a second
all-reduce; the same quantity, summed stably, never a one-pass sum and sum
of squares, which cancels differently). Both all-reduces are
differentiable (``parallel/collectives.py::all_reduce_sum``), since every
rank's loss reads the global statistics. At world size 1 both reduce to
the plain path's ``torch.mean`` and ``torch.var`` (a sum over one rank,
a division by 1, an added 0), bit for bit.

``batch_norm_mesh(mesh)`` is the scope in which ``BatchNormalization``
layers pass a mesh here (``current_batch_norm_mesh``): per-step gradient
sync (``pmean``) sets it around its forward pass; parameter averaging
does not, since each worker's statistics stay local there, as
``shard_map`` computes them per shard.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Tuple

import torch

from gan_deeplearning4j_tpu_torch.runtime.dtype import weak_scalar

DEFAULT_EPS = 1e-5
DEFAULT_DECAY = 0.9

_scope = threading.local()


def current_batch_norm_mesh():
    """The mesh this thread's training-mode BatchNorm reads its statistics
    over (:func:`batch_norm_mesh`), or None."""
    return getattr(_scope, "mesh", None)


@contextlib.contextmanager
def batch_norm_mesh(mesh):
    """Within the block, training-mode BatchNorm layers compute their batch
    statistics over every rank of ``mesh`` (None: this rank's rows)."""
    previous = current_batch_norm_mesh()
    _scope.mesh = mesh
    try:
        yield
    finally:
        _scope.mesh = previous


def batch_norm_train(
    x, gamma, beta, running_mean, running_var, *, eps: float = DEFAULT_EPS, decay: float = DEFAULT_DECAY,
    mesh=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Training-mode BN: ``(y, new_running_mean, new_running_var)``; over
    the global batch of ``mesh``'s ranks when one is given."""
    axes = tuple(range(x.ndim - 1))
    if mesh is None:
        mean = torch.mean(x, dim=axes)
        var = torch.var(x, dim=axes, correction=0)
    else:
        from gan_deeplearning4j_tpu_torch.parallel.collectives import all_reduce_sum

        local_mean = torch.mean(x, dim=axes)
        mean = all_reduce_sum(local_mean, mesh) / mesh.size
        local_var = torch.var(x, dim=axes, correction=0)
        var = all_reduce_sum(local_var + (local_mean - mean) ** 2, mesh) / mesh.size
    inv = torch.reciprocal(torch.sqrt(var + eps))
    y = (x - mean) * inv * gamma + beta
    with torch.no_grad():
        # the reference's Python decay meets bf16 stats rounded to bf16
        # (jnp weak typing); the sum is in the promoted dtype
        rest = weak_scalar(1.0 - decay, mean.dtype)
        new_mean = (weak_scalar(decay, running_mean.dtype) * running_mean
                    + rest * mean).to(running_mean.dtype)
        new_var = (weak_scalar(decay, running_var.dtype) * running_var
                   + rest * var).to(running_var.dtype)
    return y, new_mean, new_var


def batch_norm_inference(x, gamma, beta, running_mean, running_var, *, eps: float = DEFAULT_EPS):
    inv = torch.reciprocal(torch.sqrt(running_var + weak_scalar(eps, running_var.dtype)))
    return (x - running_mean) * inv * gamma + beta
