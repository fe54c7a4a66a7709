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
"""

from __future__ import annotations

from typing import Tuple

import torch

from gan_deeplearning4j_tpu_torch.runtime.dtype import weak_scalar

DEFAULT_EPS = 1e-5
DEFAULT_DECAY = 0.9


def batch_norm_train(
    x, gamma, beta, running_mean, running_var, *, eps: float = DEFAULT_EPS, decay: float = DEFAULT_DECAY
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Training-mode BN: ``(y, new_running_mean, new_running_var)``."""
    axes = tuple(range(x.ndim - 1))
    mean = torch.mean(x, dim=axes)
    var = torch.var(x, dim=axes, correction=0)
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
