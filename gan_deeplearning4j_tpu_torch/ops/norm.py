"""Batch normalization, inference form — counterpart of
``gan_deeplearning4j_tpu/ops/norm.py::batch_norm_inference``.

Normalizes over the last axis (features for 2-D inputs, channels for NHWC
4-D inputs) with the running statistics, eps 1e-5 inside the square root,
written out by the same formula as the reference rather than through
``F.batch_norm``. The training form, with DL4J's running-stat update
(population variance, decay 0.9), waits for the training slice.
"""

from __future__ import annotations

import torch

DEFAULT_EPS = 1e-5
DEFAULT_DECAY = 0.9


def batch_norm_inference(x, gamma, beta, running_mean, running_var, *, eps: float = DEFAULT_EPS):
    inv = torch.reciprocal(torch.sqrt(running_var + eps))
    return (x - running_mean) * inv * gamma + beta
