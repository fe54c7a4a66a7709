"""Activations, by the same registry names as the JAX package
(``gan_deeplearning4j_tpu/ops/activations.py``): tanh (hidden default),
sigmoid (dis/gen outputs), softmax over the last axis (classifier),
identity, and relu/leaky_relu/elu for the wider zoo.

``leaky_relu`` keeps the reference's slope default of 0.2; PyTorch's own
default is 0.01.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def identity(x):
    return x


def tanh(x):
    return torch.tanh(x)


def sigmoid(x):
    return torch.sigmoid(x)


def softmax(x):
    return torch.softmax(x, dim=-1)


def relu(x):
    return torch.relu(x)


def leaky_relu(x, negative_slope: float = 0.2):
    return F.leaky_relu(x, negative_slope)


def elu(x):
    return F.elu(x)


_REGISTRY = {
    "identity": identity,
    "linear": identity,
    "tanh": tanh,
    "sigmoid": sigmoid,
    "softmax": softmax,
    "relu": relu,
    "leakyrelu": leaky_relu,
    "leaky_relu": leaky_relu,
    "elu": elu,
}


def get(name_or_fn):
    """Resolve an activation by name (case-insensitive) or pass through a callable."""
    if callable(name_or_fn):
        return name_or_fn
    key = str(name_or_fn).lower()
    if key not in _REGISTRY:
        raise KeyError(f"unknown activation {name_or_fn!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[key]
