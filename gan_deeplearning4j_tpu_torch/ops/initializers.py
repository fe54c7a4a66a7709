"""Weight initializers for the port's own ``init`` — counterpart of
``gan_deeplearning4j_tpu/ops/initializers.py``.

DL4J's XAVIER is a Gaussian N(0, 2/(fan_in+fan_out)), the reference's
initializer everywhere; the JAX package's other names are here too, with
its fans and formulas: ``xavier_uniform`` (uniform on ±√(6/(fan_in +
fan_out))), ``he`` / ``he_normal`` (std √(2/fan_in)), ``normal`` (std
0.01), ``zeros`` and ``ones``. Draws come from an explicit
``torch.Generator`` on the CPU and are moved to the device by the caller. The draws differ from the JAX package's (threefry against
Philox/mt19937): tests that compare the two packages load the same numpy
params into both instead of initializing twice.

Fan-in/fan-out: dense kernels are (in, out); conv kernels are HWIO with
receptive-field scaling.
"""

from __future__ import annotations

import math

import torch


def _fans(shape):
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = math.prod(shape[:-2])
    return shape[-2] * receptive, shape[-1] * receptive


def xavier(generator: torch.Generator, shape, dtype=torch.float32):
    """DL4J WeightInit.XAVIER: gaussian with var = 2/(fan_in+fan_out)."""
    fan_in, fan_out = _fans(shape)
    std = math.sqrt(2.0 / (fan_in + fan_out))
    return std * torch.randn(tuple(shape), generator=generator, dtype=dtype)


def xavier_uniform(generator: torch.Generator, shape, dtype=torch.float32):
    fan_in, fan_out = _fans(shape)
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return torch.empty(tuple(shape), dtype=dtype).uniform_(-limit, limit, generator=generator)


def he_normal(generator: torch.Generator, shape, dtype=torch.float32):
    fan_in, _ = _fans(shape)
    std = math.sqrt(2.0 / fan_in)
    return std * torch.randn(tuple(shape), generator=generator, dtype=dtype)


def normal(generator: torch.Generator, shape, dtype=torch.float32, stddev=0.01):
    return stddev * torch.randn(tuple(shape), generator=generator, dtype=dtype)


def zeros(generator: torch.Generator, shape, dtype=torch.float32):
    del generator
    return torch.zeros(tuple(shape), dtype=dtype)


def ones(generator: torch.Generator, shape, dtype=torch.float32):
    del generator
    return torch.ones(tuple(shape), dtype=dtype)


_REGISTRY = {
    "xavier": xavier,
    "xavier_uniform": xavier_uniform,
    "he": he_normal,
    "he_normal": he_normal,
    "normal": normal,
    "zeros": zeros,
    "ones": ones,
}


def get(name_or_fn):
    if callable(name_or_fn):
        return name_or_fn
    key = str(name_or_fn).lower()
    if key not in _REGISTRY:
        raise KeyError(f"unknown initializer {name_or_fn!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[key]
