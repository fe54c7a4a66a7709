"""The JAX package's key stream, computed on the host with numpy.

The JAX package draws every random number it keys by seed (its array
factory, ``RngStream``, the frozen FID extractor's kernels) from jax's
default PRNG: threefry-2x32 in jax's "partitionable" mode, with jax's
default 32-bit integers. This module is the port's own copy of how that
stream is defined, so the port can reproduce those draws with no jax:

- ``PRNGKey(seed)``: a ``(2,)`` uint32 key, ``[0, seed mod 2**32]`` (jax
  truncates a Python seed to int32 before it splits it, so the high word
  is 0 for every seed, 64-bit and negative ones included; a seed outside
  int64 raises ``OverflowError`` as jax does);
- ``split(key, n)``: ``threefry(key, iota(n))`` as ``(n, 2)`` (hi, lo)
  keys, equal to ``jax.random.key_data(jax.random.split(key, n))``;
- ``bits(key, shape)``: ``hi ^ lo`` of ``threefry(key, iota(size))``, in
  row-major order, equal to ``jax.random.bits``;
- ``uniform(key, shape, dtype, minval, maxval)``: 23 (float32) or 7
  (bfloat16, from the low byte) random mantissa bits under the exponent of
  1.0, minus 1, scaled and shifted, then ``max(minval, ·)``: bit-equal to
  ``jax.random.uniform``;
- ``normal(key, shape, dtype)``: ``sqrt(2)·erfinv(u)`` with ``u`` uniform
  on ``[nextafter(-1, 0), 1)``. erfinv is XLA's float32 polynomial (Giles'
  single-precision approximation, which jax evaluates), not an accurate
  erfinv: torch's and scipy's differ from jax's by more than 1e-6
  relative in the tails (|u| near 1), while the polynomial in numpy
  float32 stays within 1e-6 (only numpy's ``log1p`` differs from XLA's),
  most draws bit-equal.

numpy has no bfloat16: a bfloat16 draw is returned as float32 values that
bfloat16 holds exactly, each arithmetic step rounded to bfloat16 as jax
rounds it; casting the result to ``torch.bfloat16`` is exact.

Host only: keys are small numpy arrays and draws are numpy arrays, which
the callers move to the device.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import numpy as np
import torch

Shape = Union[int, Sequence[int]]

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _dtype_name(dtype) -> str:
    """``"float32"`` or ``"bfloat16"`` for a numpy, torch or string dtype."""
    if dtype is None:
        return "float32"
    if isinstance(dtype, torch.dtype):
        name = str(dtype).replace("torch.", "")
    else:
        name = getattr(dtype, "name", None) or str(dtype)
    name = {"bf16": "bfloat16", "f32": "float32"}.get(name.lower(), name.lower())
    if name not in ("float32", "bfloat16"):
        raise TypeError(f"threefry draws float32 or bfloat16, not {dtype!r}")
    return name


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (int(shape),) if isinstance(shape, (int, np.integer)) else tuple(int(d) for d in shape)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key: np.ndarray, x_hi: np.ndarray, x_lo: np.ndarray):
    """The Threefry-2x32 hash of the counter pairs ``(x_hi, x_lo)`` under
    ``key`` (20 rounds, as jax applies it). Returns two uint32 arrays."""
    k1, k2 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    with np.errstate(over="ignore"):
        x = [np.asarray(x_hi, np.uint32) + ks[0], np.asarray(x_lo, np.uint32) + ks[1]]
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r)
                x[1] = x[0] ^ x[1]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def _iota_2x32(shape: Tuple[int, ...]):
    """A row-major uint64 iota over ``shape``, as its (hi, lo) uint32 words."""
    flat = np.arange(math.prod(shape), dtype=np.uint64).reshape(shape)
    return (flat >> np.uint64(32)).astype(np.uint32), (flat & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def PRNGKey(seed: int) -> np.ndarray:  # noqa: N802 (jax's name)
    """``jax.random.key_data(jax.random.PRNGKey(seed))`` under jax's default
    32-bit integers."""
    seed = int(np.int64(seed))  # OverflowError outside int64, as in jax
    return np.array([0, seed & 0xFFFFFFFF], dtype=np.uint32)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``num`` new keys, ``(num, 2)`` uint32."""
    hi, lo = threefry2x32(key, *_iota_2x32((int(num),)))
    return np.stack([hi, lo], axis=-1)


def bits(key: np.ndarray, shape: Shape) -> np.ndarray:
    """Random uint32 words of ``shape``."""
    hi, lo = threefry2x32(key, *_iota_2x32(_shape(shape)))
    return hi ^ lo


def round_bf16(x: np.ndarray) -> np.ndarray:
    """float32 values rounded to the nearest bfloat16 (ties to even), kept
    as float32."""
    b = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    with np.errstate(over="ignore"):
        b = (b + np.uint32(0x7FFF) + ((b >> np.uint32(16)) & np.uint32(1))) & np.uint32(0xFFFF0000)
    return b.view(np.float32)


def uniform(key: np.ndarray, shape: Shape = (), dtype=None, minval: float = 0.0,
            maxval: float = 1.0) -> np.ndarray:
    """Uniform draws on ``[minval, maxval)``: ``jax.random.uniform``'s."""
    shape = _shape(shape)
    words = bits(key, shape)
    if _dtype_name(dtype) == "float32":
        one = np.uint32(0x3F800000)
        floats = ((words >> np.uint32(9)) | one).view(np.float32) - np.float32(1.0)
        lo, hi = np.float32(minval), np.float32(maxval)
        return np.maximum(lo, floats * (hi - lo) + lo)
    # bfloat16: the low byte's top 7 bits under bf16's exponent of 1.0
    # (0x3F80), widened to the float32 that holds the same value
    half = ((words & np.uint32(0xFF)) >> np.uint32(1)) | np.uint32(0x3F80)
    floats = (half << np.uint32(16)).view(np.float32) - np.float32(1.0)  # exact
    lo, hi = round_bf16(np.float32(minval)), round_bf16(np.float32(maxval))
    span = round_bf16(hi - lo)
    return np.maximum(lo, round_bf16(round_bf16(floats * span) + lo))


#: XLA's ``ErfInv32`` coefficients, for ``w < 5`` and ``w >= 5``, highest first
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                 0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                 0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def erfinv(x: np.ndarray) -> np.ndarray:
    """erfinv in float32 as XLA evaluates it: ``w = -log1p(-x²)``, a degree-8
    polynomial in ``w - 2.5`` (``w < 5``) or ``sqrt(w) - 3``, times ``x``;
    ±inf at ±1."""
    x = np.asarray(x, np.float32)
    with np.errstate(divide="ignore", invalid="ignore"):
        w = -np.log1p(-x * x)
        small = w < np.float32(5.0)
        w = np.where(small, w - np.float32(2.5), np.sqrt(w) - np.float32(3.0))
        p = np.float32(0.0)
        for a, b in zip(_ERFINV_SMALL, _ERFINV_LARGE):
            p = np.where(small, np.float32(a), np.float32(b)) + p * w
        return np.where(np.abs(x) == 1, x * np.float32(np.inf), p * x).astype(np.float32)


def normal(key: np.ndarray, shape: Shape = (), dtype=None) -> np.ndarray:
    """Standard normal draws: ``sqrt(2)·erfinv(u)``, ``u`` uniform on
    ``[nextafter(-1, 0), 1)`` in ``dtype``."""
    if _dtype_name(dtype) == "float32":
        lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
        u = uniform(key, shape, "float32", lo, 1.0)
        return np.float32(math.sqrt(2.0)) * erfinv(u)
    lo = np.float32(-0.99609375)  # nextafter(-1, 0) in bfloat16
    u = uniform(key, shape, "bfloat16", lo, 1.0)
    return round_bf16(round_bf16(np.float32(math.sqrt(2.0))) * round_bf16(erfinv(u)))


__all__ = ["PRNGKey", "bits", "erfinv", "normal", "round_bf16", "split", "threefry2x32", "uniform"]
