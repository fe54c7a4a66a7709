"""Array factory — the ``Nd4j`` static-factory surface, counterpart of
``gan_deeplearning4j_tpu/runtime/factory.py``.

``randn``, ``rand``, ``uniform_latent``, ``linspace``, ``ones``, ``zeros``,
``create``, ``vstack`` and ``latent_grid`` make tensors on ``device`` (the
card unless the caller asks for another) in the port's dtype policy
(``runtime/dtype.py``: the thread's default dtype unless ``dtype`` names
one). Random factories take a key (a ``(2,)`` uint32 array) or an
:class:`RngStream`, as the JAX factory does, and draw on the host through
``runtime/threefry.py`` before the one copy to the device: ``rand`` and
``uniform_latent`` are bit-equal to the JAX factory's draws, ``randn``
within 1e-6 relative (float32; bfloat16 draws are equal).
``linspace`` and ``latent_grid`` compute ``start·(1 − t) + stop·t`` as
XLA evaluates ``jnp.linspace``, so they are equal to the JAX factory's
too.
``to_host`` is the one sanctioned device→host read.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from gan_deeplearning4j_tpu_torch.runtime import threefry
from gan_deeplearning4j_tpu_torch.runtime.device import DeviceLike, resolve_device
from gan_deeplearning4j_tpu_torch.runtime.dtype import _as_dtype, get_default_dtype
from gan_deeplearning4j_tpu_torch.runtime.prng import RngStream


def _resolve_key(rng) -> np.ndarray:
    if isinstance(rng, RngStream):
        return rng.next_key()
    return np.asarray(rng, dtype=np.uint32)


def _dtype(dtype) -> torch.dtype:
    return get_default_dtype() if dtype is None else _as_dtype(dtype)


def _shape(shape) -> tuple:
    if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
        return tuple(shape[0])
    return tuple(shape)


def _draw_dtype(dtype: torch.dtype) -> str:
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"random factories draw float32 or bfloat16, not {dtype}")
    return "bfloat16" if dtype == torch.bfloat16 else "float32"


def _put(host: np.ndarray, dtype: torch.dtype, device: DeviceLike) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(host)).to(dtype).to(resolve_device(device))


def randn(rng, *shape, dtype=None, device: DeviceLike = None) -> torch.Tensor:
    """Standard-normal samples (Nd4j.randn analog)."""
    dt = _dtype(dtype)
    return _put(threefry.normal(_resolve_key(rng), _shape(shape), _draw_dtype(dt)), dt, device)


def rand(rng, *shape, dtype=None, minval: float = 0.0, maxval: float = 1.0,
         device: DeviceLike = None) -> torch.Tensor:
    """Uniform samples in [minval, maxval) (Nd4j.rand analog)."""
    dt = _dtype(dtype)
    draw = threefry.uniform(_resolve_key(rng), _shape(shape), _draw_dtype(dt), minval, maxval)
    return _put(draw, dt, device)


def uniform_latent(rng, *shape, dtype=None, device: DeviceLike = None) -> torch.Tensor:
    """z ~ U(-1, 1): the reference's latent sampler ``rand·2−1``."""
    return rand(rng, *shape, dtype=dtype, minval=-1.0, maxval=1.0, device=device)


def _linspace_host(start: float, stop: float, num: int, dtype: torch.dtype) -> np.ndarray:
    """``jnp.linspace``'s values, ``start·(1 − t) + stop·t`` for ``t = i/div``
    and ``stop`` last, as XLA evaluates them: in float32 the division is a
    product by the reciprocal of ``div`` and the stop term is fused,
    ``fma(i, stop·(1/div), start·(1 − t))``; in bfloat16 every step is
    rounded."""
    if num <= 0:
        return np.zeros((0,), np.float32)
    f32 = np.float32
    if dtype == torch.bfloat16:
        rnd = threefry.round_bf16
        lo, hi = rnd(f32(start)), rnd(f32(stop))
        div = num - 1
        t = rnd(np.arange(div, dtype=f32) / f32(div))
        body = rnd(rnd(lo * rnd(f32(1.0) - t)) + rnd(hi * t))
    else:
        lo, hi = f32(start), f32(stop)
        div = num - 1
        i = np.arange(div, dtype=f32)
        recip = f32(1.0) / f32(max(div, 1))
        head = lo * (f32(1.0) - i * recip)
        # the fused multiply-add, exact in float64 before its one rounding
        body = (i.astype(np.float64) * np.float64(hi * recip) + head).astype(f32)
    if num == 1:
        return np.atleast_1d(lo).astype(f32)
    return np.concatenate([body, np.atleast_1d(hi)]).astype(f32)


def linspace(start: float, stop: float, num: int, dtype=None,
             device: DeviceLike = None) -> torch.Tensor:
    dt = _dtype(dtype)
    return _put(_linspace_host(start, stop, num, dt), dt, device)


def ones(*shape, dtype=None, device: DeviceLike = None) -> torch.Tensor:
    return torch.ones(_shape(shape), dtype=_dtype(dtype), device=resolve_device(device))


def zeros(*shape, dtype=None, device: DeviceLike = None) -> torch.Tensor:
    return torch.zeros(_shape(shape), dtype=_dtype(dtype), device=resolve_device(device))


def create(data, dtype=None, device: DeviceLike = None) -> torch.Tensor:
    """Host data as a device tensor (Nd4j.create analog)."""
    return torch.as_tensor(np.asarray(data)).to(_dtype(dtype)).to(resolve_device(device))


def vstack(arrays: Sequence[torch.Tensor]) -> torch.Tensor:
    """Row-stack (Nd4j.vstack analog); 0-d and 1-d tensors count as rows."""
    return torch.cat([torch.atleast_2d(a) for a in arrays], dim=0)


def latent_grid(side: int, low: float = -1.0, high: float = 1.0, dtype=None,
                device: DeviceLike = None) -> torch.Tensor:
    """The reference's z-grid for latent-manifold plots: a ``side × side``
    cartesian grid over ``linspace(low, high, side)²`` flattened to
    ``(side², 2)``, first coordinate slowest."""
    axis = linspace(low, high, side, dtype=dtype, device=device)
    xx, yy = torch.meshgrid(axis, axis, indexing="ij")
    return torch.stack([xx.reshape(-1), yy.reshape(-1)], dim=-1)


def to_host(array) -> np.ndarray:
    """Explicit device→host copy, batched (the reference's per-scalar
    ``getDouble`` reads are not reproduced). numpy has no bfloat16, so a
    bfloat16 tensor comes back as the float32 array of the same values."""
    t = torch.as_tensor(array).detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


__all__ = ["RngStream", "create", "latent_grid", "linspace", "ones", "rand", "randn",
           "to_host", "uniform_latent", "vstack", "zeros"]
