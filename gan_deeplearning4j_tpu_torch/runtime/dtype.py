"""Thread-local dtype policy — counterpart of
``gan_deeplearning4j_tpu/runtime/dtype.py``.

Two dtypes, each per thread:

- the **default** (storage) dtype, float32 unless a scope says otherwise;
- the **compute** dtype that ``ops/linear.py::dense``, ``ops/conv.py::
  conv2d`` and ``conv2d_transpose`` cast their operands to. ``None`` means
  "the default dtype".

It is a scope that those three ops read, not ``torch.autocast``: the JAX
package casts only inside them, keeps ``dense``'s product in float32 and
upcasts a convolution's output to its input's dtype before the bias, while
autocast would round ``dense``'s product to bf16 and leave convolution
outputs in bf16 for the BatchNorm after them. Everything else (BatchNorm,
activations, losses, L2, clipping, the updaters) runs in the dtypes of its
tensors.

``weak_scalar(value, dtype)`` is a Python scalar as jnp's weak typing
feeds it to an op on an array of ``dtype``: rounded to that dtype first
(0.9 meets a bf16 array as 0.8984375). torch keeps a Python scalar in the
op's fp32 arithmetic instead, so the updaters and BatchNorm round theirs
explicitly; for a float32 tensor the rounding changes nothing.

The accepted names are the JAX package's: ``"bf16"``/``"bfloat16"`` for
bfloat16; ``None``, ``"f32"``, ``"float32"``, ``"none"`` and ``""`` for full
precision.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from typing import Optional

import torch

_state = threading.local()


def _get_state():
    if not hasattr(_state, "default_dtype"):
        _state.default_dtype = torch.float32
        _state.compute_dtype = None  # None => same as default
    return _state


def _as_dtype(dtype) -> torch.dtype:
    return dtype if isinstance(dtype, torch.dtype) else parse_compute_dtype(dtype) or torch.float32


def set_default_dtype(dtype) -> None:
    """Set this thread's parameter/storage dtype (the reference: float32)."""
    _get_state().default_dtype = _as_dtype(dtype)


def get_default_dtype() -> torch.dtype:
    return _get_state().default_dtype


def set_compute_dtype(dtype) -> None:
    """Set this thread's compute dtype (e.g. ``torch.bfloat16``). ``None``
    turns mixed precision off: compute in the default dtype."""
    _get_state().compute_dtype = None if dtype is None else _as_dtype(dtype)


def get_compute_dtype() -> torch.dtype:
    st = _get_state()
    return st.compute_dtype if st.compute_dtype is not None else st.default_dtype


@contextlib.contextmanager
def default_dtype_scope(dtype):
    st = _get_state()
    prev = st.default_dtype
    st.default_dtype = _as_dtype(dtype)
    try:
        yield
    finally:
        st.default_dtype = prev


def parse_compute_dtype(name) -> Optional[torch.dtype]:
    """Map a config/CLI string to a compute dtype: ``"bf16"``/``"bfloat16"``
    → ``torch.bfloat16``; ``None``/``"f32"``/``"float32"`` → None (compute
    in the default dtype). A ``torch.dtype`` passes through; any other name
    raises ``ValueError``."""
    if name is None or isinstance(name, torch.dtype):
        return name
    key = str(name).lower()
    if key in ("bf16", "bfloat16"):
        return torch.bfloat16
    if key in ("f32", "float32", "none", ""):
        return None
    raise ValueError(f"unknown compute dtype {name!r} (use 'bf16' or 'f32')")


@contextlib.contextmanager
def compute_dtype_scope(dtype):
    st = _get_state()
    prev = st.compute_dtype
    st.compute_dtype = None if dtype is None else _as_dtype(dtype)
    try:
        yield
    finally:
        st.compute_dtype = prev


@functools.lru_cache(maxsize=256)
def weak_scalar(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype``, as a Python float."""
    return float(torch.tensor(value, dtype=dtype))


def cast_float_leaves(tree, dtype: torch.dtype):
    """A nested-dict tree of tensors with every floating leaf cast to
    ``dtype``; other leaves (int step counters) pass through."""
    if isinstance(tree, dict):
        return {k: cast_float_leaves(v, dtype) for k, v in tree.items()}
    return tree.to(dtype) if torch.is_floating_point(tree) else tree
