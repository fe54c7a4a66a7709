"""Seeded key streams — counterpart of ``gan_deeplearning4j_tpu/runtime/prng.py``.

The reference seeds every graph with one integer seed and draws from a
global stateful RNG (``Nd4j.randn/rand``). ``RngStream`` is a stateful
stream of keys from one seed, with the JAX package's semantics and values:
its keys are ``(2,)`` uint32 numpy arrays equal to ``jax.random.key_data``
of the JAX stream's keys, computed by ``runtime/threefry.py`` on the host.
``runtime/factory.py`` draws from them.
"""

from __future__ import annotations

from typing import List

import numpy as np

from gan_deeplearning4j_tpu_torch.runtime import threefry


class RngStream:
    """A stateful stream of keys derived from one seed. Each
    :meth:`next_key` returns a fresh key; the stream is deterministic given
    the seed."""

    def __init__(self, seed: int):
        self._seed = int(seed)
        self._initial_key = threefry.PRNGKey(self._seed)
        self._key = self._initial_key

    @property
    def seed(self) -> int:
        return self._seed

    def next_key(self) -> np.ndarray:
        self._key, sub = threefry.split(self._key)
        return sub

    def next_keys(self, n: int) -> List[np.ndarray]:
        self._key, *subs = threefry.split(self._key, n + 1)
        return list(subs)

    def fork(self) -> "RngStream":
        """A new independent stream rooted at this one's next key; the
        child's ``reset`` rewinds to its own root, not the parent's."""
        child = RngStream(self._seed)
        child._initial_key = self.next_key()
        child._key = child._initial_key
        return child

    def reset(self) -> None:
        self._key = self._initial_key
