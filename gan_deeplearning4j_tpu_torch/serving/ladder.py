"""Bucket-ladder support the serving path needs — from
``gan_deeplearning4j_tpu/serving/ladder.py``:

- :class:`SizeHistogram` — the bounded, thread-safe per-kind flush-size
  histogram the micro-batcher records each assembled flush into (exported
  via ``/metrics``);
- :func:`manifest_ladder` — the learned ladder a bundle's ``serving.json``
  carries in its ``ladder`` block, read straight from the manifest.

Solving a ladder from traffic (``solve_ladder``) and writing it back into
a bundle come with the rest of the serving plane (ROADMAP.md queue 1,
"Serving, the rest").
"""

from __future__ import annotations

import json
import os
import threading
from typing import Dict, Optional, Tuple

__all__ = ["SizeHistogram", "manifest_ladder"]

LADDER_BLOCK = "ladder"

#: distinct sizes tracked per kind before overflow folding kicks in.
#: Request sizes are small integers (rows per request); 256 distinct
#: values per kind is far past anything the batcher has ever seen, and
#: bounds both memory and the DP's input width.
DEFAULT_MAX_SIZES = 256


class SizeHistogram:
    """Bounded per-kind request-size counts, safe under the batcher's
    submit concurrency.

    Overflow policy (documented because it biases the solver): once a
    kind tracks ``max_sizes`` distinct sizes, an unseen size is folded
    UP to the smallest tracked size above it — conservative for the
    padding objective (the solver then plans for a slightly larger
    request, never a smaller one). A size above every tracked size folds
    into the largest tracked size: it undercounts rows but keeps the
    table bounded, and sizes that large are chunk-dominated anyway.
    """

    __slots__ = ("_lock", "_counts", "_max_sizes", "_folded")

    def __init__(self, max_sizes: int = DEFAULT_MAX_SIZES):
        if max_sizes < 1:
            raise ValueError("max_sizes must be >= 1")
        self._lock = threading.Lock()
        self._counts: Dict[str, Dict[int, int]] = {}
        self._max_sizes = int(max_sizes)
        self._folded = 0  # records that hit the overflow fold

    def record(self, kind: str, n: int) -> None:
        """Count one request of ``n`` rows for ``kind`` (hot path)."""
        n = int(n)
        if n < 1:
            return
        with self._lock:
            sizes = self._counts.get(kind)
            if sizes is None:
                sizes = self._counts[kind] = {}
            if n in sizes:
                sizes[n] += 1
                return
            if len(sizes) < self._max_sizes:
                sizes[n] = 1
                return
            # overflow: fold up to the nearest tracked size (see class
            # docstring), else into the largest tracked size
            above = [s for s in sizes if s >= n]
            target = min(above) if above else max(sizes)
            sizes[target] += 1
            self._folded += 1

    def snapshot(self) -> Dict[str, Dict[int, int]]:
        """``{kind: {size: count}}`` — a deep copy, sorted by size."""
        with self._lock:
            return {
                kind: {s: sizes[s] for s in sorted(sizes)}
                for kind, sizes in self._counts.items()
            }

    def stats(self) -> dict:
        """The ``/metrics`` export block."""
        snap = self.snapshot()
        return {
            "total": sum(c for sizes in snap.values()
                         for c in sizes.values()),
            "folded": self._folded,
            "kinds": {
                kind: {str(s): c for s, c in sizes.items()}
                for kind, sizes in snap.items()
            },
        }


def _read_block(bundle_dir: str) -> Optional[dict]:
    try:
        with open(os.path.join(bundle_dir, "serving.json")) as fh:
            manifest = json.load(fh)
    except (OSError, ValueError):
        return None
    block = manifest.get(LADDER_BLOCK)
    return block if isinstance(block, dict) else None


def manifest_ladder(bundle_dir: str) -> Optional[Tuple[int, ...]]:
    """The bundle's learned ladder, or None when absent/malformed (a
    malformed block must fall back to defaults, never fail a load)."""
    block = _read_block(bundle_dir)
    if not block:
        return None
    raw = block.get("buckets")
    if not isinstance(raw, (list, tuple)) or not raw:
        return None
    try:
        ladder = tuple(sorted(set(int(b) for b in raw)))
    except (TypeError, ValueError):
        return None
    if ladder[0] < 1:
        return None
    return ladder
