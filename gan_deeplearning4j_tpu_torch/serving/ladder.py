"""Traffic-shaped bucket ladders — counterpart of
``gan_deeplearning4j_tpu/serving/ladder.py``, plain Python kept whole in
the port: learn the ladder from live sizes.

The serving engine captures one CUDA graph per (kind, bucket) on the card
(the JAX engine compiles one executable) and pads every request up to its
bucket. A ladder of ``1/8/32/128`` is a guess that shapes padding waste by
a config default instead of by traffic. This module closes that loop:

- :class:`SizeHistogram` — a bounded, thread-safe per-kind size
  histogram the micro-batcher records each ASSEMBLED flush into (one
  dict increment per flush; no allocation once a size has been seen).
  Flush sizes — not submit sizes — are what the engine pads: under
  concurrency the batcher coalesces requests, and a ladder solved from
  per-request sizes measurably regresses when coalesced batches fall in
  the gaps between its buckets. Exported via ``/metrics`` and persisted
  into the bundle manifest so the NEXT generation boots with learned
  buckets.
- :func:`solve_ladder` — an exact dynamic program over the observed
  sizes choosing ``<= budget`` buckets that minimize expected
  padded-rows waste. The incumbent's top bucket is always kept: it is
  the chunking contract (``max_batch``, the bulk-lane slab width, and
  the "chunks of top are waste-free" identity all key on it), so a
  learned ladder never changes what a request larger than top costs.
- :func:`expected_waste` — the objective itself, reusable by benches and
  tests as the oracle for what the engine's chunker will pad.
- manifest helpers (``write_ladder_block`` / ``manifest_ladder`` /
  ``manifest_histogram``) — the ladder travels WITH the bundle in
  ``serving.json`` (same atomic-rename write as the quant cost block),
  so every loader (``from_bundle``, mux ``build_engine``, fleet
  workers) resolves the same learned ladder without extra flags.

Waste model (what the DP minimizes): the engine's chunker takes
``n = min(top, remaining)`` slices and pads each to the smallest bucket
``>= n``. A flush of ``s`` rows therefore wastes nothing on its full
``top``-chunks and ``bucket(r) - r`` rows on the remainder
``r = s % top`` (``r = s`` when ``s < top``; ``r == 0`` wastes
nothing). Folding every observed size to its remainder reduces the
problem to: given remainder counts ``c_r`` over ``r in [1, top)``,
choose ``<= budget - 1`` cut sizes (plus the mandatory ``top``) to
minimize ``sum_r c_r * (bucket(r) - r)``. An optimal ladder only ever
places buckets AT observed remainders (lowering a bucket to the next
observed size below it never increases waste), so the exact optimum is
an O(m^2 * budget) DP over the ``m`` distinct remainders — the same
per-layer micro-batching split that mu-cuDNN solves with DP under a
workspace budget (PAPERS.md), with compile count playing the role of
workspace.
"""

from __future__ import annotations

import threading
from bisect import bisect_left
from typing import Dict, Mapping, Optional, Sequence, Tuple

__all__ = [
    "SizeHistogram",
    "solve_ladder",
    "expected_waste",
    "write_ladder_block",
    "manifest_ladder",
    "manifest_histogram",
]

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

    def merge(self, snapshot: Mapping[str, Mapping]) -> None:
        """Fold another histogram's snapshot in (adoption carry-forward,
        manifest restore). Accepts string size keys — JSON round-trips
        them that way."""
        for kind, sizes in (snapshot or {}).items():
            if not isinstance(sizes, Mapping):
                continue
            for s, c in sizes.items():
                try:
                    s, c = int(s), int(c)
                except (TypeError, ValueError):
                    continue
                if s >= 1 and c >= 1:
                    self._merge_one(str(kind), s, c)

    def _merge_one(self, kind: str, n: int, c: int) -> None:
        with self._lock:
            sizes = self._counts.setdefault(kind, {})
            if n in sizes or len(sizes) < self._max_sizes:
                sizes[n] = sizes.get(n, 0) + c
                return
            above = [s for s in sizes if s >= n]
            target = min(above) if above else max(sizes)
            sizes[target] += c
            self._folded += 1

    def snapshot(self) -> Dict[str, Dict[int, int]]:
        """``{kind: {size: count}}`` — a deep copy, sorted by size."""
        with self._lock:
            return {
                kind: {s: sizes[s] for s in sorted(sizes)}
                for kind, sizes in self._counts.items()
            }

    def merged(self) -> Dict[int, int]:
        """Cross-kind ``{size: count}`` — the solver's input (every kind
        shares one ladder per engine, so waste pools across kinds)."""
        out: Dict[int, int] = {}
        with self._lock:
            for sizes in self._counts.values():
                for s, c in sizes.items():
                    out[s] = out.get(s, 0) + c
        return {s: out[s] for s in sorted(out)}

    def total(self) -> int:
        with self._lock:
            return sum(c for sizes in self._counts.values()
                       for c in sizes.values())

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


def _fold_counts(counts: Mapping, top: int) -> Dict[int, int]:
    """Observed sizes -> remainder counts in ``[1, top)`` (full
    ``top``-chunks are waste-free and drop out of the objective)."""
    folded: Dict[int, int] = {}
    for s, c in counts.items():
        s, c = int(s), int(c)
        if s < 1 or c < 1:
            continue
        r = s % top if s >= top else s
        if r == 0:
            continue
        folded[r] = folded.get(r, 0) + c
    return folded


def expected_waste(counts: Mapping, buckets: Sequence[int]) -> int:
    """Padded rows the engine's chunker will waste serving ``counts``
    (``{size: count}``) on ``buckets`` — the solver's exact objective,
    and the bench's oracle."""
    ladder = sorted(set(int(b) for b in buckets))
    if not ladder or ladder[0] < 1:
        raise ValueError(f"bad ladder {buckets!r}")
    top = ladder[-1]
    waste = 0
    for r, c in _fold_counts(counts, top).items():
        b = ladder[bisect_left(ladder, r)]  # smallest bucket >= r < top
        waste += c * (b - r)
    return waste


def solve_ladder(counts: Mapping, budget: int, *,
                 top: Optional[int] = None) -> Tuple[int, ...]:
    """Choose ``<= budget`` buckets minimizing expected padded-rows
    waste over ``counts`` (``{size: count}``), always including ``top``.

    ``top`` defaults to the largest observed size; pass the incumbent
    ladder's top bucket to preserve the chunking contract
    (``max_batch`` and the bulk lane key on it). Deterministic: ties
    break toward fewer, then smaller, buckets. ``budget=1`` degenerates
    to ``(top,)``; an empty histogram returns ``(top,)`` (nothing to
    learn — callers keep their incumbent ladder instead).
    """
    if budget < 1:
        raise ValueError("budget must be >= 1")
    clean = {int(s): int(c) for s, c in (counts or {}).items()
             if int(s) >= 1 and int(c) >= 1}
    if top is None:
        if not clean:
            raise ValueError("empty histogram and no top bucket given")
        top = max(clean)
    top = int(top)
    if top < 1:
        raise ValueError(f"top bucket must be >= 1, got {top}")

    folded = _fold_counts(clean, top)
    sizes = sorted(folded)
    m = len(sizes)
    k_free = min(budget - 1, m)
    if k_free >= m:
        # a bucket at every observed remainder: zero waste
        return tuple(sizes + [top])
    if k_free == 0:
        return (top,)

    weight = [folded[s] for s in sizes]
    # prefix sums: pc[i] = sum(weight[:i]), pw[i] = sum(w*s over [:i])
    pc = [0] * (m + 1)
    pw = [0] * (m + 1)
    for i, (s, w) in enumerate(zip(sizes, weight)):
        pc[i + 1] = pc[i] + w
        pw[i + 1] = pw[i] + w * s

    def span_cost(j: int, i: int) -> int:
        # bucket at sizes[i] covering sizes[j..i] (0-based, inclusive)
        return sizes[i] * (pc[i + 1] - pc[j]) - (pw[i + 1] - pw[j])

    def tail_cost(i: int) -> int:
        # sizes[i+1..m-1] fall through to top
        return top * (pc[m] - pc[i + 1]) - (pw[m] - pw[i + 1])

    INF = float("inf")
    # dp[k][i]: min waste covering sizes[0..i] with exactly k buckets,
    # the k-th placed at sizes[i]
    dp = [[INF] * m for _ in range(k_free + 1)]
    parent = [[-1] * m for _ in range(k_free + 1)]
    for i in range(m):
        dp[1][i] = span_cost(0, i)
    for k in range(2, k_free + 1):
        dpk, dpk1 = dp[k], dp[k - 1]
        par = parent[k]
        for i in range(k - 1, m):
            best, arg = INF, -1
            for j in range(k - 2, i):
                if dpk1[j] is INF:
                    continue
                cand = dpk1[j] + span_cost(j + 1, i)
                if cand < best:  # strict: smallest j wins ties
                    best, arg = cand, j
            dpk[i], par[i] = best, arg

    # pick (k, i): fewer buckets win ties, then smaller last-bucket
    best, best_k, best_i = INF, 0, -1
    for k in range(1, k_free + 1):
        for i in range(m):
            total = dp[k][i] + tail_cost(i)
            if total < best:
                best, best_k, best_i = total, k, i
    if best_i < 0:  # unreachable (m >= 1 here), but stay total
        return (top,)

    picks = []
    k, i = best_k, best_i
    while i >= 0 and k >= 1:
        picks.append(sizes[i])
        i = parent[k][i]
        k -= 1
    ladder = sorted(set(picks) | {top})
    return tuple(ladder)


# -- manifest persistence ----------------------------------------------------
# The ladder block rides the bundle manifest (serving.json) next to the
# quant cost block, via the same atomic temp+rename write, so watchers
# never see a torn manifest and every loader resolves one source of
# truth. Imports of quant.variants stay lazy: quant.cost imports the
# serving engine, and the engine lazily imports THIS module.

LADDER_BLOCK = "ladder"


def write_ladder_block(bundle_dir: str, buckets: Sequence[int], *,
                       histogram: Optional[Mapping] = None,
                       solved_from: Optional[dict] = None) -> dict:
    """Persist a learned ladder (and optionally the histogram it was
    solved from) into the bundle manifest. Returns the block written."""
    from gan_deeplearning4j_tpu_torch.quant.variants import (
        read_bundle_manifest, write_bundle_manifest)

    ladder = sorted(set(int(b) for b in buckets))
    if not ladder or ladder[0] < 1:
        raise ValueError(f"bad ladder {buckets!r}")
    block: dict = {"buckets": ladder}
    if histogram:
        block["histogram"] = {
            str(kind): {str(s): int(c) for s, c in sizes.items()}
            for kind, sizes in histogram.items()
        }
    if solved_from:
        block["solved_from"] = dict(solved_from)
    manifest = read_bundle_manifest(bundle_dir)
    manifest[LADDER_BLOCK] = block
    write_bundle_manifest(bundle_dir, manifest)
    return block


def _read_block(bundle_dir: str) -> Optional[dict]:
    from gan_deeplearning4j_tpu_torch.quant.variants import read_bundle_manifest

    try:
        manifest = read_bundle_manifest(bundle_dir)
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


def manifest_histogram(bundle_dir: str) -> Optional[Dict[str, Dict[int, int]]]:
    """The histogram persisted alongside the ladder — seeds a new
    generation's live histogram so learning compounds across reloads."""
    block = _read_block(bundle_dir)
    if not block:
        return None
    raw = block.get("histogram")
    if not isinstance(raw, dict):
        return None
    out: Dict[str, Dict[int, int]] = {}
    for kind, sizes in raw.items():
        if not isinstance(sizes, dict):
            continue
        clean = {}
        for s, c in sizes.items():
            try:
                s, c = int(s), int(c)
            except (TypeError, ValueError):
                continue
            if s >= 1 and c >= 1:
                clean[s] = c
        if clean:
            out[str(kind)] = clean
    return out or None
