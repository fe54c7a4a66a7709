"""Captured iterations — the port of the JAX package's device-side training
loop, ``_build_multi_iteration`` (``gan_deeplearning4j_tpu/harness/
experiment.py:646-685``), which scans K fused iterations in one dispatch.

On the card a window of K iterations is K replays of one CUDA graph. The
graph holds one *device body*: a whole iteration (a WGAN-GP round) that
reads only fixed-address buffers and ends by writing its new states and its
``(3,)`` loss row back into buffers, in one ``torch._foreach_copy_``. So a
replay costs the host one graph launch and a few copies, where the eager
iteration launched every kernel itself.

The body is ``body(trees, inputs) -> (new_trees, loss_row)``: ``trees`` is
a dict of the experiment's states (``TrainState``s and params trees, None
allowed), ``inputs`` a dict of tensors (the real batch, its labels, and
``draws``: every input the host keys by step, packed into one float32 row:
z, label noise, the dis-LR scale, WGAN-GP's z and ε). The labels are a
static input like the features, copied in before each replay: a
class-conditional run's one-hot, which the body concatenates onto z, is
read from them, never frozen at capture. The body must be
functional (new tensors out, nothing written into its arguments) and must
read the host clock, the step counters or a host RNG nowhere: a captured
graph replays whatever the host computed at capture time, forever.

Static buffers. A *layout* is one buffer per distinct tensor of a set of
trees (positions that hold the same tensor share a buffer, as the weight
sync rebinds share them), keyed by the trees' structure, aliasing, dtypes
and shapes. An *entry* is one body at one input shape and one source
layout: it reads the source layout, and writes into the layout of what the
body returns, the target. After the first iteration the two are the same
layout, and the states are updated in place (the JAX package donates
them). The target differs where the trees' aliasing or dtypes change in an
iteration: from init (dis and the classifier share layers) to the steady
state (gan and gen share layers), after ``load_models`` (every tree apart),
and under bf16 storage, where Adam promotes bf16 params to float32 in
their first step and the moments in the next. Each such entry is captured
once and keyed apart, so a captured graph is never replayed on buffers of
another dtype.

Before each run the trees in hand are checked leaf by leaf against the
source layout's buffers by identity: a leaf that is not its buffer (a
state assigned from outside, a checkpoint loaded) is copied in. After the
run the trees are rebuilt on the target's buffers, aliased as the body's
output is, so they alias exactly as after an eager iteration. The step
counters live on the host and advance by what the body's first run showed.

On the CPU (asked for explicitly), and on the card with ``captured``
False, the same body runs uncaptured on the same buffers, with the same
copies and write-back: the plain version of the captured path, which the
CPU tests hold against the JAX package.

Data-parallel bodies (``parallel/``) make collectives. NCCL's run inside
a CUDA graph: a mesh experiment on NCCL captures its body, the
all-reduces, reduce-scatters and all-gathers included (the warmup runs
make NCCL's communicator before the capture), and a failed capture fails
the run. gloo's collectives are calls of a host library, which a graph
cannot hold, so an experiment on a gloo mesh builds this object with
``captured=False``: chosen from the backend when the experiment is made,
not a fallback taken when a capture fails.

Capture on the card: the body runs ``WARMUP_RUNS`` times on a side stream
without its write-back (the first run shows the target layout; nothing
trains, so nothing needs restoring), then ``torch.cuda.graph`` captures
body and write-back on that stream into a private memory pool, under the
process-wide capture lock (``runtime/capture.py``; serving engines capture
in the same process) in ``"thread_local"`` mode, with Python's cyclic
collector run before and held off during it (a graph of an unreachable
experiment destroyed mid-capture ends the capture). A capture
that fails raises; there is no eager fallback. ``capture_counts`` counts
captures by key, and a second capture of one key raises.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from gan_deeplearning4j_tpu_torch.parallel.trainer import TrainState
from gan_deeplearning4j_tpu_torch.runtime.capture import CAPTURE_ERROR_MODE, capture_guard

Body = Callable[[Dict, Dict[str, torch.Tensor]], Tuple[Dict, torch.Tensor]]

#: body runs on the side stream before a capture
WARMUP_RUNS = 2

_TENSOR, _NONE = "tensor", "none"


def flatten_trees(node, leaves: List[torch.Tensor], steps: List[int]):
    """Append ``node``'s tensors to ``leaves`` and its ``TrainState.step``
    counters to ``steps``, in a fixed order; return its structure
    (hashable, without the counters)."""
    if isinstance(node, torch.Tensor):
        leaves.append(node)
        return _TENSOR
    if node is None:
        return _NONE
    if isinstance(node, TrainState):
        steps.append(node.step)
        return (TrainState, flatten_trees(node.params, leaves, steps),
                flatten_trees(node.opt_state, leaves, steps))
    if isinstance(node, dict):
        return (dict, tuple(node), tuple(flatten_trees(v, leaves, steps) for v in node.values()))
    raise TypeError(f"a state tree holds {type(node).__name__}, not tensors")


def unflatten_trees(structure, leaves, steps):
    """The inverse of :func:`flatten_trees`, from iterators over the leaves
    and the step counters."""
    if structure == _TENSOR:
        return next(leaves)
    if structure == _NONE:
        return None
    if structure[0] is TrainState:
        step = next(steps)
        return TrainState(unflatten_trees(structure[1], leaves, steps),
                          unflatten_trees(structure[2], leaves, steps), step)
    return {k: unflatten_trees(c, leaves, steps) for k, c in zip(structure[1], structure[2])}


def _signature(structure, leaves) -> tuple:
    """What fixes a layout: the structure, which positions share a tensor
    (each position's first position holding the same tensor), and every
    position's dtype and shape."""
    first: Dict[int, int] = {}
    alias = tuple(first.setdefault(id(t), i) for i, t in enumerate(leaves))
    return structure, alias, tuple((t.dtype, tuple(t.shape)) for t in leaves)


class _Layout:
    """One buffer per distinct tensor of trees of one signature."""

    def __init__(self, signature: tuple, leaves: List[torch.Tensor], device: torch.device):
        self.signature = signature
        self.structure, alias, _ = signature
        firsts = sorted(set(alias))
        index = {p: i for i, p in enumerate(firsts)}
        self.firsts = firsts  # one position per buffer
        self.blocks = [index[a] for a in alias]  # position -> buffer
        self.buffers = [torch.empty(leaves[p].shape, dtype=leaves[p].dtype, device=device)
                        for p in firsts]

    def tensors(self) -> List[torch.Tensor]:
        """The leaves, position by position, as buffers."""
        return [self.buffers[b] for b in self.blocks]

    def load(self, leaves: List[torch.Tensor]) -> int:
        """Copy every leaf that is not its buffer into it; returns how many
        buffers were written."""
        written = 0
        with torch.no_grad():
            for buf, p in zip(self.buffers, self.firsts):
                if leaves[p] is not buf:
                    buf.copy_(leaves[p])
                    written += 1
        return written


@dataclasses.dataclass
class _Entry:
    """One body at one input shape, reading ``source``."""

    name: str
    source: _Layout
    inputs: Dict[str, torch.Tensor]  # static input buffers
    loss: torch.Tensor  # the (3,) loss row
    target: Optional[_Layout] = None
    deltas: Tuple[int, ...] = ()
    graph: Optional["torch.cuda.CUDAGraph"] = None
    runs: int = 0
    stats: Dict[str, float] = dataclasses.field(default_factory=dict)


class CapturedIterations:
    """Runs an experiment's device body over windows: on the card as
    replays of captured graphs, on the CPU (or with ``captured`` False) as
    the same body uncaptured on the same buffers.

    - ``capture_counts``: captures by entry name (each 1);
    - ``runs``: body runs (replays or uncaptured) since construction;
    - ``copies_in``: buffers written because a tree leaf was not its buffer;
    - ``entry_stats()``: per entry, its runs and, once captured, the
      warmup-and-capture seconds and the bytes its private memory pool
      reserved."""

    def __init__(self, body: Body, device: torch.device, captured: Optional[bool] = None):
        self._body = body
        self.device = device
        self.captured = device.type == "cuda" if captured is None else captured
        self._layouts: Dict[tuple, _Layout] = {}
        self._entries: Dict[tuple, _Entry] = {}
        self._stream = None
        self.capture_counts: Dict[str, int] = {}
        self.runs = 0
        self.copies_in = 0

    def entry_stats(self) -> Dict[str, Dict[str, float]]:
        return {e.name: {"runs": e.runs, **e.stats} for e in self._entries.values()}

    # -- layouts and entries ---------------------------------------------------
    def _layout(self, structure, leaves) -> _Layout:
        sig = _signature(structure, leaves)
        layout = self._layouts.get(sig)
        if layout is None:
            layout = self._layouts[sig] = _Layout(sig, leaves, self.device)
        return layout

    def _entry(self, structure, leaves, slots: Dict[str, torch.Tensor]) -> _Entry:
        source = self._layout(structure, leaves)
        shapes = tuple((n, t.dtype, tuple(t.shape)) for n, t in slots.items())
        key = (shapes, source.signature)
        entry = self._entries.get(key)
        if entry is None:
            dtypes = sorted({str(t.dtype).replace("torch.", "") for t in source.buffers})
            name = (" ".join(f"{n}{list(s)}" for n, _, s in shapes)
                    + f" | {len(leaves)} leaves in {len(source.buffers)} buffers, "
                    + "/".join(dtypes) + f" | layout {len(self._entries)}")
            entry = self._entries[key] = _Entry(
                name, source,
                {n: torch.empty(t.shape, dtype=t.dtype, device=self.device) for n, t in slots.items()},
                torch.empty(3, dtype=torch.float32, device=self.device))
        return entry

    # -- one run ----------------------------------------------------------------
    def _apply(self, entry: _Entry, steps: List[int]):
        """The body on the entry's buffers: ``(output leaves, output steps,
        output structure, loss row)``."""
        trees = unflatten_trees(entry.source.structure, iter(entry.source.tensors()), iter(steps))
        new_trees, row = self._body(trees, entry.inputs)
        leaves, out_steps = [], []
        structure = flatten_trees(new_trees, leaves, out_steps)
        return leaves, out_steps, structure, row

    def _bind_target(self, entry: _Entry, structure, leaves, steps, out_steps) -> None:
        """The target layout from the body's first output, and the step
        increments."""
        sig = _signature(structure, leaves)
        if sig == entry.source.signature:
            # in place: an output that is a static buffer may only be its
            # own position's, or a copy could read a buffer already written
            src = entry.source
            storages = {b.untyped_storage().data_ptr(): i for i, b in enumerate(src.buffers)}
            for p, t in enumerate(leaves):
                i = storages.get(t.untyped_storage().data_ptr())
                if i is not None and (i != src.blocks[p] or t is not src.buffers[i]):
                    raise RuntimeError(f"the body returns a view of a static input at leaf {p}")
            entry.target = src
        else:
            entry.target = self._layout(structure, leaves)
        entry.deltas = tuple(o - i for o, i in zip(out_steps, steps))

    def _write_back(self, entry: _Entry, leaves, row) -> None:
        target = entry.target
        with torch.no_grad():
            torch._foreach_copy_(target.buffers + [entry.loss],
                                 [leaves[p] for p in target.firsts] + [row])

    def _run_plain(self, entry: _Entry, steps: List[int]) -> None:
        leaves, out_steps, structure, row = self._apply(entry, steps)
        if entry.target is None:
            self._bind_target(entry, structure, leaves, steps, out_steps)
        self._write_back(entry, leaves, row)

    def _capture(self, entry: _Entry, steps: List[int]) -> None:
        if entry.name in self.capture_counts:
            raise RuntimeError(f"captured twice: {entry.name}")
        self.capture_counts[entry.name] = 1
        t0 = time.perf_counter()
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        side = self._stream
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            first = self._apply(entry, steps)
            for _ in range(WARMUP_RUNS - 1):
                self._apply(entry, steps)
        torch.cuda.current_stream(self.device).wait_stream(side)
        leaves, out_steps, structure, _ = first
        # the target's buffers are allocated on the stream that replays
        self._bind_target(entry, structure, leaves, steps, out_steps)
        del first, leaves
        graph = torch.cuda.CUDAGraph()
        # an unreachable experiment's graph that the cyclic collector
        # destroyed mid-capture would end the capture: collect first, and
        # not during it; one capture at a time in the process
        with capture_guard():
            with torch.cuda.graph(graph, stream=side, capture_error_mode=CAPTURE_ERROR_MODE):
                reserved = torch.cuda.memory_reserved(self.device)
                leaves, _, _, row = self._apply(entry, steps)
                self._write_back(entry, leaves, row)
            del leaves, row
        entry.graph = graph
        torch.cuda.synchronize(self.device)
        entry.stats = {"warmup_and_capture_s": time.perf_counter() - t0,
                       "pool_reserved_bytes": torch.cuda.memory_reserved(self.device) - reserved}

    # -- windows ----------------------------------------------------------------
    def run(self, trees: Dict, window: Dict[str, torch.Tensor]) -> Tuple[Dict, torch.Tensor]:
        """K runs of the body over ``window`` (``{name: (K, …) tensor on the
        device}``, slot k feeding run k). Returns the new trees, on static
        buffers, and a freshly allocated ``(K, 3)`` loss tensor."""
        leaves, steps = [], []
        structure = flatten_trees(trees, leaves, steps)
        k_total = next(iter(window.values())).shape[0]
        losses = torch.empty((k_total, 3), dtype=torch.float32, device=self.device)
        entry = None
        for k in range(k_total):
            slots = {n: t[k] for n, t in window.items()}
            if entry is None or entry.target is not entry.source:
                entry = self._entry(structure, leaves, slots)
                self.copies_in += entry.source.load(leaves)
            with torch.no_grad():
                torch._foreach_copy_(list(entry.inputs.values()), [slots[n] for n in entry.inputs])
            if not self.captured:
                self._run_plain(entry, steps)
            else:
                if entry.graph is None:
                    self._capture(entry, steps)
                entry.graph.replay()
            self.runs += 1
            entry.runs += 1
            with torch.no_grad():
                losses[k].copy_(entry.loss)
            leaves, structure = entry.target.tensors(), entry.target.structure
            steps = [s + d for s, d in zip(steps, entry.deltas)]
        return unflatten_trees(structure, iter(leaves), iter(steps)), losses
