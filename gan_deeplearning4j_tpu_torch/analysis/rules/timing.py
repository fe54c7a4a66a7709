"""JG002 — stale or missing fence around CUDA work.

The torch counterpart of the JAX package's ``timing.py``. CUDA launches
are asynchronous: a torch op returns as soon as its kernel is queued, so a
host clock read after it measures the enqueue, not the work. A wall-clock
window around device work must end in a fence — ``torch.cuda.synchronize``,
an event's or a stream's ``synchronize()``, or a host read of the work's
output (``.item()``, ``.cpu()``, ``.tolist()``, ``.numpy()``) — before its
second clock read. Two patterns:

1. stale fence in a timed loop — a for/while loop that reads a wall clock
   and fences by a host read none of whose names is bound inside the loop:
   the read cannot be of this iteration's output, and is served from an
   earlier one (the JAX rule's pattern, with torch's host reads). A loop
   that replays a graph is exempt: the replay rewrites the static outputs
   bound before it;
2. missing fence — ``clock() - t0`` (inline, or ``t1 - t0`` of two clock
   reads) whose window holds device work — a graph ``replay()``, a
   ``torch.*`` op, a ``@`` product, or a project function the index marks
   as launching device work — and no fence after the last of it: a call
   that fences through its callees (the index's host-read taint) counts.

On an H100, 20 fp32 4096² products take tens of milliseconds; the
unfenced window around them reads well under half of that (``chip_smoke.py``
(aa2)).
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional

from gan_deeplearning4j_tpu_torch.analysis import _common
from gan_deeplearning4j_tpu_torch.analysis.project import is_device_call

_CASTS = {"float", "int", "bool"}


@dataclasses.dataclass
class Window:
    """One timed window of a scope: from the clock read bound to the
    origin name (line ``start``) to the closing clock read (line ``end``);
    ``delta`` is the subtraction node, ``nodes`` the scope's nodes with
    ``start < line <= end``."""

    start: int
    end: int
    delta: ast.BinOp
    nodes: List[ast.AST]


def _is_clock(node, mod) -> bool:
    return (isinstance(node, ast.Call)
            and mod.resolve(node.func) in _common.CLOCK_CALLS)


def timed_windows(body, mod) -> List[Window]:
    """Every ``clock() - t0`` / ``t1 - t0`` window of a scope body (nested
    defs excluded), in source order."""
    nodes = list(_common.walk_excluding_defs(body))
    clock_binds: Dict[str, List[int]] = {}
    for n in nodes:
        if isinstance(n, ast.Assign) and _is_clock(n.value, mod):
            for target in n.targets:
                if isinstance(target, ast.Name):
                    clock_binds.setdefault(target.id, []).append(n.lineno)

    def bound_line(name: str, before: int) -> Optional[int]:
        lines = [ln for ln in clock_binds.get(name, ()) if ln <= before]
        return max(lines) if lines else None

    out = []
    for n in nodes:
        if not (isinstance(n, ast.BinOp) and isinstance(n.op, ast.Sub)
                and isinstance(n.right, ast.Name)):
            continue
        start = bound_line(n.right.id, n.lineno)
        if start is None:
            continue
        if _is_clock(n.left, mod):
            end = n.left.lineno
        elif isinstance(n.left, ast.Name):
            end = bound_line(n.left.id, n.lineno)
            if end is None or end <= start:
                continue
        else:
            continue
        inside = [m for m in nodes if start < getattr(m, "lineno", 0) <= end]
        out.append(Window(start, end, n, inside))
    out.sort(key=lambda w: (w.start, w.end))
    return out


def device_work(node, mod, direct_ops: bool = True,
                project: bool = True) -> str:
    """Source text of ``node`` when it queues device work, else "":
    ``replay()``, (``project``) a project function the index marks as
    launching device work, and (``direct_ops``) a ``torch.*`` op or a
    ``@`` product."""
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.MatMult):
        return ast.unparse(node)[:48] if direct_ops else ""
    if not isinstance(node, ast.Call):
        return ""
    if (isinstance(node.func, ast.Attribute) and node.func.attr == "replay"
            and not node.args):
        return ast.unparse(node)[:48]
    if direct_ops and is_device_call(node, mod.resolve):
        return ast.unparse(node)[:48]
    if project and mod.project is not None:
        summary = mod.project.resolve_function(mod, node.func)
        if summary is not None and mod.project.device_tainted(summary):
            return ast.unparse(node)[:48]
    return ""


def is_fence(node, mod) -> bool:
    """A host read or synchronize, direct or through a project callee; a
    ``float``/``int``/``bool`` of a computed value counts (on a tensor it
    is a host read; counting one that is not only spares a finding)."""
    if not isinstance(node, ast.Call):
        return False
    if _common.is_host_read(node, mod.resolve):
        return True
    if (isinstance(node.func, ast.Name) and node.func.id in _CASTS
            and node.func.id not in mod.imports and node.args
            and not isinstance(node.args[0], ast.Constant)):
        return True
    if mod.project is None:
        return False
    summary = mod.project.resolve_function(mod, node.func)
    return summary is not None and mod.project.host_read_tainted(summary)


def unfenced_work(window: Window, mod, direct_ops: bool = True) -> str:
    """Source text of the last device work in ``window`` when no fence
    follows it inside the window, else ""."""
    work = [(getattr(n, "lineno", 0), text) for n in window.nodes
            for text in [device_work(n, mod, direct_ops)] if text]
    if not work:
        return ""
    last_line, text = max(work)
    if any(is_fence(n, mod) and n.lineno >= last_line for n in window.nodes):
        return ""
    return text


def _fence_read_names(call: ast.Call, mod):
    """Names whose values a host-read fence forces to the host, or None if
    ``call`` is not one (``synchronize`` reads no name)."""
    resolved = mod.resolve(call.func)
    if resolved in _common.HOST_READ_CALLS:
        names = set()
        for arg in call.args:
            names |= _common.loaded_names(arg)
        return names
    if (isinstance(call.func, ast.Attribute)
            and call.func.attr in _common.HOST_READ_METHODS and not call.args):
        return _common.loaded_names(call.func.value)
    return None


class StaleOrMissingFence:
    code = "JG002"
    name = "stale-or-missing-fence"
    summary = ("timed window around CUDA work with no fence, or a timed "
               "loop fencing on a value bound outside it — measures the "
               "enqueue, not the work")

    def check(self, mod):
        yield from self._check_loops(mod)
        yield from self._check_windows(mod)

    # -- pattern 1: in-loop stale fence ------------------------------------
    def _check_loops(self, mod):
        for loop in _common.iter_loops(mod.tree):
            if not any(_is_clock(n, mod)
                       for n in _common.walk_excluding_defs(loop)):
                continue
            loop_bound = _common.bound_names(loop)
            if any(isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
                   and n.func.attr == "replay"
                   for n in _common.walk_excluding_defs(loop)):
                continue  # a replay rewrites static outputs bound outside
            for n in _common.walk_excluding_defs(loop):
                if not isinstance(n, ast.Call):
                    continue
                read = _fence_read_names(n, mod)
                if read and not (read & loop_bound):
                    yield mod.finding(
                        self.code,
                        f"timed loop fences on `{ast.unparse(n)[:60]}` but "
                        f"none of {sorted(read)} is assigned in the loop — "
                        f"the read waits on a stale value, not this "
                        f"iteration's output",
                        n,
                    ), n

    # -- pattern 2: a window with no fence ----------------------------------
    def _check_windows(self, mod):
        seen = set()
        for scope in _common.iter_scopes(mod.tree):
            body = getattr(scope, "body", None)
            if not body:
                continue
            for window in timed_windows(body, mod):
                if id(window.delta) in seen:
                    continue
                seen.add(id(window.delta))
                work = unfenced_work(window, mod)
                if work:
                    yield mod.finding(
                        self.code,
                        f"wall-clock delta `{ast.unparse(window.delta)[:48]}` "
                        f"spans device work `{work}` with no fence before "
                        f"the second clock read — CUDA launches return at "
                        f"enqueue, so this times the launch, not the work; "
                        f"`torch.cuda.synchronize()` (or read the output) "
                        f"first",
                        window.delta,
                    ), window.delta
