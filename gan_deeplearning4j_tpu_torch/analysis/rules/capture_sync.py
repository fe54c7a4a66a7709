"""JG005 — host sync inside a CUDA-graph capture.

The torch counterpart of the JAX package's ``host_sync.py`` (a host
crossing inside traced code). A capture records the kernels a body queues
and replays them later without Python; the body runs once. A call that
needs the host inside it is either an error or a silent lie:

- a host read (``.item()``, ``.cpu()``, ``.tolist()``, ``.numpy()``,
  ``np.asarray(t)``), ``torch.cuda.synchronize()`` or an event's or a
  stream's ``synchronize()`` ends the capture with CUDA's "operation not
  permitted when stream is capturing" — and in ``"global"`` mode breaks
  every other thread's capture too;
- a ``pin_memory=True`` allocation (a ``cudaHostAlloc``) and
  ``gc.collect()`` (which may destroy another graph) end it the same way:
  the port learned both on the card (``runtime/capture.py``);
- ``print`` of a tensor runs once, at capture, and never on a replay.

Capture regions are found syntactically: the body of a
``with torch.cuda.graph(g):``, the statements between ``g.capture_begin()``
and ``g.capture_end()``, and — through the project index — every function
called, transitively, from one of those (the finding lands in the file that
owns the call). A capture (either spelling) not lexically inside
``with capture_guard():`` is flagged too: the guard holds the process's
capture lock and keeps the cyclic collector off during the capture.
"""

from __future__ import annotations

import ast

from gan_deeplearning4j_tpu_torch.analysis import _common
from gan_deeplearning4j_tpu_torch.analysis.project import capture_regions


def _hazard(call: ast.Call, mod):
    """The message for a host-crossing call, else None."""
    resolved = mod.resolve(call.func)
    if _common.is_host_read(call, mod.resolve):
        what = (resolved if resolved in _common.FENCE_CALLS
                or resolved in _common.HOST_READ_CALLS
                else f".{call.func.attr}()")
        return (f"`{what}` inside a CUDA-graph capture needs the host: it "
                f"ends the capture (\"operation not permitted when stream is "
                f"capturing\"); read or fence after the replay instead")
    if resolved == "gc.collect":
        return ("`gc.collect()` inside a CUDA-graph capture may destroy "
                "another graph mid-capture, which ends it; collect before "
                "the capture (capture_guard does)")
    if any(kw.arg == "pin_memory" and isinstance(kw.value, ast.Constant)
           and kw.value.value is True for kw in call.keywords) or (
            isinstance(call.func, ast.Attribute)
            and call.func.attr == "pin_memory"):
        return ("a pinned host allocation (`cudaHostAlloc`) inside a "
                "CUDA-graph capture ends the capture; allocate the pinned "
                "buffer before capturing")
    if resolved == "print" and any(
            not isinstance(a, ast.Constant) for a in call.args):
        return ("print inside a CUDA-graph capture runs once, at capture, "
                "never on a replay — and printing a tensor reads it on the "
                "host; print after the replay")
    return None


def _guarded(fn, anchor, mod) -> bool:
    """Whether ``anchor`` sits lexically inside ``with capture_guard():``
    in ``fn``."""
    for n in ast.walk(fn):
        if not isinstance(n, (ast.With, ast.AsyncWith)):
            continue
        if not any(isinstance(item.context_expr, ast.Call)
                   and _common.last_component(
                       mod.resolve(item.context_expr.func))
                   == _common.CAPTURE_GUARD for item in n.items):
            continue
        if any(sub is anchor for sub in ast.walk(n)):
            return True
    return False


class HostSyncInCapture:
    code = "JG005"
    name = "host-sync-in-capture"
    summary = ("host read, synchronize, pinned allocation, gc.collect or "
               "print inside a CUDA-graph capture, or a capture outside "
               "capture_guard()")

    def check(self, mod):
        reported = set()
        for scope in _common.iter_scopes(mod.tree):
            body = getattr(scope, "body", None)
            if not body:
                continue
            for anchor, nodes, graph in capture_regions(body, mod.resolve):
                if id(anchor) in reported:
                    continue
                reported.add(id(anchor))
                if not _guarded(scope, anchor, mod):
                    yield mod.finding(
                        self.code,
                        f"capture of `{graph}` outside `capture_guard()` — "
                        f"another thread's capture, or the cyclic collector "
                        f"destroying a graph mid-capture, can end it; wrap "
                        f"the capture in `with capture_guard():`",
                        anchor,
                    ), anchor
                for n in nodes:
                    if id(n) in reported or not isinstance(n, ast.Call):
                        continue
                    msg = _hazard(n, mod)
                    if msg:
                        reported.add(id(n))
                        yield mod.finding(self.code, msg, n), n
        yield from self._check_captured_functions(mod, reported)

    def _check_captured_functions(self, mod, reported):
        """Hazards in this module's functions that the index shows run
        inside a capture made elsewhere."""
        info = mod.project.by_path.get(mod.path) if mod.project else None
        if info is None:
            return
        for summary in info.functions.values():
            if not summary.in_capture:
                continue
            for n in _common.walk_excluding_defs(summary.node.body):
                if id(n) in reported or not isinstance(n, ast.Call):
                    continue
                msg = _hazard(n, mod)
                if msg:
                    reported.add(id(n))
                    yield mod.finding(
                        self.code,
                        f"`{summary.qualname}` runs inside the capture at "
                        f"{summary.capture_site}: {msg}",
                        n,
                    ), n
