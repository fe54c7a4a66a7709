"""JG009 — host read reached through a callee inside a timed region.

The torch counterpart of the JAX package's ``callbacks.py`` (a host
callback inside a timed region). A host read (``.item()``, ``.cpu()``,
``.tolist()``, ``.numpy()``) or a synchronize drains the device queue and
stalls the host until it is empty. One at the end of a timed window is the
window's fence — the protocol JG002 enforces. One in the middle, followed
by more device work, or one repeated per iteration of a loop inside the
window, bills a pipeline drain and a host round trip to every
measurement; hidden in a helper two calls down, nobody sees it.

Through the project index's host-read taint (a function that reads or
fences directly, or through its callees), a call inside a timed window
(JG002's ``clock() - t0`` windows that hold device work of their own: a
``replay()``, a ``torch.*`` op or a ``@`` — the windows that measure, not
the ones that keep a phase's seconds) is flagged when it is not the
window's final fence: when device work or another such call follows it inside the
window, or when it sits in a loop nested in the window. Direct host reads
in the window are JG002's business, not this rule's.
"""

from __future__ import annotations

import ast

from gan_deeplearning4j_tpu_torch.analysis import _common
from gan_deeplearning4j_tpu_torch.analysis.rules.timing import (
    device_work,
    timed_windows,
)


class HostReadInTimedRegion:
    code = "JG009"
    name = "host-read-in-timed-region"
    summary = ("host read or synchronize reached through a callee inside a "
               "timed window, other than the window's final fence")

    def check(self, mod):
        if mod.project is None:
            return
        reported = set()
        for scope in _common.iter_scopes(mod.tree):
            body = getattr(scope, "body", None)
            if not body:
                continue
            loops = [n for n in _common.walk_excluding_defs(body)
                     if isinstance(n, (ast.For, ast.AsyncFor, ast.While))]
            for window in timed_windows(body, mod):
                yield from self._scan(window, loops, mod, reported)

    def _scan(self, window, loops, mod, reported):
        if not any(device_work(n, mod, project=False) for n in window.nodes):
            return  # a bookkeeping window (a phase's seconds), not a measurement
        tainted = []
        for n in window.nodes:
            if not isinstance(n, ast.Call) or _common.is_host_read(n, mod.resolve):
                continue
            summary = mod.project.resolve_function(mod, n.func)
            if summary is not None and mod.project.host_read_tainted(summary):
                tainted.append((n, summary))
        for call, summary in tainted:
            if id(call) in reported:
                continue
            in_loop = any(
                window.start < loop.lineno
                and (loop.end_lineno or loop.lineno) < window.end
                and any(sub is call for sub in ast.walk(loop))
                for loop in loops)
            later = any(
                getattr(n, "lineno", 0) > call.lineno
                and (device_work(n, mod) or any(n is c for c, _ in tainted))
                for n in window.nodes)
            if not (in_loop or later):
                continue
            reported.add(id(call))
            where = ("in a loop inside" if in_loop
                     else "before more device work in")
            yield mod.finding(
                self.code,
                f"`{ast.unparse(call.func)}` reads a device value on the "
                f"host or synchronizes (`{summary.fq}`, directly or through "
                f"its callees) {where} the timed window ending at line "
                f"{window.end} — the measurement includes a pipeline drain "
                f"and a host round trip; keep one fence, at the end",
                call,
            ), call
