"""JG020 — synchronous host I/O on a timed replay path.

The torch counterpart of the JAX package's ``step_io.py``. A replay
returns as soon as the graph is queued; the card runs it while the host
goes on. A timed window that replays a graph (or calls a project function
that launches device work) and also writes a file, fsyncs, replaces one,
opens a socket or a URL, or copies a tree — directly or in a helper two
calls down — blocks the host for the I/O between launches: once the card
has drained the queue it idles until the host returns, and every number
measured over the window includes the I/O. The checkpoint writes behind
the JAX rule are fsync-bound the same way here.

The window is JG009's: a ``clock() - t0`` delta of one scope that holds
device work of its own — a ``replay()``, a ``torch.*`` op or a ``@`` (a
window around helpers alone keeps a phase's seconds, and measures no
step). The I/O is a call in :data:`_common.SYNC_IO_CALLS` (an ``open``
only with a mode that writes) or a project function the index marks as
I/O-tainted (:meth:`ProjectIndex.io_tainted`). Timed I/O with no device
work — a publish timed on purpose, the supervisor's ``_publish`` — stays
silent, and so does I/O outside every window.
"""

from __future__ import annotations

import ast

from gan_deeplearning4j_tpu_torch.analysis import _common
from gan_deeplearning4j_tpu_torch.analysis.project import is_sync_io
from gan_deeplearning4j_tpu_torch.analysis.rules.timing import device_work, timed_windows


class SyncIoOnTimedReplayPath:
    code = "JG020"
    name = "sync-io-on-timed-replay-path"
    summary = ("synchronous file or network I/O reachable from a timed window "
               "that replays a graph or launches device work through a callee")
    skip_tests = True

    def check(self, mod):
        reported = set()
        for scope in _common.iter_scopes(mod.tree):
            body = getattr(scope, "body", None)
            if not body:
                continue
            for window in timed_windows(body, mod):
                work = next((t for n in window.nodes
                             for t in [device_work(n, mod, project=False)] if t), "")
                if work:
                    yield from self._scan(window, work, mod, reported)

    def _scan(self, window, work, mod, reported):
        for call in window.nodes:
            if not isinstance(call, ast.Call) or id(call) in reported:
                continue
            if is_sync_io(call, mod.resolve):
                detail = f"`{mod.resolve(call.func)}` is synchronous host I/O"
            elif mod.project is not None and mod.resolve(call.func) not in _common.CLOCK_CALLS:
                summary = mod.project.resolve_function(mod, call.func)
                if summary is None or not mod.project.io_tainted(summary):
                    continue
                detail = (f"`{ast.unparse(call.func)}` does synchronous host I/O "
                          f"(`{summary.fq}`, directly or through its callees)")
            else:
                continue
            reported.add(id(call))
            yield mod.finding(
                self.code,
                f"{detail} inside the timed window ending at line {window.end}, "
                f"which launches `{work}` — the host blocks on the I/O between "
                f"launches, the card idles once its queue drains, and the "
                f"measurement includes it; move the I/O off the timed path "
                f"(after the window, or on a background thread)",
                call,
            ), call
