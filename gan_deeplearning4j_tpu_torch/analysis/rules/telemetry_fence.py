"""JG015 — unfenced wall-clock delta around device work fed to a metrics
sink.

The torch counterpart of the JAX package's ``telemetry_fence.py``. The
telemetry plane makes recording a duration one line —
``hist.observe(time.perf_counter() - t0)``, ``stats.add("device", dt)`` —
and that revives JG002's bug where it does the most harm: CUDA launches
return at enqueue, so a delta around a graph ``replay()`` or a device
kernel's launch with no fence records the launch, not the work, and the
histogram lands in ``/metrics``, the SLO tracker and the routing and
reload decisions built on them.

Flagged: a ``clock() - t0`` (or ``t1 - t0``) delta, inline or through a
name, passed to ``.observe``/``.add``/``.record``/``.set``, whose window
holds a ``replay()`` or a call of a project function the index marks as
launching device work, with no fence (a synchronize or a host read, direct
or through a callee) after it inside the window. Deltas around host work,
and deltas that only reach plain dicts or lists, are left alone.
"""

from __future__ import annotations

import ast
from typing import Dict

from gan_deeplearning4j_tpu_torch.analysis import _common
from gan_deeplearning4j_tpu_torch.analysis.rules.timing import (
    timed_windows,
    unfenced_work,
)

_SINK_METHODS = {"observe", "add", "record", "set"}


class TelemetryUnfencedTiming:
    code = "JG015"
    name = "telemetry-unfenced-timing"
    summary = ("clock delta around a replay or device launch feeds a "
               "telemetry sink without a fence — the metric records the "
               "launch, not the work")
    skip_tests = True

    def check(self, mod):
        for scope in _common.iter_scopes(mod.tree):
            body = getattr(scope, "body", None)
            if not body:
                continue
            windows = {id(w.delta): w for w in timed_windows(body, mod)}
            if not windows:
                continue
            nodes = list(_common.walk_excluding_defs(body))
            named: Dict[str, ast.AST] = {}
            for n in nodes:
                if isinstance(n, ast.Assign) and id(n.value) in windows:
                    for target in n.targets:
                        if isinstance(target, ast.Name):
                            named[target.id] = n.value
            for call in nodes:
                if not (isinstance(call, ast.Call)
                        and isinstance(call.func, ast.Attribute)
                        and call.func.attr in _SINK_METHODS):
                    continue
                for arg in call.args:
                    delta = arg if id(arg) in windows else (
                        named.get(arg.id) if isinstance(arg, ast.Name) else None)
                    if delta is None:
                        continue
                    work = unfenced_work(windows[id(delta)], mod,
                                         direct_ops=False)
                    if not work:
                        continue
                    yield mod.finding(
                        self.code,
                        f"`{ast.unparse(call.func)[:48]}` records a "
                        f"wall-clock delta taken around `{work}` with no "
                        f"fence — CUDA launches return at enqueue, so the "
                        f"metric measures the launch, not the work; "
                        f"synchronize (or read the output) before the "
                        f"second clock read (JG002's contract, extended to "
                        f"telemetry sinks)",
                        call,
                    ), call
                    break
