"""JG021 — subprocess respawn loop with no attempt cap and no backoff.

The fleet manager relaunches dead workers from a supervision loop; the
hazard this rule polices arrived with it. A worker that dies *before
ever becoming routable* (a bundle that segfaults every boot, a poisoned
environment) turns an eager ``while alive: relaunch()`` supervisor into
a hot loop: a fresh process per scheduler tick, each one paying the full
interpreter + jax import cost, saturating the host the surviving
workers are trying to serve from — a fork bomb with extra steps. The
corrected idiom is the manager's spawn-failure backoff: count failures,
relaunch on a capped exponential schedule, surface a counter.

The rule: a ``while`` loop whose body reaches a process-spawning entry
point (:data:`_common.SPAWN_CALLS` — directly, or transitively through
a project function per the index's spawn-taint closure, constructors
included) is flagged when the loop has NEITHER

- an **attempt cap** — a comparison in the loop condition
  (``while relaunches <= budget:``, ``while candidate is None:`` —
  progress-shaped conditions that bound the loop), NOR
- a **backoff sleep** — ``time.sleep(...)``, a ``.sleep(...)`` method
  call, or a ``.wait(<timeout>)`` method call WITH an argument
  (``Event.wait(0.2)`` is the supervision loop's idiomatic pacer).
  An *argless* ``.wait()`` is NOT a pacer: ``while True:
  p = Popen(cmd); p.wait()`` is the canonical naive supervisor, and
  ``Popen.wait`` returns instantly when the child dies at boot — the
  loop forks as fast as the host allows.

``for`` loops are iteration-bounded by construction and never flagged.
Test modules are exempt (``skip_tests`` — test harnesses relaunch under
their own timeouts).
"""

from __future__ import annotations

import ast

from gan_deeplearning4j_tpu_torch.analysis import _common

#: method names that pace a loop (event.wait, stop.wait, time-ish sleeps
#: reached as attributes)
_PACER_METHODS = {"sleep", "wait"}


class UnboundedRespawnLoop:
    code = "JG021"
    name = "unbounded-respawn-loop"
    summary = ("subprocess spawn inside a while loop with neither an "
               "attempt cap nor a backoff sleep — a process that dies "
               "on every boot relaunches as fast as the host can fork")
    skip_tests = True

    def check(self, mod):
        for loop in ast.walk(mod.tree):
            if not isinstance(loop, ast.While):
                continue
            if self._capped(loop.test):
                continue
            body = list(_common.walk_excluding_defs(loop.body))
            if self._paced(body, mod):
                continue
            for call in body:
                if not isinstance(call, ast.Call):
                    continue
                spawner = self._spawn_target(call, mod)
                if spawner is None:
                    continue
                yield mod.finding(
                    self.code,
                    f"`{spawner}` is reached from an unbounded `while` "
                    f"loop with no backoff sleep on the respawn path — "
                    f"a process that dies before becoming healthy "
                    f"relaunches in a hot loop (one fresh process per "
                    f"iteration); cap the attempts or back off with a "
                    f"capped exponential sleep",
                    call,
                ), call

    @staticmethod
    def _capped(test: ast.expr) -> bool:
        """A comparison anywhere in the loop condition is read as an
        attempt cap / progress bound (``attempts < budget``,
        ``proc.poll() is None``). ``while True`` and event-flag shapes
        (``while not stop.is_set():``) are the unbounded supervisors
        this rule exists for."""
        return any(isinstance(n, ast.Compare) for n in ast.walk(test))

    @staticmethod
    def _paced(body, mod) -> bool:
        for n in body:
            if not isinstance(n, ast.Call):
                continue
            if mod.resolve(n.func) in _common.SLEEP_CALLS:
                return True
            if not (isinstance(n.func, ast.Attribute)
                    and n.func.attr in _PACER_METHODS):
                continue
            if n.func.attr == "sleep":
                return True
            # `.wait(...)` paces only WITH an argument: `stop.wait(0.2)`
            # bounds the iteration, while an argless `p.wait()` is the
            # naive supervisor blocking on a child that may die at boot
            # — Popen.wait returns instantly then, and the loop is hot
            if n.args or n.keywords:
                return True
        return False

    @staticmethod
    def _spawn_target(call: ast.Call, mod):
        """The spawning callee this call reaches, or None: a direct
        :data:`_common.SPAWN_CALLS` hit, or a project function whose
        spawn-taint closure is true (class constructors resolved through
        their ``__init__``)."""
        resolved = mod.resolve(call.func)
        if resolved in _common.SPAWN_CALLS:
            return resolved
        if mod.project is None:
            return None
        summary = mod.project.resolve_function(mod, call.func)
        if summary is None:
            # constructor shape: WorkerProcess(...) summarizes as
            # WorkerProcess.__init__ in the index (imported classes
            # resolve through the import map; module-local ones straight
            # off this module's function table)
            dotted = _common.dotted_name(call.func)
            if dotted is not None:
                summary = mod.project.resolve_function(
                    mod, f"{dotted}.__init__")
                if summary is None:
                    info = mod.project.by_path.get(mod.path)
                    if info is not None:
                        summary = info.functions.get(f"{dotted}.__init__")
        if summary is not None and mod.project.spawn_tainted(summary):
            return summary.fq
        return None
