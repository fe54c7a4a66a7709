"""JG024 — shared mutable attribute escapes its majority lock.

Generalizes JG016 beyond ``swap*`` classes to every threaded plane the
fleet now runs: the router's health loop mutates member tables the request
threads read, the autoscaler tick resizes what the manager loop walks, the
reload controller rebinds candidate state the /healthz handler snapshots,
the alert evaluator appends to event lists the drill reader drains. The
drills catch these races only probabilistically; this rule catches the
*inconsistency* statically.

The model (from the phase-1 concurrency index, :mod:`..concurrency`): a
class that spawns threads (``Thread(target=self._loop)``, ``Timer``,
``run`` of a ``Thread`` subclass) has ≥2 concurrent contexts — each
spawned entry point's same-class call closure, plus ``<caller>`` for the
public API. An instance attribute is *shared mutable state* when it is
mutated outside ``__init__`` (rebound, aug-assigned, subscript-stored, or
used through a mutator method like ``.append``) and touched from ≥2
contexts. When most of its accesses sit under one lock (≥2 guarded
accesses under lock L, strictly more than the accesses escaping L) but at
least one access escapes unguarded, each escape is flagged: the lock
discipline exists, and the escape is where another thread observes a torn
rebind or lost update.

Not flagged (true negatives): ``__init__`` (single-threaded construction,
as in JG016); never-locked attributes (no discipline to escape — Events
and atomic flags live here by design); attributes only read outside
``__init__``; classes that spawn no threads; accesses in ``*_locked``
methods and in private helpers whose every in-class call site holds the
lock (the caller-holds-the-lock convention); ``BaseHTTPRequestHandler``
subclasses (instances are per-request, so ``self`` attrs are not shared).

Known false negatives (static visibility only): module-global state shared
by module-level thread targets; attributes reached through non-``self``
bases; 50/50 guarded/unguarded splits (no majority — no discipline to
enforce); ``.acquire()``/``.release()`` pairs outside ``with``.
"""

from __future__ import annotations

from collections import Counter, defaultdict


class UnguardedSharedMutableState:
    code = "JG024"
    name = "unguarded-shared-mutable-state"
    summary = ("attribute shared across thread contexts escapes the lock "
               "that guards its other accesses")
    skip_tests = True

    def check(self, mod):
        if mod.project is None:
            return
        for cc in mod.project.concurrency.classes(mod.path):
            if not cc.instance_shared or not cc.entry_points:
                continue
            spawned = [e for e, kind in cc.entry_points.items()
                       if kind != "http-handler"]
            if not spawned:
                continue
            contexts = cc.thread_contexts()
            if len(contexts) < 2:
                continue
            yield from self._scan_class(mod, cc, contexts)

    def _scan_class(self, mod, cc, contexts):
        by_attr = defaultdict(list)
        for name, mc in cc.methods.items():
            if name == "__init__" or name.endswith("_locked"):
                continue
            for a in mc.accesses:
                if a.attr in cc.lock_attrs or a.attr in cc.lock_aliases:
                    continue
                by_attr[a.attr].append(
                    (a, a.held | mc.caller_held))
        for attr in sorted(by_attr):
            accesses = by_attr[attr]
            if not any(a.is_mutating for a, _ in accesses):
                continue  # read-only outside __init__: config, not state
            touched = {a.method for a, _ in accesses}
            hit = sum(1 for _, members in contexts if touched & members)
            if hit < 2:
                continue  # one thread owns it
            guard_votes = Counter()
            for _, held in accesses:
                for lock in held:
                    guard_votes[lock] += 1
            if not guard_votes:
                continue  # never locked anywhere: no discipline to escape
            # deterministic majority pick: most votes, ties by name
            lock, votes = sorted(
                guard_votes.items(), key=lambda kv: (-kv[1], kv[0]))[0]
            escapes = [(a, held) for a, held in accesses if lock not in held]
            if votes < 2 or votes <= len(escapes):
                continue  # no majority: not a discipline, a coincidence
            entries = ", ".join(
                f"`{e}`" for e in sorted(cc.entry_points))
            for a, _ in escapes:
                verb = ("mutates" if a.is_store or a.is_mutating
                        else "reads")
                yield mod.finding(
                    self.code,
                    f"`{a.method}` {verb} `self.{attr}` without holding "
                    f"`{lock.rpartition('.')[2]}` — `{cc.name}` runs "
                    f"threads ({entries}) and guards this attribute's "
                    f"other {votes} access(es) with that lock, so this "
                    f"escape can observe a torn rebind or lose an update; "
                    f"guard it or snapshot the attribute to a local under "
                    f"the lock",
                    a.node,
                ), a.node
