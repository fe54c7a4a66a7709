"""JG025 — lock-order inversion (potential deadlock).

With PRs 11–15 every plane holds its own lock, and several hold two (the
fleet manager's ``_lock``/``_cycle_lock``/``_supervise_lock``, the mux
service's registry + splitter pair). Two threads that take the same two
locks in opposite orders deadlock the first time their critical sections
overlap — a hazard no drill reproduces reliably, because the window is a
few instructions wide. The classic static check: build the
lock-acquisition graph (edge A→B when B is acquired while A is held) and
flag cycles.

The model (phase-1 concurrency index): every ``with <lock>:`` acquisition
contributes edges from each lock already held (lexical nesting), plus one
resolved same-class call hop — ``with self._a: self._helper()`` where
``_helper`` does ``with self._b:`` contributes A→B at the call site. Lock
identities are class-qualified for ``self`` locks (``Manager._lock``),
source text for module-level and foreign locks (``_capture_lock``,
``registry.lock``) — and **unified across classes** through the index's
project-wide union-find: a lock injected via a constructor
(``Worker(lock=self._lock)`` forwarded into ``self._lk``) or planted by
attribute assignment (``worker._lk = self._lock``) is ONE canonical lock,
and the acquisition graph is project-wide, so an inversion split between
two planes (manager nests A→B, the worker it built around the same A
nests B→A) is found even though neither module alone contains a cycle.
Each cycle is reported exactly once, in the module owning its closing
edge (first in sorted path/line order — deterministic across runs).

Not flagged: re-acquiring the same canonical lock (RLock re-entrancy,
Condition-over-lock aliasing, and a shared injected lock held on both
sides of a call are not inversions); consistent global orderings (A→B
twice is one edge). Known false negatives: sharing routes other than
constructor injection/attribute assignment (a lock fished out of a
registry dict); ``.acquire()``/``.release()`` held regions outside
``with`` (the lifecycle index pairs those, but they carry no held-set).
"""

from __future__ import annotations

from typing import Dict, List, Optional


def _short(key: tuple) -> str:
    """Display form of a canonical (module, short_id) lock key."""
    return key[1]


class LockOrderInversion:
    code = "JG025"
    name = "lock-order-inversion"
    summary = ("two locks acquired in opposite orders on different paths — "
               "a potential deadlock")
    skip_tests = True

    def check(self, mod):
        if mod.project is None:
            return
        index = mod.project.concurrency
        edges = index.global_lock_edges()

        adj: Dict[tuple, List[tuple]] = {}
        for (a, b) in edges:
            adj.setdefault(a, []).append(b)
        for a in adj:
            adj[a].sort()

        # walk edges in deterministic (path, line, edge) order; the first
        # edge that closes each cycle owns the finding, and only the
        # module that owns it reports — one finding per cycle, stable
        # regardless of which module the runner visits first
        seen_cycles = set()
        for (a, b) in sorted(
                edges,
                key=lambda e: (edges[e][0], edges[e][1].lineno, e)):
            path = self._path(adj, b, a)
            if path is None:
                continue
            cycle = [a] + path  # a -> b -> ... -> a
            key = frozenset(cycle)
            if key in seen_cycles:
                continue
            seen_cycles.add(key)
            epath, node, where = edges[(a, b)]
            if epath != mod.path:
                continue
            hops = []
            for i in range(len(cycle) - 1):
                e = edges.get((cycle[i], cycle[i + 1]))
                loc = (f"{e[0]}:{e[1].lineno} in {e[2]}"
                       if e else "resolved hop")
                hops.append(
                    f"`{_short(cycle[i])}` -> `{_short(cycle[i + 1])}` "
                    f"({loc})")
            names = ' -> '.join(f'`{_short(c)}`' for c in cycle)
            yield mod.finding(
                self.code,
                f"lock-order inversion: taking `{_short(b)}` while "
                f"holding `{_short(a)}` (in {where}) closes the cycle "
                f"{names} — two threads entering these regions "
                f"concurrently can deadlock; pick one global acquisition "
                f"order [{'; '.join(hops)}]",
                node,
            ), node

    @staticmethod
    def _path(adj, start, goal) -> Optional[List[tuple]]:
        """Deterministic DFS path start -> ... -> goal, as a node list
        ending at goal (start included first), else None."""
        stack = [(start, [start])]
        visited = set()
        while stack:
            cur, path = stack.pop()
            if cur == goal:
                return path
            if cur in visited:
                continue
            visited.add(cur)
            for nxt in reversed(adj.get(cur, [])):
                if nxt not in visited:
                    stack.append((nxt, path + [nxt]))
        return None
