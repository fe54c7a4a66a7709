"""JG016 — swappable engine attribute touched outside the lock/swap seam.

The reload plane (deploy/) hot-swaps the serving engine under the
micro-batcher's lock: ``swap_engine`` rebinds ``self._engine`` while
worker, completer, and HTTP threads are all running. The seam only works
if EVERY access to the swappable attribute goes through that lock — an
unguarded ``self._engine.dispatch(...)`` can pair a flush cut from the old
engine with a dispatch on the new one, which finalizes foreign staging
buffers and releases phantom replica reservations (the reload-plane
thread-safety hazard the ROADMAP queued this rule for). The correct idioms
are a lock-guarded accessor, or snapshotting the attribute to a local
under the lock and using the local.

The rule: in any class with a ``swap*`` method, an attribute that method
rebinds (plain assignment — augmented counters like ``self._swaps += 1``
are not swap targets) is *swappable*; every load or store of it in any
method other than ``__init__`` must sit inside a ``with`` block whose
context expression is a lock-ish ``self`` attribute (name containing
"lock", or a condition variable: ``_cv``/``cond``/...). The swap method
itself is held to the same bar — a swap seam that rebinds without the
lock is the worst offender, not an exemption.

True negatives: reads under ``with self._lock:`` (or the condition
variable that wraps it), locals snapshotted under the lock, ``__init__``
(construction is single-threaded by contract), and classes with no swap
method at all.
"""

from __future__ import annotations

import ast
from typing import Iterable, Set

#: with-context attribute names that count as holding the swap lock
_LOCK_NAMES = {"_cv", "cv", "_cond", "cond", "_condition", "condition",
               "_mutex", "mutex"}


def _is_lockish(expr: ast.AST) -> bool:
    """``self.<lock-ish>`` (optionally ``self.<lock>.acquire_…()`` style
    calls are NOT with-contexts here — only the plain attribute)."""
    if (isinstance(expr, ast.Attribute)
            and isinstance(expr.value, ast.Name)
            and expr.value.id == "self"):
        name = expr.attr
        return "lock" in name.lower() or name in _LOCK_NAMES
    return False


def _self_attr(node: ast.AST):
    """The attribute name of a ``self.<attr>`` node, else None."""
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _assign_targets(node: ast.AST) -> Iterable[ast.AST]:
    """Flatten plain-assignment targets through tuple/list unpacking
    (``old, self._engine = self._engine, new``)."""
    if isinstance(node, ast.Assign):
        stack = list(node.targets)
        while stack:
            t = stack.pop()
            if isinstance(t, (ast.Tuple, ast.List)):
                stack.extend(t.elts)
            else:
                yield t


class SwapSeamUnguardedAccess:
    code = "JG016"
    name = "engine-swap-unguarded-access"
    summary = ("swappable engine attribute accessed outside the batcher's "
               "lock/swap seam")
    skip_tests = True

    def check(self, mod):
        for cls in ast.walk(mod.tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            methods = [n for n in cls.body
                       if isinstance(n, (ast.FunctionDef,
                                         ast.AsyncFunctionDef))]
            swap_methods = [m for m in methods
                            if m.name.lstrip("_").startswith("swap")]
            swappable: Set[str] = set()
            for m in swap_methods:
                for node in ast.walk(m):
                    for target in _assign_targets(node):
                        attr = _self_attr(target)
                        if attr is not None:
                            swappable.add(attr)
            if not swappable:
                continue
            for m in methods:
                if m.name == "__init__":
                    continue  # construction is single-threaded by contract
                yield from self._scan(mod, cls, m, swappable)

    def _scan(self, mod, cls, method, swappable: Set[str]):
        hits = []

        def visit(node: ast.AST, guarded: bool) -> None:
            if isinstance(node, (ast.With, ast.AsyncWith)):
                inner = guarded or any(
                    _is_lockish(item.context_expr) for item in node.items)
                for item in node.items:
                    visit(item, guarded)
                for child in node.body:
                    visit(child, inner)
                return
            attr = _self_attr(node)
            if attr in swappable and not guarded:
                hits.append((node, attr,
                             isinstance(getattr(node, "ctx", None),
                                        ast.Store)))
            for child in ast.iter_child_nodes(node):
                visit(child, guarded)

        for stmt in method.body:
            visit(stmt, False)
        for node, attr, is_store in hits:
            verb = "rebinds" if is_store else "reads"
            yield mod.finding(
                self.code,
                f"`{method.name}` {verb} swappable attribute `self.{attr}` "
                f"outside the lock — `{cls.name}` hot-swaps it in its "
                f"swap method, so another thread can observe a"
                f"{' torn rebind' if is_store else ' mid-swap value'}; "
                f"guard with `with self._lock:` or snapshot it to a local "
                f"under the lock",
                node,
            ), node
