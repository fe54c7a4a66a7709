"""JG012 — an in-place collective's input read afterwards as the local value.

The torch counterpart of the JAX package's ``sharding.py`` (a donation
made dead by ``out_shardings``): where JAX's hazard is a buffer silently
not aliased, torch's is a buffer silently aliased. ``dist.all_reduce(t)``,
``dist.broadcast(t, src)`` and the port's ``collectives.all_reduce_(t,
mesh)`` write their result into ``t``. Two shapes lose the local value:

1. an alias of ``t`` — ``a = t``, ``t.view(...)``, ``t[...]``,
   ``t.detach()`` — bound before the collective and read after it, with no
   ``.clone()``: it holds the reduced value, not the local one it was
   bound to (a local loss logged as the mesh's, a residual computed
   against the mean);
2. ``async_op=True``: the collective returns a work handle and the write
   lands when the card gets to it. ``t`` read before the handle's
   ``.wait()`` — or the handle discarded, so nothing waits — is either
   value.

The port's wrappers read nothing of the kind: ``collectives.all_reduce_``
reduces in place and returns the tensor, ``_packed`` reads the reduced
buffer on purpose, and synchronised BatchNorm reduces copies
(``all_reduce_sum``).
"""

from __future__ import annotations

import ast

from gan_deeplearning4j_tpu_torch.analysis import _common
from gan_deeplearning4j_tpu_torch.analysis.project import alias_root

_IN_PLACE = {"torch.distributed.all_reduce", "torch.distributed.broadcast",
             "torch.distributed.reduce"}
#: the port's in-place wrapper, matched by its last name component
_PORT_IN_PLACE = "all_reduce_"


def _in_place_target(call, mod):
    """The name an in-place collective writes into, else None."""
    if not (isinstance(call, ast.Call) and call.args and isinstance(call.args[0], ast.Name)):
        return None
    resolved = mod.resolve(call.func) or ""
    if resolved in _IN_PLACE or _common.last_component(resolved) == _PORT_IN_PLACE:
        return call.args[0].id
    return None


def _async(call) -> bool:
    return any(kw.arg == "async_op" and isinstance(kw.value, ast.Constant)
               and kw.value.value is True for kw in call.keywords)


class InPlaceCollectiveReadAsLocal:
    code = "JG012"
    name = "in-place-collective-read-as-local"
    summary = ("alias of an in-place collective's input read after it, or an "
               "async_op collective's input read before its wait")

    def check(self, mod):
        if "reduce" not in mod.text and "broadcast" not in mod.text:
            return
        for scope in _common.iter_scopes(mod.tree):
            body = getattr(scope, "body", None)
            if not body or not isinstance(scope, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            nodes = list(_common.walk_excluding_defs(body))
            collectives = [(n, t) for n in nodes for t in [_in_place_target(n, mod)] if t]
            if not collectives:
                continue
            yield from self._aliases(nodes, collectives, mod)
            yield from self._async(nodes, collectives, mod)

    def _aliases(self, nodes, collectives, mod):
        binds = {}
        for n in nodes:
            if isinstance(n, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                for name in _common.assignment_targets(n):
                    binds.setdefault(name, []).append(n.lineno)
        for stmt in nodes:
            if not isinstance(stmt, ast.Assign):
                continue
            root = alias_root(stmt.value)
            if not isinstance(root, ast.Name):
                continue
            for alias in _common.assignment_targets(stmt) - {root.id}:
                later = [ln for ln in binds.get(alias, ()) if ln > stmt.lineno]
                until = min(later) if later else float("inf")
                source_rebound = [ln for ln in binds.get(root.id, ()) if ln > stmt.lineno]
                hit = next((c for c, t in collectives if t == root.id
                            and stmt.lineno < c.lineno < until
                            and not any(ln < c.lineno for ln in source_rebound)), None)
                if hit is None:
                    continue
                read = next((n for n in nodes if isinstance(n, ast.Name) and n.id == alias
                             and isinstance(n.ctx, ast.Load)
                             and hit.lineno < n.lineno <= until), None)
                if read is None:
                    continue
                yield mod.finding(
                    self.code,
                    f"`{alias}` aliases `{root.id}`, which "
                    f"`{ast.unparse(hit.func)}` overwrites in place at line "
                    f"{hit.lineno}; read at line {read.lineno} it holds the "
                    f"collective's result, not the local value it was bound to "
                    f"— bind `{root.id}.clone()` for the local value",
                    stmt,
                ), stmt

    def _async(self, nodes, collectives, mod):
        parents = {}
        for n in nodes:
            for child in ast.iter_child_nodes(n):
                parents[id(child)] = n
        for call, target in collectives:
            if not _async(call):
                continue
            holder = parents.get(id(call))
            if isinstance(holder, ast.Expr):
                yield mod.finding(
                    self.code,
                    f"`{ast.unparse(call.func)}(..., async_op=True)` discards its "
                    f"work handle — nothing waits for the write into `{target}`, "
                    f"so a later read sees the local value or the result; keep "
                    f"the handle and `.wait()` before reading",
                    call,
                ), call
                continue
            if not (isinstance(holder, ast.Assign) and len(holder.targets) == 1
                    and isinstance(holder.targets[0], ast.Name)):
                continue
            handle = holder.targets[0].id
            waits = [n.lineno for n in nodes if isinstance(n, ast.Call)
                     and isinstance(n.func, ast.Attribute) and n.func.attr == "wait"
                     and isinstance(n.func.value, ast.Name) and n.func.value.id == handle
                     and n.lineno > call.lineno]
            until = min(waits) if waits else float("inf")
            read = next((n for n in nodes if isinstance(n, ast.Name) and n.id == target
                         and isinstance(n.ctx, ast.Load) and call.lineno < n.lineno < until),
                        None)
            if read is not None:
                yield mod.finding(
                    self.code,
                    f"`{target}` is read at line {read.lineno}, before "
                    f"`{handle}.wait()`, while `{ast.unparse(call.func)}` "
                    f"(async_op=True) may still be writing it — the read sees "
                    f"the local value or the result; wait first",
                    call,
                ), call
