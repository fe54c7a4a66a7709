"""JG010 — a replayer's static output held across a second call.

The torch counterpart of the JAX package's ``donation_flow.py`` (donation
through ``functools.partial`` and imports). JG006 sees a static output's
alias read after a later replay in the function that captured the graph.
It is blind to the indirection the port's callers see: a helper that
replays a graph and returns its static output (``return cap.y``, or a
module global bound in the capture) — a *replayer*, in the project index's
words. Every call of a replayer writes into the same static tensor and
returns it, so a caller that binds one call's result and reads it after a
second call of the same replayer reads the second call's result. Nothing
raises; the first result is gone. The cure is a copy, at the call
(``run(1).clone()``) or in the helper (``return cap.y.clone()``, or
``out.copy_(cap.y)`` into a buffer of the caller's, as the serving engine
copies into its pinned host buffer under its replay lock).

Discovery, as the JAX rule's:

1. the replayer is called directly, imported from another module, or
   through a module-level alias the index records (``run2 = run``,
   ``double = functools.partial(run, device=d)``), or through a
   ``functools.partial`` bound in the scope;
2. a ``functools.partial`` that binds the replayer's buffer parameter (the
   object whose graph it replays and whose output it returns) is flagged
   where it is built: every call of it replays that one graph into one
   static output, so no two of its results can be held at once — the
   counterpart of the JAX rule's bound donated argument.

A result is flagged at its binding (``a = run(1)``) when it is read after a
later call of the same replayer with no rebind between. A defect is
reported under JG006 or JG010, never both: JG006 follows names bound to a
static output in the capturing function, JG010 the results of calls.
"""

from __future__ import annotations

import ast

from gan_deeplearning4j_tpu_torch.analysis import _common


class StaticOutputAcrossCalls:
    code = "JG010"
    name = "static-output-across-calls"
    summary = ("result of a replayer (a function that replays a captured graph "
               "and returns its static output) read after a second call of it")

    def check(self, mod):
        index = mod.project
        if index is None or not any(name in mod.text for name in index.replayer_names):
            return
        scopes = [s for s in _common.iter_scopes(mod.tree)
                  if getattr(s, "body", None)]
        for scope in scopes:
            body = [s for s in scope.body
                    if not isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef,
                                          ast.ClassDef))]
            nodes = list(_common.walk_excluding_defs(body))
            partials = {}
            for node in nodes:
                hit = self._partial(node, mod, index)
                if hit is None:
                    continue
                name, target, bound = hit
                if bound:
                    yield mod.finding(
                        self.code,
                        f"functools.partial binds `{target.name}`'s argument "
                        f"`{bound}`, the captured graph it replays — every call "
                        f"of `{name}` replays that one graph into one static "
                        f"output, so each result is overwritten by the next "
                        f"call; bind the data only, or copy each result",
                        node.value,
                    ), node.value
                else:
                    partials[name] = target
            yield from self._scan(nodes, partials, mod, index)

    def _partial(self, node, mod, index):
        """``(name, replayer, bound buffer param or "")`` for ``name =
        functools.partial(replayer, ...)``, else None."""
        if not (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and isinstance(node.value, ast.Call) and node.value.args
                and mod.resolve(node.value.func) == "functools.partial"):
            return None
        target = index.replayer(mod, node.value.args[0])
        if target is None:
            return None
        bound_args = node.value.args[1:]
        names = [target.params[i] for i in target.buffer_params]
        bound = [target.params[i] for i in target.buffer_params if i < len(bound_args)]
        bound += [kw.arg for kw in node.value.keywords if kw.arg in names]
        return node.targets[0].id, target, ", ".join(bound)

    def _replayer_call(self, call, partials, mod, index):
        if not isinstance(call, ast.Call):
            return None
        if isinstance(call.func, ast.Name) and call.func.id in partials:
            return partials[call.func.id]
        return index.replayer(mod, call.func)

    def _scan(self, nodes, partials, mod, index):
        calls = []  # (line, replayer fq, call)
        for n in nodes:
            target = self._replayer_call(n, partials, mod, index)
            if target is not None:
                calls.append((n.lineno, target.fq, n))
        if len(calls) < 2:
            return
        by_node = {id(c): fq for _, fq, c in calls}
        rebinds = {}
        for n in nodes:
            if isinstance(n, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                for name in _common.assignment_targets(n):
                    rebinds.setdefault(name, []).append(n.lineno)
        for stmt in nodes:
            if not (isinstance(stmt, ast.Assign) and id(stmt.value) in by_node):
                continue
            fq = by_node[id(stmt.value)]
            for result in sorted(_common.assignment_targets(stmt)):
                later = [ln for ln in rebinds.get(result, ()) if ln > stmt.lineno]
                until = min(later) if later else float("inf")
                again = [ln for ln, f, c in calls
                         if f == fq and c is not stmt.value and stmt.lineno < ln < until]
                if not again:
                    continue
                read = next((n for n in nodes if isinstance(n, ast.Name)
                             and n.id == result and isinstance(n.ctx, ast.Load)
                             and again[0] < n.lineno <= until), None)
                if read is None:
                    continue
                yield mod.finding(
                    self.code,
                    f"`{result}` holds the static output `{fq}` returned, and "
                    f"is read at line {read.lineno} after `{fq}` ran again at "
                    f"line {again[0]} — the replay wrote that call's result "
                    f"into the same tensor, so `{result}` shows it, not its "
                    f"own; copy it at the call "
                    f"(`{ast.unparse(stmt.value)[:40]}.clone()`)",
                    stmt,
                ), stmt
