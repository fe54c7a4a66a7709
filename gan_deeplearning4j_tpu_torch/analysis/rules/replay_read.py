"""JG006 — a captured graph's static buffer read after a later replay.

The torch counterpart of the JAX package's ``donation.py`` (a buffer read
after it was donated). A captured graph owns its outputs: every
``replay()`` writes the new result into the SAME static tensors. A name
bound to a static output — or to an alias of it (``a = y``, ``y[:n]``,
``y.view(...)``, ``y.detach()``) — holds a window onto the buffer, not a
value: read after a later replay of the same graph, it shows that replay's
result, not the one it was bound to. Nothing raises; the earlier result is
simply gone. The cure is a copy at bind time (``y.clone()``, or
``out.copy_(y)`` into a buffer of one's own — the serving engine's
``host.copy_(cap.y)`` under its replay lock).

The rule works per function: the project index records, for every capture
in it (``with torch.cuda.graph(g)`` or ``g.capture_begin()``), the names
the capture binds (its static outputs). An alias of one, bound outside the
capture, is flagged when it is read after a later ``g.replay()`` with no
rebind in between.
"""

from __future__ import annotations

import ast

from gan_deeplearning4j_tpu_torch.analysis import _common
from gan_deeplearning4j_tpu_torch.analysis.project import alias_root, capture_regions


def _alias_source(value: ast.AST):
    """The name an expression aliases (``y``, ``y[:n]``,
    ``y.view(...)``), else None."""
    root = alias_root(value)
    return root.id if isinstance(root, ast.Name) else None


class StaticBufferReadAfterReplay:
    code = "JG006"
    name = "static-buffer-read-after-replay"
    summary = ("alias of a captured graph's static output read after a "
               "later replay() — it shows the new result, not its own")

    def check(self, mod):
        info = mod.project.by_path.get(mod.path) if mod.project else None
        if info is None:
            return
        for summary in info.functions.values():
            for graph, (_, outs) in summary.static_names.items():
                if outs:
                    yield from self._scan(summary.node, graph, outs, mod)

    def _scan(self, fn, graph, outs, mod):
        nodes = list(_common.walk_excluding_defs(fn.body))
        replays = sorted(
            n.lineno for n in nodes
            if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
            and n.func.attr == "replay" and ast.unparse(n.func.value) == graph)
        if not replays:
            return
        captured = {id(n) for _, region, g in
                    capture_regions(fn.body, mod.resolve)
                    if g == graph for n in region}
        binds = {}  # alias name -> [bind lines]
        for n in nodes:
            if (isinstance(n, ast.Assign) and id(n) not in captured
                    and _alias_source(n.value) in outs):
                for target in _common.assignment_targets(n):
                    if target not in outs:
                        binds.setdefault(target, []).append(n)
        for alias, stmts in sorted(binds.items()):
            rebinds = sorted(
                n.lineno for n in nodes
                if isinstance(n, (ast.Assign, ast.AugAssign, ast.AnnAssign))
                and alias in _common.assignment_targets(n))
            for stmt in stmts:
                later = [r for r in rebinds if r > stmt.lineno]
                until = later[0] if later else float("inf")
                between = [r for r in replays if stmt.lineno < r < until]
                if not between:
                    continue
                use = next(
                    (n for n in nodes if isinstance(n, ast.Name)
                     and n.id == alias and isinstance(n.ctx, ast.Load)
                     and between[0] < n.lineno <= until), None)
                if use is None:
                    continue
                yield mod.finding(
                    self.code,
                    f"`{alias}` aliases `{graph}`'s static output "
                    f"`{_alias_source(stmt.value)}` and is read at line "
                    f"{use.lineno}, after `{graph}.replay()` at line "
                    f"{between[0]} rewrote it — it holds that replay's "
                    f"result, not its own; bind a copy "
                    f"(`{ast.unparse(stmt.value)[:40]}.clone()`)",
                    stmt,
                ), stmt
