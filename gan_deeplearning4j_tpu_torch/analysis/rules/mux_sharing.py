"""JG022 — cross-generation engine table touched outside the registry lock.

The multiplexing plane (serving/mux, docs/MULTIPLEX.md) holds N serving
generations in one variant table: ``registry._variants`` maps a name to
its engine + micro-batcher *while resident*. Unlike the single-model swap
seam (JG016), the table's membership itself is concurrent state — the
residency budget demotes a variant's engine to a cold manifest, a ramp
rollback rewrites weights, and the reload plane adopts new variants, all
from other threads. Reading another generation's engine straight out of
the table (``registry.variants["gen-12"].engine.dispatch(...)``,
``for v in self._variants.values(): v.engine...``) races those
transitions: the engine can be demoted (its batcher closed, its staging
buffers recycled through the shared pool) between the lookup and the
use, which finalizes foreign buffers and releases phantom replica
reservations — the same corruption class JG016 polices, multiplied by N
generations.

The rule: any load of an attribute named like a variant/engine table
(``variants``/``_variants``/``engines``/``_engines``) must sit inside a
``with`` block whose context expression is a lock-ish attribute
(name containing "lock", or a condition-variable name) of the SAME base
object — ``with registry.lock:`` guards ``registry.variants``, ``with
self.lock:`` guards ``self._variants``. Two conventions are exempt:

- ``__init__`` (construction is single-threaded by contract, as in
  JG016), and
- functions whose name ends in ``_locked`` (the caller-holds-the-lock
  helper convention the registry itself uses).

True negatives: access under the matching lock, the exempt conventions
above, locals snapshotted under the lock and used outside it, and
same-named attributes on objects whose lock IS held (the base-expression
match is exact, so ``with a.lock:`` does not bless ``b.variants``)."""

from __future__ import annotations

import ast

#: attribute names that read as "the cross-generation table"
_TABLE_NAMES = {"variants", "_variants", "engines", "_engines"}

#: with-context attribute names that count as a lock (JG016's set)
_LOCK_NAMES = {"_cv", "cv", "_cond", "cond", "_condition", "condition",
               "_mutex", "mutex"}


def _lock_base(expr: ast.AST):
    """``<base>.<lock-ish>`` context expression -> the dump of ``<base>``
    (the guard identity); None for anything else."""
    if isinstance(expr, ast.Attribute):
        name = expr.attr
        if "lock" in name.lower() or name in _LOCK_NAMES:
            return ast.dump(expr.value)
    return None


def _expr_src(expr: ast.AST) -> str:
    try:
        return ast.unparse(expr)
    except Exception:  # pragma: no cover - unparse handles all exprs here
        return "<expr>"


class CrossGenerationEngineSharing:
    code = "JG022"
    name = "unguarded-cross-generation-engine-sharing"
    summary = ("cross-generation engine/variant table accessed outside "
               "the registry lock")
    skip_tests = True

    def check(self, mod):
        for fn in ast.walk(mod.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if fn.name == "__init__" or fn.name.endswith("_locked"):
                continue
            yield from self._scan(mod, fn)

    def _scan(self, mod, fn):
        hits = []

        def visit(node: ast.AST, guarded: frozenset) -> None:
            if (isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and node is not fn):
                # nested defs get their own scan with a fresh guard set —
                # a closure does not inherit the lexical lock (it may run
                # on another thread, after the with block exited)
                return
            if isinstance(node, (ast.With, ast.AsyncWith)):
                inner = set(guarded)
                for item in node.items:
                    base = _lock_base(item.context_expr)
                    if base is not None:
                        inner.add(base)
                    visit(item.context_expr, guarded)
                inner = frozenset(inner)
                for child in node.body:
                    visit(child, inner)
                return
            if (isinstance(node, ast.Attribute)
                    and node.attr in _TABLE_NAMES
                    and ast.dump(node.value) not in guarded):
                hits.append(node)
            for child in ast.iter_child_nodes(node):
                visit(child, guarded)

        for stmt in fn.body:
            visit(stmt, frozenset())
        for node in hits:
            base = _expr_src(node.value)
            yield mod.finding(
                self.code,
                f"`{fn.name}` reads the cross-generation engine table "
                f"`{base}.{node.attr}` outside the registry lock — the "
                f"residency budget, a ramp rollback, or a reload adoption "
                f"can demote/evict an engine between the lookup and the "
                f"use (foreign staging buffers recycled, phantom replica "
                f"reservations); guard with `with {base}.lock:` or go "
                f"through the registry accessors",
                node,
            ), node
