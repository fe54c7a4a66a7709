"""JG014 — one seed handed to two seeding helpers.

The torch counterpart of the JAX package's ``prng_flow.py`` (one PRNG key
handed to two consuming helpers). A ``torch.Generator`` has state: sharing
one generator across helpers draws distinct numbers, and is safe. The
torch hazard is the seed. A helper that seeds a generator from its
parameter (``torch.Generator().manual_seed(seed)``) replays the stream that
seed names, so one seed expression handed to two such helpers — or to one
helper and one direct ``manual_seed`` — gives both the same stream: the
noise of two phases comes out equal, or a dataset's shuffle matches its
dropout masks. JG001 sees the direct form in one scope; the hand-off hides
it a module away.

The project index records each function's *seeding parameters*: those
whose value reaches ``manual_seed`` in its body (the seed expression is
the parameter, ``int(param)`` or a branch of a conditional that is), or
handed whole to another function at one of its seeding parameters. A
*hand-off* is a call of a resolved project function with an argument at a
seeding parameter. Two detections, JG001's shapes with hand-offs:

1. one seed expression used twice in one scope with no rebind of its names
   between, at least one use a hand-off (pairs where both uses are direct
   ``manual_seed`` calls are JG001's);
2. a hand-off inside a loop whose seed reads no name the loop binds: every
   iteration replays one stream.

Unresolvable callees (methods of objects, attributes) are silence. Test
modules are exempt: they seed alike on purpose, as the JAX rule's are.
"""

from __future__ import annotations

import ast

from gan_deeplearning4j_tpu_torch.analysis import _common
from gan_deeplearning4j_tpu_torch.analysis.project import seed_argument


def _stmt_roots(stmt):
    """The parts of a statement evaluated when it runs (a compound
    statement's header, not its body: the body is scanned as a block)."""
    if isinstance(stmt, (ast.For, ast.AsyncFor)):
        return [stmt.iter]
    if isinstance(stmt, ast.While):
        return [stmt.test]
    if isinstance(stmt, ast.If):
        return [stmt.test]
    if isinstance(stmt, (ast.With, ast.AsyncWith)):
        return [item.context_expr for item in stmt.items]
    if isinstance(stmt, ast.Try):
        return []
    return [stmt]


class SeedHandedToTwoHelpers:
    code = "JG014"
    name = "seed-handed-to-two-helpers"
    summary = ("one seed expression reaches manual_seed in two helpers (or a "
               "helper and a direct manual_seed), or a seeding hand-off in a "
               "loop from a seed bound outside it")
    skip_tests = True

    def check(self, mod):
        if mod.project is None or ("manual_seed" not in mod.text and not any(
                name in mod.text for name in mod.project.seeding_names)):
            return
        for scope in _common.iter_scopes(mod.tree):
            body = getattr(scope, "body", None)
            if body:
                yield from self._block(body, {}, mod)

    def _uses(self, roots, mod):
        """``(call, seed expr, description, is_handoff)`` under ``roots``."""
        out = []
        for node in _common.walk_excluding_defs(roots):
            if not isinstance(node, ast.Call):
                continue
            seed = seed_argument(node, mod.resolve)
            if seed is not None:
                out.append((node, seed, "manual_seed", False))
                continue
            summary = mod.project.resolve_function(mod, node.func)
            if summary is None:
                continue
            seeding = mod.project.seeding_params(summary)
            if not seeding:
                continue
            out += [(node, arg, f"`{summary.fq}`", True)
                    for key, arg in _common.call_args_with_keywords(node)
                    if summary.param_at(key) in seeding]
        out.sort(key=lambda t: (t[0].lineno, t[0].col_offset))
        return out

    def _block(self, stmts, used, mod):
        """``used``: seed text -> (line, description, is_handoff, names)."""
        for stmt in stmts:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                continue
            for call, seed, desc, handoff in self._uses(_stmt_roots(stmt), mod):
                text = ast.unparse(seed)
                if text not in used:
                    used[text] = (call.lineno, desc, handoff, _common.loaded_names(seed))
                    continue
                line, first, first_handoff, _ = used[text]
                if handoff or first_handoff:
                    yield mod.finding(
                        self.code,
                        f"seed `{text[:40]}` already reached {first} at line "
                        f"{line}; {desc} seeds a generator from it again, so "
                        f"both replay one stream — derive a distinct seed for "
                        f"each, or hand both one generator",
                        call,
                    ), call
            rebound = _common.assignment_targets(stmt)
            if isinstance(stmt, (ast.For, ast.AsyncFor)):
                _common._target_names(stmt.target, rebound)
            for text in [t for t, (*_, names) in used.items() if names & rebound]:
                del used[text]
            if isinstance(stmt, (ast.For, ast.AsyncFor, ast.While)):
                yield from self._loop(stmt, dict(used), mod)
            elif isinstance(stmt, ast.If):
                yield from self._block(stmt.body, dict(used), mod)
                yield from self._block(stmt.orelse, dict(used), mod)
            elif isinstance(stmt, (ast.With, ast.AsyncWith)):
                yield from self._block(stmt.body, used, mod)
            elif isinstance(stmt, ast.Try):
                for block in (stmt.body, stmt.orelse, stmt.finalbody):
                    yield from self._block(block, used, mod)
                for handler in stmt.handlers:
                    yield from self._block(handler.body, dict(used), mod)

    def _loop(self, loop, used, mod):
        yield from self._block(loop.body, used, mod)
        bound = _common.bound_names(loop)
        for call, seed, desc, handoff in self._uses(loop.body, mod):
            if handoff and not (_common.loaded_names(seed) & bound):
                yield mod.finding(
                    self.code,
                    f"seed `{ast.unparse(seed)[:40]}` is handed to {desc} inside "
                    f"a loop but bound outside it — every iteration seeds the "
                    f"same stream; mix the loop index into the seed",
                    call,
                ), call
