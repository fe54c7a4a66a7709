"""JG001 — generator reuse.

The torch counterpart of the JAX package's ``prng.py`` (one PRNG key fed to
two draws). A ``torch.Generator`` seeded with a value replays one stream:
two generators seeded from the same expression draw the same numbers, and a
generator (or the global generator) re-seeded inside a loop from a value
bound outside it restarts the same stream every iteration. In a GAN that
is not a crash, it is a quality bug: the latents of the discriminator's
and the generator's phases come out equal, or every step sees the same
noise.

Two detections, scope-local and name-based:

1. twin generators — two generator names seeded (``torch.Generator()
   .manual_seed(E)`` or ``g.manual_seed(E)``) from the same expression
   ``E`` in one scope, with no rebind of ``E``'s names between, and both
   feeding draws (passed as an argument, ``generator=g`` and the like);
2. re-seed in a loop — ``manual_seed(E)`` (on a generator, or
   ``torch.manual_seed``) inside a for/while body where ``E`` reads no name
   bound in the loop.

One generator seeded once and used for every draw is the port's idiom
(``nn/graph.py::init``); a seed that is the same on every rank of a mesh
on purpose (``parallel/drill.py``) seeds one generator per process and is
not flagged.
"""

from __future__ import annotations

import ast

from gan_deeplearning4j_tpu_torch.analysis import _common


def _seed_expr(call: ast.Call, mod):
    """``(generator_text_or_None, seed_expr)`` of a seeding call, else
    None: ``g.manual_seed(E)``, ``torch.Generator().manual_seed(E)``
    (generator None: the result is the generator) or
    ``torch.manual_seed(E)`` (generator ``"<global>"``)."""
    if not call.args:
        return None
    if mod.resolve(call.func) in _common.GLOBAL_SEED_CALLS:
        return "<global>", call.args[0]
    if not (isinstance(call.func, ast.Attribute)
            and call.func.attr in _common.SEED_METHODS):
        return None
    recv = call.func.value
    if isinstance(recv, ast.Call) and mod.resolve(recv.func) \
            in _common.GENERATOR_CONSTRUCTORS:
        return None, call.args[0]
    return ast.unparse(recv), call.args[0]


def _feeds_draws(name: str, nodes) -> bool:
    for n in nodes:
        if not isinstance(n, ast.Call):
            continue
        args = list(n.args) + [kw.value for kw in n.keywords]
        if any(isinstance(a, ast.Name) and a.id == name for a in args):
            return True
    return False


class GeneratorReuse:
    code = "JG001"
    name = "generator-reuse"
    summary = ("two generators seeded from one expression, or a generator "
               "re-seeded in a loop from a value bound outside it")

    def check(self, mod):
        for scope in _common.iter_scopes(mod.tree):
            body = getattr(scope, "body", None)
            if not body:
                continue
            yield from self._twins(body, mod)
        yield from self._loops(mod)

    def _twins(self, body, mod):
        nodes = list(_common.walk_excluding_defs(body))
        seeded = []  # (generator name, seed text, seed names, call)
        for n in nodes:
            if isinstance(n, ast.Assign) and isinstance(n.value, ast.Call):
                hit = _seed_expr(n.value, mod)
                if hit is not None and hit[0] is None:
                    for target in _common.assignment_targets(n):
                        seeded.append((target, hit[1], n.value))
            elif isinstance(n, ast.Expr) and isinstance(n.value, ast.Call):
                hit = _seed_expr(n.value, mod)
                if hit is not None and hit[0] not in (None, "<global>"):
                    seeded.append((hit[0], hit[1], n.value))
        seeded.sort(key=lambda t: t[2].lineno)
        rebinds = [(n.lineno, _common.assignment_targets(n)) for n in nodes
                   if isinstance(n, (ast.Assign, ast.AugAssign, ast.AnnAssign))]
        for i, (gen_b, seed_b, call_b) in enumerate(seeded):
            for gen_a, seed_a, call_a in seeded[:i]:
                if gen_a == gen_b or ast.unparse(seed_a) != ast.unparse(seed_b):
                    continue
                names = _common.loaded_names(seed_a)
                if any(call_a.lineno < ln < call_b.lineno and names & targets
                       for ln, targets in rebinds):
                    continue
                if not (_feeds_draws(gen_a, nodes) and _feeds_draws(gen_b, nodes)):
                    continue
                yield mod.finding(
                    self.code,
                    f"generator `{gen_b}` is seeded from "
                    f"`{ast.unparse(seed_b)[:40]}`, as `{gen_a}` was at line "
                    f"{call_a.lineno} — both replay one stream, so their "
                    f"draws are equal; derive distinct seeds or draw both "
                    f"from one generator",
                    call_b,
                ), call_b
                break

    def _loops(self, mod):
        seen = set()
        for loop in _common.iter_loops(mod.tree):
            loop_bound = _common.bound_names(loop)
            for n in _common.walk_excluding_defs(loop.body):
                if not isinstance(n, ast.Call) or id(n) in seen:
                    continue
                hit = _seed_expr(n, mod)
                if hit is None or _common.loaded_names(hit[1]) & loop_bound:
                    continue
                seen.add(id(n))
                yield mod.finding(
                    self.code,
                    f"`{ast.unparse(n)[:60]}` re-seeds inside a loop from a "
                    f"value bound outside it — every iteration replays the "
                    f"same stream; seed once before the loop, or mix the "
                    f"loop index into the seed",
                    n,
                ), n
