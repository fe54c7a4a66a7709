"""JG031 — hard-coded bucket ladder at a manifest-carrying load seam.

The traffic-shaped ladder contract (docs/SERVING.md, serving/ladder.py):
a published bundle carries its learned bucket ladder in ``serving.json``,
and every loader that takes a bundle directory — ``from_bundle``, the mux
registry's ``build_engine``, ``measure_bundle_cost`` — resolves that
manifest ladder when ``buckets`` is omitted. Passing a literal ladder at
one of these seams silently overrides what the bundle learned from live
traffic: the engine compiles the author's guess, the cost block prices a
ladder the variant will never serve, and the padding-waste win the
reload plane accumulated across generations is thrown away at load time.
(The pre-learning default lives in ONE place — ``DEFAULT_BUCKETS`` — so
a literal at a load seam is never the right spelling of "the default".)

The rule flags a call whose callee name (attribute or bare) is one of
the bundle-loading seams AND whose ``buckets`` keyword is a list/tuple
literal of integer constants.

True negatives: ``buckets=None`` (explicit manifest resolution);
``buckets=args.buckets`` or any other non-literal expression (operator
override, a solved ladder, ``DEFAULT_BUCKETS``); no ``buckets`` kwarg at
all; ``from_checkpoints(buckets=[...])`` — raw checkpoints carry no
manifest, a literal is the only way to say anything. Test modules are
exempt (``skip_tests``): fixtures legitimately pin tiny ladders to make
compile counts deterministic.
"""

from __future__ import annotations

import ast

#: callee names whose ``buckets=`` kwarg shadows a bundle manifest ladder
_BUNDLE_SEAMS = ("from_bundle", "measure_bundle_cost", "build_engine")


def _callee_name(func) -> str:
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return ""


def _literal_int_ladder(node) -> bool:
    return (isinstance(node, (ast.List, ast.Tuple))
            and bool(node.elts)
            and all(isinstance(e, ast.Constant)
                    and isinstance(e.value, int)
                    and not isinstance(e.value, bool)
                    for e in node.elts))


class HardcodedLadderLiteral:
    code = "JG031"
    name = "hardcoded-ladder-literal"
    summary = ("literal bucket ladder passed at a bundle-loading seam — "
               "overrides the learned manifest ladder the bundle carries")
    skip_tests = True  # tests pin tiny ladders for deterministic compiles

    def check(self, mod):
        for n in ast.walk(mod.tree):
            if not isinstance(n, ast.Call):
                continue
            seam = _callee_name(n.func)
            if seam not in _BUNDLE_SEAMS:
                continue
            for kw in n.keywords:
                if kw.arg != "buckets":
                    continue
                if not _literal_int_ladder(kw.value):
                    continue
                f = mod.finding(
                    self.code,
                    f"{seam}() called with a literal bucket ladder — this "
                    f"seam resolves the bundle's LEARNED manifest ladder "
                    f"when buckets is omitted (serving/ladder.py), so a "
                    f"hard-coded list silently discards the traffic-shaped "
                    f"buckets the reload plane solved and compiles the "
                    f"author's guess instead; pass buckets=None (or a "
                    f"computed ladder / DEFAULT_BUCKETS) and let the "
                    f"manifest win",
                    kw.value,
                )
                yield f, n
