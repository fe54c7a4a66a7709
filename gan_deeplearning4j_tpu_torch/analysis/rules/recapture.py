"""JG004 — recapture hazard.

The torch counterpart of the JAX package's ``recompile.py`` (a jit built
per iteration, or keyed by an unhashable static). A CUDA graph is captured
for one set of shapes and replayed many times; its warmup and capture cost
milliseconds to seconds, and every capture holds its own memory pool. Two
mechanical ways to lose that:

1. capture in a loop — ``torch.cuda.CUDAGraph()``, ``torch.cuda.graph(...)``
   or ``make_graphed_callables`` inside a for/while body with no cache
   check around it: every iteration captures a new graph,
   and ``torch.cuda.memory_reserved`` climbs with every pool. A call
   guarded by a membership or ``None`` test inside the loop
   (``if key not in cache``, ``if entry.graph is None``) is the cache the
   port uses (``harness/graphs.py``, ``serving/engine.py``). A helper
   that captures, called from a loop, is not followed: timing helpers
   capture the function they are handed on purpose.
2. keyed by a varying shape — a graph stored into a cache under a key taken
   from an input's shape (``x.shape``, ``x.size(0)``, ``len(x)``): every
   new shape captures anew. The port keys its graphs by (kind, bucket,
   replica), the bucket from a fixed ladder.
"""

from __future__ import annotations

import ast

from gan_deeplearning4j_tpu_torch.analysis import _common


def _constructs(call: ast.Call, mod) -> bool:
    resolved = mod.resolve(call.func)
    return (resolved in _common.GRAPH_CONSTRUCTORS
            or resolved in _common.CAPTURE_CONTEXTS
            or resolved in _common.GRAPHED_CALLABLES)


def _is_cache_test(test: ast.AST) -> bool:
    for n in ast.walk(test):
        if isinstance(n, ast.Compare) and any(
                isinstance(op, (ast.In, ast.NotIn, ast.Is, ast.IsNot))
                for op in n.ops):
            return True
        if (isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
                and n.func.attr == "get"):
            return True
    return False


def _shape_of_param(expr: ast.AST, params) -> str:
    """Source text of a shape read off a parameter when ``expr`` is one
    (``x.shape``, ``x.shape[0]``, ``x.size(0)``, ``len(x)``,
    ``tuple(x.shape)``) or a tuple holding one, else "". A value computed
    from a shape by any other call (a bucket picked off a ladder) is not."""
    if isinstance(expr, (ast.Tuple, ast.List)):
        for elt in expr.elts:
            text = _shape_of_param(elt, params)
            if text:
                return text
        return ""
    node = expr.value if isinstance(expr, ast.Subscript) else expr
    if (isinstance(node, ast.Attribute) and node.attr == "shape"
            and _common.base_name(node.value) in params):
        return ast.unparse(expr)
    if isinstance(expr, ast.Call):
        func = expr.func
        if (isinstance(func, ast.Attribute) and func.attr == "size"
                and _common.base_name(func.value) in params):
            return ast.unparse(expr)
        if (isinstance(func, ast.Name) and func.id in ("len", "tuple")
                and len(expr.args) == 1):
            inner = expr.args[0]
            if func.id == "len" and _common.base_name(inner) in params:
                return ast.unparse(expr)
            return _shape_of_param(inner, params)
    return ""


class RecaptureHazard:
    code = "JG004"
    name = "recapture-hazard"
    summary = ("CUDA graph captured per loop iteration, or cached under a "
               "key taken from a varying input's shape")

    def check(self, mod):
        yield from self._check_loops(mod)
        yield from self._check_shape_keys(mod)

    def _check_loops(self, mod):
        seen = set()
        for loop in _common.iter_loops(mod.tree):
            guarded = set()
            for n in _common.walk_excluding_defs(loop.body):
                if isinstance(n, ast.If) and _is_cache_test(n.test):
                    guarded |= {id(s) for s in ast.walk(n)}
            for n in _common.walk_excluding_defs(loop.body):
                if not isinstance(n, ast.Call) or id(n) in seen \
                        or id(n) in guarded:
                    continue
                if _constructs(n, mod):
                    seen.add(id(n))
                    yield mod.finding(
                        self.code,
                        f"`{ast.unparse(n.func)}` inside a loop with no "
                        f"cache check — every iteration captures a new "
                        f"graph (and a new memory pool); capture once "
                        f"outside the loop and replay inside it",
                        n,
                    ), n

    def _check_shape_keys(self, mod):
        for scope in _common.iter_scopes(mod.tree):
            if not isinstance(scope, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            a = scope.args
            params = {p.arg for p in a.posonlyargs + a.args + a.kwonlyargs} \
                - {"self", "cls"}
            nodes = list(_common.walk_excluding_defs(scope.body))
            graphs = set()
            keys = {}
            for n in nodes:
                if isinstance(n, ast.Assign) and isinstance(n.value, ast.Call) \
                        and _constructs(n.value, mod):
                    graphs |= _common.assignment_targets(n)
            for n in nodes:
                if isinstance(n, ast.Assign):
                    for target in _common.assignment_targets(n):
                        keys[target] = n.value
            for n in nodes:
                if not isinstance(n, ast.Assign):
                    continue
                if not (_common.loaded_names(n.value) & graphs
                        or (isinstance(n.value, ast.Call)
                            and _constructs(n.value, mod))):
                    continue
                for target in n.targets:
                    if not isinstance(target, ast.Subscript):
                        continue
                    key = target.slice
                    shape = _shape_of_param(key, params)
                    if not shape and isinstance(key, ast.Name) \
                            and key.id in keys:
                        shape = _shape_of_param(keys[key.id], params)
                    if shape:
                        yield mod.finding(
                            self.code,
                            f"graph cached under a key built from "
                            f"`{shape}` — every new input shape captures a "
                            f"new graph and pool; round the shape up to a "
                            f"fixed bucket ladder and key by the bucket",
                            n,
                        ), n
