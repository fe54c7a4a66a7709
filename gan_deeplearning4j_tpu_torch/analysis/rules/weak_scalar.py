"""JG008 — weak-scalar drift.

The torch counterpart of the JAX package's ``scan_dtype.py`` (a Python
float literal on a loop carry). jnp treats a Python scalar as weakly typed:
``state * 0.99`` with a bf16 ``state`` first rounds 0.99 to bf16
(0.98828125), then multiplies. torch keeps the scalar at full precision
and rounds only the product. Under the bf16 compute scope the two differ
in about half of all results (445 of 1,000 bf16 values in [1, 2] on the
CPU), and on updater state or a captured window's carry the difference
compounds every step: the port drifts from the reference it is held to.
The port's cure is ``weak_scalar(value, dtype)`` (``runtime/dtype.py``),
which rounds the scalar as jnp does (``optim/updaters.py``,
``optim/optimizer.py``, ``ops/norm.py``).

Flagged, unless the literal sits inside ``weak_scalar(...)``, a call with
a ``dtype=`` argument, or a ``torch.tensor``/``torch.full``/``.to`` cast:

- a bare float literal as an operand of arithmetic (``*``, ``/``, ``+``,
  ``-``, ``**``) or as the scalar argument of a torch arithmetic call
  (``torch._foreach_mul(xs, 0.9)``, ``x.mul(0.9)``, ``x.add_(g, alpha=0.1)``)
  in an updater rule — a method of a class derived from ``UpdaterSpec`` (or
  any ``*Updater``);
- the same in a carry update — ``c = c * 0.99 + g`` or ``c *= 0.99`` —
  inside a ``with compute_dtype_scope(...)`` block, or in a function the
  project index shows runs inside a CUDA-graph capture (a captured window
  replays it every step).
"""

from __future__ import annotations

import ast

from gan_deeplearning4j_tpu_torch.analysis import _common

_ARITH_OPS = (ast.Mult, ast.Div, ast.Add, ast.Sub, ast.Pow)
#: torch arithmetic spelled as calls: ``torch.<name>``/``torch._foreach_<name>``
#: and tensor methods (with their in-place ``_`` twins)
_ARITH_CALLS = {"mul", "div", "add", "sub", "pow", "lerp", "addcmul",
                "addcdiv"}
_CAST_CALLS = {"torch.tensor", "torch.full", "torch.full_like",
               "torch.as_tensor", "torch.scalar_tensor"}


def _arith_call(call: ast.Call) -> bool:
    name = ""
    if isinstance(call.func, ast.Attribute):
        name = call.func.attr
    name = name[len("_foreach_"):] if name.startswith("_foreach_") else name
    return name.rstrip("_") in _ARITH_CALLS


def _exempt(root, mod) -> set:
    """ids of float literals whose dtype is pinned by an enclosing call."""
    out = set()
    for n in _common.walk_excluding_defs(root):
        if not isinstance(n, ast.Call):
            continue
        resolved = mod.resolve(n.func)
        if (_common.last_component(resolved) == _common.WEAK_SCALAR
                or resolved in _CAST_CALLS
                or any(kw.arg == "dtype" for kw in n.keywords)
                or (isinstance(n.func, ast.Attribute)
                    and n.func.attr in ("to", "type"))):
            out |= {id(c) for c in ast.walk(n)}
    return out


def _float_lit(node):
    while isinstance(node, ast.UnaryOp):
        node = node.operand
    if isinstance(node, ast.Constant) and isinstance(node.value, float):
        return node
    return None


def _literals(root, mod):
    """Bare float literals used as arithmetic operands under ``root``."""
    exempt = _exempt(root, mod)
    for n in _common.walk_excluding_defs(root):
        operands = []
        if isinstance(n, ast.BinOp) and isinstance(n.op, _ARITH_OPS):
            operands = [n.left, n.right]
        elif isinstance(n, ast.AugAssign) and isinstance(n.op, _ARITH_OPS):
            operands = [n.value]
        elif isinstance(n, ast.Call) and _arith_call(n):
            operands = list(n.args) + [kw.value for kw in n.keywords]
        for op in operands:
            lit = _float_lit(op)
            if lit is not None and id(lit) not in exempt:
                yield lit


def _is_carry_update(stmt) -> bool:
    if isinstance(stmt, ast.AugAssign):
        return True
    if isinstance(stmt, ast.Assign):
        return bool(_common.assignment_targets(stmt)
                    & _common.loaded_names(stmt.value))
    return False


def _updater_class(cls: ast.ClassDef, mod) -> bool:
    for base in cls.bases:
        last = _common.last_component(mod.resolve(base))
        if last.endswith(("UpdaterSpec", "Updater")):
            return True
    return False


class WeakScalarDrift:
    code = "JG008"
    name = "weak-scalar-drift"
    summary = ("bare Python float in arithmetic on updater state or a bf16 "
               "carry — torch keeps it at full precision where jnp rounds "
               "it, and the drift compounds every step")

    def check(self, mod):
        reported = set()
        for cls in ast.walk(mod.tree):
            if isinstance(cls, ast.ClassDef) and _updater_class(cls, mod):
                for fn in cls.body:
                    if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        yield from self._report(
                            _literals(fn.body, mod), mod, reported,
                            f"the updater rule `{cls.name}.{fn.name}`")
        for scope in _common.iter_scopes(mod.tree):
            body = getattr(scope, "body", None)
            if not body:
                continue
            for n in _common.walk_excluding_defs(body):
                if isinstance(n, (ast.With, ast.AsyncWith)) and any(
                        isinstance(item.context_expr, ast.Call)
                        and _common.last_component(
                            mod.resolve(item.context_expr.func))
                        == _common.COMPUTE_SCOPE for item in n.items):
                    yield from self._carries(
                        n.body, mod, reported, "a compute_dtype_scope block")
        info = mod.project.by_path.get(mod.path) if mod.project else None
        for summary in (info.functions.values() if info else ()):
            if summary.in_capture:
                yield from self._carries(
                    summary.node.body, mod, reported,
                    f"`{summary.qualname}`, which runs inside the capture at "
                    f"{summary.capture_site}")

    def _carries(self, body, mod, reported, where):
        for stmt in _common.walk_excluding_defs(body):
            if _is_carry_update(stmt):
                yield from self._report(_literals(stmt, mod), mod, reported,
                                        f"a carry update in {where}")

    def _report(self, literals, mod, reported, where):
        for lit in literals:
            if id(lit) in reported:
                continue
            reported.add(id(lit))
            yield mod.finding(
                self.code,
                f"float literal `{lit.value}` in arithmetic in {where} — "
                f"jnp rounds a weak scalar to the tensor's dtype first "
                f"({lit.value} in bf16 differs), torch does not, and the "
                f"difference compounds every step; pass it through "
                f"`weak_scalar({lit.value}, t.dtype)`",
                lit,
            ), lit
