"""JG007 — discarded out-of-place result.

The torch counterpart of the JAX package's ``at_update.py`` (a discarded
``.at[...].set()``). torch spells most updates twice: ``x.add(v)`` returns
a NEW tensor and leaves ``x`` alone; ``x.add_(v)`` writes into ``x``.
Written as a bare statement — the reflex of anyone who meant the in-place
twin — the out-of-place form is a silent no-op: nothing raises, the update
just never happens.

Flagged: an expression STATEMENT whose value is a call of an out-of-place
tensor method that has an in-place twin. Methods only tensors have
(``masked_fill``, ``index_put``, ``scatter``, ``clamp`` and the like) are
flagged on any receiver; the names Python containers share (``add`` on a
set, ``mul``, ``sub``, ``div``) only on a receiver known to be a tensor —
a name bound from a ``torch.*`` call or a tensor method in the same scope,
or a parameter annotated ``torch.Tensor``.

Fixable (``--fix``): when the receiver is a plain name or a dotted
attribute, the rewrite ``x = x.add(v)`` restores the intended update, as
the JAX fixer's ``x = x.at[i].set(v)`` does; other receivers are reported
and left to a human.
"""

from __future__ import annotations

import ast

from gan_deeplearning4j_tpu_torch.analysis import _common

#: out-of-place methods only tensors have, each with an in-place twin
TENSOR_ONLY = {
    "clamp", "clamp_min", "clamp_max", "masked_fill", "masked_scatter",
    "index_put", "index_add", "index_copy", "index_fill", "scatter",
    "scatter_add", "scatter_reduce", "addcmul", "addcdiv", "lerp",
    "nan_to_num", "fill_diagonal",
}
#: names other types share (``set.add``, ``logger.log``, ``math``-like
#: helpers): flagged on a known tensor only
SHARED_NAMES = {"add", "sub", "mul", "div", "pow", "clip", "sigmoid",
                "relu", "tanh", "sqrt", "rsqrt", "exp", "log", "abs", "neg",
                "reciprocal", "floor", "ceil", "round", "sign"}


def tensor_names(scope, mod) -> set:
    """Names that a scope binds to tensors, as far as a glance can tell."""
    out = set()
    args = getattr(scope, "args", None)
    if args is not None:
        for a in args.posonlyargs + args.args + args.kwonlyargs:
            ann = a.annotation
            if ann is not None and _common.last_component(
                    mod.resolve(ann) or ast.unparse(ann).strip("'\"")) == "Tensor":
                out.add(a.arg)
    for n in _common.walk_excluding_defs(getattr(scope, "body", [])):
        if not (isinstance(n, ast.Assign) and isinstance(n.value, ast.Call)):
            continue
        func = n.value.func
        resolved = mod.resolve(func) or ""
        if (resolved.startswith("torch.") and not resolved.startswith(
                ("torch.cuda.", "torch.Generator", "torch.device"))) or (
                isinstance(func, ast.Attribute)
                and _common.base_name(func.value) in out):
            out |= _common.assignment_targets(n)
    return out


def discarded_call(node: ast.AST, tensors: set):
    """The ``(receiver, method)`` of a flagged out-of-place call, else
    None."""
    if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)):
        return None
    method, recv = node.func.attr, node.func.value
    if method in TENSOR_ONLY:
        return recv, method
    if method in SHARED_NAMES and isinstance(recv, ast.Name) \
            and recv.id in tensors:
        return recv, method
    return None


def fixable_base_text(base: ast.AST):
    """Source text to rebind when the receiver is mechanically rebindable —
    a bare name or a dotted attribute chain (``self.params``)."""
    node = base
    while isinstance(node, ast.Attribute):
        node = node.value
    if isinstance(node, ast.Name):
        return ast.unparse(base)
    return None


class DiscardedOutOfPlace:
    code = "JG007"
    name = "discarded-out-of-place"
    summary = ("out-of-place tensor method as a bare statement — the result "
               "is discarded and the tensor is unchanged")

    def check(self, mod):
        for scope in _common.iter_scopes(mod.tree):
            body = getattr(scope, "body", None)
            if not body:
                continue
            tensors = tensor_names(scope, mod)
            for node in _common.walk_excluding_defs(body):
                if not isinstance(node, ast.Expr):
                    continue
                hit = discarded_call(node.value, tensors)
                if hit is None:
                    continue
                base, method = hit
                target = fixable_base_text(base) or ast.unparse(base)
                yield mod.finding(
                    self.code,
                    f"`.{method}(...)` returns a new tensor and this "
                    f"statement discards it — `{target}` is unchanged; "
                    f"rebind (`{target} = {ast.unparse(node.value)[:60]}`) "
                    f"or call the in-place `.{method}_(...)`",
                    node,
                ), node
