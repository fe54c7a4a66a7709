"""JG011 — ``torch.vmap`` ``in_dims`` that provably mismatch.

The torch counterpart of the JAX package's ``axes.py`` (``vmap`` /
``pmap`` ``in_axes``). ``torch.vmap`` (``torch.func.vmap``) checks
``in_dims`` against the call only when the mapped function runs: a tuple
of the wrong length, or mapped dimensions of different sizes, raise then —
on the cards, minutes into a run. This rule recovers what is visible
without running it, on certain evidence only:

1. the ``in_dims`` tuple's length against the mapped function's
   positional arity, the function resolved through the project index (it
   may live in another module); a function with ``*args`` is skipped, and
   a length between its required and its total count is accepted;
2. the tuple's length against the positional arguments of the immediate
   call (``torch.vmap(f, in_dims=(0, 0))(x)``, or through a name bound to
   the mapped function in the scope);
3. the mapped sizes of arguments bound in the scope to constructors with a
   literal shape (``torch.zeros(4, 3)``, ``torch.randn((8, 2))``): every
   mapped argument must have the same size along its mapped dimension.

``None`` entries map nothing; an unresolvable function or an argument of
unknown shape is silence, not a guess. The port maps nothing today: the
rule guards code to come.
"""

from __future__ import annotations

import ast

from gan_deeplearning4j_tpu_torch.analysis import _common

_VMAPS = {"torch.vmap", "torch.func.vmap", "functorch.vmap"}
#: constructors whose positional arguments (or first tuple) are the shape
_SHAPED = {"torch.zeros", "torch.ones", "torch.empty", "torch.randn", "torch.rand"}


def _literal_dims(node):
    """``in_dims`` as a list of int/None, an int or None for a scalar spec,
    or ``"?"`` when it is not literal."""
    if isinstance(node, ast.Constant) and (node.value is None or isinstance(node.value, int)):
        return node.value
    if isinstance(node, (ast.Tuple, ast.List)):
        out = []
        for elt in node.elts:
            if not (isinstance(elt, ast.Constant)
                    and (elt.value is None or isinstance(elt.value, int))):
                return "?"
            out.append(elt.value)
        return out
    return "?"


def _in_dims(call: ast.Call):
    if len(call.args) > 1:
        return call.args[1]
    return next((kw.value for kw in call.keywords if kw.arg == "in_dims"), None)


def _shape(call: ast.Call, mod):
    if mod.resolve(call.func) not in _SHAPED:
        return None
    if len(call.args) == 1 and isinstance(call.args[0], (ast.Tuple, ast.List)):
        return _common.literal_int_tuple(call.args[0])
    if call.args and all(isinstance(a, ast.Constant) and isinstance(a.value, int)
                         for a in call.args):
        return tuple(a.value for a in call.args)
    return None


class VmapInDimsMismatch:
    code = "JG011"
    name = "vmap-in-dims-mismatch"
    summary = "torch.vmap in_dims arity or mapped sizes provably mismatch"

    def check(self, mod):
        if "vmap" not in mod.text:
            return
        for scope in _common.iter_scopes(mod.tree):
            if not getattr(scope, "body", None):
                continue
            shapes, mapped = {}, {}
            for n in ast.walk(scope):
                if (isinstance(n, ast.Assign) and len(n.targets) == 1
                        and isinstance(n.targets[0], ast.Name) and isinstance(n.value, ast.Call)):
                    shape = _shape(n.value, mod)
                    if shape is not None:
                        shapes[n.targets[0].id] = shape
                    if mod.resolve(n.value.func) in _VMAPS:
                        mapped[n.targets[0].id] = n.value
            for n in ast.walk(scope):
                if not isinstance(n, ast.Call):
                    continue
                if isinstance(n.func, ast.Call) and mod.resolve(n.func.func) in _VMAPS:
                    yield from self._check(n.func, n, mod, shapes)
                elif mod.resolve(n.func) in _VMAPS:
                    yield from self._check(n, None, mod, shapes)
                elif isinstance(n.func, ast.Name) and n.func.id in mapped:
                    yield from self._check(mapped[n.func.id], n, mod, shapes)

    def _check(self, vmap, call, mod, shapes):
        node = _in_dims(vmap)
        dims = 0 if node is None else _literal_dims(node)
        if dims == "?":
            return
        fn = ast.unparse(vmap.args[0]) if vmap.args else "<unknown>"
        if isinstance(dims, list) and vmap.args and mod.project is not None:
            summary = mod.project.resolve_function(mod, vmap.args[0])
            if summary is not None and summary.node is not None \
                    and not summary.node.args.vararg:
                most = len(summary.params)
                least = most - len(summary.node.args.defaults)
                if not least <= len(dims) <= most:
                    yield mod.finding(
                        self.code,
                        f"in_dims has {len(dims)} entries but `{fn}` "
                        f"({summary.fq}) takes {least}"
                        + (f"-{most}" if most != least else "")
                        + " positional arguments — torch.vmap raises when it "
                        "runs; align in_dims with the signature",
                        vmap,
                    ), vmap
                    return
        if call is None or any(isinstance(a, ast.Starred) for a in call.args):
            return
        n_args = len(call.args)
        if isinstance(dims, list) and n_args and len(dims) != n_args:
            yield mod.finding(
                self.code,
                f"in_dims has {len(dims)} entries but this call passes {n_args} "
                f"positional argument{'s' if n_args != 1 else ''} — torch.vmap "
                f"raises when it runs",
                call,
            ), call
            return
        sized = []
        for i, arg in enumerate(call.args):
            dim = dims[i] if isinstance(dims, list) and i < len(dims) else dims
            if not isinstance(dim, int) or not isinstance(arg, ast.Name) \
                    or arg.id not in shapes:
                continue
            shape = shapes[arg.id]
            at = dim if dim >= 0 else len(shape) + dim
            if 0 <= at < len(shape):
                sized.append((arg.id, dim, shape[at]))
        if len({size for _, _, size in sized}) > 1:
            detail = ", ".join(f"`{name}` dim {dim} has size {size}"
                               for name, dim, size in sized)
            yield mod.finding(
                self.code,
                f"mapped sizes disagree at this torch.vmap call: {detail} — every "
                f"mapped argument must share the mapped size; fix the shapes or "
                f"in_dims",
                call,
            ), call
