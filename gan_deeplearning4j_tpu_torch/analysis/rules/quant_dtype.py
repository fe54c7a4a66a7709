"""JG030 — quantized-variant precision/cast mismatch.

The JAX package's rule with torch's dtype spellings: ``.to(torch.float16)``,
``.half()``, ``.bfloat16()``, ``.char()``, ``.byte()``, ``.type(d)`` and
``dtype=torch.int8`` (numpy's spellings are kept: calibration math may run
in numpy). The rest is the JAX rule's text:

The quant plane's contract (docs/QUANT.md): a bundle manifest's
``precision`` field is LOAD-BEARING. The serving engine reads it and
compiles the variant's AOT executables accordingly — ``"bf16"`` traces
under a bfloat16 compute scope, ``"int8"`` expects QuantDenseLayer
int8 weights. A builder that *declares* one precision while *casting*
its params to a different low-precision dtype ships a bundle whose
numerics and cost block silently disagree with what the mux plane and
the canary believe they adopted: a ``precision: "bf16"`` manifest over
``astype(jnp.float16)`` params serves fp16 rounding under a bf16
compute scope (two incompatible 16-bit formats — different exponent
widths), and the measured cost ledger prices the wrong artifact.

The rule is scope-local per function: collect every *declared* variant
precision — a ``"precision"`` key in a dict literal, a
``manifest["precision"] = ...`` subscript store, or a ``precision=``
call kwarg, with a constant-string value of ``"bf16"`` or ``"int8"`` —
and every *low-precision cast* in the same scope (``.astype(d)`` or a
``dtype=d`` kwarg where ``d`` resolves to a sub-f32 dtype:
``jnp.bfloat16``/``float16``/``int8``/``uint8``, numpy spellings
included). When a scope declares exactly one quantized precision and
casts to low-precision dtypes but NONE of them match the declaration,
the declaration is flagged.

True negatives: a scope whose casts include the declared dtype (extra
f32 upcasts alongside are fine — dequant outputs are float by design);
declarations with no low-precision cast at all (the builder may copy
checkpoints byte-identical, as the int8 generator path does);
non-constant or non-quantized precision values; scopes declaring both
precisions (a dispatch table, not a builder). Known false negatives:
builder halves split across functions (declare here, cast in a helper)
— the cast evidence is scope-local by design, an unresolved helper must
not indict correct code.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Tuple

#: manifest precision strings the quant plane defines (docs/QUANT.md)
_QUANT_PRECISIONS = ("bf16", "int8")

#: resolved dtype dotted-name → the manifest precision it implements
_DTYPE_PRECISION = {
    "torch.bfloat16": "bf16",
    "numpy.bfloat16": "bf16",
    "ml_dtypes.bfloat16": "bf16",
    "torch.int8": "int8",
    "numpy.int8": "int8",
    # sub-f32 dtypes that implement NO declared precision — evidence of
    # a cast mismatch when one is declared
    "torch.float16": "fp16",
    "torch.half": "fp16",
    "numpy.float16": "fp16",
    "torch.uint8": "uint8",
    "numpy.uint8": "uint8",
    "torch.int4": "int4",
    "torch.float8_e4m3fn": "fp8",
    "torch.float8_e5m2": "fp8",
}

#: tensor methods that cast to one dtype by name
_CAST_METHODS = {"bfloat16": "bf16", "half": "fp16", "char": "int8",
                 "byte": "uint8"}


def _const_str(node) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _declared_precisions(scope) -> List[Tuple[str, ast.AST]]:
    """(precision, node) per declaration site inside the scope."""
    out = []
    for n in ast.walk(scope):
        if isinstance(n, ast.Dict):
            for k, v in zip(n.keys, n.values):
                if _const_str(k) == "precision":
                    p = _const_str(v)
                    if p in _QUANT_PRECISIONS:
                        out.append((p, v))
        elif isinstance(n, ast.Assign):
            for t in n.targets:
                if (isinstance(t, ast.Subscript)
                        and _const_str(t.slice) == "precision"):
                    p = _const_str(n.value)
                    if p in _QUANT_PRECISIONS:
                        out.append((p, n.value))
        elif isinstance(n, ast.Call):
            for kw in n.keywords:
                if kw.arg == "precision":
                    p = _const_str(kw.value)
                    if p in _QUANT_PRECISIONS:
                        out.append((p, kw.value))
    return out


def _cast_precisions(scope, resolve) -> Dict[str, ast.AST]:
    """precision-tag → first cast node, for every low-precision cast:
    ``x.to(dtype)``/``x.type(dtype)``/``x.astype(dtype)``, the named casts
    (``x.half()``) and ``dtype=`` kwargs, resolved through the module's
    import aliases."""
    found: Dict[str, ast.AST] = {}

    def _note(expr):
        tag = _DTYPE_PRECISION.get(resolve(expr) or "")
        if tag is not None and tag not in found:
            found[tag] = expr

    for n in ast.walk(scope):
        if not isinstance(n, ast.Call):
            continue
        if isinstance(n.func, ast.Attribute):
            if n.func.attr in ("to", "type", "astype") and n.args:
                _note(n.args[0])
            tag = _CAST_METHODS.get(n.func.attr)
            if tag is not None and not n.args and tag not in found:
                found[tag] = n
        for kw in n.keywords:
            if kw.arg == "dtype":
                _note(kw.value)
    return found


class QuantPrecisionCastMismatch:
    code = "JG030"
    name = "quant-precision-cast-mismatch"
    summary = ("manifest declares one quantized precision but the params "
               "are cast to a different low-precision dtype — the engine "
               "compiles for the declaration, not the bytes")

    def check(self, mod):
        for scope in ast.walk(mod.tree):
            if not isinstance(scope, (ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                continue
            declared = _declared_precisions(scope)
            precisions = {p for p, _ in declared}
            if len(precisions) != 1:
                # no declaration, or a bf16+int8 dispatch table — not a
                # single-variant builder, nothing to contradict
                continue
            precision = next(iter(precisions))
            casts = _cast_precisions(scope, mod.resolve)
            if not casts or precision in casts:
                continue
            others = ", ".join(sorted(casts))
            for p, node in declared:
                f = mod.finding(
                    self.code,
                    f"declares variant precision \"{p}\" but this scope "
                    f"casts params to {others} and never to {p} — the "
                    f"serving engine compiles its executables for the "
                    f"DECLARED precision (bf16 compute scope / int8 "
                    f"QuantDenseLayer weights), so the shipped bytes and "
                    f"the compiled numerics disagree; cast with the "
                    f"matching dtype or fix the manifest field",
                    node,
                )
                yield f, scope
