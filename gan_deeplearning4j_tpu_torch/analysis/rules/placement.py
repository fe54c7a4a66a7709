"""JG018 — params and their updater state placed on different partitions.

The torch counterpart of the JAX package's ``state_spec.py``. Update
sharding rests on one invariant: a parameter and the updater state that
steps it live on the same partition of the mesh. The port's own plan
(``parallel/update_sharding.py``) keys each slot's updater rows to its
param's owner in the checkpoint plane's assignment, computed, never
written down. Code that places state with ``torch.distributed.tensor`` —
``distribute_tensor(x, mesh, placements)`` or ``DTensor.from_local(local,
mesh, placements)`` — can break it: params replicated while their
optimizer state is sharded over dimension 0, or the other way round. Every
step then reshards the whole state (an all-gather or a scatter of the
updater), erasing what sharding was for, or an in-place update meets a
placement mismatch on the cards.

The rule fires only on statically certain evidence, in one scope and
against one mesh name:

1. a value recognisably params or updater state by its name (the placed
   expression's last identifier, else the name it is assigned to): one
   containing ``opt_state``, ``optimizer_state`` or ``updater`` is updater
   state, one containing ``param`` (and not ``spec`` or ``sharding``)
   params — the JAX rule's naming test;
2. placed with literal placements: a list or tuple of ``Shard(k)``,
   ``Replicate()`` and ``Partial()`` with literal arguments;
3. every param placement against the mesh agrees, and an updater placement
   differs from it.

Non-literal placements, unrecognised names, different meshes, and scopes
whose param placements already disagree among themselves are silence. Test
modules are exempt: parity tests place mismatched state on purpose.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Tuple

from gan_deeplearning4j_tpu_torch.analysis import _common

_PLACEMENTS = {"Shard", "Replicate", "Partial"}
_UPDATER_TOKENS = ("opt_state", "optimizer_state", "updater")


def _identifier(node) -> Optional[str]:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


def _role(name: Optional[str]) -> Optional[str]:
    low = (name or "").lower()
    if any(tok in low for tok in _UPDATER_TOKENS):
        return "updater"
    if "param" in low and "spec" not in low and "sharding" not in low:
        return "param"
    return None


def _literal_placements(node) -> Optional[Tuple]:
    if not isinstance(node, (ast.List, ast.Tuple)):
        return None
    out = []
    for elt in node.elts:
        if not (isinstance(elt, ast.Call) and not elt.keywords
                and _common.last_component(_common.dotted_name(elt.func)) in _PLACEMENTS
                and all(isinstance(a, ast.Constant) for a in elt.args)):
            return None
        kind = _common.last_component(_common.dotted_name(elt.func))
        out.append(f"{kind}({', '.join(repr(a.value) for a in elt.args)})")
    return tuple(out)


class StatePlacementMismatch:
    code = "JG018"
    name = "state-placement-mismatch"
    summary = ("updater state placed on the mesh with placements that disagree "
               "with its params'")
    skip_tests = True

    def _placements(self, mod, scope):
        """``(role, mesh name, placements, call)`` of every certain placement
        among the scope's own statements."""
        body = [s for s in (getattr(scope, "body", []) or [])
                if not isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))]
        assigned: Dict[int, str] = {}
        calls: List[ast.Call] = []
        for n in _common.walk_excluding_defs(body):
            if (isinstance(n, ast.Assign) and len(n.targets) == 1
                    and isinstance(n.targets[0], ast.Name) and isinstance(n.value, ast.Call)):
                assigned[id(n.value)] = n.targets[0].id
            if isinstance(n, ast.Call) and isinstance(n.func, (ast.Name, ast.Attribute)):
                resolved = mod.resolve(n.func) or ""
                last = _common.last_component(resolved)
                if last == "distribute_tensor" and resolved.startswith("torch.distributed") \
                        or last == "from_local" and resolved.endswith("DTensor.from_local"):
                    calls.append(n)
        out = []
        for call in calls:
            args = list(call.args)
            kws = {kw.arg: kw.value for kw in call.keywords}
            value = args[0] if args else kws.get("tensor", kws.get("local_tensor"))
            mesh = args[1] if len(args) > 1 else kws.get("device_mesh")
            placements = _literal_placements(args[2] if len(args) > 2 else kws.get("placements"))
            if value is None or not isinstance(mesh, ast.Name) or placements is None:
                continue
            role = _role(_identifier(value)) or _role(assigned.get(id(call)))
            if role is not None:
                out.append((role, mesh.id, placements, call))
        return out

    def check(self, mod):
        if "distribute_tensor" not in mod.text and "from_local" not in mod.text:
            return
        for scope in _common.iter_scopes(mod.tree):
            by_mesh: Dict[str, list] = {}
            for role, mesh, placements, call in self._placements(mod, scope):
                by_mesh.setdefault(mesh, []).append((role, placements, call))
            for mesh, group in by_mesh.items():
                params = {p for role, p, _ in group if role == "param"}
                if len(params) != 1:
                    continue
                param = next(iter(params))
                for role, placements, call in group:
                    if role == "updater" and placements != param:
                        yield mod.finding(
                            self.code,
                            f"updater state is placed on mesh `{mesh}` as "
                            f"[{', '.join(placements)}] but its params as "
                            f"[{', '.join(param)}] — every optimizer step "
                            f"reshards the whole updater state (or the in-place "
                            f"update fails on the cards); place the updater "
                            f"state as its params",
                            call,
                        ), call
