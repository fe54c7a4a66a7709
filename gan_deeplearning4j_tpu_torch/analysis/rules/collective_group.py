"""JG013 — a collective over a group the mesh did not make.

The torch counterpart of the JAX package's ``mesh_axes.py`` (a sharding
spec that names an axis its mesh lacks). In torch a mesh is the group its
collectives run over: the port's ``DataMesh`` (``runtime/environment.py``)
carries its process group (None: the default group, every rank), and
``init_device_mesh`` makes one group per named dimension. A
``torch.distributed`` collective that runs over another group — the
default group where the scope's only meshes are sub-meshes, or a
``dist.new_group(...)`` that no mesh of the scope was built on — sums or
waits over the wrong ranks: a hang when some ranks never join, or a wrong
mean that raises nothing. A dimension name the mesh lacks
(``mesh["tp"]``, ``mesh.get_group("tp")``) raises only when the line runs,
on the cards.

The rule fires only on statically certain evidence, in one scope:

1. a mesh binding: a name bound once to ``make_mesh(...)``,
   ``DataMesh(...)`` or ``init_device_mesh(...)``; a ``DataMesh`` with
   ``group=None`` (or none given) and ``make_mesh`` span every rank, as
   does a one-dimensional ``init_device_mesh``; a ``DataMesh`` over a
   ``dist.new_group`` bound in the scope, or an ``init_device_mesh`` of two
   or more dimensions, does not;
2. a collective (``all_reduce``, ``all_gather_into_tensor``,
   ``reduce_scatter_tensor``, ``broadcast``, ``barrier`` and their kin)
   with no ``group=`` when no mesh of the scope spans every rank, or with
   a ``group=`` that names a ``dist.new_group`` of the scope that no mesh
   was built on;
3. a literal dimension name that an ``init_device_mesh`` with literal
   ``mesh_dim_names`` lacks, in ``mesh[name]`` or ``mesh.get_group(name)``.

A group reached through an attribute (``mesh.group``, ``self.group``) or a
parameter is the mesh's own or unknown: silence, not a guess.
"""

from __future__ import annotations

import ast
from typing import Dict, Optional

from gan_deeplearning4j_tpu_torch.analysis import _common

_MESH_CTORS = {"make_mesh", "DataMesh", "init_device_mesh"}
_COLLECTIVES = {"all_reduce", "all_gather", "all_gather_into_tensor", "reduce_scatter",
                "reduce_scatter_tensor", "broadcast", "barrier", "reduce", "all_to_all",
                "all_to_all_single", "gather", "scatter"}
_NEW_GROUP = "torch.distributed.new_group"


def _scope_nodes(scope):
    body = [s for s in (getattr(scope, "body", []) or [])
            if not isinstance(s, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef))]
    return list(_common.walk_excluding_defs(body))


def _kw(call: ast.Call, name: str, position: Optional[int] = None):
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    if position is not None and len(call.args) > position:
        return call.args[position]
    return None


def _literal_names(node):
    if isinstance(node, (ast.Tuple, ast.List)) and all(
            isinstance(e, ast.Constant) and isinstance(e.value, str) for e in node.elts):
        return tuple(e.value for e in node.elts)
    return None


class CollectiveOffTheMesh:
    code = "JG013"
    name = "collective-off-the-mesh"
    summary = ("torch.distributed collective over a group no mesh of the scope "
               "was built on, or a mesh dimension name the mesh lacks")

    def check(self, mod):
        if not any(v.startswith("torch.distributed") for v in mod.imports.values()):
            return
        for scope in _common.iter_scopes(mod.tree):
            nodes = _scope_nodes(scope)
            counts: Dict[str, int] = {}
            if isinstance(scope, (ast.FunctionDef, ast.AsyncFunctionDef)):
                a = scope.args
                for arg in a.posonlyargs + a.args + a.kwonlyargs:
                    counts[arg.arg] = counts.get(arg.arg, 0) + 1
            groups, meshes = set(), {}
            for n in nodes:
                if not isinstance(n, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
                    continue
                for name in _common.assignment_targets(n):
                    counts[name] = counts.get(name, 0) + 1
                if not (isinstance(n, ast.Assign) and len(n.targets) == 1
                        and isinstance(n.targets[0], ast.Name)
                        and isinstance(n.value, ast.Call)):
                    continue
                resolved = mod.resolve(n.value.func) or ""
                if resolved == _NEW_GROUP:
                    groups.add(n.targets[0].id)
                elif _common.last_component(resolved) in _MESH_CTORS:
                    meshes[n.targets[0].id] = n.value
            meshes = {m: c for m, c in meshes.items() if counts.get(m) == 1}
            groups = {g for g in groups if counts.get(g) == 1}
            if not meshes:
                continue
            yield from self._check_scope(mod, nodes, meshes, groups)

    def _mesh_facts(self, mod, call, groups):
        """``(spans every rank, its new_group name or None, dimension
        names or None)`` of one mesh construction."""
        kind = _common.last_component(mod.resolve(call.func))
        if kind == "init_device_mesh":
            shape = _common.literal_int_tuple(_kw(call, "mesh_shape", 1)) or ()
            dims = _literal_names(_kw(call, "mesh_dim_names"))
            return len(shape) == 1, None, dims
        if kind == "DataMesh":
            group = _kw(call, "group", 0)
            if group is None or (isinstance(group, ast.Constant) and group.value is None):
                return True, None, None
            if isinstance(group, ast.Name) and group.id in groups:
                return False, group.id, None
            return None, None, None  # a group from elsewhere: unknown
        return True, None, None  # make_mesh: the default group

    def _check_scope(self, mod, nodes, meshes, groups):
        facts = {m: self._mesh_facts(mod, c, groups) for m, c in meshes.items()}
        spans_world = [f[0] for f in facts.values()]
        owned = {f[1] for f in facts.values() if f[1]}
        for n in nodes:
            if isinstance(n, ast.Call):
                yield from self._collective(mod, n, spans_world, groups, owned)
            yield from self._dim_name(mod, n, facts)

    def _collective(self, mod, call, spans_world, groups, owned):
        resolved = mod.resolve(call.func) or ""
        if not (resolved.startswith("torch.distributed.")
                and _common.last_component(resolved) in _COLLECTIVES):
            return
        group = _kw(call, "group")
        what = _common.last_component(resolved)
        if group is None:
            if spans_world and all(s is False for s in spans_world):
                yield mod.finding(
                    self.code,
                    f"`dist.{what}` runs over the default group (every rank), but "
                    f"no mesh of this scope spans every rank — it waits on or "
                    f"sums ranks outside the mesh; pass the mesh's group",
                    call,
                ), call
        elif isinstance(group, ast.Name) and group.id in groups and group.id not in owned:
            yield mod.finding(
                self.code,
                f"`dist.{what}` runs over `{group.id}`, a `dist.new_group` of "
                f"this scope that no mesh was built on — the collective spans "
                f"other ranks than the mesh's; pass the mesh's group",
                call,
            ), call

    def _dim_name(self, mod, node, facts):
        mesh, name = None, None
        if (isinstance(node, ast.Subscript) and isinstance(node.value, ast.Name)
                and isinstance(node.slice, ast.Constant) and isinstance(node.slice.value, str)):
            mesh, name = node.value.id, node.slice.value
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
              and node.func.attr == "get_group" and isinstance(node.func.value, ast.Name)
              and node.args and isinstance(node.args[0], ast.Constant)
              and isinstance(node.args[0].value, str)):
            mesh, name = node.func.value.id, node.args[0].value
        if mesh not in facts:
            return
        dims = facts[mesh][2]
        if dims is not None and name not in dims:
            yield mod.finding(
                self.code,
                f"mesh `{mesh}` has dimensions {dims!r}, not {name!r} — the "
                f"lookup raises when it runs, on the cards; name one of the "
                f"mesh's dimensions",
                node,
            ), node
