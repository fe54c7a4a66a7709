"""Cross-replica weight-update sharding — counterpart of
``gan_deeplearning4j_tpu/parallel/update_sharding.py`` ("Automatic
Cross-Replica Sharding of Weight Update in Data-Parallel Training").

Under per-step gradient sync every rank would apply the same full update.
Here the trainable keys are partitioned over the ``data`` axis: each rank
owns some, takes the mean gradient of its own keys, applies the updater
to them with the updater state it alone holds, and the updated params are
all-gathered. Resident updater state per rank is about 1/N.

The partition is the JAX package's, key for key. Ownership of a key is
``utils/serializer.py::shard_assignment`` evaluated on the experiment's
flat ``<model>/params|updater|step`` namespace, so compute shard k owns
the updater keys checkpoint shard k writes (a multi-field state, Adam's
m/v/t, goes with its first key). A leaf bigger than its group's threshold
(``max(1024, total / 4N)``) is split into one contiguous piece per rank.

The layout is not the JAX package's. ``PackedOptState`` there is a
``(N, width)`` row matrix per updater group, placed on the mesh's devices
for XLA to partition; here each rank holds only its own row, one flat
``(width,)`` tensor per group and state field: ``{group id: {field:
row}}``, a plain dict (CUDA-graph capture treats it as any state tree).
A scalar field (Adam's ``t``) is stored per element, as in the JAX
package, so every update stays elementwise.

One step (:meth:`UpdateShardingPlan.apply_update`): this rank's ``(W,)``
row of the mean gradient, per dtype, all groups side by side, is made in
one of two ways, as the JAX package's ``exact_grads`` chooses:

- ``exact_grads=True`` (the default, as in the JAX package): the
  gradients are averaged with the replicated step's all-reduce, on the
  same buffer (``GraphTrainer.reduce``), and each rank slices its row out
  of the mean: the sharded step then equals the replicated one bit for
  bit, since packing is slicing and concatenation and every updater is
  elementwise;
- ``exact_grads=False``: every rank packs its local gradients into the
  ``(N, W)`` layout and reduce-scatters it (sum), which leaves its row
  summed over ranks, then divides by N: the paper's communication, half
  an all-reduce's bytes. The sums may add the ranks' contributions in
  another order than the all-reduce (gloo's ring does at 4 ranks), which
  is rounding.

The row is clipped as the replicated optimizer clips (elementwise; a
global norm takes one more all-reduce of the squared sum), and each
group's updater runs on its segment of it. The updated param rows are
all-gathered, one collective per dtype, and unpacked into the param tree.
BatchNorm running stats are not trainable; they come from the forward
pass, equal on every rank.

:meth:`UpdateShardingPlan.unpack_state` (the tree form that checkpoints
and digests take) all-gathers every field, a collective: every rank calls
it together.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from gan_deeplearning4j_tpu_torch.optim.optimizer import GraphOptimizer
from gan_deeplearning4j_tpu_torch.parallel import collectives
from gan_deeplearning4j_tpu_torch.runtime.dtype import weak_scalar


@dataclasses.dataclass(frozen=True)
class _Slot:
    """One piece of a trainable param leaf in the row layout: the whole
    leaf, owned by the partition's shard, or one rank's contiguous piece of
    an element-split leaf."""

    key: str                 # flat param key: <model>/params/<layer>/<pname>
    layer: str
    pname: str
    shape: Tuple[int, ...]
    start: int               # element range [start, stop) of the flat leaf
    stop: int
    row: int                 # owning rank
    offset: int              # start within the owner's row of the group
    split: bool
    state_keys: Tuple[str, ...]

    @property
    def size(self) -> int:
        return self.stop - self.start


@dataclasses.dataclass
class _Group:
    """The slots sharing one (updater spec, param dtype)."""

    spec: Any
    dtype: torch.dtype
    fields: Tuple[str, ...]
    field_dtypes: Dict[str, torch.dtype]
    scalar_fields: frozenset
    slots: List[_Slot] = dataclasses.field(default_factory=list)
    rows: List[List[_Slot]] = dataclasses.field(default_factory=list)
    width: int = 0


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def flat_model_keys(model_name: str, params: Dict, optimizer: GraphOptimizer) -> Dict[str, int]:
    """The flat key namespace one model contributes to an experiment's
    ``_flat_state()``, as key → element count: every param leaf, every
    updater state leaf and the step counter (from shapes alone)."""
    from gan_deeplearning4j_tpu_torch.utils.serializer import _element_count, _flatten

    keys: Dict[str, Any] = {}
    _flatten(f"{model_name}/params", params, keys)
    _flatten(f"{model_name}/updater", optimizer.state_structs(params), keys)
    keys[f"{model_name}/step"] = None
    return {k: _element_count(v) for k, v in keys.items()}


class UpdateShardingPlan:
    """The partition and row layout of one model's trainable state over a
    mesh. ``global_keys`` maps every flat key of the partition to its
    element count (an experiment passes its whole ``_flat_state()``
    namespace, so ownership matches its checkpoint shards); None derives
    it from this model alone."""

    def __init__(self, graph, optimizer: GraphOptimizer, params: Dict, mesh,
                 model_name: str = "model", global_keys: Optional[Dict[str, int]] = None,
                 exact_grads: bool = True):
        del graph  # the optimizer carries everything the layout needs
        from gan_deeplearning4j_tpu_torch.utils.serializer import shard_assignment

        self.mesh = mesh
        self.exact_grads = exact_grads
        self.model_name = model_name
        self.num_shards = int(mesh.size)
        self.rank = int(mesh.rank)
        self.base = optimizer
        if global_keys is None:
            global_keys = flat_model_keys(model_name, params, optimizer)
        assign = shard_assignment(dict(global_keys), self.num_shards)

        structs = optimizer.state_structs(params)
        self._groups: Dict[str, _Group] = {}
        for layer in sorted(params):
            spec = optimizer.updaters.get(layer)
            if spec is None:
                continue
            for pname in sorted(params[layer]):
                if not optimizer.trainable(layer, pname):
                    continue
                leaf = params[layer][pname]
                field_structs = structs.get(layer, {}).get(pname, {})
                fields = tuple(sorted(field_structs))
                state_keys = tuple(f"{model_name}/updater/{layer}/{pname}/{f}" for f in fields)
                anchor = state_keys[0] if state_keys else f"{model_name}/params/{layer}/{pname}"
                if anchor not in assign:
                    raise ValueError(
                        f"update-sharding anchor key {anchor!r} is missing "
                        f"from the global flat key list — the partition "
                        f"would disagree with the checkpoint plane")
                slot = _Slot(key=f"{model_name}/params/{layer}/{pname}", layer=layer,
                             pname=pname, shape=tuple(leaf.shape), start=0,
                             stop=max(1, leaf.numel()), row=assign[anchor], offset=-1,
                             split=False, state_keys=state_keys)
                gid = f"{spec.kind}|{spec!r}|{_dtype_name(leaf.dtype)}"
                group = self._groups.get(gid)
                if group is None:
                    group = self._groups[gid] = _Group(
                        spec=spec, dtype=leaf.dtype, fields=fields,
                        field_dtypes={f: field_structs[f].dtype for f in fields},
                        scalar_fields=frozenset(f for f in fields if field_structs[f].ndim == 0))
                group.slots.append(slot)

        # element-split oversized leaves into one contiguous piece per rank
        n = self.num_shards
        for group in self._groups.values():
            total = sum(s.size for s in group.slots)
            threshold = max(1024, -(-total // (4 * n)))
            pieces: List[_Slot] = []
            for slot in group.slots:
                if n > 1 and slot.size > threshold:
                    chunk = -(-slot.size // n)
                    for j in range(n):
                        lo, hi = j * chunk, min((j + 1) * chunk, slot.size)
                        if lo < hi:
                            pieces.append(dataclasses.replace(slot, start=lo, stop=hi, row=j,
                                                              split=True))
                else:
                    pieces.append(slot)
            group.slots = pieces

        # per group, each rank's pieces in sorted (key, start) order
        for group in self._groups.values():
            rows: List[List[_Slot]] = [[] for _ in range(n)]
            for slot in sorted(group.slots, key=lambda s: (s.key, s.start)):
                row = rows[slot.row]
                row.append(dataclasses.replace(slot, offset=sum(s.size for s in row)))
            group.rows = rows
            group.slots = [s for row in rows for s in row]
            group.width = max(1, max(sum(s.size for s in row) for row in rows))
        self._gids = sorted(self._groups)
        # per dtype, the groups side by side in one row of width W
        self._by_dtype: Dict[torch.dtype, List[str]] = {}
        for gid in self._gids:
            self._by_dtype.setdefault(self._groups[gid].dtype, []).append(gid)

    # -- partition introspection ------------------------------------------
    def updater_keys_for_shard(self, shard: int) -> List[str]:
        """The flat updater keys wholly resident on rank ``shard`` (an
        element-split key spans every rank)."""
        out = []
        for gid in self._gids:
            for slot in self._groups[gid].rows[shard]:
                if not slot.split:
                    out.extend(slot.state_keys)
        return sorted(out)

    def element_split_state_keys(self) -> List[str]:
        return sorted({k for g in self._groups.values() for s in g.slots if s.split
                       for k in s.state_keys})

    def describe(self) -> Dict:
        """Layout summary: shard count, per-group widths, rows used, split
        keys and the row layout's padding share."""
        groups = {}
        for gid in self._gids:
            g = self._groups[gid]
            used = [sum(s.size for s in row) for row in g.rows]
            groups[gid] = {
                "kind": g.spec.kind,
                "fields": list(g.fields),
                "width": g.width,
                "rows_used": used,
                "split_keys": sorted({s.key for s in g.slots if s.split}),
                "padding_fraction": 1.0 - sum(used) / float(g.width * self.num_shards),
            }
        return {"model": self.model_name, "num_shards": self.num_shards,
                "data_axis": self.mesh.axis, "exact_grads": self.exact_grads, "groups": groups}

    def resident_bytes(self, packed: Dict) -> int:
        """Bytes of this rank's updater rows."""
        return sum(t.numel() * t.element_size() for fields in packed.values()
                   for t in fields.values())

    # -- packing -------------------------------------------------------------
    def _row(self, group: _Group, r: int, leaf_of: Callable[[_Slot], torch.Tensor],
             dtype, device) -> torch.Tensor:
        """Rank ``r``'s ``(width,)`` row of ``group``: its pieces of the
        flattened leaves, zero-padded. ``leaf_of`` returns the whole leaf
        (or a 0-d tensor, broadcast over the piece)."""
        parts = []
        for slot in group.rows[r]:
            leaf = leaf_of(slot).to(dtype)
            if leaf.ndim == 0:
                parts.append(leaf.expand(slot.size))
            else:
                parts.append(leaf.reshape(-1)[slot.start:slot.stop])
        used = sum(s.size for s in group.rows[r])
        if used < group.width:
            parts.append(torch.zeros(group.width - used, dtype=dtype, device=device))
        return torch.cat(parts)

    def init_packed(self, params: Dict) -> Dict:
        """This rank's updater rows, fresh: each owned piece's
        ``init_state_packed``, the values of the tree init."""
        out = {}
        for gid in self._gids:
            group = self._groups[gid]
            device = params[group.rows[self.rank][0].layer][group.rows[self.rank][0].pname].device \
                if group.rows[self.rank] else self.mesh.device
            per_piece = {}
            for slot in group.rows[self.rank]:
                flat = params[slot.layer][slot.pname].to(group.dtype).reshape(-1)[slot.start:slot.stop]
                per_piece[(slot.key, slot.start)] = group.spec.init_state_packed(flat)
            fields = {}
            for f in group.fields:
                parts = [per_piece[(s.key, s.start)][f] for s in group.rows[self.rank]]
                used = sum(s.size for s in group.rows[self.rank])
                if used < group.width:
                    parts.append(torch.zeros(group.width - used, dtype=group.field_dtypes[f],
                                             device=device))
                fields[f] = torch.cat(parts)
            out[gid] = fields
        return out

    def pack_state(self, opt_state: Dict) -> Dict:
        """This rank's rows of a tree-form updater state (a checkpoint's)."""
        out = {}
        for gid in self._gids:
            group = self._groups[gid]
            out[gid] = {
                f: self._row(group, self.rank, lambda s, f=f: opt_state[s.layer][s.pname][f],
                             group.field_dtypes[f], self.mesh.device)
                for f in group.fields
            }
        return out

    def _pieces_by_key(self, group: _Group) -> Dict[str, List[_Slot]]:
        by_key: Dict[str, List[_Slot]] = {}
        for slot in group.slots:
            by_key.setdefault(slot.key, []).append(slot)
        return {k: sorted(v, key=lambda s: s.start) for k, v in by_key.items()}

    def _unpack(self, group: _Group, full: torch.Tensor, scalar: bool, into: Callable) -> None:
        """Split ``full`` ``(N, width)`` into leaves, ``into(slot, leaf)``."""
        for pieces in self._pieces_by_key(group).values():
            first = pieces[0]
            if scalar:
                into(first, full[first.row, first.offset])
                continue
            segs = [full[p.row, p.offset:p.offset + p.size] for p in pieces]
            flat = segs[0] if len(segs) == 1 else torch.cat(segs)
            into(first, flat.reshape(first.shape))

    def unpack_state(self, packed: Dict) -> Dict:
        """The tree form of every rank's rows (an all-gather per field: a
        collective), as ``GraphOptimizer.init`` lays it out."""
        state: Dict = {}
        for gid in self._gids:
            group = self._groups[gid]
            for f in group.fields:
                full = collectives.all_gather(packed[gid][f], self.mesh).view(self.num_shards, -1)

                def into(slot, leaf, f=f):
                    state.setdefault(slot.layer, {}).setdefault(slot.pname, {})[f] = leaf.clone()

                self._unpack(group, full, f in group.scalar_fields, into)
        for group in self._groups.values():
            for slot in group.slots:
                state.setdefault(slot.layer, {}).setdefault(slot.pname, {})
        return state

    # -- the sharded update -----------------------------------------------
    def _clip(self, rows: Dict[torch.dtype, torch.Tensor]) -> Dict[torch.dtype, torch.Tensor]:
        base = self.base
        if base._clip == "elementwise":
            v = base._clip_value
            return {dt: r.clamp(-v, v) for dt, r in rows.items()}
        if base._clip == "global_norm":
            sq = sum(torch.sum(r.float() ** 2) for r in rows.values())
            norm = torch.sqrt(collectives.all_reduce_(sq.reshape(1), self.mesh))[0]
            scale = torch.clamp(base._clip_value / (norm + 1e-12), max=1.0)
            return {dt: (r * scale).to(dt) for dt, r in rows.items()}
        if base._clip is not None:
            raise ValueError(f"unknown gradient_clip {base._clip!r}")
        return rows

    def apply_update(self, params: Dict, grads: Dict, packed: Dict,
                     lr_scale=None) -> Tuple[Dict, Dict]:
        """The sharded ``GraphOptimizer.step``: ``grads`` are the mesh mean
        (``exact_grads``) or this rank's local gradients. Returns the new
        params (every leaf, replicated) and this rank's new updater rows."""
        n, r = self.num_shards, self.rank
        rows = {}
        for dtype, gids in self._by_dtype.items():
            if self.exact_grads:
                rows[dtype] = torch.cat([
                    self._row(self._groups[gid], r, lambda s: grads[s.layer][s.pname], dtype,
                              self.mesh.device) for gid in gids])
                continue
            full = torch.cat([
                self._row(self._groups[gid], k, lambda s: grads[s.layer][s.pname], dtype,
                          self.mesh.device)
                for k in range(n) for gid in gids
            ])
            rows[dtype] = collectives.reduce_scatter(full, self.mesh).div_(n)
        rows = self._clip(rows)
        new_params = {layer: dict(v) for layer, v in params.items()}
        new_packed: Dict[str, Dict[str, torch.Tensor]] = {}
        for dtype, gids in self._by_dtype.items():
            updated, col = [], 0
            for gid in gids:
                group = self._groups[gid]
                g_row = rows[dtype][col:col + group.width]
                col += group.width
                p_row = self._row(group, r, lambda s: params[s.layer][s.pname], dtype,
                                  self.mesh.device)
                deltas, states = group.spec.apply_group([packed[gid]], [g_row], [p_row])
                delta = deltas[0]
                if lr_scale is not None:
                    scale = (lr_scale.to(delta.dtype) if isinstance(lr_scale, torch.Tensor)
                             else weak_scalar(lr_scale, delta.dtype))
                    delta = delta * scale
                updated.append(p_row - delta)
                new_packed[gid] = dict(states[0])
            full = collectives.all_gather(torch.cat(updated), self.mesh).view(n, -1)
            col = 0
            for gid in gids:
                group = self._groups[gid]
                block = full[:, col:col + group.width]
                col += group.width

                def into(slot, leaf):
                    new_params[slot.layer][slot.pname] = leaf

                self._unpack(group, block, False, into)
        return new_params, new_packed


class ShardedGraphOptimizer:
    """Drop-in for :class:`GraphOptimizer` whose state is this rank's rows
    (``init`` / ``step`` keep the base signatures); ``base`` is the
    replicated optimizer (checkpoints and restores go through its tree
    form)."""

    def __init__(self, plan: UpdateShardingPlan):
        self.plan = plan
        self.base = plan.base

    def trainable(self, layer: str, pname: str) -> bool:
        return self.base.trainable(layer, pname)

    def trainable_keys(self, params: Dict):
        return self.base.trainable_keys(params)

    @property
    def updaters(self):
        return self.base.updaters

    def init(self, params: Dict) -> Dict:
        return self.plan.init_packed(params)

    def step(self, params: Dict, grads: Dict, opt_state: Dict,
             lr_scale=None) -> Tuple[Dict, Dict]:
        return self.plan.apply_update(params, grads, opt_state, lr_scale=lr_scale)
