"""Collectives over a ``DataMesh`` — the all-reduces, reduce-scatters and
all-gathers that XLA inserts for the JAX package's sharded programs, made
explicitly here, one process per rank.

- :func:`mean` averages a list of tensors over the mesh into new tensors:
  one all-reduce (sum) per dtype over the tensors packed into one flat
  buffer, then a division by the axis size, so at world 1 the values keep
  their bits;
- :func:`maximum` takes the elementwise maximum (the JAX package's
  ``pmax`` for integer leaves);
- :func:`reduce_scatter` / :func:`all_gather` move a flat ``(N·w,)`` buffer
  to this rank's ``(w,)`` row summed over ranks, and back;
- :func:`all_reduce_sum` is differentiable: its backward all-reduces the
  incoming gradient. ``torch.distributed.all_reduce`` carries no gradient;
  synchronised BatchNorm needs one, since every rank's loss reads the
  global statistics (``ops/norm.py``).

There is no shortcut at world size 1: the collective is still made, so a
world of one runs the path a larger world runs (inside a captured CUDA
graph on NCCL).

gloo on CUDA tensors: gloo's CUDA coverage is narrower than its CPU
coverage (no reduce-scatter, no all-gather into one tensor), so on a gloo
mesh whose device is a card every collective here goes through a host
buffer: a copy to the host, the collective on the host tensor, a copy
back. That is the gloo path only (``DataMesh.staged``); NCCL never stages.
:data:`STAGING` counts those calls, their bytes and the host seconds they
took (the copies and the collective together), per process; :data:`CALLS`
counts every collective issued, by kind.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Dict, List, Sequence

import torch
import torch.distributed as dist

#: gloo-on-CUDA host staging in this process: calls, bytes, host seconds
STAGING: Dict[str, float] = {"calls": 0, "bytes": 0, "seconds": 0.0}
#: collectives this process has issued, by kind (a captured graph issues
#: its collectives once, at capture; its replays run them without Python)
CALLS: Dict[str, int] = {"all_reduce": 0, "reduce_scatter": 0, "all_gather": 0}

_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def reset_staging() -> None:
    STAGING.update(calls=0, bytes=0, seconds=0.0)


def reset_calls() -> None:
    CALLS.update({k: 0 for k in CALLS})


def _staged(mesh, kind: str, fn, *tensors: torch.Tensor):
    """Run the collective ``fn`` on host copies of ``tensors`` and copy the
    results back (gloo on the card); on the tensors themselves otherwise."""
    CALLS[kind] += 1
    if not mesh.staged:
        fn(*tensors)
        return
    t0 = time.perf_counter()
    host = [t.detach().to("cpu") for t in tensors]
    fn(*host)
    for t, h in zip(tensors, host):
        t.copy_(h)
    STAGING["calls"] += 1
    STAGING["bytes"] += sum(t.numel() * t.element_size() for t in tensors)
    STAGING["seconds"] += time.perf_counter() - t0


def all_reduce_(tensor: torch.Tensor, mesh, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """In place: ``tensor`` reduced over the mesh with ``op``."""
    _staged(mesh, "all_reduce", lambda t: dist.all_reduce(t, op=op, group=mesh.group), tensor)
    return tensor


def _by_dtype(tensors: Sequence[torch.Tensor]) -> "OrderedDict[torch.dtype, List[int]]":
    groups: "OrderedDict[torch.dtype, List[int]]" = OrderedDict()
    for i, t in enumerate(tensors):
        groups.setdefault(t.dtype, []).append(i)
    return groups


def _packed(tensors: Sequence[torch.Tensor], mesh, op) -> List[torch.Tensor]:
    """New tensors: ``tensors`` reduced over the mesh with ``op``, one
    collective per dtype on a flat buffer."""
    out: List[torch.Tensor] = [None] * len(tensors)  # type: ignore[list-item]
    for _, idx in _by_dtype(tensors).items():
        flat = torch.cat([tensors[i].detach().reshape(-1) for i in idx])
        all_reduce_(flat, mesh, op)
        at = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = flat[at:at + n].view(tensors[i].shape)
            at += n
    return out


def mean(tensors: Sequence[torch.Tensor], mesh) -> List[torch.Tensor]:
    """New tensors: the mean of each of ``tensors`` over the mesh (sum,
    then a division by the axis size in each tensor's dtype)."""
    summed = _packed(tensors, mesh, dist.ReduceOp.SUM)
    return [s.div_(mesh.size) for s in summed]


def maximum(tensors: Sequence[torch.Tensor], mesh) -> List[torch.Tensor]:
    """New tensors: the elementwise maximum over the mesh."""
    return _packed(tensors, mesh, dist.ReduceOp.MAX)


def reduce_scatter(flat: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's ``(w,)`` row of ``flat`` ``(N·w,)``, summed over ranks."""
    flat = flat.contiguous()
    row = torch.empty(flat.numel() // mesh.size, dtype=flat.dtype, device=flat.device)
    _staged(mesh, "reduce_scatter", lambda o, i: _reduce_scatter(o, i, group=mesh.group), row, flat)
    return row


def all_gather(row: torch.Tensor, mesh) -> torch.Tensor:
    """``(N·w,)``: every rank's ``(w,)`` row, in rank order."""
    row = row.contiguous()
    out = torch.empty(row.numel() * mesh.size, dtype=row.dtype, device=row.device)
    _staged(mesh, "all_gather", lambda o, i: _all_gather(o, i, group=mesh.group), out, row)
    return out


class _AllReduceSum(torch.autograd.Function):
    """Sum over the mesh whose backward sums the gradient over the mesh:
    rank r's input feeds every rank's output, so the gradient reaching it
    is the sum of every rank's output gradient."""

    @staticmethod
    def forward(ctx, tensor, mesh):
        ctx.mesh = mesh
        out = tensor.detach().clone(memory_format=torch.contiguous_format)
        return all_reduce_(out, mesh)

    @staticmethod
    def backward(ctx, grad):
        out = grad.detach().clone(memory_format=torch.contiguous_format)
        return all_reduce_(out, ctx.mesh), None


def all_reduce_sum(tensor: torch.Tensor, mesh) -> torch.Tensor:
    """Differentiable sum of ``tensor`` over the mesh (a new tensor)."""
    return _AllReduceSum.apply(tensor, mesh)

