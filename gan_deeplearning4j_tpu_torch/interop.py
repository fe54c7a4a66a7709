"""Weights carried across from the JAX package.

``params_from_numpy(tree, device, graph=...)`` turns params given as nested
dicts of host arrays, ``{layer: {name: array}}`` — what the JAX package's
params become under ``np.asarray``, and what a checkpoint's ``arrays.npz``
holds — into the port's tensors on ``device``. Both packages keep the same
layouts (NHWC activations, HWIO conv kernels, ``(in, out)`` dense kernels),
so this is a checked copy with no transposes: every layer and param name,
shape and dtype is checked against the port's graph, and a missing or
extra key raises.

``train_state_from_numpy(state, device, graph=...)`` does the same for a
whole ``TrainState`` (params, updater state, step): what the JAX package's
``TrainState`` becomes under ``np.asarray``, and what a checkpoint with
updater state holds. The updater state is checked key for key, shape for
shape and dtype for dtype against a fresh ``GraphOptimizer(graph).init``,
except that a float slot may be in either storage dtype (under bf16
storage, Adam leaves a step with float32 params and bf16 moments).

Param leaves are float32, bfloat16 or int8 (a quantized layer's ``W_q``,
which stays int8 on the device). Leaves may be numpy arrays (including
``ml_dtypes`` bfloat16 arrays, as
``np.asarray`` gives them for a bf16 JAX array) or CPU tensors (the
serializer decodes bf16 members straight into tensors: numpy has no
bfloat16 of its own).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from gan_deeplearning4j_tpu_torch.runtime.device import DeviceLike, resolve_device

#: the float storage dtypes the reference writes params and updater state in
_FLOAT_STORAGE_DTYPES = (torch.float32, torch.bfloat16)
#: every param storage dtype: int8 is a quantized layer's ``W_q``, kept
#: int8 on the device
_STORAGE_DTYPES = _FLOAT_STORAGE_DTYPES + (torch.int8,)


def leaf_to_tensor(value) -> torch.Tensor:
    """One host leaf as a CPU tensor that owns its memory. A bfloat16 numpy
    array (``ml_dtypes``) travels by its 16-bit pattern."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu()
    arr = np.asarray(value)
    if arr.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def params_from_numpy(tree: Dict, device: DeviceLike, *, graph) -> Dict[str, Dict[str, torch.Tensor]]:
    """Checked copy of a ``{layer: {name: array}}`` tree onto ``device``
    (``None`` = the card). Raises ``KeyError`` on a missing or extra layer
    or param and ``ValueError`` on a shape or dtype the graph does not
    take."""
    dev = resolve_device(device)
    want = graph.param_shapes()
    missing = sorted(set(want) - set(tree))
    extra = sorted(set(tree) - set(want))
    if missing or extra:
        raise KeyError(f"param layers do not match the graph: missing {missing}, extra {extra}")
    out: Dict[str, Dict[str, torch.Tensor]] = {}
    for layer, shapes in want.items():
        leaves = tree[layer]
        missing = sorted(set(shapes) - set(leaves))
        extra = sorted(set(leaves) - set(shapes))
        if missing or extra:
            raise KeyError(
                f"params of layer {layer!r} do not match the graph: missing {missing}, extra {extra}"
            )
        out[layer] = {}
        for name, shape in shapes.items():
            t = leaf_to_tensor(leaves[name])
            if tuple(t.shape) != tuple(shape):
                raise ValueError(
                    f"{layer}/{name}: graph wants shape {tuple(shape)}, got {tuple(t.shape)}"
                )
            if t.dtype not in _STORAGE_DTYPES:
                raise ValueError(
                    f"{layer}/{name}: dtype {t.dtype} is not a storage dtype "
                    f"({', '.join(str(d) for d in _STORAGE_DTYPES)})"
                )
            out[layer][name] = t.to(dev)
    return out


def train_state_from_numpy(state, device: DeviceLike, *, graph):
    """Checked copy of a train state onto ``device``: ``state`` has
    ``params``, ``opt_state`` and ``step`` as attributes or as dict keys.
    Returns the port's ``TrainState`` (``step`` a Python int). Raises
    ``KeyError``/``ValueError`` as :func:`params_from_numpy` does."""
    from gan_deeplearning4j_tpu_torch.optim.optimizer import GraphOptimizer
    from gan_deeplearning4j_tpu_torch.parallel.trainer import TrainState

    def part(name):
        return state[name] if isinstance(state, dict) else getattr(state, name)

    dev = resolve_device(device)
    params = params_from_numpy(part("params"), dev, graph=graph)
    # the expected slots, shapes and dtypes, without allocating them
    want = GraphOptimizer(graph).init(
        {layer: {n: p.to("meta") for n, p in lp.items()} for layer, lp in params.items()}
    )
    got = part("opt_state")
    opt_state: Dict = {}
    for layer in sorted(set(want) | set(got)):
        if layer not in want or layer not in got:
            raise KeyError(f"updater state layers do not match the graph at {layer!r}")
        opt_state[layer] = {}
        for pname in sorted(set(want[layer]) | set(got[layer])):
            if pname not in want[layer] or pname not in got[layer]:
                raise KeyError(f"updater state of {layer!r} does not match the graph at {pname!r}")
            slots_want, slots_got = want[layer][pname], got[layer][pname]
            if set(slots_want) != set(slots_got):
                raise KeyError(
                    f"{layer}/{pname}: updater slots {sorted(slots_got)}, "
                    f"graph wants {sorted(slots_want)}"
                )
            opt_state[layer][pname] = {}
            for slot, ref in slots_want.items():
                t = leaf_to_tensor(slots_got[slot])
                # a float slot may be in either storage dtype, whatever its
                # param's: under bf16 storage Adam promotes the params to
                # float32 one step before their moments (optim/updaters.py)
                dtype_ok = t.dtype == ref.dtype or (
                    ref.dtype in _FLOAT_STORAGE_DTYPES and t.dtype in _FLOAT_STORAGE_DTYPES)
                if tuple(t.shape) != tuple(ref.shape) or not dtype_ok:
                    raise ValueError(
                        f"{layer}/{pname}/{slot}: graph wants {tuple(ref.shape)} {ref.dtype}, "
                        f"got {tuple(t.shape)} {t.dtype}"
                    )
                opt_state[layer][pname][slot] = t.to(dev)
    return TrainState(params, opt_state, int(np.asarray(part("step"))))
