"""Model checkpoints in the JAX package's format — counterpart of
``gan_deeplearning4j_tpu/utils/serializer.py`` (``write_model``,
``read_model`` and ``ModelSerializer.restore_train_state``).

A checkpoint is one zip holding:

- ``topology.json`` — ``ComputationGraph.to_dict()``;
- ``arrays.npz`` — every named param (and, optionally, updater state)
  under ``params/<layer>/<name>`` / ``updater/<layer>/<param>/<slot>``;
- ``meta.json`` — format version, step, and a sha256 digest per member.

bfloat16 leaves travel as uint16 bit patterns, with the real dtype
recorded in ``meta.json``'s ``array_dtypes``; int8 leaves (a quantized
layer's ``W_q``) are npz's own int8 and load as int8. Only numpy and zipfile touch
the bytes, so a zip written by either package loads in the other.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import tempfile
import zipfile
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from gan_deeplearning4j_tpu_torch.interop import leaf_to_tensor, params_from_numpy
from gan_deeplearning4j_tpu_torch.runtime.device import DeviceLike, resolve_device

FORMAT_VERSION = 1


def member_digest(data: bytes) -> str:
    """Content digest of one checkpoint member (``sha256:<hex>``)."""
    return "sha256:" + hashlib.sha256(data).hexdigest()


def _flatten(prefix: str, tree: Dict, out: Dict) -> None:
    for key, value in tree.items():
        path = f"{prefix}/{key}"
        if isinstance(value, dict):
            _flatten(path, value, out)
        else:
            out[path] = value


def _unflatten(flat: Dict, prefix: str) -> Dict:
    tree: Dict = {}
    plen = len(prefix) + 1
    for path, value in flat.items():
        if not path.startswith(prefix + "/"):
            continue
        node = tree
        parts = path[plen:].split("/")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    return tree


def _npz_encode(arrays: Dict) -> Tuple[bytes, Dict[str, str]]:
    """Serialize a flat dict of tensors/arrays to npz bytes; bfloat16 leaves
    as uint16 bit patterns, named in the returned dtype map."""
    host: Dict[str, np.ndarray] = {}
    ext_dtypes: Dict[str, str] = {}
    for key, value in arrays.items():
        t = leaf_to_tensor(value)
        if t.dtype == torch.bfloat16:
            host[key] = t.view(torch.int16).numpy().view(np.uint16)
            ext_dtypes[key] = "bfloat16"
        else:
            host[key] = t.numpy()
    buf = io.BytesIO()
    np.savez(buf, **host)
    return buf.getvalue(), ext_dtypes


def _npz_decode(npz_bytes: bytes, ext_dtypes: Dict[str, str]) -> Dict:
    """npz bytes back to a flat dict: numpy arrays, and CPU bfloat16
    tensors for the tagged leaves."""
    with np.load(io.BytesIO(npz_bytes)) as npz:
        flat = {k: npz[k] for k in npz.files}
    for key, name in ext_dtypes.items():
        if name != "bfloat16":
            raise ValueError(f"array {key!r} has unsupported stored dtype {name!r}")
        flat[key] = torch.from_numpy(flat[key].view(np.int16).copy()).view(torch.bfloat16)
    return flat


def write_model(path: str, graph, state, save_updater: bool = True) -> None:
    """Serialize graph topology + params (+ updater state) to ``path``.

    ``state`` is a bare params dict, or an object with ``params`` (and
    optionally ``opt_state``/``step``) attributes. Lands via temp file,
    fsync and rename, so a reader never sees a torn zip."""
    params = getattr(state, "params", state)
    opt_state = getattr(state, "opt_state", None) if save_updater else None
    step = getattr(state, "step", None)

    arrays: Dict = {}
    _flatten("params", params, arrays)
    if opt_state is not None:
        _flatten("updater", opt_state, arrays)
    npz_bytes, ext_dtypes = _npz_encode(arrays)
    topology_bytes = json.dumps(graph.to_dict()).encode()
    meta = {
        "format_version": FORMAT_VERSION,
        "step": int(step) if step is not None else 0,
        "has_updater": opt_state is not None,
        "array_dtypes": ext_dtypes,
        "member_digests": {
            "topology.json": member_digest(topology_bytes),
            "arrays.npz": member_digest(npz_bytes),
        },
    }
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as fh:
            with zipfile.ZipFile(fh, "w", zipfile.ZIP_DEFLATED) as zf:
                zf.writestr("topology.json", topology_bytes)
                zf.writestr("meta.json", json.dumps(meta))
                zf.writestr("arrays.npz", npz_bytes)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def read_model(
    path: str, load_updater: bool = True, *, device: DeviceLike = None
) -> Tuple[object, Dict, Optional[Dict], int]:
    """Load a checkpoint: ``(graph, params, opt_state_or_None, step)``, the
    tensors on ``device`` (``None`` = the card).

    Params go through :func:`params_from_numpy`, checked against the graph
    rebuilt from ``topology.json``. A corrupted or truncated file raises
    ``ValueError``; it is never half-loaded."""
    from gan_deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    dev = resolve_device(device)
    try:
        with zipfile.ZipFile(path, "r") as zf:
            topology_bytes = zf.read("topology.json")
            meta = json.loads(zf.read("meta.json"))
            if meta["format_version"] > FORMAT_VERSION:
                raise ValueError(
                    f"checkpoint format {meta['format_version']} is newer than "
                    f"supported {FORMAT_VERSION}"
                )
            npz_bytes = zf.read("arrays.npz")
            for name, data in (("topology.json", topology_bytes), ("arrays.npz", npz_bytes)):
                want = meta.get("member_digests", {}).get(name)
                if want is not None and member_digest(data) != want:
                    raise ValueError(
                        f"checkpoint {path!r} member {name!r} fails digest "
                        f"verification (expected {want}) — corrupted bytes"
                    )
            topology = json.loads(topology_bytes)
    except zipfile.BadZipFile as exc:
        raise ValueError(f"corrupted or truncated checkpoint {path!r}: {exc}") from exc
    except KeyError as exc:
        raise ValueError(f"checkpoint {path!r} is missing a required member: {exc}") from exc
    try:
        flat = _npz_decode(npz_bytes, meta.get("array_dtypes", {}))
    except zipfile.BadZipFile as exc:
        raise ValueError(f"corrupted or truncated checkpoint {path!r}: {exc}") from exc

    graph = ComputationGraph.from_dict(topology)
    params = params_from_numpy(_unflatten(flat, "params"), dev, graph=graph)
    opt_state = None
    if load_updater and meta["has_updater"]:
        opt_state = _to_device(_unflatten(flat, "updater"), dev)
    return graph, params, opt_state, meta["step"]


def _to_device(tree: Dict, device: torch.device) -> Dict:
    return {
        k: _to_device(v, device) if isinstance(v, dict) else leaf_to_tensor(v).to(device)
        for k, v in tree.items()
    }


class ModelSerializer:
    """DL4J-shaped static facade (``ModelSerializer.restore``)."""

    @staticmethod
    def restore_train_state(path: str, trainer, *, device: DeviceLike = None):
        """A trainer-ready ``TrainState`` from a checkpoint (resume). A
        checkpoint without updater state gets a fresh one; one with updater
        state is checked against the trainer's graph like the params."""
        from gan_deeplearning4j_tpu_torch.interop import train_state_from_numpy

        graph, params, opt_state, step = read_model(path, device=device)
        if opt_state is None:
            opt_state = trainer.optimizer.init(params)
        return train_state_from_numpy(
            {"params": params, "opt_state": opt_state, "step": step}, device, graph=trainer.graph
        )
