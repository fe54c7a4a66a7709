"""Model checkpoints in the JAX package's format — counterpart of
``gan_deeplearning4j_tpu/utils/serializer.py`` (``write_model``,
``read_model``, ``ModelSerializer.restore_train_state``, and the mesh
checkpoint plane's ``shard_assignment``, ``shard_keys``,
``write_state_shard`` and ``read_state_shard``).

A checkpoint is one zip holding:

- ``topology.json`` — ``ComputationGraph.to_dict()``;
- ``arrays.npz`` — every named param (and, optionally, updater state)
  under ``params/<layer>/<name>`` / ``updater/<layer>/<param>/<slot>``;
- ``meta.json`` — format version, step, and a sha256 digest per member.

bfloat16 leaves travel as uint16 bit patterns, with the real dtype
recorded in ``meta.json``'s ``array_dtypes``; int8 leaves (a quantized
layer's ``W_q``) are npz's own int8 and load as int8. Only numpy and zipfile touch
the bytes, so a zip written by either package loads in the other.

A mesh checkpoint is one zip per shard, ``arrays.npz`` (the shard's keys
of the experiment's flat ``<model>/params|updater|step`` namespace) and
``meta.json``; the partition is :func:`shard_assignment`, a size-balanced
split that every rank derives from the sorted keys and their element
counts alone, and that the update-sharding plan
(``parallel/update_sharding.py``) shares. The step counters enter the
namespace as 0-d int32 arrays, as the JAX package's do: their element
count is 1 (a Python int would count as its value). For the same arrays
the port writes the JAX package's ``arrays.npz`` byte for byte.
"""

from __future__ import annotations

import hashlib
import heapq
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


def _element_count(value) -> int:
    """Leaf size (elements) for the balanced partition: tensors and arrays
    by shape, ints verbatim, anything else (None placeholders) 1."""
    if value is None:
        return 1
    if isinstance(value, (int, np.integer)):
        return max(1, int(value))
    shape = getattr(value, "shape", None)
    if shape is None:
        return 1
    n = 1
    for d in shape:
        n *= int(d)
    return max(1, n)


def shard_assignment(sizes: Dict[str, int], shard_count: int) -> Dict[str, int]:
    """The deterministic size-balanced partition of the flat key space,
    key → owning shard: within each kind bucket (the second path
    component, ``params`` / ``updater`` / ``step``) keys go largest first
    to the least-loaded shard, ties to the lowest index. The JAX package's
    function, value for value."""
    if shard_count < 1:
        raise ValueError("shard_count must be >= 1")

    def bucket(key: str) -> str:
        parts = key.split("/")
        return parts[1] if len(parts) > 1 else ""

    assign: Dict[str, int] = {}
    for b in sorted({bucket(k) for k in sizes}):
        order = sorted((k for k in sizes if bucket(k) == b),
                       key=lambda k: (-_element_count(sizes[k]), k))
        heap = [(0, i) for i in range(shard_count)]
        heapq.heapify(heap)
        for key in order:
            load, i = heapq.heappop(heap)
            assign[key] = i
            heapq.heappush(heap, (load + _element_count(sizes[key]), i))
    return assign


def shard_keys(keys, shard_index: int, shard_count: int):
    """Shard ``shard_index``'s keys of ``shard_count``: for a mapping (flat
    key → tensor, array or size) its keys of :func:`shard_assignment`; for
    a bare key list every ``shard_count``-th key of the sorted list."""
    if shard_count < 1:
        raise ValueError("shard_count must be >= 1")
    if not 0 <= shard_index < shard_count:
        raise ValueError(f"shard_index {shard_index} outside [0, {shard_count})")
    if isinstance(keys, dict):
        assign = shard_assignment(keys, shard_count)
        return sorted(k for k, s in assign.items() if s == shard_index)
    return sorted(keys)[shard_index::shard_count]


def _write_zip(path: str, members) -> None:
    """``members`` ``[(name, bytes)]`` into a zip at ``path``, by temp file,
    fsync and rename."""
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as fh:
            with zipfile.ZipFile(fh, "w", zipfile.ZIP_DEFLATED) as zf:
                for name, data in members:
                    zf.writestr(name, data)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def write_state_shard(path: str, flat_arrays: Dict, meta: Optional[dict] = None) -> None:
    """One shard of a mesh checkpoint: ``arrays.npz`` (this shard's flat
    keys) and ``meta.json`` with the member digest, no topology (a restore
    rebuilds onto the live experiment's graphs)."""
    npz_bytes, ext_dtypes = _npz_encode(dict(flat_arrays))
    payload = {
        "format_version": FORMAT_VERSION,
        "array_dtypes": ext_dtypes,
        "keys": sorted(flat_arrays),
        **(meta or {}),
        "member_digests": {"arrays.npz": member_digest(npz_bytes)},
    }
    _write_zip(path, [("meta.json", json.dumps(payload)), ("arrays.npz", npz_bytes)])


def read_state_shard(path: str) -> Tuple[Dict, dict]:
    """``(flat arrays, meta)`` of one shard (numpy arrays; CPU bfloat16
    tensors for bf16 leaves). A corrupted or truncated shard raises
    ``ValueError``."""
    try:
        with zipfile.ZipFile(path, "r") as zf:
            meta = json.loads(zf.read("meta.json"))
            if meta["format_version"] > FORMAT_VERSION:
                raise ValueError(
                    f"shard format {meta['format_version']} is newer than "
                    f"supported {FORMAT_VERSION}"
                )
            npz_bytes = zf.read("arrays.npz")
            want = meta.get("member_digests", {}).get("arrays.npz")
            if want is not None and member_digest(npz_bytes) != want:
                raise ValueError(
                    f"shard {path!r} member 'arrays.npz' fails digest "
                    f"verification (expected {want}) — corrupted bytes"
                )
    except zipfile.BadZipFile as exc:
        raise ValueError(f"corrupted or truncated shard {path!r}: {exc}") from exc
    except KeyError as exc:
        raise ValueError(f"shard {path!r} is missing a required member: {exc}") from exc
    return _npz_decode(npz_bytes, meta.get("array_dtypes", {})), meta


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
    _write_zip(path, [("topology.json", topology_bytes), ("meta.json", json.dumps(meta)),
                      ("arrays.npz", npz_bytes)])


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
