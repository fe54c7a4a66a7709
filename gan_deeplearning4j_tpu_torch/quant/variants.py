"""Serving variants of a published bundle — counterpart of
``gan_deeplearning4j_tpu/quant/variants.py``.

Both builders take a published serving bundle (``serving.json`` and its
checkpoints, as ``publish_for_serving`` writes it) and write a new bundle
of the same shape whose manifest declares ``precision`` and a ``quant``
block of provenance. A bundle built by either package loads in the other.

- ``build_bf16_variant``: every float param cast to bfloat16 (the
  serializer stores them as tagged uint16, so they round-trip losslessly);
  the engine serves it under a bf16 compute scope on half the resident
  param bytes.
- ``build_int8_variant``: post-training quantization of the transfer
  classifier. Every dense vertex becomes a ``QuantDenseLayer`` with
  per-output-channel symmetric int8 weights and an activation scale
  calibrated on a fixed seeded probe batch (the canary's rows when the
  caller passes them). The generator checkpoint is copied byte for byte.

Calibration is deterministic: the same rows through the same float graph
give bit-identical activation maxima, hence bit-identical scales. It runs
on the card unless the caller asks for the CPU, in full fp32 (no TF32), as
the engine serves fp32. The bf16 cast computes nothing, so it reads and
writes its checkpoints on the CPU.
"""

from __future__ import annotations

import json
import os
import shutil
import tempfile
import time
from typing import Dict, Optional

import numpy as np
import torch

from gan_deeplearning4j_tpu_torch.runtime.device import (
    DeviceLike,
    pin_fp32_precision,
    resolve_device,
)
from gan_deeplearning4j_tpu_torch.runtime.dtype import cast_float_leaves


def read_bundle_manifest(directory: str) -> dict:
    with open(os.path.join(directory, "serving.json")) as fh:
        return json.load(fh)


def write_bundle_manifest(directory: str, manifest: dict) -> None:
    """Write ``serving.json`` by temp file and rename, so a reader never
    sees a torn manifest."""
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as fh:
            json.dump(manifest, fh, indent=2)
            fh.write("\n")
        os.replace(tmp, os.path.join(directory, "serving.json"))
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


#: symmetric int8 range: -128 is left out, so a scale maps amax onto ±127
_QMAX = 127.0

#: floor of a calibrated maximum: a dead vertex (all-zero activation) must
#: not give a zero scale
_AMAX_FLOOR = 1e-8

#: the canary gate's probe defaults (deploy/canary.py): the fallback
#: calibration batch is drawn with the same seed and row count
CALIBRATION_SEED = 666
CALIBRATION_ROWS = 256


def default_calibration_rows(num_features: int, num_rows: int = CALIBRATION_ROWS,
                             seed: int = CALIBRATION_SEED) -> np.ndarray:
    """The fallback probe batch: seeded uniform rows in [0, 1), the range
    the reference pipeline scales real rows into (the JAX package's stream,
    drawn with numpy)."""
    rng = np.random.default_rng(seed)
    return rng.random((num_rows, num_features), dtype=np.float32)


def calibrate_activation_scales(graph, params, rows) -> Dict[str, float]:
    """Per dense vertex, the amax of its INPUT activation (the producing
    vertex's output, through the consumer's preprocessor) over one forward
    pass of ``rows``, mapped onto ±127. Runs on the params' device."""
    from gan_deeplearning4j_tpu_torch.nn.layers import DenseLayer

    leaf = next(t for lp in params.values() for t in lp.values())
    rows = torch.from_numpy(np.asarray(rows, dtype=np.float32)).to(leaf.device)
    with torch.inference_mode():
        acts = graph.feed_forward(params, rows)
        scales: Dict[str, float] = {}
        for v in graph.vertices:
            if v.layer is None or not isinstance(v.layer, DenseLayer):
                continue
            x = acts[v.inputs[0]]
            if v.preprocessor is not None:
                x = v.preprocessor(x)
            amax = float(torch.max(torch.abs(x)))
            scales[v.name] = max(amax, _AMAX_FLOOR) / _QMAX
    return scales


def quantize_dense_params(w, b, *, act_scale: float) -> Dict[str, torch.Tensor]:
    """Per-output-channel symmetric weight quantization: ``w_scale[j]``
    maps column j's amax onto ±127 (an fp32 division, as the reference),
    and ``W_q = int8(clip(round(w / w_scale), ±127))``, rounding half to
    even. Returns the ``QuantDenseLayer`` params (``b`` stays float32).
    ``act_scale`` is the layer's and does not enter the weights."""
    w = torch.as_tensor(w).to(torch.float32)
    amax = torch.clamp(torch.max(torch.abs(w), dim=0).values, min=_AMAX_FLOOR)
    w_scale = (amax / _QMAX).to(torch.float32)
    w_q = torch.clamp(torch.round(w / w_scale), -_QMAX, _QMAX).to(torch.int8)
    return {"W_q": w_q, "w_scale": w_scale, "b": torch.as_tensor(b).to(torch.float32)}


def quantize_classifier(graph, params, rows):
    """Graph surgery: every DenseLayer/OutputLayer vertex becomes a
    ``QuantDenseLayer`` carrying its calibrated activation scale (through
    ``to_dict``/``from_dict``); every other vertex keeps its float form.
    Returns ``(quantized graph, quantized params, scales)``."""
    from gan_deeplearning4j_tpu_torch.nn.graph import ComputationGraph

    scales = calibrate_activation_scales(graph, params, rows)
    spec = graph.to_dict()
    for node in spec["nodes"]:
        name = node["name"]
        if name not in scales:
            continue
        layer_d = node["layer"]
        node["layer"] = {
            "type": "QuantDenseLayer",
            "activation": layer_d.get("activation"),
            "weight_init": layer_d.get("weight_init"),
            "updater": layer_d.get("updater"),
            "l2": layer_d.get("l2"),
            "n_out": layer_d["n_out"],
            "n_in": layer_d.get("n_in"),
            "act_scale": scales[name],
        }
    qgraph = ComputationGraph.from_dict(spec)
    qparams = dict(params)
    for name, scale in scales.items():
        p = params[name]
        qparams[name] = quantize_dense_params(p["W"], p["b"], act_scale=scale)
    return qgraph, qparams, scales


def cast_params_bf16(params):
    """Float leaves of a nested-dict params tree → bfloat16; other leaves
    pass through."""
    return cast_float_leaves(params, torch.bfloat16)


def _base_quant_block(manifest: dict, source_dir: str, method: str) -> dict:
    return {
        "method": method,
        "source": os.path.basename(os.path.abspath(source_dir)),
        "source_generation": manifest.get("generation"),
        "source_step": manifest.get("step"),
        "built_unix": time.time(),
    }


def build_bf16_variant(source_dir: str, out_dir: str) -> dict:
    """Source bundle → bf16 bundle in ``out_dir``. Returns the written
    manifest. The checkpoints are read and written on the CPU."""
    from gan_deeplearning4j_tpu_torch.utils.serializer import read_model, write_model

    manifest = read_bundle_manifest(source_dir)
    os.makedirs(out_dir, exist_ok=True)
    for key in ("generator", "classifier"):
        name = manifest.get(key)
        if not name:
            continue
        graph, params, _, _ = read_model(
            os.path.join(source_dir, name), load_updater=False, device="cpu")
        write_model(os.path.join(out_dir, name), graph, cast_params_bf16(params),
                    save_updater=False)
    manifest["precision"] = "bf16"
    manifest["quant"] = _base_quant_block(manifest, source_dir, "bf16_cast")
    write_bundle_manifest(out_dir, manifest)
    return manifest


def build_int8_variant(source_dir: str, out_dir: str, *,
                       calibration_rows: Optional[np.ndarray] = None,
                       calibration_seed: int = CALIBRATION_SEED,
                       device: DeviceLike = None) -> dict:
    """Source bundle → int8 bundle in ``out_dir``: the classifier's dense
    vertices quantized against ``calibration_rows`` (the canary's probe
    batch when the caller has it, else the seeded fallback), the generator
    checkpoint copied byte for byte, and the manifest given
    ``precision: "int8"`` and the calibration's provenance (seed, row
    count, row source, per-vertex scales). Calibration and quantization run
    on ``device`` (the card unless the caller asks for the CPU). Returns the
    written manifest."""
    from gan_deeplearning4j_tpu_torch.utils.serializer import read_model, write_model

    dev = resolve_device(device)
    if dev.type == "cuda":
        pin_fp32_precision()

    manifest = read_bundle_manifest(source_dir)
    cv_name = manifest.get("classifier")
    if not cv_name:
        raise ValueError(
            f"bundle at {source_dir} serves no classifier — int8 PTQ quantizes the "
            f"discriminator-feature classifier")
    os.makedirs(out_dir, exist_ok=True)

    graph, params, _, _ = read_model(
        os.path.join(source_dir, cv_name), load_updater=False, device=dev)
    caller_rows = calibration_rows is not None
    if calibration_rows is None:
        calibration_rows = default_calibration_rows(
            graph.input_types[0].features, seed=calibration_seed)
    rows = np.asarray(calibration_rows, dtype=np.float32)
    qgraph, qparams, scales = quantize_classifier(graph, params, rows)
    write_model(os.path.join(out_dir, cv_name), qgraph, qparams, save_updater=False)

    gen_name = manifest.get("generator")
    if gen_name:
        shutil.copyfile(os.path.join(source_dir, gen_name), os.path.join(out_dir, gen_name))

    manifest["precision"] = "int8"
    quant = _base_quant_block(manifest, source_dir, "ptq_per_channel_symmetric")
    quant["calibration"] = {
        "seed": int(calibration_seed),
        "num_rows": int(rows.shape[0]),
        "source": "caller_probe_batch" if caller_rows else "seeded_fallback",
        "activation_scales": {k: float(v) for k, v in sorted(scales.items())},
    }
    manifest["quant"] = quant
    write_bundle_manifest(out_dir, manifest)
    return manifest
