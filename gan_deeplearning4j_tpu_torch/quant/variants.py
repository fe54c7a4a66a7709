"""bf16 serving bundles — counterpart of
``gan_deeplearning4j_tpu/quant/variants.py`` (``cast_params_bf16``,
``build_bf16_variant`` and the manifest helpers).

``build_bf16_variant(source_dir, out_dir)`` takes a published serving
bundle (``serving.json`` and its checkpoints, as ``publish_for_serving``
writes it) and writes a new bundle of the same shape: every float param
cast to bfloat16 (the serializer stores them as tagged uint16, so they
round-trip losslessly), and a manifest with ``precision: "bf16"`` and a
``quant`` block (``method: "bf16_cast"`` and its provenance). The engine
serves such a bundle under a bf16 compute scope, on half the resident
param bytes. A bundle built by either package loads in the other.

``build_int8_variant`` (post-training int8 quantization of the
classifier) waits for ROADMAP.md queue 1, 'Quantization'.
"""

from __future__ import annotations

import json
import os
import tempfile
import time

import torch

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
