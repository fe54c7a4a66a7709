"""Serving variants of a published bundle — counterpart of
``gan_deeplearning4j_tpu/quant/``, the bf16 half. The int8 variant
(``build_int8_variant``, ``QuantDenseLayer``, ``quant_dense``) and the
measured cost block wait for ROADMAP.md queue 1, 'Quantization'."""

from gan_deeplearning4j_tpu_torch.quant.variants import (
    build_bf16_variant,
    cast_params_bf16,
    read_bundle_manifest,
    write_bundle_manifest,
)

__all__ = [
    "build_bf16_variant",
    "cast_params_bf16",
    "read_bundle_manifest",
    "write_bundle_manifest",
]
