"""quant/ — quantized serving variants with measured cost, the counterpart
of ``gan_deeplearning4j_tpu/quant/``. Three parts:

- **variant builders** (:mod:`.variants`): a published serving bundle in,
  a bf16 bundle (every float param bf16, served under a bf16 compute
  scope) or an int8 bundle (per-channel symmetric PTQ of the transfer
  classifier, activation scales calibrated on the canary's fixed seeded
  probe batch) out, a normal bundle whose manifest declares ``precision``
  and its provenance;
- **measured cost** (:mod:`.cost`): each variant profiled on the engine's
  own ladder (per-bucket latency, resident param bytes, staged width) into
  the manifest's ``cost`` block;
- **quality gating** by the deploy canary (``deploy/canary.py``): the
  relative FID and accuracy thresholds any candidate must clear.

The int8 forward pass is :class:`~.layers.QuantDenseLayer`, whose
``quant_dense`` runs one hand-written CUDA kernel on the card
(``csrc/quant_dense.cu``). ``python -m gan_deeplearning4j_tpu_torch.quant.bench``
measures all three on one freshly published bundle.
"""

from gan_deeplearning4j_tpu_torch.quant.cost import (
    manifest_cost,
    measure_bundle_cost,
    measure_engine_cost,
    write_cost_block,
)
from gan_deeplearning4j_tpu_torch.quant.layers import QuantDenseLayer
from gan_deeplearning4j_tpu_torch.quant.variants import (
    build_bf16_variant,
    build_int8_variant,
    calibrate_activation_scales,
    cast_params_bf16,
    default_calibration_rows,
    quantize_classifier,
    quantize_dense_params,
    read_bundle_manifest,
    write_bundle_manifest,
)

__all__ = [
    "QuantDenseLayer",
    "build_bf16_variant",
    "build_int8_variant",
    "calibrate_activation_scales",
    "cast_params_bf16",
    "default_calibration_rows",
    "quantize_classifier",
    "quantize_dense_params",
    "manifest_cost",
    "measure_bundle_cost",
    "measure_engine_cost",
    "write_cost_block",
    "read_bundle_manifest",
    "write_bundle_manifest",
]
