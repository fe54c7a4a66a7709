"""QuantDenseLayer — the int8 post-training-quantized dense layer, the
counterpart of ``gan_deeplearning4j_tpu/quant/layers.py``.

``quant/variants.py::quantize_classifier`` swaps it in for each
``DenseLayer``/``OutputLayer`` vertex of the transfer classifier. Weights
are int8 ``(in, out)`` with a per-output-channel symmetric scale
(``w ≈ W_q * w_scale``); the activation scale is a static field,
calibrated once at build time; the forward pass is
``ops/linear.py::quant_dense`` (on the card, the hand-written kernel).
Inputs and outputs stay float. Inference only: ``init`` exists so that the
graph machinery can shape-check it, and a quantized graph is built from a
trained float one, never trained.

``nn/layers.py::layer_from_dict`` resolves it lazily, so that an int8
topology round-trips in a process that never imported ``quant/``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from gan_deeplearning4j_tpu_torch.nn.input_type import InputType
from gan_deeplearning4j_tpu_torch.nn.layers import Layer, register_layer
from gan_deeplearning4j_tpu_torch.ops import linear as linear_ops


@register_layer
@dataclasses.dataclass(frozen=True)
class QuantDenseLayer(Layer):
    """Int8 dense with per-channel weight scales and a calibrated static
    activation scale (module docstring)."""

    n_out: int = 0
    n_in: Optional[int] = None  # inferred from in_type when None
    #: x ≈ round(x / act_scale) * act_scale, calibrated at build time
    act_scale: float = 1.0

    def _n_in(self, in_type: InputType) -> int:
        return self.n_in if self.n_in is not None else in_type.features

    def param_shapes(self, in_type):
        return {"W_q": (self._n_in(in_type), self.n_out), "w_scale": (self.n_out,),
                "b": (self.n_out,)}

    def init(self, generator: torch.Generator, in_type: InputType) -> Dict[str, torch.Tensor]:
        n_in = self._n_in(in_type)
        return {
            "W_q": torch.zeros((n_in, self.n_out), dtype=torch.int8),
            "w_scale": torch.ones((self.n_out,), dtype=torch.float32),
            "b": torch.zeros((self.n_out,), dtype=torch.float32),
        }

    def apply(self, params, x, *, train: bool = False, generator=None):
        y = linear_ops.quant_dense(x, params["W_q"], params["w_scale"], params["b"],
                                   float(self.act_scale))
        return self._act(y), None

    def output_type(self, in_type):
        return InputType.feed_forward(self.n_out)

    def param_roles(self):
        # w_scale is not a weight: L2 and the weight-sync maps never touch it
        return {"W_q": "weight", "w_scale": "scale", "b": "bias"}
