"""Input preprocessors — layout adapters at layer boundaries, counterpart
of ``gan_deeplearning4j_tpu/nn/preprocessors.py``.

Activations are NHWC, as in the JAX package; DL4J's flat vectors are in
(c, h, w) order. The three flatten orders are kept exactly:

- ``FeedForwardToCnnPreProcessor`` reads the flat vector as (c, h, w);
- ``CnnToFeedForwardPreProcessor`` writes it as (c, h, w);
- ``FlatToCnnPreProcessor`` reads CSV image rows as (h, w, c) row-major.
"""

from __future__ import annotations

import dataclasses

from gan_deeplearning4j_tpu_torch.nn.input_type import InputType


@dataclasses.dataclass(frozen=True)
class FeedForwardToCnnPreProcessor:
    """(N, c*h*w) flat → (N, h, w, c) NHWC, interpreting the flat vector in
    DL4J's (c, h, w) row-major order."""

    height: int
    width: int
    channels: int

    def __call__(self, x):
        n = x.shape[0]
        y = x.reshape(n, self.channels, self.height, self.width)
        return y.permute(0, 2, 3, 1)

    def output_type(self, in_type: InputType) -> InputType:
        expect = self.channels * self.height * self.width
        if in_type.features != expect:
            raise ValueError(
                f"FeedForwardToCnn({self.height},{self.width},{self.channels}) expects "
                f"{expect} features, got {in_type.features}"
            )
        return InputType.convolutional(self.height, self.width, self.channels)

    def to_dict(self) -> dict:
        return {
            "type": "ff_to_cnn",
            "height": self.height,
            "width": self.width,
            "channels": self.channels,
        }


@dataclasses.dataclass(frozen=True)
class CnnToFeedForwardPreProcessor:
    """(N, h, w, c) NHWC → (N, c*h*w) flat in DL4J's (c, h, w) order."""

    def __call__(self, x):
        n = x.shape[0]
        return x.permute(0, 3, 1, 2).reshape(n, -1)

    def output_type(self, in_type: InputType) -> InputType:
        return InputType.feed_forward(in_type.features)

    def to_dict(self) -> dict:
        return {"type": "cnn_to_ff"}


@dataclasses.dataclass(frozen=True)
class FlatToCnnPreProcessor:
    """(N, h*w*c) flat image rows → (N, h, w, c). Used for ``cnn_flat``
    declared inputs (DL4J ``convolutionalFlat``): MNIST CSV rows are h*w
    row-major pixels."""

    height: int
    width: int
    channels: int

    def __call__(self, x):
        n = x.shape[0]
        return x.reshape(n, self.height, self.width, self.channels)

    def output_type(self, in_type: InputType) -> InputType:
        return InputType.convolutional(self.height, self.width, self.channels)

    def to_dict(self) -> dict:
        return {
            "type": "flat_to_cnn",
            "height": self.height,
            "width": self.width,
            "channels": self.channels,
        }


def preprocessor_from_dict(d: dict):
    t = d["type"]
    if t == "ff_to_cnn":
        return FeedForwardToCnnPreProcessor(d["height"], d["width"], d["channels"])
    if t == "cnn_to_ff":
        return CnnToFeedForwardPreProcessor()
    if t == "flat_to_cnn":
        return FlatToCnnPreProcessor(d["height"], d["width"], d["channels"])
    raise KeyError(f"unknown preprocessor type {t!r}")
