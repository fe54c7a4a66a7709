"""InputType — declared input shapes driving graph shape inference.

The PyTorch port's copy of ``gan_deeplearning4j_tpu/nn/input_type.py``
(the port imports nothing of the JAX package).

Analog of DL4J's ``InputType`` (the reference declares
``InputType.convolutionalFlat(28,28,1)`` at dl4jGANComputerVision.java:165 and
``feedForward(2)`` implicitly via the z input). Shapes exclude the batch axis.
Convolutional activations are NHWC (the JAX package's layout; DL4J is NCHW — the
flat<->cnn preprocessors keep DL4J's element ordering at the boundaries).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class InputType:
    kind: str  # "ff" | "cnn" | "cnn_flat"
    shape: Tuple[int, ...]  # ff: (features,); cnn/cnn_flat: (h, w, c)

    @staticmethod
    def feed_forward(size: int) -> "InputType":
        return InputType("ff", (int(size),))

    @staticmethod
    def convolutional(height: int, width: int, channels: int) -> "InputType":
        return InputType("cnn", (int(height), int(width), int(channels)))

    @staticmethod
    def convolutional_flat(height: int, width: int, channels: int) -> "InputType":
        """Flat (N, h*w*c) input to be consumed by conv layers — DL4J's
        ``convolutionalFlat`` (dl4jGANComputerVision.java:165)."""
        return InputType("cnn_flat", (int(height), int(width), int(channels)))

    # -- derived quantities -------------------------------------------------
    @property
    def features(self) -> int:
        if self.kind == "ff":
            return self.shape[0]
        h, w, c = self.shape
        return h * w * c

    @property
    def channels(self) -> int:
        if self.kind == "ff":
            raise ValueError("feed-forward InputType has no channel axis")
        return self.shape[2]

    def array_shape(self, batch: int | None = None) -> Tuple[int, ...]:
        """Concrete array shape (batch leading; None → batch omitted)."""
        if self.kind == "ff" or self.kind == "cnn_flat":
            core = (self.features,)
        else:
            core = self.shape
        return core if batch is None else (batch,) + core

    def to_dict(self) -> dict:
        return {"kind": self.kind, "shape": list(self.shape)}

    @staticmethod
    def from_dict(d: dict) -> "InputType":
        return InputType(d["kind"], tuple(d["shape"]))

    def __str__(self) -> str:
        if self.kind == "ff":
            return f"FeedForward({self.shape[0]})"
        h, w, c = self.shape
        flat = "Flat" if self.kind == "cnn_flat" else ""
        return f"Convolutional{flat}({h}x{w}x{c})"
