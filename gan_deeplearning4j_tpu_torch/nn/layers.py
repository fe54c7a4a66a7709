"""Layer configs of the PyTorch port — counterpart of
``gan_deeplearning4j_tpu/nn/layers.py``: Dense, Output, Loss,
BatchNormalization, Convolution, Deconvolution2D, Subsampling (max and
average), Upsampling2D, Activation and Dropout; the int8
``QuantDenseLayer`` lives in ``quant/layers.py`` and resolves lazily.

Each layer is a frozen config dataclass with the same fields, and so the
same ``to_dict`` schema, as its JAX counterpart:

- ``param_shapes(in_type)``: ``{name: shape}``. Names match DL4J's
  (``W``/``b``; BatchNorm ``gamma``/``beta``/``mean``/``var``) because the
  reference's weight-sync protocol and the checkpoint format both address
  params by ``(layer, name)``;
- ``init(generator, in_type)``: a dict of CPU tensors drawn from an
  explicit ``torch.Generator``;
- ``apply(params, x, train=False, generator=None) -> (y, state_updates)``:
  ``state_updates`` is a dict of "state"-role params rewritten by the
  training forward pass (BatchNorm's running statistics) or None;
  ``generator`` is the ``torch.Generator`` that training-mode dropout
  draws its masks from (the JAX package passes an rng key);
- ``output_type(in_type)``, ``param_roles()`` (L2 applies to "weight"
  params only, and updaters skip "state").

All compute goes through the functional ops in ``ops/``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import torch

from gan_deeplearning4j_tpu_torch.nn.input_type import InputType
from gan_deeplearning4j_tpu_torch.ops import activations as act_ops
from gan_deeplearning4j_tpu_torch.ops import conv as conv_ops
from gan_deeplearning4j_tpu_torch.ops import initializers as init_ops
from gan_deeplearning4j_tpu_torch.ops import linear as linear_ops
from gan_deeplearning4j_tpu_torch.ops import losses as loss_ops
from gan_deeplearning4j_tpu_torch.ops import norm as norm_ops
from gan_deeplearning4j_tpu_torch.optim.updaters import UpdaterSpec, updater_from_dict

IntPair = Union[int, Tuple[int, int]]
Shapes = Dict[str, Tuple[int, ...]]

_pair = conv_ops._pair

@dataclasses.dataclass(frozen=True)
class Layer:
    """Base layer config. ``activation``/``weight_init``/``updater``/``l2`` of
    None mean "inherit the graph default" (resolved by GraphBuilder)."""

    activation: Optional[str] = None
    weight_init: Optional[str] = None
    updater: Optional[UpdaterSpec] = None
    l2: Optional[float] = None

    def param_shapes(self, in_type: InputType) -> Shapes:
        return {}

    def init(self, generator: torch.Generator, in_type: InputType) -> Dict[str, torch.Tensor]:
        """Fresh CPU params: ``W`` from the layer's initializer, everything
        else zeros (BatchNormalization overrides)."""
        shapes = self.param_shapes(in_type)
        out = {}
        for name, shape in shapes.items():
            if name == "W":
                out[name] = init_ops.get(self.weight_init or "xavier")(generator, shape)
            else:
                out[name] = torch.zeros(shape, dtype=torch.float32)
        return out

    def apply(self, params, x, *, train: bool = False, generator=None):
        raise NotImplementedError

    def output_type(self, in_type: InputType) -> InputType:
        raise NotImplementedError

    def param_roles(self) -> Dict[str, str]:
        return {}

    @property
    def kind(self) -> str:
        return type(self).__name__

    def _act(self, x):
        return act_ops.get(self.activation or "identity")(x)

    def has_params(self) -> bool:
        return bool(self.param_roles())

    def to_dict(self) -> dict:
        d = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, UpdaterSpec):
                v = v.to_dict()
            d[f.name] = v
        d["type"] = self.kind
        return d


@dataclasses.dataclass(frozen=True)
class DenseLayer(Layer):
    """Fully-connected layer (DL4J DenseLayer)."""

    n_out: int = 0
    n_in: Optional[int] = None  # inferred from in_type when None

    def _n_in(self, in_type: InputType) -> int:
        return self.n_in if self.n_in is not None else in_type.features

    def param_shapes(self, in_type):
        return {"W": (self._n_in(in_type), self.n_out), "b": (self.n_out,)}

    def apply(self, params, x, *, train: bool = False, generator=None):
        return self._act(linear_ops.dense(x, params["W"], params["b"])), None

    def output_type(self, in_type):
        return InputType.feed_forward(self.n_out)

    def param_roles(self):
        return {"W": "weight", "b": "bias"}


@dataclasses.dataclass(frozen=True)
class OutputLayer(DenseLayer):
    """Dense + attached loss (DL4J OutputLayer: XENT with sigmoid on the
    discriminator, MCXENT with softmax on the classifier)."""

    loss: str = "xent"

    def loss_fn(self, probs, labels):
        return loss_ops.get(self.loss)(probs, labels)


@dataclasses.dataclass(frozen=True)
class LossLayer(Layer):
    """Parameterless loss attachment: passes its input through the
    activation and binds a loss."""

    loss: str = "mse"

    def apply(self, params, x, *, train: bool = False, generator=None):
        return self._act(x), None

    def output_type(self, in_type):
        return in_type

    def loss_fn(self, preds, labels):
        return loss_ops.get(self.loss)(preds, labels)


@dataclasses.dataclass(frozen=True)
class BatchNormalization(Layer):
    """BatchNorm over the trailing feature/channel axis (DL4J
    BatchNormalization). Running ``mean``/``var`` are named params with
    role "state"."""

    decay: float = norm_ops.DEFAULT_DECAY
    eps: float = norm_ops.DEFAULT_EPS

    @staticmethod
    def _n_features(in_type: InputType) -> int:
        return in_type.shape[-1] if in_type.kind == "cnn" else in_type.features

    def param_shapes(self, in_type):
        n = (self._n_features(in_type),)
        return {"gamma": n, "beta": n, "mean": n, "var": n}

    def init(self, generator, in_type):
        n = self._n_features(in_type)
        return {
            "gamma": torch.ones(n),
            "beta": torch.zeros(n),
            "mean": torch.zeros(n),
            "var": torch.ones(n),
        }

    def apply(self, params, x, *, train: bool = False, generator=None):
        if train:
            y, new_mean, new_var = norm_ops.batch_norm_train(
                x, params["gamma"], params["beta"], params["mean"], params["var"],
                eps=self.eps, decay=self.decay, mesh=norm_ops.current_batch_norm_mesh(),
            )
            return self._act(y), {"mean": new_mean, "var": new_var}
        y = norm_ops.batch_norm_inference(
            x, params["gamma"], params["beta"], params["mean"], params["var"], eps=self.eps
        )
        return self._act(y), None

    def output_type(self, in_type):
        return in_type

    def param_roles(self):
        return {"gamma": "gain", "beta": "bias", "mean": "state", "var": "state"}


@dataclasses.dataclass(frozen=True)
class ConvolutionLayer(Layer):
    """2-D convolution (DL4J ConvolutionLayer). Kernel stored HWIO; shape
    semantics = DL4J Truncate mode."""

    kernel: IntPair = 5
    stride: IntPair = 1
    padding: IntPair = 0
    n_out: int = 0
    n_in: Optional[int] = None

    def _n_in(self, in_type: InputType) -> int:
        return self.n_in if self.n_in is not None else in_type.channels

    def param_shapes(self, in_type):
        kh, kw = _pair(self.kernel)
        return {"W": (kh, kw, self._n_in(in_type), self.n_out), "b": (self.n_out,)}

    def apply(self, params, x, *, train: bool = False, generator=None):
        y = conv_ops.conv2d(x, params["W"], params["b"], stride=self.stride, padding=self.padding)
        return self._act(y), None

    def output_type(self, in_type):
        h, w, _ = in_type.shape
        kh, kw = _pair(self.kernel)
        sh, sw = _pair(self.stride)
        ph, pw = _pair(self.padding)
        return InputType.convolutional(
            conv_ops.conv_out_size(h, kh, sh, ph),
            conv_ops.conv_out_size(w, kw, sw, pw),
            self.n_out,
        )

    def param_roles(self):
        return {"W": "weight", "b": "bias"}


@dataclasses.dataclass(frozen=True)
class Deconvolution2D(ConvolutionLayer):
    """Transposed convolution (DL4J Deconvolution2D). Kernel stored HWIO,
    ``(kh, kw, n_in, n_out)``, as the JAX package stores it; output size
    ``(in - 1)·s - 2p + k``."""

    def apply(self, params, x, *, train: bool = False, generator=None):
        y = conv_ops.conv2d_transpose(
            x, params["W"], params["b"], stride=self.stride, padding=self.padding
        )
        return self._act(y), None

    def output_type(self, in_type):
        h, w, _ = in_type.shape
        kh, kw = _pair(self.kernel)
        sh, sw = _pair(self.stride)
        ph, pw = _pair(self.padding)
        return InputType.convolutional(
            (h - 1) * sh - 2 * ph + kh,
            (w - 1) * sw - 2 * pw + kw,
            self.n_out,
        )


@dataclasses.dataclass(frozen=True)
class SubsamplingLayer(Layer):
    """Pooling (DL4J SubsamplingLayer), ``pool`` "max" or "avg"."""

    pool: str = "max"
    kernel: IntPair = 2
    stride: IntPair = 2
    padding: IntPair = 0

    def apply(self, params, x, *, train: bool = False, generator=None):
        if self.pool == "max":
            y = conv_ops.max_pool2d(x, kernel=self.kernel, stride=self.stride, padding=self.padding)
        elif self.pool == "avg":
            y = conv_ops.avg_pool2d(x, kernel=self.kernel, stride=self.stride, padding=self.padding)
        else:
            raise ValueError(f"unknown pool type {self.pool!r}")
        return self._act(y), None

    def output_type(self, in_type):
        h, w, c = in_type.shape
        kh, kw = _pair(self.kernel)
        sh, sw = _pair(self.stride)
        ph, pw = _pair(self.padding)
        return InputType.convolutional(
            conv_ops.conv_out_size(h, kh, sh, ph),
            conv_ops.conv_out_size(w, kw, sw, pw),
            c,
        )


@dataclasses.dataclass(frozen=True)
class Upsampling2D(Layer):
    """Nearest-neighbor upsampling (DL4J Upsampling2D)."""

    size: IntPair = 2

    def apply(self, params, x, *, train: bool = False, generator=None):
        return conv_ops.upsample2d(x, scale=self.size), None

    def output_type(self, in_type):
        h, w, c = in_type.shape
        sh, sw = _pair(self.size)
        return InputType.convolutional(h * sh, w * sw, c)


@dataclasses.dataclass(frozen=True)
class ActivationLayer(Layer):
    """Standalone activation."""

    def apply(self, params, x, *, train: bool = False, generator=None):
        return self._act(x), None

    def output_type(self, in_type):
        return in_type


@dataclasses.dataclass(frozen=True)
class DropoutLayer(Layer):
    """Inverted dropout, in training mode only: each element is kept with
    probability ``1 - rate`` and scaled by ``1 / (1 - rate)``. The mask is
    drawn on the generator's device from the ``torch.Generator`` the caller
    passes; training mode without one raises, as the JAX package raises
    without an rng key."""

    rate: float = 0.5

    def apply(self, params, x, *, train: bool = False, generator=None):
        if not train or self.rate <= 0.0:
            return x, None
        if generator is None:
            raise ValueError("DropoutLayer needs a torch.Generator when train=True")
        keep = 1.0 - self.rate
        draw = torch.rand(x.shape, generator=generator, device=generator.device)
        mask = (draw < keep).to(x.device)
        return torch.where(mask, x / keep, torch.zeros_like(x)), None

    def output_type(self, in_type):
        return in_type


_LAYER_CLASSES = {
    c.__name__: c
    for c in (
        DenseLayer,
        OutputLayer,
        LossLayer,
        BatchNormalization,
        ConvolutionLayer,
        Deconvolution2D,
        SubsamplingLayer,
        Upsampling2D,
        ActivationLayer,
        DropoutLayer,
    )
}

#: layer types owned by optional subsystems, resolved on first use, so an
#: int8 topology round-trips without nn/ importing quant/
_EXTERNAL_LAYER_MODULES = {
    "QuantDenseLayer": "gan_deeplearning4j_tpu_torch.quant.layers",
}


def register_layer(cls):
    """Register a Layer subclass for :func:`layer_from_dict` (the extension
    point ``quant/`` registers through). Usable as a class decorator."""
    _LAYER_CLASSES[cls.__name__] = cls
    return cls


def layer_from_dict(d: dict) -> Layer:
    d = dict(d)
    kind = d.pop("type")
    if kind not in _LAYER_CLASSES and kind in _EXTERNAL_LAYER_MODULES:
        import importlib

        importlib.import_module(_EXTERNAL_LAYER_MODULES[kind])
    if kind not in _LAYER_CLASSES:
        raise KeyError(f"unknown layer type {kind!r}")
    if d.get("updater") is not None:
        d["updater"] = updater_from_dict(d["updater"])
    for k in ("kernel", "stride", "padding", "size"):
        if isinstance(d.get(k), list):
            d[k] = tuple(d[k])
    return _LAYER_CLASSES[kind](**d)
