"""FID harness — counterpart of ``gan_deeplearning4j_tpu/eval/fid.py``
(``FeatureStats``, ``fid_from_stats``, ``frozen_feature_fn``,
``inception_feature_fn``, ``quick_fid_scorer``, ``graph_feature_fn``,
``fid_score``).

The Fréchet distance fits Gaussians to feature activations of real and
generated rows: ``||μr−μg||² + Tr(Σr+Σg−2(ΣrΣg)^½)``, in float64 numpy, as
the reference computes it. Feature extractors run on the card unless the
caller asks for the CPU, and return host arrays; ``.forward`` is each
one's device function (a tensor in, a tensor out):

- ``frozen_feature_fn``: three seeded He-initialised convolutions (stride
  2, "SAME" padding, leaky 0.2), each contributing its spatial mean, 224
  features in all. ``frozen_kernels(channels, seed)`` draws the kernels as
  the JAX package does, from jax's threefry stream computed on the host
  (``runtime/threefry.py``), for any seed and channel count.
  ``frozen_kernels.npz`` beside this module holds the JAX package's own
  draw for seed 666 (1 and 3 channels), stamped with the jax version
  (``frozen_kernels_stamp()``; ``tests/test_torch_canary.py
  --export-frozen-kernels`` writes it): the pin a test holds the draw to.
- ``inception_feature_fn``: a feature network from user-supplied weights,
  a ``.npz`` whose ``__schema__`` describes a dataflow graph (``conv``
  with optional bias and relu, ``maxpool``, ``avgpool``, ``concat``,
  ``global_avgpool``); without weights, the frozen extractor
  (``.source == "frozen"``), as the reference documents.
- ``quick_fid_scorer``: the in-training FID tracker over a fixed z set.
- ``graph_feature_fn``: a named vertex of a port graph (the classifier's
  ``dis_dense_layer_6``), for model-space diagnostics and the canary's
  dis-feature space.

The reference computes its features at HIGHEST precision, so an extractor
built for the card pins TF32 off (``pin_fp32_precision``), process wide,
as the engine does. TensorFlow's "SAME" on a strided convolution or pool
puts the odd pixel after (``_same_padding``), which torch's
``padding="same"`` refuses to do, so each pads with ``F.pad``.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from gan_deeplearning4j_tpu_torch.runtime import threefry
from gan_deeplearning4j_tpu_torch.runtime.device import (
    DeviceLike,
    pin_fp32_precision,
    resolve_device,
)
from gan_deeplearning4j_tpu_torch.runtime.dtype import compute_dtype_scope

#: (out_channels, kernel, stride) per stage of the frozen extractor: the
#: feature vector concatenates each stage's spatial mean, 32 + 64 + 128
_FROZEN_STAGES = ((32, 5, 2), (64, 5, 2), (128, 3, 2))

_FROZEN_NPZ = os.path.join(os.path.dirname(os.path.abspath(__file__)), "frozen_kernels.npz")


@dataclasses.dataclass(frozen=True)
class FeatureStats:
    """Gaussian moments of a feature set: mean (D,) and covariance (D, D)."""

    mean: np.ndarray
    cov: np.ndarray

    @staticmethod
    def from_features(features: np.ndarray) -> "FeatureStats":
        features = np.asarray(features, dtype=np.float64)
        if features.ndim != 2:
            features = features.reshape(features.shape[0], -1)
        if features.shape[0] < 2:
            raise ValueError("need at least 2 samples to fit covariance")
        return FeatureStats(
            mean=features.mean(axis=0),
            cov=np.cov(features, rowvar=False).reshape(features.shape[1], features.shape[1]),
        )


def _sqrtm_psd(mat: np.ndarray) -> np.ndarray:
    """Matrix square root of a (near-)PSD symmetric matrix by its
    eigendecomposition, negative eigenvalues clipped to zero."""
    vals, vecs = np.linalg.eigh((mat + mat.T) / 2.0)
    vals = np.clip(vals, 0.0, None)
    return (vecs * np.sqrt(vals)) @ vecs.T


def fid_from_stats(real: FeatureStats, fake: FeatureStats, eps: float = 1e-6) -> float:
    """Fréchet distance between the two Gaussians. Both covariances are
    regularised by ``eps·I``, and the cross term is taken as
    ``sqrt(sqrt(A)·B·sqrt(A))``, symmetric PSD with the trace of
    ``sqrtm(A·B)``."""
    diff = real.mean - fake.mean
    offset = eps * np.eye(real.cov.shape[0])
    sr = _sqrtm_psd(real.cov + offset)
    covmean = _sqrtm_psd(sr @ (fake.cov + offset) @ sr)
    return float(diff @ diff + np.trace(real.cov + fake.cov - 2.0 * covmean))


def _batched(forward: Callable, device: torch.device, batch_size: int) -> Callable:
    """A host extractor around ``forward`` (a device tensor (N, ·) → (N, D)):
    one host-device round trip per ``batch_size`` rows, numpy in and out.
    On the card it pins full fp32 (no TF32) once, as the engine does at
    load: the reference runs its features at HIGHEST precision."""
    if device.type == "cuda":
        pin_fp32_precision()

    def extract(samples: np.ndarray) -> np.ndarray:
        samples = np.asarray(samples, dtype=np.float32)
        chunks = []
        with torch.inference_mode():
            for i in range(0, len(samples), batch_size):
                x = torch.from_numpy(np.ascontiguousarray(samples[i:i + batch_size])).to(device)
                chunks.append(forward(x).cpu().numpy())
        return np.concatenate(chunks, axis=0)

    return extract


@functools.lru_cache(maxsize=None)
def _frozen_npz() -> Tuple[Dict[str, np.ndarray], dict]:
    with np.load(_FROZEN_NPZ, allow_pickle=False) as npz:
        arrays = {k: np.asarray(npz[k]) for k in npz.files if k != "__stamp__"}
        stamp = json.loads(str(npz["__stamp__"]))
    return arrays, stamp


def frozen_kernels_stamp() -> dict:
    """Which jax version, seed and channel counts made ``frozen_kernels.npz``."""
    return dict(_frozen_npz()[1])


def pinned_frozen_kernels(channels: int) -> List[np.ndarray]:
    """The JAX package's own kernels for seed 666, as ``frozen_kernels.npz``
    holds them (1 or 3 channels)."""
    arrays = _frozen_npz()[0]
    return [arrays[f"c{channels}/stage{i}"] for i in range(len(_FROZEN_STAGES))]


def frozen_kernels(channels: int = 1, seed: int = 666) -> List[np.ndarray]:
    """The three HWIO kernels of the frozen extractor, drawn as the JAX
    package draws them: ``split(PRNGKey(seed), 3)``, then ``normal(key,
    (k, k, c_in, c_out)) · sqrt(2 / fan_in)``."""
    keys = threefry.split(threefry.PRNGKey(seed), len(_FROZEN_STAGES))
    kernels, c_in = [], channels
    for key, (c_out, k, _) in zip(keys, _FROZEN_STAGES):
        fan_in = k * k * c_in
        kernels.append(threefry.normal(key, (k, k, c_in, c_out), "float32")
                       * np.sqrt(np.float32(2.0 / fan_in)))
        c_in = c_out
    return kernels


def _same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """TensorFlow's "SAME": ``ceil(size / stride)`` outputs, the padding split
    with the odd pixel after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def _pads(padding: str, size: Tuple[int, int], kernel: Tuple[int, int],
          stride: int) -> Tuple[int, int, int, int]:
    """``F.pad``'s (left, right, top, bottom) for a "SAME" or "VALID"
    (kh, kw) window over an (H, W) map."""
    mode = str(padding).upper()
    if mode == "VALID":
        return (0, 0, 0, 0)
    if mode != "SAME":
        raise ValueError(f"padding must be 'SAME' or 'VALID', not {padding!r}")
    top, bottom = _same_padding(size[0], kernel[0], stride)
    left, right = _same_padding(size[1], kernel[1], stride)
    return (left, right, top, bottom)


def _padded(x: torch.Tensor, pads: Tuple[int, int, int, int], value: float = 0.0) -> torch.Tensor:
    """``x`` padded by ``pads``; ``x`` itself when there is none (``F.pad``
    would copy it)."""
    return F.pad(x, pads, value=value) if any(pads) else x


def frozen_feature_fn(
    height: int,
    width: int,
    channels: int = 1,
    seed: int = 666,
    batch_size: int = 500,
    device: DeviceLike = None,
) -> Callable:
    """Fixed random-conv feature extractor, the stable FID feature space:
    rows (N, H·W·C) or images (N, H, W, C) in [0, 1] → (N, 224) features,
    depending only on (height, width, channels, seed). ``.forward`` is the
    device function (a tensor in, a tensor out)."""
    dev = resolve_device(device)
    # HWIO -> OIHW, on the device once
    weights = [torch.from_numpy(k).permute(3, 2, 0, 1).contiguous().to(dev)
               for k in frozen_kernels(channels, seed)]
    strides = [s for _, _, s in _FROZEN_STAGES]

    def forward(x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], height, width, channels).to(torch.float32)
        x = (x * 2.0 - 1.0).permute(0, 3, 1, 2)  # center [0,1] pixels; NCHW
        pooled = []
        for w, stride in zip(weights, strides):
            x = F.conv2d(F.pad(x, _pads("SAME", x.shape[2:], w.shape[2:], stride)), w,
                         stride=stride)
            x = torch.where(x > 0, x, 0.2 * x)  # leaky ReLU
            pooled.append(x.mean(dim=(2, 3)))
        return torch.cat(pooled, dim=-1)

    extract = _batched(forward, dev, batch_size)
    extract.forward = forward
    return extract


def _load_schema(path: str):
    with np.load(path, allow_pickle=False) as npz:
        schema = json.loads(str(npz["__schema__"]))
        arrays = {k: np.asarray(npz[k]) for k in npz.files if k != "__schema__"}
    return schema, arrays


def inception_feature_fn(
    height: int,
    width: int,
    channels: int = 1,
    path: Optional[str] = None,
    batch_size: int = 500,
    seed: int = 666,
    device: DeviceLike = None,
) -> Callable:
    """A literature-comparable FID extractor from user-supplied weights:
    the network that ``path`` (or ``$INCEPTION_WEIGHTS``) describes, with
    :func:`frozen_feature_fn`'s call contract and ``.source ==
    "inception:<path>"``. With no weights there it returns the frozen
    extractor with ``.source == "frozen"``, the reference's documented
    contract (weights can only be mounted, never fetched).

    The ``.npz`` holds a ``__schema__`` JSON entry, ``{"input": {"height",
    "width", "channels", optional "mean" and "std"}, "nodes": [...],
    "output": name}``, over the other arrays. A node is ``{"name", "op",
    "in", ...}``: ``conv`` (HWIO ``kernel``, optional ``bias``, ``stride``,
    ``padding`` "SAME"/"VALID", ``activation`` "relu"), ``maxpool`` and
    ``avgpool`` (``size``, ``stride``, ``padding``; an average counts only
    the real elements of its window, as TensorFlow and pytorch-fid do),
    ``concat`` (a list of inputs, joined on channels) and
    ``global_avgpool``. Inputs are rows or NHWC images in [0, 1]: grayscale
    is broadcast to the schema's channels, the image resized to the
    schema's size (bilinear, anti-aliased as ``jax.image.resize`` does when
    it shrinks), then normalised by ``(x − mean) / std``. Conv weights go
    to the device once, as OIHW; the network runs in NCHW."""
    path = path or os.environ.get("INCEPTION_WEIGHTS")
    if not path or not os.path.exists(path):
        fallback = frozen_feature_fn(height, width, channels, seed=seed,
                                     batch_size=batch_size, device=device)
        fallback.source = "frozen"
        return fallback

    dev = resolve_device(device)
    schema, arrays = _load_schema(path)
    spec_in, nodes, out_name = schema["input"], schema["nodes"], schema["output"]
    h_in, w_in, c_in = spec_in["height"], spec_in["width"], spec_in["channels"]
    mean = torch.tensor(spec_in.get("mean", [0.0]), dtype=torch.float32, device=dev).reshape(1, -1, 1, 1)
    std = torch.tensor(spec_in.get("std", [1.0]), dtype=torch.float32, device=dev).reshape(1, -1, 1, 1)
    kernels = {n["kernel"] for n in nodes if n["op"] == "conv"}
    consts = {}
    for name, value in arrays.items():
        t = torch.from_numpy(np.ascontiguousarray(value, dtype=np.float32))
        if name in kernels:
            t = t.permute(3, 2, 0, 1).contiguous()  # HWIO -> OIHW
        consts[name] = t.to(dev)
    # each activation is dropped after its last reader: at 299×299 and
    # 2500 rows one stem activation is several GB
    dead: List[List[str]] = [[] for _ in nodes]
    last_read: Dict[str, int] = {}
    for i, node in enumerate(nodes):
        if node["op"] not in ("conv", "maxpool", "avgpool", "concat", "global_avgpool"):
            raise ValueError(f"unknown op {node['op']!r} in {path}")
        for src in (node["in"] if node["op"] == "concat" else [node["in"]]):
            last_read[src] = i
    for src, i in last_read.items():
        if src != out_name:
            dead[i].append(src)

    def pool(y: torch.Tensor, node: dict, op: str) -> torch.Tensor:
        k, s = node["size"], node.get("stride", 1)
        pads = _pads(node.get("padding", "VALID"), y.shape[2:], (k, k), s)
        if op == "maxpool":
            return F.max_pool2d(_padded(y, pads, float("-inf")), k, s)
        # the window sums over zero padding, divided by the count of real
        # elements (a ones map pooled the same way), as JAX does
        total = F.avg_pool2d(_padded(y, pads), k, s, divisor_override=1)
        ones = torch.ones((1, 1) + tuple(y.shape[2:]), dtype=y.dtype, device=y.device)
        counts = F.avg_pool2d(_padded(ones, pads), k, s, divisor_override=1)
        return total / counts

    def forward(x: torch.Tensor) -> torch.Tensor:
        x = x.reshape(x.shape[0], height, width, channels).to(torch.float32)
        if channels == 1 and c_in > 1:
            x = x.expand(x.shape[:3] + (c_in,))
        x = x.permute(0, 3, 1, 2)  # NCHW
        if (height, width) != (h_in, w_in):
            x = F.interpolate(x, size=(h_in, w_in), mode="bilinear", align_corners=False,
                              antialias=True)
        acts = {"input": (x - mean) / std}
        for node, drop in zip(nodes, dead):
            op, src = node["op"], node["in"]
            if op == "concat":
                y = torch.cat([acts[n] for n in src], dim=1)
            elif op == "conv":
                y = acts[src]
                w, stride = consts[node["kernel"]], node.get("stride", 1)
                pads = _pads(node.get("padding", "SAME"), y.shape[2:], w.shape[2:], stride)
                y = F.conv2d(_padded(y, pads), w, stride=stride)
                if node.get("bias"):
                    y = y + consts[node["bias"]].reshape(1, -1, 1, 1)
                if node.get("activation") == "relu":
                    y = torch.clamp_min(y, 0.0)
            elif op == "global_avgpool":
                y = acts[src].mean(dim=(2, 3))
            else:
                y = pool(acts[src], node, op)
            acts[node["name"]] = y
            for name in drop:
                del acts[name]
        out = acts[out_name]
        if out.dim() == 4:
            out = out.permute(0, 2, 3, 1)  # the reference flattens NHWC
        return out.reshape(out.shape[0], -1)

    extract = _batched(forward, dev, batch_size)
    extract.forward = forward
    extract.source = f"inception:{path}"
    return extract


def quick_fid_scorer(exp, frozen_fn, real_stats: FeatureStats, num_samples: int = 2048,
                     seed: int = 679) -> Callable:
    """The in-training quick-FID tracker: ``score(experiment, index) ->
    fid``. A fixed z set (``default_rng(seed)`` uniform in [-1, 1), put on
    the experiment's device once) goes through the generator and
    ``frozen_fn.forward`` in one ``inference_mode`` under the experiment's
    compute dtype; only the (N, 224) features come back to the host, to be
    scored against ``real_stats``. ``score.curve`` collects ``[index,
    round(fid, 3)]``; a repeated call for the last index returns its
    cached value."""
    z = np.random.default_rng(seed).random((num_samples, exp.model_cfg.z_size),
                                           dtype=np.float32) * 2.0 - 1.0
    z_dev = torch.from_numpy(z).to(exp.device)
    curve: list = []

    def score(e, index) -> float:
        if curve and curve[-1][0] == index:
            return curve[-1][1]
        with torch.inference_mode(), compute_dtype_scope(e._compute_dtype):
            feats = frozen_fn.forward(e.gen.output(e.gen_params, z_dev, train=False))
            feats = feats.float().cpu().numpy()
        fid = float(fid_from_stats(real_stats, FeatureStats.from_features(feats)))
        curve.append([index, round(fid, 3)])
        return fid

    score.curve = curve
    return score


def graph_feature_fn(graph, params, layer_name: str, batch_size: int = 500) -> Callable:
    """Feature extractor tapping vertex ``layer_name`` of a port graph
    (``feed_forward``), on the params' device; rows in, (N, D) out."""
    leaf = next(t for lp in params.values() for t in lp.values())

    def forward(x: torch.Tensor) -> torch.Tensor:
        return graph.feed_forward(params, x)[layer_name].reshape(x.shape[0], -1)

    return _batched(forward, leaf.device, batch_size)


def fid_score(real_samples: np.ndarray, fake_samples: np.ndarray,
              feature_fn: Optional[Callable] = None) -> float:
    """End-to-end FID: extract features (identity when ``feature_fn`` is
    None: raw-row FID), fit the moments, measure."""
    extract = feature_fn if feature_fn is not None else (
        lambda x: np.asarray(x).reshape(len(x), -1))
    return fid_from_stats(FeatureStats.from_features(extract(real_samples)),
                          FeatureStats.from_features(extract(fake_samples)))


__all__ = [
    "FeatureStats",
    "fid_from_stats",
    "fid_score",
    "frozen_feature_fn",
    "frozen_kernels",
    "frozen_kernels_stamp",
    "graph_feature_fn",
    "inception_feature_fn",
    "pinned_frozen_kernels",
    "quick_fid_scorer",
]
