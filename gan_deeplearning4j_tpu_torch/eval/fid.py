"""FID harness — counterpart of ``gan_deeplearning4j_tpu/eval/fid.py``
(``FeatureStats``, ``fid_from_stats``, ``frozen_feature_fn``,
``graph_feature_fn``, ``fid_score``).

The Fréchet distance fits Gaussians to feature activations of real and
generated rows: ``||μr−μg||² + Tr(Σr+Σg−2(ΣrΣg)^½)``, in float64 numpy, as
the reference computes it. Feature extractors run on the card unless the
caller asks for the CPU, and return host arrays:

- ``frozen_feature_fn``: three seeded He-initialised convolutions (stride
  2, "SAME" padding, leaky 0.2), each contributing its spatial mean, 224
  features in all. torch cannot draw the reference's threefry numbers, so
  the kernels are the JAX package's own, exported once into
  ``frozen_kernels.npz`` beside this module, which is stamped with the jax
  version and seed that made them (``frozen_kernels_stamp()``;
  ``tests/test_torch_canary.py --export-frozen-kernels`` writes it). It
  holds seed 666 for 1 and 3 channels; another seed or channel count is
  refused. torch refuses ``padding="same"`` for a strided convolution, so
  each stage pads the TensorFlow way (the odd pixel after) with ``F.pad``;
  the reference runs at HIGHEST precision, so an extractor built for the
  card pins TF32 off (``pin_fp32_precision``), process wide, as the
  engine does.
- ``graph_feature_fn``: a named vertex of a port graph (the classifier's
  ``dis_dense_layer_6``), for model-space diagnostics and the canary's
  dis-feature space.

``inception_feature_fn`` and ``quick_fid_scorer`` wait for ROADMAP.md
queue 1, 'Data and eval'.
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

from gan_deeplearning4j_tpu_torch.runtime.device import (
    DeviceLike,
    pin_fp32_precision,
    resolve_device,
)

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


def _kernel_key(channels: int, stage: int) -> str:
    """The name of one exported kernel in ``frozen_kernels.npz``."""
    return f"c{channels}/stage{stage}"


def frozen_kernels_stamp() -> dict:
    """Which jax version, seed and channel counts made the exported kernels."""
    return dict(_frozen_npz()[1])


def frozen_kernels(channels: int = 1, seed: int = 666) -> List[np.ndarray]:
    """The three HWIO kernels of the frozen extractor, as the JAX package
    draws them (already scaled by ``sqrt(2 / fan_in)``). Raises
    ``NotImplementedError`` for a seed or channel count that was not
    exported."""
    arrays, stamp = _frozen_npz()
    if seed != stamp["seed"] or channels not in stamp["channels"]:
        raise NotImplementedError(
            f"frozen FID kernels for seed {seed}, {channels} channel(s) are not exported "
            f"(frozen_kernels.npz holds seed {stamp['seed']}, channels {stamp['channels']}): "
            f"ROADMAP.md queue 1, 'Data and eval'")
    return [arrays[_kernel_key(channels, i)] for i in range(len(_FROZEN_STAGES))]


def _same_padding(size: int, kernel: int, stride: int) -> Tuple[int, int]:
    """TensorFlow's "SAME": ``ceil(size / stride)`` outputs, the padding split
    with the odd pixel after."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


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
            k = w.shape[-1]
            top, bottom = _same_padding(x.shape[2], k, stride)
            left, right = _same_padding(x.shape[3], k, stride)
            x = F.conv2d(F.pad(x, (left, right, top, bottom)), w, stride=stride)
            x = torch.where(x > 0, x, 0.2 * x)  # leaky ReLU
            pooled.append(x.mean(dim=(2, 3)))
        return torch.cat(pooled, dim=-1)

    extract = _batched(forward, dev, batch_size)
    extract.forward = forward
    return extract


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
]
