"""Zoo dataset loaders — counterpart of ``gan_deeplearning4j_tpu/zoo/datasets.py``
(numpy only): one seeded, offline-deterministic source per dataset of the
scenario manifest.

Every loader keeps the contract of ``data/mnist.py::synthetic_mnist``:
``((x_train, y_train), (x_test, y_test))`` with ``x`` float32 in [0, 1] of
shape ``(N, num_features)``, row-major (h, w, c flattened), and ``y`` int64
class labels. Each dataset is a deterministic class-template synthesis
(smooth per-class fields with seeded jitter), so nothing is downloaded.
``fashion_mnist`` and ``cifar_shaped`` use template seeds and textures of
their own, so a canary gate comparing across datasets sees different
statistics. At one seed the arrays are bit-equal to the JAX package's.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np

from gan_deeplearning4j_tpu_torch.data.mnist import synthetic_mnist
from gan_deeplearning4j_tpu_torch.zoo.manifest import DATASET_SHAPES

Split = Tuple[np.ndarray, np.ndarray]
LoadResult = Tuple[Split, Split]

NUM_CLASSES = 10

# per-dataset constants, not derived from the caller's seed: two datasets
# at one seed must still come from different distributions
_TEMPLATE_SEED = {"fashion_mnist": 13_666, "cifar_shaped": 32_666}


def _smooth_field(rng: np.random.Generator, side: int, waves: int) -> np.ndarray:
    yy, xx = np.mgrid[0:side, 0:side].astype(np.float32) / side
    field = np.zeros((side, side), dtype=np.float32)
    for _ in range(waves):
        fx, fy = rng.uniform(0.5, 4.0, size=2)
        px, py = rng.uniform(0, 2 * np.pi, size=2)
        field += rng.uniform(0.3, 1.0) * np.cos(2 * np.pi * fx * xx + px) * np.cos(
            2 * np.pi * fy * yy + py
        )
    return (field - field.min()) / (field.max() - field.min() + 1e-8)


def _garment_templates(side: int, seed: int) -> np.ndarray:
    """Fashion-MNIST-like glyphs: blocky garment silhouettes (rectangular
    masks, some with side lobes) filled with smooth texture."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:side, 0:side].astype(np.float32) / side
    templates = np.zeros((NUM_CLASSES, side, side), dtype=np.float32)
    for c in range(NUM_CLASSES):
        top, bottom = rng.uniform(0.05, 0.25), rng.uniform(0.75, 0.95)
        left, right = rng.uniform(0.1, 0.3), rng.uniform(0.7, 0.9)
        mask = ((yy >= top) & (yy <= bottom) & (xx >= left) & (xx <= right))
        if rng.uniform() < 0.5:  # sleeves / straps: side lobes
            mask |= (yy >= top) & (yy <= top + 0.2) & ((xx < left) | (xx > right))
        templates[c] = mask.astype(np.float32) * (
            0.35 + 0.65 * _smooth_field(rng, side, waves=4)
        )
    return templates


def _scene_templates(side: int, channels: int, seed: int) -> np.ndarray:
    """CIFAR-shaped scenes: per-channel smooth fields plus a class-specific
    centred blob, so each class has its own dominant hue and layout."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:side, 0:side].astype(np.float32) / side
    templates = np.zeros((NUM_CLASSES, side, side, channels), dtype=np.float32)
    for c in range(NUM_CLASSES):
        cx, cy = rng.uniform(0.3, 0.7, size=2)
        blob = np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / rng.uniform(0.02, 0.08))
        hue = rng.dirichlet(np.ones(channels)).astype(np.float32)
        for ch in range(channels):
            templates[c, :, :, ch] = np.clip(
                0.5 * _smooth_field(rng, side, waves=5) + hue[ch] * blob, 0.0, 1.0
            )
    return templates


def _synthesize(templates: np.ndarray, num_train: int, num_test: int, seed: int,
                noise: float, max_shift: int) -> LoadResult:
    feat = int(np.prod(templates.shape[1:]))
    rng = np.random.default_rng(seed + 1)

    def make(n: int) -> Split:
        labels = rng.integers(0, NUM_CLASSES, size=n)
        imgs = templates[labels].copy()
        shifts = rng.integers(-max_shift, max_shift + 1, size=(n, 2))
        for i in range(n):
            imgs[i] = np.roll(imgs[i], shifts[i], axis=(0, 1))
        imgs += rng.normal(0.0, noise, size=imgs.shape).astype(np.float32)
        imgs = np.clip(imgs, 0.0, 1.0)
        return imgs.reshape(n, feat).astype(np.float32), labels.astype(np.int64)

    return make(num_train), make(num_test)


def load_fashion_mnist(num_train: int = 2000, num_test: int = 500, seed: int = 666) -> LoadResult:
    side = DATASET_SHAPES["fashion_mnist"][0]
    templates = _garment_templates(side, _TEMPLATE_SEED["fashion_mnist"])
    return _synthesize(templates, num_train, num_test, seed, noise=0.06, max_shift=1)


def load_cifar_shaped(num_train: int = 2000, num_test: int = 500, seed: int = 666) -> LoadResult:
    h, w, c = DATASET_SHAPES["cifar_shaped"]
    templates = _scene_templates(h, c, _TEMPLATE_SEED["cifar_shaped"])
    return _synthesize(templates, num_train, num_test, seed, noise=0.05, max_shift=2)


def load_mnist(num_train: int = 2000, num_test: int = 500, seed: int = 666) -> LoadResult:
    return synthetic_mnist(num_train=num_train, num_test=num_test, seed=seed)


LOADERS: Dict[str, Callable[..., LoadResult]] = {
    "mnist": load_mnist,
    "fashion_mnist": load_fashion_mnist,
    "cifar_shaped": load_cifar_shaped,
}


def load_dataset(name: str, num_train: int = 2000, num_test: int = 500,
                 seed: int = 666) -> LoadResult:
    """A zoo dataset by its manifest name; an unknown name raises."""
    try:
        loader = LOADERS[name]
    except KeyError:
        raise ValueError(
            f"unknown zoo dataset {name!r} (want one of {sorted(LOADERS)})"
        ) from None
    return loader(num_train=num_train, num_test=num_test, seed=seed)
