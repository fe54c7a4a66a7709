"""Multi-resolution image DCGANs in the PyTorch port — counterpart of
``gan_deeplearning4j_tpu/models/dcgan_image.py`` (BASELINE.md configs 3
and 4: CIFAR-10 32×32×3 and CelebA 64×64×3).

The MNIST family's three graphs and weight-sync protocol, generalised over
resolution and channels. ``stages_for(side)`` = log2(side / 4) stages, so
32×32 runs 3 and 64×64 runs 4:

- ``dis``: BN → per stage conv5 s2 p2 (width ``base_filters``, doubling)
  then maxpool 2 s1 → dense ``dense_width`` → sigmoid 1 under XENT;
- ``gen``: z → BN → dense ``dense_width`` → dense 4·4·C₀ → BN → reshape
  to 4×4×C₀ → per stage deconv k4 s2 p1 (exactly ×2) to
  ``max(base_filters // 2, c // 2)`` channels → conv5 p2 to ``channels``,
  sigmoid; every updater at LR 0;
- ``gan``: the generator stack feeding a copy of the discriminator frozen
  at LR 0.

``synthetic_images`` makes the JAX package's deterministic CIFAR/CelebA
shaped rows.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np

from gan_deeplearning4j_tpu_torch.nn import (
    BatchNormalization,
    ComputationGraph,
    ConvolutionLayer,
    Deconvolution2D,
    DenseLayer,
    FeedForwardToCnnPreProcessor,
    GraphBuilder,
    GraphConfig,
    InputType,
    OutputLayer,
    SubsamplingLayer,
)
from gan_deeplearning4j_tpu_torch.optim import RmsProp


def stages_for(height: int, width: int) -> int:
    """Deconv/conv stages between a 4×4 stem and full resolution (shared by
    the image and WGAN-GP families)."""
    if height != width or height < 8 or height & (height - 1):
        raise ValueError(f"side must be a power of two >= 8, got {height}x{width}")
    return int(np.log2(height // 4))


@dataclasses.dataclass(frozen=True)
class ImageGanConfig:
    height: int = 32
    width: int = 32
    channels: int = 3
    z_size: int = 64
    base_filters: int = 64  # discriminator stage-1 width; doubles per stage
    dense_width: int = 1024
    dis_learning_rate: float = 0.002
    gen_learning_rate: float = 0.004
    frozen_learning_rate: float = 0.0
    seed: int = 666
    l2: float = 1e-4
    grad_clip: float = 1.0

    @property
    def num_features(self) -> int:
        return self.height * self.width * self.channels

    @property
    def stages(self) -> int:
        return stages_for(self.height, self.width)


CIFAR10 = ImageGanConfig(height=32, width=32, channels=3)
CELEBA64 = ImageGanConfig(height=64, width=64, channels=3)


def _graph_config(cfg: ImageGanConfig) -> GraphConfig:
    return GraphConfig(
        seed=cfg.seed,
        default_activation="tanh",
        weight_init="xavier",
        l2=cfg.l2,
        gradient_clip="elementwise",
        gradient_clip_value=cfg.grad_clip,
        updater=RmsProp(cfg.dis_learning_rate, 1e-8, 1e-8),
        optimization_algo="sgd",
    )


def _add_discriminator_layers(
    b: GraphBuilder, prefix: str, start: int, lr: float, cfg: ImageGanConfig, input_name: str
) -> str:
    """BN stem, per stage conv5 s2 p2 + maxpool 2 s1, then dense and the
    sigmoid XENT head. Returns the output-layer name."""
    up = RmsProp(lr, 1e-8, 1e-8)
    i = start
    b.add_layer(f"{prefix}_batch_layer_{i}", BatchNormalization(updater=up), input_name)
    prev = f"{prefix}_batch_layer_{i}"
    i += 1
    n_in = cfg.channels
    filters = cfg.base_filters
    for _ in range(cfg.stages):
        b.add_layer(
            f"{prefix}_conv2d_layer_{i}",
            ConvolutionLayer(kernel=5, stride=2, padding=2, n_in=n_in, n_out=filters, updater=up),
            prev,
        )
        prev = f"{prefix}_conv2d_layer_{i}"
        i += 1
        b.add_layer(
            f"{prefix}_maxpool_layer_{i}",
            SubsamplingLayer(pool="max", kernel=2, stride=1),
            prev,
        )
        prev = f"{prefix}_maxpool_layer_{i}"
        i += 1
        n_in, filters = filters, filters * 2
    b.add_layer(f"{prefix}_dense_layer_{i}", DenseLayer(n_out=cfg.dense_width, updater=up), prev)
    prev = f"{prefix}_dense_layer_{i}"
    i += 1
    out = f"{prefix}_output_layer_{i}"
    b.add_layer(out, OutputLayer(n_out=1, activation="sigmoid", loss="xent", updater=up), prev)
    return out


def _add_generator_layers(
    b: GraphBuilder, prefix: str, lr: float, cfg: ImageGanConfig, input_name: str
) -> str:
    """z → BN → dense → dense(4·4·C₀) → BN → reshape → per stage deconv
    k4 s2 p1 → conv5 p2 to ``channels``, sigmoid."""
    up = RmsProp(lr, 1e-8, 1e-8)
    stem_c = cfg.base_filters * (2 ** (cfg.stages - 1))
    b.add_layer(f"{prefix}_batch_1", BatchNormalization(updater=up), input_name)
    b.add_layer(f"{prefix}_dense_layer_2", DenseLayer(n_out=cfg.dense_width, updater=up), f"{prefix}_batch_1")
    b.add_layer(
        f"{prefix}_dense_layer_3",
        DenseLayer(n_out=4 * 4 * stem_c, updater=up),
        f"{prefix}_dense_layer_2",
    )
    b.add_layer(f"{prefix}_batch_4", BatchNormalization(updater=up), f"{prefix}_dense_layer_3")
    prev = f"{prefix}_batch_4"
    i = 5
    c = stem_c
    pre = FeedForwardToCnnPreProcessor(4, 4, stem_c)
    for s in range(cfg.stages):
        n_out = max(cfg.base_filters // 2, c // 2)
        b.add_layer(
            f"{prefix}_deconv2d_{i}",
            Deconvolution2D(kernel=4, stride=2, padding=1, n_in=c, n_out=n_out, updater=up),
            prev,
            preprocessor=pre if s == 0 else None,
        )
        prev = f"{prefix}_deconv2d_{i}"
        i += 1
        c = n_out
    out = f"{prefix}_conv2d_{i}"
    b.add_layer(
        out,
        ConvolutionLayer(
            kernel=5, stride=1, padding=2, n_in=c, n_out=cfg.channels,
            activation="sigmoid", updater=up,
        ),
        prev,
    )
    return out


def build_discriminator(cfg: ImageGanConfig = CIFAR10) -> ComputationGraph:
    b = GraphBuilder(_graph_config(cfg))
    b.add_inputs("dis_input_layer_0")
    b.set_input_types(InputType.convolutional_flat(cfg.height, cfg.width, cfg.channels))
    out = _add_discriminator_layers(b, "dis", 1, cfg.dis_learning_rate, cfg, "dis_input_layer_0")
    b.set_outputs(out)
    return b.build()


def build_generator(cfg: ImageGanConfig = CIFAR10) -> ComputationGraph:
    b = GraphBuilder(_graph_config(cfg))
    b.add_inputs("gen_input_layer_0")
    b.set_input_types(InputType.feed_forward(cfg.z_size))
    out = _add_generator_layers(b, "gen", cfg.frozen_learning_rate, cfg, "gen_input_layer_0")
    b.set_outputs(out)
    return b.build()


def build_gan(cfg: ImageGanConfig = CIFAR10) -> ComputationGraph:
    b = GraphBuilder(_graph_config(cfg))
    b.add_inputs("gan_input_layer_0")
    b.set_input_types(InputType.feed_forward(cfg.z_size))
    gen_out = _add_generator_layers(b, "gan", cfg.gen_learning_rate, cfg, "gan_input_layer_0")
    start = 5 + cfg.stages + 1  # first index after the generator stack
    out = _add_discriminator_layers(b, "gan_dis", start, cfg.frozen_learning_rate, cfg, gen_out)
    b.set_outputs(out)
    return b.build()


def sync_maps(cfg: ImageGanConfig = CIFAR10) -> Tuple[Dict[str, str], Dict[str, str]]:
    """(DIS_TO_GAN, GAN_TO_GEN) weight-sync maps for this topology; the
    param-free max-pool layers are skipped."""
    start = 5 + cfg.stages + 1
    dis_to_gan = {"dis_batch_layer_1": f"gan_dis_batch_layer_{start}"}
    i_src, i_dst = 2, start + 1
    for _ in range(cfg.stages):
        dis_to_gan[f"dis_conv2d_layer_{i_src}"] = f"gan_dis_conv2d_layer_{i_dst}"
        i_src += 2  # skip the param-free maxpool
        i_dst += 2
    dis_to_gan[f"dis_dense_layer_{i_src}"] = f"gan_dis_dense_layer_{i_dst}"
    dis_to_gan[f"dis_output_layer_{i_src + 1}"] = f"gan_dis_output_layer_{i_dst + 1}"

    gan_to_gen = {
        "gan_batch_1": "gen_batch_1",
        "gan_dense_layer_2": "gen_dense_layer_2",
        "gan_dense_layer_3": "gen_dense_layer_3",
        "gan_batch_4": "gen_batch_4",
    }
    for k in range(cfg.stages):
        gan_to_gen[f"gan_deconv2d_{5 + k}"] = f"gen_deconv2d_{5 + k}"
    gan_to_gen[f"gan_conv2d_{5 + cfg.stages}"] = f"gen_conv2d_{5 + cfg.stages}"
    return dis_to_gan, gan_to_gen


def synthetic_images(num: int, cfg: ImageGanConfig = CIFAR10, seed: int = 666) -> np.ndarray:
    """Deterministic CIFAR/CelebA-shaped rows, ``(N, H·W·C)`` float32 in
    [0, 1], row for row the JAX package's: smooth colour fields with an
    object-like blob and a little noise."""
    rng = np.random.default_rng(seed)
    h, w, c = cfg.height, cfg.width, cfg.channels
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    yy, xx = yy / h, xx / w
    out = np.empty((num, h, w, c), dtype=np.float32)
    for i in range(num):
        img = np.empty((h, w, c), dtype=np.float32)
        cy, cx = rng.uniform(0.3, 0.7, size=2)
        r = rng.uniform(0.1, 0.3)
        blob = np.exp(-(((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * r * r)))
        for ch in range(c):
            fx, fy = rng.uniform(0.5, 2.0, size=2)
            px, py = rng.uniform(0, 2 * np.pi, size=2)
            bg = 0.5 + 0.25 * np.cos(2 * np.pi * fx * xx + px) * np.cos(2 * np.pi * fy * yy + py)
            img[:, :, ch] = bg + rng.uniform(-0.4, 0.4) * blob
        img += rng.normal(0, 0.03, size=img.shape)
        out[i] = np.clip(img, 0.0, 1.0)
    return out.reshape(num, cfg.num_features)
