"""Tabular MLP-GAN in the PyTorch port — counterpart of
``gan_deeplearning4j_tpu/models/mlp_gan.py`` (BASELINE.md config 2): dense
G/D on synthetic financial-transactions rows, with the DCGAN family's
three graphs, per-layer RmsProp, LR-0 freezing and weight-sync protocol.
Layer names keep the ``{prefix}_{kind}_layer_{i}`` scheme, so the sync
maps and the checkpoints are the JAX package's.

- ``dis``: BN → dense × len(hidden) → sigmoid 1 under XENT;
- ``gen``: z → BN → dense × len(hidden) → dense ``num_features``, sigmoid
  (rows stay in [0, 1] like the scaled real data); every updater at LR 0;
- ``gan``: the generator stack (LR ``gen_learning_rate``) feeding a copy of
  the discriminator stack frozen at LR 0.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from gan_deeplearning4j_tpu_torch.nn import (
    BatchNormalization,
    ComputationGraph,
    DenseLayer,
    GraphBuilder,
    GraphConfig,
    InputType,
    OutputLayer,
)
from gan_deeplearning4j_tpu_torch.optim import RmsProp


@dataclasses.dataclass(frozen=True)
class MlpGanConfig:
    """Hyperparameters: the reference's values where they transfer, dense
    widths sized for tabular rows."""

    num_features: int = 32
    z_size: int = 8
    hidden: Tuple[int, ...] = (256, 256)
    dis_learning_rate: float = 0.002
    gen_learning_rate: float = 0.004
    frozen_learning_rate: float = 0.0
    seed: int = 666
    l2: float = 1e-4
    grad_clip: float = 1.0


def _graph_config(cfg: MlpGanConfig) -> GraphConfig:
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
    b: GraphBuilder, prefix: str, start: int, lr: float, cfg: MlpGanConfig, input_name: str
) -> str:
    up = RmsProp(lr, 1e-8, 1e-8)
    prev = input_name
    i = start
    b.add_layer(f"{prefix}_batch_layer_{i}", BatchNormalization(updater=up), prev)
    prev = f"{prefix}_batch_layer_{i}"
    i += 1
    for width in cfg.hidden:
        b.add_layer(f"{prefix}_dense_layer_{i}", DenseLayer(n_out=width, updater=up), prev)
        prev = f"{prefix}_dense_layer_{i}"
        i += 1
    out = f"{prefix}_output_layer_{i}"
    b.add_layer(out, OutputLayer(n_out=1, activation="sigmoid", loss="xent", updater=up), prev)
    return out


def _add_generator_layers(
    b: GraphBuilder, prefix: str, lr: float, cfg: MlpGanConfig, input_name: str
) -> str:
    up = RmsProp(lr, 1e-8, 1e-8)
    b.add_layer(f"{prefix}_batch_1", BatchNormalization(updater=up), input_name)
    prev = f"{prefix}_batch_1"
    i = 2
    for width in cfg.hidden:
        b.add_layer(f"{prefix}_dense_layer_{i}", DenseLayer(n_out=width, updater=up), prev)
        prev = f"{prefix}_dense_layer_{i}"
        i += 1
    out = f"{prefix}_dense_layer_{i}"
    b.add_layer(out, DenseLayer(n_out=cfg.num_features, activation="sigmoid", updater=up), prev)
    return out


def build_discriminator(cfg: MlpGanConfig = MlpGanConfig()) -> ComputationGraph:
    b = GraphBuilder(_graph_config(cfg))
    b.add_inputs("dis_input_layer_0")
    b.set_input_types(InputType.feed_forward(cfg.num_features))
    out = _add_discriminator_layers(b, "dis", 1, cfg.dis_learning_rate, cfg, "dis_input_layer_0")
    b.set_outputs(out)
    return b.build()


def build_generator(cfg: MlpGanConfig = MlpGanConfig()) -> ComputationGraph:
    b = GraphBuilder(_graph_config(cfg))
    b.add_inputs("gen_input_layer_0")
    b.set_input_types(InputType.feed_forward(cfg.z_size))
    out = _add_generator_layers(b, "gen", cfg.frozen_learning_rate, cfg, "gen_input_layer_0")
    b.set_outputs(out)
    return b.build()


def build_gan(cfg: MlpGanConfig = MlpGanConfig()) -> ComputationGraph:
    b = GraphBuilder(_graph_config(cfg))
    b.add_inputs("gan_input_layer_0")
    b.set_input_types(InputType.feed_forward(cfg.z_size))
    gen_out = _add_generator_layers(b, "gan", cfg.gen_learning_rate, cfg, "gan_input_layer_0")
    start = 2 + len(cfg.hidden) + 1  # first index after the generator stack
    out = _add_discriminator_layers(b, "gan_dis", start, cfg.frozen_learning_rate, cfg, gen_out)
    b.set_outputs(out)
    return b.build()


def sync_maps(cfg: MlpGanConfig = MlpGanConfig()):
    """(DIS_TO_GAN, GAN_TO_GEN) name maps for the weight-sync protocol."""
    n = len(cfg.hidden)
    start = 2 + n + 1
    dis_to_gan = {"dis_batch_layer_1": f"gan_dis_batch_layer_{start}"}
    for k in range(n):
        dis_to_gan[f"dis_dense_layer_{2 + k}"] = f"gan_dis_dense_layer_{start + 1 + k}"
    dis_to_gan[f"dis_output_layer_{2 + n}"] = f"gan_dis_output_layer_{start + 1 + n}"
    gan_to_gen = {"gan_batch_1": "gen_batch_1"}
    for k in range(n + 1):
        gan_to_gen[f"gan_dense_layer_{2 + k}"] = f"gen_dense_layer_{2 + k}"
    return dis_to_gan, gan_to_gen


def synthetic_transactions(
    num_rows: int = 10000, num_features: int = 32, seed: int = 666
) -> np.ndarray:
    """Synthetic financial-transactions table scaled to [0, 1], row for row
    the JAX package's: log-normal amounts, a cyclic time-of-day pair, a
    merchant-category one-hot block, correlated balance and velocity
    columns, then noisy linear mixes of those. Deterministic per seed."""
    rng = np.random.default_rng(seed)
    cat = rng.integers(0, 8, size=num_rows)
    amount = rng.lognormal(mean=3.0 + 0.3 * cat, sigma=0.8, size=num_rows)
    hour = rng.normal(loc=9.0 + cat, scale=2.5, size=num_rows) % 24.0
    balance = amount * rng.uniform(5.0, 50.0, size=num_rows)
    velocity = rng.poisson(lam=1.0 + cat, size=num_rows).astype(np.float64)

    cols = [
        np.clip(np.log1p(amount) / 10.0, 0, 1),
        (np.sin(2 * np.pi * hour / 24.0) + 1.0) / 2.0,
        (np.cos(2 * np.pi * hour / 24.0) + 1.0) / 2.0,
        np.clip(np.log1p(balance) / 15.0, 0, 1),
        np.clip(velocity / 10.0, 0, 1),
    ]
    one_hot = np.eye(8)[cat]
    base = np.column_stack(cols + [one_hot])  # 13 structured columns
    if num_features < base.shape[1]:
        return base[:, :num_features].astype(np.float32)
    extra = num_features - base.shape[1]
    mix = rng.normal(size=(base.shape[1], extra)) / np.sqrt(base.shape[1])
    noise = 0.05 * rng.normal(size=(num_rows, extra))
    rest = np.clip(base @ mix + 0.5 + noise, 0, 1)
    return np.column_stack([base, rest]).astype(np.float32)
