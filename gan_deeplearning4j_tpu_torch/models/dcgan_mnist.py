"""The reference's DCGAN-MNIST graphs in the PyTorch port — counterpart of
``gan_deeplearning4j_tpu/models/dcgan_mnist.py``: the discriminator
``dis``, the sampler ``gen``, the stacked ``gan`` and the transfer
classifier ``cv``, with layer names string for string (the checkpoint
format and the weight-sync protocol address params by ``(layer, name)``).

- ``gen``: z(2) → BN → dense 1024 → dense 6272 → BN → up×2 → conv5 128→64
  → up×2 → conv5 64→1, sigmoid; every updater at LR 0.0;
- ``dis``: BN → conv5 s2 1→64 → maxpool 2 s1 → conv5 s2 64→128 → maxpool →
  dense 1152→1024 → sigmoid 1 under XENT;
- ``gan``: the generator stack (LR 0.004) feeding a copy of the
  discriminator stack frozen at LR 0.0, one XENT loss at the end;
- ``cv``: ``dis`` frozen up to ``dis_dense_layer_6``, then BN → softmax 10
  under MCXENT.

``DIS_TO_GAN``, ``GAN_TO_GEN`` and ``DIS_TO_CV`` are the reference's
weight-sync copies as ``{src_layer: dst_layer}`` maps.
"""

from __future__ import annotations

import dataclasses

from gan_deeplearning4j_tpu_torch.nn import (
    BatchNormalization,
    ComputationGraph,
    ConvolutionLayer,
    DenseLayer,
    FeedForwardToCnnPreProcessor,
    FineTuneConfiguration,
    GraphBuilder,
    GraphConfig,
    InputType,
    OutputLayer,
    SubsamplingLayer,
    TransferLearning,
    Upsampling2D,
)
from gan_deeplearning4j_tpu_torch.optim import RmsProp


@dataclasses.dataclass(frozen=True)
class DcganConfig:
    """The reference's hyperparameter block, model-side subset."""

    height: int = 28
    width: int = 28
    channels: int = 1
    num_features: int = 784
    num_classes: int = 10
    num_classes_dis: int = 1
    z_size: int = 2
    dis_learning_rate: float = 0.002
    gen_learning_rate: float = 0.004
    frozen_learning_rate: float = 0.0
    seed: int = 666  # numberOfTheBeast
    l2: float = 1e-4
    grad_clip: float = 1.0


def _graph_config(cfg: DcganConfig) -> GraphConfig:
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
    b: GraphBuilder, prefix: str, start: int, lr: float, cfg: DcganConfig, input_name: str
) -> str:
    """The 7-layer discriminator stack (names ``{prefix}_*_layer_{start..}``).
    Returns the output-layer name."""
    up = RmsProp(lr, 1e-8, 1e-8)
    names = [f"{prefix}_{kind}_layer_{start + i}" for i, kind in enumerate(
        ["batch", "conv2d", "maxpool", "conv2d", "maxpool", "dense", "output"]
    )]
    b.add_layer(names[0], BatchNormalization(updater=up), input_name)
    b.add_layer(
        names[1],
        ConvolutionLayer(kernel=5, stride=2, n_in=cfg.channels, n_out=64, updater=up),
        names[0],
    )
    b.add_layer(names[2], SubsamplingLayer(pool="max", kernel=2, stride=1), names[1])
    b.add_layer(
        names[3],
        ConvolutionLayer(kernel=5, stride=2, n_in=64, n_out=128, updater=up),
        names[2],
    )
    b.add_layer(names[4], SubsamplingLayer(pool="max", kernel=2, stride=1), names[3])
    b.add_layer(names[5], DenseLayer(n_out=1024, updater=up), names[4])
    b.add_layer(
        names[6],
        OutputLayer(n_out=cfg.num_classes_dis, activation="sigmoid", loss="xent", updater=up),
        names[5],
    )
    return names[6]


def build_discriminator(cfg: DcganConfig = DcganConfig()) -> ComputationGraph:
    """Trainable discriminator ``dis``."""
    b = GraphBuilder(_graph_config(cfg))
    b.add_inputs("dis_input_layer_0")
    b.set_input_types(InputType.convolutional_flat(cfg.height, cfg.width, cfg.channels))
    out = _add_discriminator_layers(b, "dis", 1, cfg.dis_learning_rate, cfg, "dis_input_layer_0")
    b.set_outputs(out)
    return b.build()


def _add_generator_layers(b: GraphBuilder, prefix: str, lr: float, cfg: DcganConfig, input_name: str) -> str:
    """The 8-layer generator stack; returns the output name.
    ``{prefix}_deconv2d_5``/``_7`` are Upsampling2D layers, as in the
    reference."""
    up = RmsProp(lr, 1e-8, 1e-8)
    dense3 = 7 * 7 * 128
    b.add_layer(f"{prefix}_batch_1", BatchNormalization(updater=up), input_name)
    b.add_layer(f"{prefix}_dense_layer_2", DenseLayer(n_out=1024, updater=up), f"{prefix}_batch_1")
    b.add_layer(
        f"{prefix}_dense_layer_3", DenseLayer(n_out=dense3, updater=up), f"{prefix}_dense_layer_2"
    )
    b.add_layer(f"{prefix}_batch_4", BatchNormalization(updater=up), f"{prefix}_dense_layer_3")
    b.add_layer(
        f"{prefix}_deconv2d_5",
        Upsampling2D(size=2),
        f"{prefix}_batch_4",
        preprocessor=FeedForwardToCnnPreProcessor(7, 7, 128),
    )
    b.add_layer(
        f"{prefix}_conv2d_6",
        ConvolutionLayer(kernel=5, stride=1, padding=2, n_in=128, n_out=64, updater=up),
        f"{prefix}_deconv2d_5",
    )
    b.add_layer(f"{prefix}_deconv2d_7", Upsampling2D(size=2), f"{prefix}_conv2d_6")
    b.add_layer(
        f"{prefix}_conv2d_8",
        ConvolutionLayer(
            kernel=5, stride=1, padding=2, n_in=64, n_out=cfg.channels,
            activation="sigmoid", updater=up,
        ),
        f"{prefix}_deconv2d_7",
    )
    return f"{prefix}_conv2d_8"


def build_generator(cfg: DcganConfig = DcganConfig()) -> ComputationGraph:
    """Frozen sampler ``gen`` — all updaters LR 0.0."""
    b = GraphBuilder(_graph_config(cfg))
    b.add_inputs("gen_input_layer_0")
    b.set_input_types(InputType.feed_forward(cfg.z_size))
    out = _add_generator_layers(b, "gen", cfg.frozen_learning_rate, cfg, "gen_input_layer_0")
    b.set_outputs(out)
    return b.build()


def build_gan(cfg: DcganConfig = DcganConfig()) -> ComputationGraph:
    """Stacked GAN: trainable generator (LR 0.004) feeding a frozen
    discriminator copy (LR 0.0), so the generator's gradients flow through
    the frozen D."""
    b = GraphBuilder(_graph_config(cfg))
    b.add_inputs("gan_input_layer_0")
    b.set_input_types(InputType.feed_forward(cfg.z_size))
    gen_out = _add_generator_layers(b, "gan", cfg.gen_learning_rate, cfg, "gan_input_layer_0")
    out = _add_discriminator_layers(b, "gan_dis", 9, cfg.frozen_learning_rate, cfg, gen_out)
    b.set_outputs(out)
    return b.build()


def build_transfer_classifier(dis_graph: ComputationGraph, dis_params, cfg: DcganConfig = DcganConfig()):
    """The ``computerVision`` classifier: dis features frozen below
    ``dis_dense_layer_6``, the sigmoid head replaced by BatchNorm(1024) +
    Softmax(10). The new head reuses the name ``dis_output_layer_7``.
    Returns ``(graph, params)``."""
    up = RmsProp(cfg.dis_learning_rate, 1e-8, 1e-8)
    return (
        TransferLearning(dis_graph, dis_params)
        .fine_tune_configuration(
            FineTuneConfiguration(
                seed=cfg.seed,
                default_activation="tanh",
                weight_init="xavier",
                l2=cfg.l2,
                gradient_clip="elementwise",
                gradient_clip_value=cfg.grad_clip,
                updater=up,
                optimization_algo="sgd",
            )
        )
        .set_feature_extractor("dis_dense_layer_6")
        .remove_vertex_keep_connections("dis_output_layer_7")
        .add_layer("dis_batch", BatchNormalization(updater=up), "dis_dense_layer_6")
        .add_layer(
            "dis_output_layer_7",
            OutputLayer(n_out=cfg.num_classes, activation="softmax", loss="mcxent", updater=up),
            "dis_batch",
        )
        .build()
    )


# dis → gan frozen tail: refresh the stacked GAN's discriminator copy after
# a dis step
DIS_TO_GAN = {
    "dis_batch_layer_1": "gan_dis_batch_layer_9",
    "dis_conv2d_layer_2": "gan_dis_conv2d_layer_10",
    "dis_conv2d_layer_4": "gan_dis_conv2d_layer_12",
    "dis_dense_layer_6": "gan_dis_dense_layer_14",
    "dis_output_layer_7": "gan_dis_output_layer_15",
}

# gan → gen: refresh the frozen sampler after a generator step
GAN_TO_GEN = {
    "gan_batch_1": "gen_batch_1",
    "gan_dense_layer_2": "gen_dense_layer_2",
    "gan_dense_layer_3": "gen_dense_layer_3",
    "gan_batch_4": "gen_batch_4",
    "gan_conv2d_6": "gen_conv2d_6",
    "gan_conv2d_8": "gen_conv2d_8",
}

# dis → classifier feature layers (the head layers are the classifier's own)
DIS_TO_CV = {
    "dis_batch_layer_1": "dis_batch_layer_1",
    "dis_conv2d_layer_2": "dis_conv2d_layer_2",
    "dis_conv2d_layer_4": "dis_conv2d_layer_4",
    "dis_dense_layer_6": "dis_dense_layer_6",
}
