"""WGAN-GP in the PyTorch port — counterpart of
``gan_deeplearning4j_tpu/models/wgan_gp.py`` (BASELINE.md config 5:
Wasserstein GAN with gradient penalty on CIFAR-10-shaped data).

Differences from the XENT families (Gulrajani et al. 2017):
- the critic ends in a linear score (loss ``wasserstein``), has no
  BatchNorm (the penalty is per example) and uses leaky-ReLU 0.2;
- the critic takes ``n_critic`` steps per generator step, each on
  E[D(fake)] − E[D(real)] + λ·GP, where GP differentiates the critic's
  input gradient (``ops/losses.py::gradient_penalty``);
- Adam(2e-4, β1 0, β2 0.9), no clipping, no L2.

``WganGpTrainer`` runs on one device. Its steps are built like
``GraphTrainer.train_step``: gradients of detached copies of the
trainable leaves by ``autograd.grad``, then ``GraphOptimizer.step``, with
new tensors returned. The random inputs (z, ε) are arguments: the caller
owns the draws (``harness/wgan_experiment.py``), and a round reads nothing
else from the host, so it can be captured as a CUDA graph (the gradient
penalty's double backward included).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch.profiler import record_function

from gan_deeplearning4j_tpu_torch.models.dcgan_image import stages_for
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
)
from gan_deeplearning4j_tpu_torch.ops import losses as loss_ops
from gan_deeplearning4j_tpu_torch.optim import Adam
from gan_deeplearning4j_tpu_torch.parallel.trainer import (
    GraphTrainer,
    TrainState,
    detach_params,
    grad_leaves,
    grads_by_layer,
)
from gan_deeplearning4j_tpu_torch.runtime.device import DeviceLike


@dataclasses.dataclass(frozen=True)
class WganGpConfig:
    height: int = 32
    width: int = 32
    channels: int = 3
    z_size: int = 128
    base_filters: int = 64
    dense_width: int = 1024
    critic_learning_rate: float = 2e-4
    gen_learning_rate: float = 2e-4
    adam_beta1: float = 0.0
    adam_beta2: float = 0.9
    gp_lambda: float = 10.0
    n_critic: int = 5
    seed: int = 666
    grad_clip: float = 0.0  # no clipping: the penalty regularizes

    @property
    def num_features(self) -> int:
        return self.height * self.width * self.channels

    @property
    def stages(self) -> int:
        return stages_for(self.height, self.width)


def _updater(cfg: WganGpConfig, lr: float) -> Adam:
    return Adam(lr, cfg.adam_beta1, cfg.adam_beta2, 1e-8)


def _graph_config(cfg: WganGpConfig, lr: float) -> GraphConfig:
    return GraphConfig(
        seed=cfg.seed,
        default_activation="leaky_relu",
        weight_init="xavier",
        l2=0.0,
        gradient_clip=None if cfg.grad_clip <= 0 else "elementwise",
        gradient_clip_value=cfg.grad_clip,
        updater=_updater(cfg, lr),
        optimization_algo="sgd",
    )


def build_critic(cfg: WganGpConfig = WganGpConfig()) -> ComputationGraph:
    """Per stage conv5 s2 p2 (width ``base_filters``, doubling), then dense
    ``dense_width`` and a linear score; no BatchNorm."""
    up = _updater(cfg, cfg.critic_learning_rate)
    b = GraphBuilder(_graph_config(cfg, cfg.critic_learning_rate))
    b.add_inputs("critic_input_0")
    b.set_input_types(InputType.convolutional_flat(cfg.height, cfg.width, cfg.channels))
    prev = "critic_input_0"
    n_in, filters = cfg.channels, cfg.base_filters
    for i in range(cfg.stages):
        name = f"critic_conv2d_{i + 1}"
        b.add_layer(
            name,
            ConvolutionLayer(kernel=5, stride=2, padding=2, n_in=n_in, n_out=filters, updater=up),
            prev,
        )
        prev = name
        n_in, filters = filters, filters * 2
    b.add_layer("critic_dense", DenseLayer(n_out=cfg.dense_width, updater=up), prev)
    b.add_layer(
        "critic_score",
        OutputLayer(n_out=1, activation="identity", loss="wasserstein", updater=up),
        "critic_dense",
    )
    b.set_outputs("critic_score")
    return b.build()


def build_generator(cfg: WganGpConfig = WganGpConfig()) -> ComputationGraph:
    """z → dense 4·4·C₀ → BN → reshape → per stage deconv k4 s2 p1 →
    conv5 p2 to ``channels``, sigmoid."""
    up = _updater(cfg, cfg.gen_learning_rate)
    stem_c = cfg.base_filters * (2 ** (cfg.stages - 1))
    b = GraphBuilder(_graph_config(cfg, cfg.gen_learning_rate))
    b.add_inputs("gen_input_0")
    b.set_input_types(InputType.feed_forward(cfg.z_size))
    b.add_layer("gen_dense_1", DenseLayer(n_out=4 * 4 * stem_c, updater=up), "gen_input_0")
    b.add_layer("gen_batch_2", BatchNormalization(updater=up), "gen_dense_1")
    prev = "gen_batch_2"
    pre = FeedForwardToCnnPreProcessor(4, 4, stem_c)
    c = stem_c
    for s in range(cfg.stages):
        n_out = max(cfg.base_filters // 2, c // 2)
        name = f"gen_deconv2d_{3 + s}"
        b.add_layer(
            name,
            Deconvolution2D(kernel=4, stride=2, padding=1, n_in=c, n_out=n_out, updater=up),
            prev,
            preprocessor=pre if s == 0 else None,
        )
        prev = name
        c = n_out
    b.add_layer(
        "gen_image",
        ConvolutionLayer(kernel=5, stride=1, padding=2, n_in=c, n_out=cfg.channels,
                         activation="sigmoid", updater=up),
        prev,
    )
    b.set_outputs("gen_image")
    return b.build()


class WganGpTrainer:
    """Alternating WGAN-GP training on one device: a critic round
    (``n_critic`` sequential critic steps) and a generator step."""

    def __init__(self, cfg: WganGpConfig = WganGpConfig(), mesh=None):
        if mesh is not None:
            raise NotImplementedError(
                "mesh WGAN-GP training is not ported yet: ROADMAP.md queue 1, 'Parallel training'"
            )
        self.cfg = cfg
        self.critic_trainer = GraphTrainer(build_critic(cfg))
        self.gen_trainer = GraphTrainer(build_generator(cfg))
        self.critic = self.critic_trainer.graph
        self.generator = self.gen_trainer.graph
        self.critic_opt = self.critic_trainer.optimizer
        self.gen_opt = self.gen_trainer.optimizer

    def init_states(self, seed: Optional[int] = None, *,
                    device: DeviceLike = None) -> Tuple[TrainState, TrainState]:
        return (self.critic_trainer.init_state(seed, device=device),
                self.gen_trainer.init_state(seed, device=device))

    def _score(self, cparams, x):
        return self.critic.output(cparams, x, train=False)[:, 0]

    def critic_loss(self, cparams, gen_params, real, z, epsilon):
        """E[D(fake)] − E[D(real)] + λ·GP on flat ``(N, F)`` rows. The
        generator runs in inference mode (running BN statistics) and is
        not differentiated; the penalty's input gradient is taken with
        respect to the flat pixels (the norm does not depend on the
        critic's internal reshape)."""
        with torch.no_grad():
            fake = self.generator.output(gen_params, z, train=False).reshape(real.shape[0], -1)
        w_loss = torch.mean(self._score(cparams, fake)) - torch.mean(self._score(cparams, real))
        gp = loss_ops.gradient_penalty(lambda x: self._score(cparams, x), real, fake, epsilon)
        return w_loss + self.cfg.gp_lambda * gp

    def critic_grads(self, cparams, gen_params, real, z, epsilon):
        """``(loss, grads)`` of :meth:`critic_loss` at ``cparams``, the
        gradients ``{layer: {param: grad}}`` of every trainable leaf."""
        params, keys, leaves = grad_leaves(self.critic_opt, cparams)
        with torch.enable_grad(), record_function("step.grad"):
            loss = self.critic_loss(params, gen_params, real, z, epsilon)
            grads = grads_by_layer(keys, torch.autograd.grad(loss, leaves))
        return loss.detach(), grads

    def gen_grads(self, gparams, critic_params, z):
        """``(loss, grads, new_params)`` of the generator's loss
        −E[D(G(z))] at ``gparams``, the generator in training mode
        (``new_params`` carries its new BN running statistics)."""
        params, keys, leaves = grad_leaves(self.gen_opt, gparams)
        with torch.enable_grad(), record_function("step.grad"):
            outs, new_params = self.generator.apply(params, z, train=True)
            fake = outs[self.generator.output_names[0]].reshape(z.shape[0], -1)
            loss = -torch.mean(self._score(critic_params, fake))
            grads = grads_by_layer(keys, torch.autograd.grad(loss, leaves))
        return loss.detach(), grads, detach_params(new_params)

    def critic_step(self, state: TrainState, gen_params, real, z, epsilon):
        """One critic optimizer step: ``(params, opt_state, loss)``. The
        step counter is the round's to advance."""
        loss, grads = self.critic_grads(state.params, gen_params, real, z, epsilon)
        with record_function("step.update"):
            new_params, opt_state = self.critic_opt.step(state.params, grads, state.opt_state)
        return new_params, opt_state, loss

    def critic_round(self, state: TrainState, gen_params, real_batches, zs, epsilons):
        """``n`` critic steps, one per slice of ``real_batches`` ``(n, B, F)``,
        ``zs`` ``(n, B, z)`` and ``epsilons`` ``(n, B, 1)``. The step
        counter advances by ``n``; the loss is the mean of the steps'."""
        params, opt_state = state.params, state.opt_state
        losses = []
        for k in range(real_batches.shape[0]):
            params, opt_state, loss = self.critic_step(
                TrainState(params, opt_state, state.step), gen_params,
                real_batches[k], zs[k], epsilons[k],
            )
            losses.append(loss)
        return TrainState(params, opt_state, state.step + real_batches.shape[0]), \
            torch.mean(torch.stack(losses))

    def gen_step(self, state: TrainState, critic_params, z):
        """One generator step on −E[D(G(z))]: the generator runs in training
        mode and keeps its new BN running statistics; the critic is read
        at ``critic_params`` and not updated."""
        loss, grads, new_params = self.gen_grads(state.params, critic_params, z)
        with record_function("step.update"):
            params, opt_state = self.gen_opt.step(new_params, grads, state.opt_state)
        return TrainState(params, opt_state, state.step + 1), loss

    def train_round(self, critic_state, gen_state, real_batches, draws):
        """One WGAN-GP round: the critic round on ``real_batches``
        ``(n_critic, B, F)``, then the generator step. ``draws`` is
        ``(zs (n, B, z), epsilons (n, B, 1), gen_z (B, z))``. Returns
        ``(critic_state, gen_state, c_loss, g_loss)``, losses on the device."""
        if real_batches.shape[0] != self.cfg.n_critic:
            raise ValueError(
                f"need {self.cfg.n_critic} critic batches, got {real_batches.shape[0]}"
            )
        zs, epsilons, gen_z = draws
        with record_function("round.critic"):
            critic_state, c_loss = self.critic_round(
                critic_state, gen_state.params, real_batches, zs, epsilons
            )
        with record_function("round.gen"):
            gen_state, g_loss = self.gen_step(gen_state, critic_state.params, gen_z)
        return critic_state, gen_state, c_loss, g_loss

    def sample(self, gen_state: TrainState, generator: torch.Generator, num: int):
        """``num`` images ``(num, H, W, C)`` from z ~ N(0, 1) drawn from
        ``generator`` (a CPU generator; the images land on the params'
        device)."""
        leaf = next(iter(next(iter(gen_state.params.values())).values()))
        z = torch.randn((num, self.cfg.z_size), generator=generator).to(leaf.device)
        with torch.no_grad():
            return self.generator.output(gen_state.params, z, train=False)
