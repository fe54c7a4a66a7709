"""WganGpExperiment — WGAN-GP on the ``GanExperiment`` surface, counterpart
of ``gan_deeplearning4j_tpu/harness/wgan_experiment.py``.

One iteration is one WGAN-GP round: ``n_critic`` critic steps, then one
generator step (Gulrajani et al. 2017, Algorithm 1). The real batch is
split into ``n_critic`` equal critic minibatches, so ``batch_size_train``
is the round's budget of real rows and the generator step runs on one
minibatch's worth of z. A batch below ``n_critic`` rows is padded by
cycling its rows; a remainder of ``b % n_critic`` rows is dropped.

``run()``, ``export_manifold`` and ``publish_for_serving`` (a
generator-only bundle) are ``GanExperiment``'s; ``export_predictions``
refuses, as there is no classifier.

Randomness. Each round draws from one CPU ``torch.Generator``,
``step_generator(seed + 2, gen_step)``, in this order: the critic steps'
z ``(n, b/n, z)`` ~ N(0, 1), their ε ``(n, b/n, 1)`` ~ U[0, 1), then the
generator step's z ``(b/n, z)`` ~ N(0, 1). ``draw_source(gen_step,
n_critic, rows)`` returns that triple and may be replaced (the parity tests
feed it the JAX package's own draws). Every round is keyed by its
generator step, in ``train_iteration`` and in ``train_iterations`` alike,
so a window of K rounds equals K single rounds bit for bit and a resumed
run draws what the uninterrupted one would have. (The JAX package's
window draws another stream than its single round.)

Precision is ``GanExperiment``'s: rounds, sampling and exports run inside
the experiment's compute-dtype scope, and bf16 storage casts both states at
init and on load. The gradient penalty's double backward then runs through
the bf16 convolutions. Adam promotes bf16 params to float32 on their first
step and their moments on the next, as in the JAX package
(``optim/updaters.py``); the draws stay float32.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

from gan_deeplearning4j_tpu_torch.harness.config import ExperimentConfig
from gan_deeplearning4j_tpu_torch.harness.experiment import (
    _MESH_SHARD_RE,
    _OPERATIONS_WAITS,
    GanExperiment,
    experiment_device,
    forward_flops,
    latent_grid,
    rounding_only_params,
    step_generator,
)
from gan_deeplearning4j_tpu_torch.runtime.dtype import compute_dtype_scope, parse_compute_dtype
from gan_deeplearning4j_tpu_torch.models import registry
from gan_deeplearning4j_tpu_torch.models.wgan_gp import WganGpTrainer
from gan_deeplearning4j_tpu_torch.utils.metrics import MetricsLogger
from gan_deeplearning4j_tpu_torch.utils.profiling import PhaseTimer
from gan_deeplearning4j_tpu_torch.utils.serializer import write_model


class WganGpExperiment(GanExperiment):
    """``GanExperiment``-surface wrapper over :class:`WganGpTrainer`. It
    shares only the loop and the exports: there is no stacked ``gan``
    graph and no weight-sync protocol."""

    def __init__(self, config: Optional[ExperimentConfig] = None, mesh=None):
        # GanExperiment.__init__ builds the three-graph protocol, which
        # does not apply here
        if mesh is not None:
            raise NotImplementedError(
                "mesh experiments are not ported yet: ROADMAP.md queue 1, 'Parallel training'"
            )
        config = config if config is not None else ExperimentConfig(model_family="wgan_gp")
        self.config = config.validate()
        cfg = config
        self.device = experiment_device(cfg)
        self.family = registry.get(cfg.model_family)
        self.model_cfg = self.family.make_model_config(cfg)
        self.trainer = WganGpTrainer(self.model_cfg)
        self.critic_state, self.gen_state = self.trainer.init_states(cfg.seed, device=self.device)
        self._compute_dtype = parse_compute_dtype(cfg.compute_dtype)
        self._param_dtype = parse_compute_dtype(cfg.param_dtype)
        self.critic_state = self._cast_state(self.critic_state)
        self.gen_state = self._cast_state(self.gen_state)
        # no transfer classifier; the generator is what gets published
        self.cv = self.cv_trainer = self.cv_state = None
        self.gen = self.trainer.generator
        self._z_grid = latent_grid(cfg.latent_grid, self.model_cfg.z_size)
        self.draw_source = self._draw

        self.timer = PhaseTimer()
        self.metrics = MetricsLogger(cfg.metrics_jsonl)
        self.batch_counter = 0
        self._epilogue_active = False

    @property
    def gen_params(self):
        """The sampler's params (``export_manifold`` and
        ``publish_for_serving`` read them)."""
        return self.gen_state.params

    # -- randomness -------------------------------------------------------
    def _draw(self, gen_step: int, n_critic: int, rows: int):
        """The default draws of the round at ``gen_step``: ``(critic z,
        critic ε, generator z)`` from the step's CPU generator, in pinned
        memory when the run is on the card."""
        g = step_generator(self.config.seed + 2, gen_step)
        z_size = self.model_cfg.z_size
        pin = self.device.type == "cuda"
        zs = torch.randn((n_critic, rows, z_size), generator=g, pin_memory=pin)
        epsilons = torch.rand((n_critic, rows, 1), generator=g, pin_memory=pin)
        gen_z = torch.randn((rows, z_size), generator=g, pin_memory=pin)
        return zs, epsilons, gen_z

    def _round_draws(self, gen_step: int, rows: int):
        n = self.model_cfg.n_critic
        return tuple(self._to_device(t) for t in self.draw_source(gen_step, n, rows))

    # -- the round --------------------------------------------------------
    def _critic_batches(self, real: torch.Tensor) -> torch.Tensor:
        """``(n_critic, b', F)`` critic minibatches of one round's rows: a
        batch below ``n_critic`` rows is padded by cycling, a remainder of
        ``b % n_critic`` rows is dropped."""
        n = self.model_cfg.n_critic
        b = real.shape[0]
        if b == 0:
            raise ValueError("empty batch")
        if b < n:
            real = real.repeat(-(-n // b), 1)[:n]
            b = n
        elif b % n:
            b = (b // n) * n
            real = real[:b]
        return real.reshape(n, b // n, -1)

    def train_iteration(self, real_features, real_labels=None) -> Dict:
        """One WGAN-GP round. ``real_labels`` is accepted (``run()`` passes
        labels) and ignored: the critic is unsupervised. Returns device
        scalars; ``cv_loss`` is NaN."""
        with self.timer.phase("train_round"), compute_dtype_scope(self._compute_dtype):
            batches = self._critic_batches(self._to_device(real_features))
            draws = self._round_draws(int(self.gen_state.step), batches.shape[1])
            self.critic_state, self.gen_state, c, g = self.trainer.train_round(
                self.critic_state, self.gen_state, batches, draws
            )
        return {"d_loss": c, "g_loss": g, "cv_loss": torch.full((), float("nan"), device=self.device)}

    def train_iterations(self, features, labels=None) -> Dict:
        """K rounds over a ``(K, B, num_features)`` window, moved to the
        device once, each keyed by its generator step: identical to K calls
        of ``train_iteration``. Returns ``(K,)`` device loss vectors."""
        feats = self._to_device(features)
        rounds = torch.stack([self._critic_batches(feats[k]) for k in range(feats.shape[0])])
        step = int(self.gen_state.step)
        draws = [self._round_draws(step + k, rounds.shape[2]) for k in range(rounds.shape[0])]
        with self.timer.phase("train_rounds"), compute_dtype_scope(self._compute_dtype):
            self.critic_state, self.gen_state, c, g = self.trainer.train_rounds(
                self.critic_state, self.gen_state, rounds, draws
            )
        return {"d_loss": c, "g_loss": g, "cv_loss": torch.full_like(c, float("nan"))}

    def flops_per_iteration(self, batch_size: Optional[int] = None) -> int:
        """FLOPs of the dense and (transposed) convolution layers in one
        round, from shapes, at ``r = b / n_critic`` rows per step, with
        ``G`` and ``C`` one forward pass of the generator and of the
        critic at ``r`` rows. Each critic step: ``G`` (the fakes), ``6C``
        for E[D(fake)] − E[D(real)] (forward, input-gradient and
        weight-gradient passes on real and on fake rows), and ``6C`` for
        the penalty (the forward pass at x̂, the input-gradient pass, and
        the backward pass of each, two passes apiece): ``G + 12C``. The
        generator step: ``3G`` (forward and both gradient passes) and
        ``2C`` (the critic's forward and input-gradient passes; its
        weights are not differentiated). A round is ``n·(G + 12C) + 3G +
        2C``. Elementwise work is not counted."""
        n = self.model_cfg.n_critic
        rows = (batch_size or self.config.batch_size_train) // n
        g = forward_flops(self.trainer.generator, rows)
        c = forward_flops(self.trainer.critic, rows)
        return n * (g + 12 * c) + 3 * g + 2 * c

    def sample(self, num: int, seed: int = 0) -> np.ndarray:
        """``(num, H, W, C)`` generator samples, z from a CPU generator
        seeded with ``seed``."""
        with compute_dtype_scope(self._compute_dtype):
            out = self.trainer.sample(self.gen_state, torch.Generator().manual_seed(seed), num)
        return out.cpu().numpy()

    # -- checkpoints ------------------------------------------------------
    def _publish_step(self) -> int:
        return int(self.gen_state.step)  # the generator steps once per round

    def digest_states(self) -> Dict:
        return {"critic": self.critic_state, "gen": self.gen_state}

    def rounding_only_keys(self) -> List[str]:
        """The generator's biases that feed a BatchNorm (``gen_dense_1/b``)
        and their Adam moments: their exact gradient is zero, and Adam at
        β1 = 0 (eps outside the square root) turns the rounding that reaches
        them into steps of up to ``lr``. The critic has no BatchNorm."""
        keys = rounding_only_params(self.trainer.generator)
        return [f"gen/params/{k}" for k in keys] + [
            f"gen/opt_state/{k}/{slot}" for k in keys for slot in ("m", "v")]

    def save_models(self, directory: Optional[str] = None) -> List[str]:
        """``{prefix}_critic_model.zip`` and ``{prefix}_gen_model.zip``,
        each with its Adam state, as the JAX package writes them."""
        cfg = self.config
        directory = directory or cfg.output_dir
        os.makedirs(directory, exist_ok=True)
        paths = []
        for name, graph, state in (
            ("critic", self.trainer.critic, self.critic_state),
            ("gen", self.trainer.generator, self.gen_state),
        ):
            path = os.path.join(directory, f"{cfg.file_prefix}_{name}_model.zip")
            write_model(path, graph, state, save_updater=True)
            paths.append(path)
        return paths

    def load_models(self, directory: Optional[str] = None) -> int:
        """Resume from either package's ``save_models`` directory. Returns
        the restored round count (the generator's step). Under bf16
        storage every float leaf is cast on entry, as at init."""
        cfg = self.config
        directory = directory or cfg.output_dir
        if any(_MESH_SHARD_RE.search(n) and n.startswith(cfg.file_prefix)
               for n in os.listdir(directory)):
            raise NotImplementedError(
                f"mesh-sharded checkpoints are not ported yet: {_OPERATIONS_WAITS}"
            )
        prefix = os.path.join(directory, cfg.file_prefix)
        self.critic_state = self._restore(f"{prefix}_critic_model.zip", self.trainer.critic_trainer)
        self.gen_state = self._restore(f"{prefix}_gen_model.zip", self.trainer.gen_trainer)
        self.batch_counter = int(self.gen_state.step)
        return self.batch_counter
