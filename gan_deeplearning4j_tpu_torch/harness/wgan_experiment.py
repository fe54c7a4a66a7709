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

A round is split as ``GanExperiment``'s iteration is: the host draws a
window's triples into one pinned tensor, and the device body (``_body``:
the critic round and the generator step, the gradient penalty's double
backward included) reads only static buffers. On the card a window of K
rounds is K replays of that body captured as a CUDA graph
(``harness/graphs.py``); on the CPU it runs uncaptured on the same
buffers. The states are updated in place.

Data parallel (``distributed="pmean"``, the one mode the JAX package's
WGAN-GP takes): the global batch is split into the ``n_critic`` critic
minibatches first, and each rank takes its contiguous rows of every
minibatch (the JAX package's ``PartitionSpec(None, "data")`` on the
``(n_critic, B/n, F)`` rounds); the draws are made for the global rows and
each rank takes the same rows of z and of the penalty's ε, and its rows of
the generator's z. A mesh iterator hands each rank contiguous rows of the
global batch, which split into minibatches differently: the same law,
another assignment of rows to critic steps than the JAX package's.

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
from gan_deeplearning4j_tpu_torch.harness.graphs import CapturedIterations
from gan_deeplearning4j_tpu_torch.harness.experiment import (
    GanExperiment,
    experiment_device,
    experiment_mesh,
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
        config = config if config is not None else ExperimentConfig(model_family="wgan_gp")
        self.config = config.validate()
        cfg = config
        self.mesh = experiment_mesh(cfg, mesh)
        self.device = experiment_device(cfg, self.mesh)
        self.family = registry.get(cfg.model_family)
        self.model_cfg = self.family.make_model_config(cfg)
        self.trainer = WganGpTrainer(self.model_cfg, mesh=self.mesh)
        self.critic_state, self.gen_state = self.trainer.init_states(cfg.seed, device=self.device)
        self._compute_dtype = parse_compute_dtype(cfg.compute_dtype)
        self._param_dtype = parse_compute_dtype(cfg.param_dtype)
        self.critic_state = self._cast_state(self.critic_state)
        self.gen_state = self._cast_state(self.gen_state)
        # no transfer classifier; the generator is what gets published
        self.cv = self.cv_trainer = self.cv_state = None
        self._cond_classes = 0  # validate() refuses a conditional WGAN-GP
        self.gen = self.trainer.generator
        self._z_grid = latent_grid(cfg.latent_grid, self.model_cfg.z_size)
        self.draw_source = self._draw

        self.timer = PhaseTimer()
        self.metrics = MetricsLogger(cfg.metrics_jsonl if self._writes else None)
        self.batch_counter = 0
        self._epilogue_active = False
        self.graphs = CapturedIterations(self._body, self.device, captured=self._captured())

    @property
    def gen_params(self):
        """The sampler's params (``export_manifold`` and
        ``publish_for_serving`` read them)."""
        return self.gen_state.params

    # -- randomness -------------------------------------------------------
    def _draw(self, gen_step: int, n_critic: int, rows: int):
        """The default draws of the round at ``gen_step``: ``(critic z,
        critic ε, generator z)`` from the step's CPU generator."""
        g = step_generator(self.config.seed + 2, gen_step)
        z_size = self.model_cfg.z_size
        zs = torch.randn((n_critic, rows, z_size), generator=g)
        epsilons = torch.rand((n_critic, rows, 1), generator=g)
        gen_z = torch.randn((rows, z_size), generator=g)
        return zs, epsilons, gen_z

    def _critic_rows(self, b: int) -> int:
        """Rows of each critic minibatch of a ``b``-row round (the tail
        policy of ``_critic_batches``)."""
        if b == 0:
            raise ValueError("empty batch")
        return max(b, self.model_cfg.n_critic) // self.model_cfg.n_critic

    def _step_draws(self, gen_step: int, rows: int) -> torch.Tensor:
        """The round's ``(zs, epsilons, gen_z)`` at ``rows`` rows a step, as
        one float32 host row. On a mesh ``rows`` is this rank's: the draws
        are made for the global rows and its rows taken."""
        zs, epsilons, gen_z = (torch.as_tensor(t, dtype=torch.float32) for t in
                               self.draw_source(gen_step, self.model_cfg.n_critic, rows * self._world))
        if self.mesh is not None:
            r = self.mesh.rows(rows * self._world)
            zs, epsilons, gen_z = zs[:, r], epsilons[:, r], gen_z[r]
        return torch.cat([t.reshape(-1) for t in (zs, epsilons, gen_z)])

    def _local_rows(self, x, n: int):
        """This rank's rows of a global ``(K, B, F)`` window: the tail policy
        of ``_critic_batches`` on B, the ``n_critic`` minibatches, and the
        rank's contiguous rows of each (truncated to a multiple of the
        world size), as ``(K, n_critic · rows, F)``."""
        if self.mesh is None or x is None:
            return x
        nc = self.model_cfg.n_critic
        x = torch.as_tensor(x)
        if n == 0:
            raise ValueError("empty batch")
        if n < nc:
            x = x.repeat(1, -(-nc // n), 1)[:, :nc]
            n = nc
        rounds = x[:, : n // nc * nc].reshape(x.shape[0], nc, n // nc, -1)
        per_step = rounds.shape[2] // self.mesh.size * self.mesh.size
        if per_step == 0:
            raise ValueError(f"critic minibatches of {rounds.shape[2]} rows cannot be split "
                             f"over {self.mesh.size} shards")
        mine = rounds[:, :, self.mesh.rows(per_step)]
        return mine.reshape(x.shape[0], -1, mine.shape[-1])

    def _window_draws(self, k: int, b: int) -> torch.Tensor:
        rows = self._critic_rows(b)
        step = self.gen_state.step
        return self._to_device(torch.stack([self._step_draws(step + i, rows) for i in range(k)]))

    def _unpack_draws(self, draws: torch.Tensor, rows: int):
        n, z_size = self.model_cfg.n_critic, self.model_cfg.z_size
        nz, ne = n * rows * z_size, n * rows
        return (draws[:nz].view(n, rows, z_size), draws[nz:nz + ne].view(n, rows, 1),
                draws[nz + ne:].view(rows, z_size))

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

    def _body(self, trees: Dict, inputs: Dict[str, torch.Tensor]):
        """The device body: one round on ``trees`` (``critic``, ``gen``) and
        ``inputs`` (``features``, ``draws``), functional. Returns the new
        trees and the ``(critic, generator, NaN)`` loss row."""
        batches = self._critic_batches(inputs["features"])
        draws = self._unpack_draws(inputs["draws"], batches.shape[1])
        with compute_dtype_scope(self._compute_dtype):
            critic, gen, c, g = self.trainer.train_round(trees["critic"], trees["gen"], batches, draws)
        nan = torch.full((), float("nan"), device=c.device)
        return {"critic": critic, "gen": gen}, torch.stack([c.float(), g.float(), nan])

    def _trees(self) -> Dict:
        return {"critic": self.critic_state, "gen": self.gen_state}

    def _set_trees(self, trees: Dict) -> None:
        self.critic_state, self.gen_state = trees["critic"], trees["gen"]

    def train_iteration(self, real_features, real_labels=None, local: bool = False) -> Dict:
        """One WGAN-GP round (a window of one). ``real_labels`` is accepted
        (``run()`` passes labels) and ignored: the critic is unsupervised.
        On a mesh the batch is global (``local``: this rank's rows).
        Returns device scalars; ``cv_loss`` is NaN."""
        with self.timer.phase("train_round"):
            losses = self._window(torch.as_tensor(real_features)[None], None, local)
        return {k: v[0] for k, v in losses.items()}

    def train_iterations(self, features, labels=None, local: bool = False) -> Dict:
        """K rounds over a ``(K, B, num_features)`` window, moved to the
        device once, each keyed by its generator step: identical to K calls
        of ``train_iteration`` (K graph replays on the card). Returns
        ``(K,)`` device loss vectors."""
        with self.timer.phase("train_rounds"):
            return self._window(features, None, local)

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
        paths = []
        for name, graph, state in (
            ("critic", self.trainer.critic, self.critic_state),
            ("gen", self.trainer.generator, self.gen_state),
        ):
            path = os.path.join(directory, f"{cfg.file_prefix}_{name}_model.zip")
            if self._writes:
                write_model(path, graph, state, save_updater=True)
            paths.append(path)
        return paths

    def _load_models_sharded(self, directory: str, shard_files: List[str]) -> int:
        flat = self._merged_shard_state(directory, shard_files)
        self.critic_state = self._restored(flat, "critic", self.trainer.critic_trainer)
        self.gen_state = self._restored(flat, "gen", self.trainer.gen_trainer)
        self.batch_counter = int(self.gen_state.step)
        return self.batch_counter

    def load_models(self, directory: Optional[str] = None) -> int:
        """Resume from either package's ``save_models`` directory. Returns
        the restored round count (the generator's step). Under bf16
        storage every float leaf is cast on entry, as at init."""
        cfg = self.config
        directory = directory or cfg.output_dir
        shard_files = self._shard_files(directory)
        if shard_files:
            return self._load_models_sharded(directory, shard_files)
        prefix = os.path.join(directory, cfg.file_prefix)
        self.critic_state = self._restore(f"{prefix}_critic_model.zip", self.trainer.critic_trainer)
        self.gen_state = self._restore(f"{prefix}_gen_model.zip", self.trainer.gen_trainer)
        self.batch_counter = int(self.gen_state.step)
        return self.batch_counter
