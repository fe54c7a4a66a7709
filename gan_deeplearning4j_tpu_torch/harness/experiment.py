"""GanExperiment — the alternating training loop, counterpart of
``gan_deeplearning4j_tpu/harness/experiment.py`` on its single-device path.

One iteration reproduces the reference's hot loop
(dl4jGANComputerVision.java:408-621), in the order of the JAX package's
fused program (``_build_fused_iteration``):

1. a fake batch from the frozen sampler ``gen`` (inference mode) on
   z ~ U(−1, 1);
2. two discriminator steps: real → 1+ε, then fake → 0+ε, each scaled by
   the staircase dis-LR factor when that schedule is on;
3. dis → gan frozen tail (a rebind of the same tensors);
4. the generator step through the frozen D on ``[z, ones]``;
5. gan → gen (the sampler refresh), then dis → classifier features and
   the classifier step on the real labelled batch, in the families that
   have a transfer classifier (``mnist``; ``tabular`` and ``image`` have
   none, and their ``cv_loss`` is NaN).

The WGAN-GP family has a loop of its own on the same surface
(``harness/wgan_experiment.py``).

The iteration is split in two, as the JAX package's fused program is:
the host draws every input it keys by step (z, resampled label noise, the
dis-LR scale) for a whole window into one pinned tensor and copies it to
the device once; the *device body* (``_body``) is the iteration itself, a
function of static buffers only. On the card a window of K iterations is K
replays of that body captured as one CUDA graph (``harness/graphs.py``,
the port of ``_build_multi_iteration``), and ``train_iteration`` is a
window of one; on the CPU the same body runs uncaptured on the same
buffers. Every op goes to PyTorch's kernels (cuDNN, cuBLAS, ATen). The
states are updated in place in their static buffers, as the JAX package
donates them: a caller that keeps a state tree across an iteration clones
it. The losses stay on the device until ``run()`` reads a window of them
back in one copy. Each stage is a ``torch.profiler.record_function`` range
(``iteration.sample_fake``, ``iteration.dis_real``, ``iteration.dis_fake``,
``iteration.gan``, ``iteration.cv``); they mark host time while the body
runs uncaptured or is captured.

Class conditioning (``conditioning="class"``, the JAX package's
``_cond_classes``): the generator and the stacked gan take ``[z |
one-hot(class)]``, ``z_size + num_classes`` wide, while ``model_cfg``
keeps the base ``z_size`` and the discriminator and the classifier stay
unconditional. The device body concatenates the real batch's one-hot
labels (the window's static ``labels`` input, float32) onto both z draws,
so the draws row is the unconditional one; the manifold grid's row i
conditions on class i mod C (``_with_condition``).

Randomness. Label softening ε comes from ``np.random.default_rng(seed)``
and is drawn once (the reference's quirk), so it is bit-equal to the JAX
package's. The per-iteration z draws (z for the fakes and z for the
generator step, ``(2, B, z_size)``) come from a CPU ``torch.Generator``
seeded from ``(seed + 2, dis_step)``, as the JAX package keys
``fold_in(PRNGKey(seed + 2), dis_step)``: the same seed gives the same
trajectory on the CPU and on the card, and a resumed run draws what the
uninterrupted one would have. ``z_source(dis_step, batch)`` is an
attribute and may be replaced (the parity tests feed it the JAX package's
own draws).

Device. ``config.use_accelerator`` picks it: True is ``cuda:0`` and raises
without CUDA; False is the CPU. On the card fp32 runs with TF32 off and
cuDNN restricted to deterministic algorithms.

Precision, as in the JAX package. Every forward and backward pass (the
iteration, the exports) runs inside ``compute_dtype_scope(compute_dtype)``,
which ``dense`` and the convolutions read. Under ``param_dtype="bf16"``
every float leaf of the params and the updater state is cast to bf16 at
init and when a checkpoint is loaded (``_cast_state``); int leaves
(Adam's ``t``) stay. Batches, z and label noise stay float32: activations
are float32 from the first bias or BatchNorm on, and only params, updater
state and param gradients are bf16.

Data parallel (``config.distributed``, over a ``DataMesh`` from
``runtime/environment.py``; one process per rank; without a mesh argument
the experiment makes one from the environment, a world of one where
torchrun set none):

- ``"pmean"``: the device body above with ``GraphTrainer(mesh=...)``:
  each rank trains on its contiguous rows of every global batch (the
  ``PartitionSpec("data")`` split), BatchNorm statistics over the global
  batch, the gradients and losses averaged over the mesh every step.
  Every rank draws the global z and label noise from the same generator
  and takes its rows, so world N computes what one process computes at
  the global batch. ``update_sharding`` swaps the optimizer for
  ``parallel/update_sharding.py``'s (the updater state is held as this
  rank's rows; ``digest_states``, ``save_models`` and ``_flat_state``
  gather the tree form, a collective every rank makes);
- ``"param_averaging"``: ``train_iteration`` is the JAX package's phased
  iteration (each fit through ``ParameterAveragingTrainer.fit``, the
  discriminator's real and fake rows as one 2-minibatch fit, every rank
  holding the global rows and fitting its worker's block), and a window
  (``train_iterations``, ``run()``) runs the per-fit averaging body
  (``_avg_body``, the JAX ``_build_fused_avg_body``): one local step per
  fit on this worker's rows (two for the discriminator), then params and
  updater state averaged over the mesh. Worker draws are this worker's
  rows of the global draws (the JAX package folds the worker index into
  its key: a different stream of the same law);
- a NCCL mesh captures the body, its collectives included, as a CUDA
  graph; a gloo mesh cannot (gloo is a host library), so its body runs
  uncaptured on the same buffers (``harness/graphs.py``);
- checkpoints, exports and metrics are written by rank 0;
  ``save_model_shard(directory, k, M)`` writes shard k of a mesh
  checkpoint, and ``load_models`` restores a directory of such shards from
  any M at any world size.

Not ported yet, raising with its ROADMAP.md item: publishing into a
``CheckpointStore`` ('The operations planes').
"""

from __future__ import annotations

import dataclasses
import logging
import os
import re
import time
import types
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from gan_deeplearning4j_tpu_torch.data import DataSet, DevicePrefetchIterator, write_csv
from gan_deeplearning4j_tpu_torch.harness.config import ExperimentConfig
from gan_deeplearning4j_tpu_torch.harness.graphs import CapturedIterations
from gan_deeplearning4j_tpu_torch.interop import params_from_numpy
from gan_deeplearning4j_tpu_torch.models import registry
from gan_deeplearning4j_tpu_torch.nn import ComputationGraph
from gan_deeplearning4j_tpu_torch.nn.layers import (
    BatchNormalization,
    ConvolutionLayer,
    Deconvolution2D,
    DenseLayer,
)
from gan_deeplearning4j_tpu_torch.parallel import GraphTrainer, ParameterAveragingTrainer, TrainState
from gan_deeplearning4j_tpu_torch.parallel import collectives
from gan_deeplearning4j_tpu_torch.parallel.trainer import check_mesh
from gan_deeplearning4j_tpu_torch.quant.variants import write_bundle_manifest
from gan_deeplearning4j_tpu_torch.runtime.device import (
    pin_deterministic_kernels,
    pin_fp32_precision,
    resolve_device,
)
from gan_deeplearning4j_tpu_torch.runtime.dtype import (
    cast_float_leaves,
    compute_dtype_scope,
    parse_compute_dtype,
)
from gan_deeplearning4j_tpu_torch.utils.metrics import MetricsLogger
from gan_deeplearning4j_tpu_torch.utils.profiling import PhaseTimer, device_trace
from gan_deeplearning4j_tpu_torch.utils.serializer import (
    ModelSerializer,
    _element_count,
    _flatten,
    _unflatten,
    read_model,
    read_state_shard,
    shard_keys,
    write_model,
    write_state_shard,
)

logger = logging.getLogger(__name__)

# one shard of a mesh-coordinated checkpoint (the JAX package's
# resilience/mesh.py): <prefix>_state_shard-<K>-of-<M>.zip
_MESH_SHARD_RE = re.compile(r"_state_shard-(\d{4})-of-(\d{4})\.zip$")
_OPERATIONS_WAITS = "ROADMAP.md queue 1, 'The operations planes'"


def latent_grid(n: int, z_size: int = 2) -> np.ndarray:
    """The n×n manifold grid over linspace(−1,1,n)² (reference :382-389).
    For z_size > 2 the remaining dims are zero (the grid spans the first two)."""
    line = np.linspace(-1.0, 1.0, n, dtype=np.float32)
    a, b = np.meshgrid(line, line, indexing="ij")
    grid = np.zeros((n * n, z_size), dtype=np.float32)
    grid[:, 0] = a.ravel()
    grid[:, 1 % z_size] = b.ravel()
    return grid


def step_generator(seed: int, dis_step: int) -> torch.Generator:
    """The CPU generator of one iteration, keyed by ``(seed, dis_step)``
    through numpy's SeedSequence (well-mixed, independent per step)."""
    state = np.random.SeedSequence([seed, dis_step]).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(state))


def flatten_states(states: Dict) -> Dict[str, object]:
    """``digest_states()`` as one flat ``{path: tensor or int}`` dict
    (``dis/params/<layer>/<name>``, ``dis/opt_state/...``, ``dis/step``,
    ``gen/<layer>/<name>``): what bit-exactness checks compare."""
    out: Dict[str, object] = {}

    def walk(prefix, node):
        if isinstance(node, TrainState):
            walk(prefix + "/params", node.params)
            walk(prefix + "/opt_state", node.opt_state)
            out[prefix + "/step"] = node.step
        elif isinstance(node, dict):
            for key, value in node.items():
                walk(f"{prefix}/{key}", value)
        else:
            out[prefix] = node

    for name, state in states.items():
        walk(name, state)
    return out


def state_divergence(a: Dict[str, object], b: Dict[str, object],
                     rounding_only: Sequence[str] = ()) -> Dict[str, float]:
    """How far two flat states (same keys, e.g. two ``flatten_states``) are
    apart: ``max_abs``, the largest elementwise difference, and
    ``max_leaf_rel``, the largest leafwise ``‖a−b‖₂ / max(‖b‖₂, 1e-5·√n)``
    (the floor keeps a leaf near zero from reading rounding as relative
    error). Two fp32 runs of the same iteration differ in sparse elements:
    RmsProp at decay = eps = 1e-8 moves a param by about ``lr·sign(g)``, so a
    gradient that cancels to |g| ≲ 1e-4 turns a rounding difference into an
    update difference of up to 2·lr, and a cache ``g²`` of such a sum carries
    a large relative rounding. ``max_leaf_rel`` reads a whole-leaf error,
    which a wrong rebind, label or learning rate would cause, apart from
    those.

    ``rounding_only`` names leaves whose exact gradient is zero (see
    :func:`rounding_only_params`): what moves them is rounding, which Adam
    at β1 = 0 turns into steps of up to ``lr`` of either sign, so two runs
    disagree on the whole leaf. They are left out of both numbers above
    and reported as ``rounding_only_max_abs``, which the update rule bounds
    by 2·lr per step."""
    if sorted(a) != sorted(b):
        raise KeyError(f"states differ in keys: {sorted(set(a) ^ set(b))[:5]}")
    max_abs = max_rel = rounding_abs = 0.0
    for key in a:
        x = np.asarray(a[key].detach().cpu() if isinstance(a[key], torch.Tensor) else a[key], np.float64)
        y = np.asarray(b[key].detach().cpu() if isinstance(b[key], torch.Tensor) else b[key], np.float64)
        diff = np.abs(x - y)
        if not diff.size:
            continue
        if key in rounding_only:
            rounding_abs = max(rounding_abs, float(diff.max()))
            continue
        max_abs = max(max_abs, float(diff.max()))
        floor = 1e-5 * np.sqrt(diff.size)
        max_rel = max(max_rel, float(np.linalg.norm(diff) / max(np.linalg.norm(y), floor)))
    return {"max_abs": max_abs, "max_leaf_rel": max_rel, "rounding_only_max_abs": rounding_abs}


def rounding_only_params(graph: ComputationGraph) -> List[str]:
    """The biases (``"<layer>/b"``) of the dense and convolution layers
    whose output goes straight into a BatchNormalization. In training mode
    BatchNorm subtracts the batch mean, which cancels such a bias: its
    exact gradient is zero, and what reaches it is rounding."""
    by_name = {v.name: v for v in graph.vertices}
    out = []
    for v in graph.vertices:
        src = by_name.get(v.inputs[0])
        if (isinstance(v.layer, BatchNormalization) and src is not None
                and isinstance(src.layer, (ConvolutionLayer, DenseLayer))):
            out.append(f"{src.name}/b")
    return out


def _rebind(src: TrainState, dst: TrainState, mapping) -> TrainState:
    """Weight sync as a rebind of the source's tensors (the reference's
    setParam blocks, :429-542): nothing is copied, and nothing writes into
    a shared tensor afterwards."""
    return TrainState(
        ComputationGraph.copy_params(src.params, dst.params, mapping), dst.opt_state, dst.step
    )


class _Batches:
    """Consecutive ``b``-row slices of tensors, as DataSets (the phased
    averaging fits' minibatch stream)."""

    def __init__(self, features: torch.Tensor, labels: torch.Tensor, b: int):
        self.features, self.labels, self.b, self._at = features, labels, b, 0

    def has_next(self) -> bool:
        return self._at < self.features.shape[0]

    def next(self) -> DataSet:
        lo, self._at = self._at, self._at + self.b
        return DataSet(self.features[lo:self._at], self.labels[lo:self._at])


def _stack(rows: Sequence) -> torch.Tensor:
    """Batches of one shape, host arrays or device tensors, stacked where
    they lie: device batches never come back to the host."""
    return torch.stack([torch.as_tensor(r) for r in rows])


def experiment_mesh(cfg: ExperimentConfig, mesh):
    """The experiment's mesh: ``mesh`` itself when given, else, under a
    distributed mode, the mesh over the environment's process group
    (``runtime/environment.py::make_mesh``); None for ``"none"``."""
    check_mesh(mesh)
    if mesh is None and cfg.distributed != "none":
        from gan_deeplearning4j_tpu_torch.runtime.environment import make_mesh

        mesh = make_mesh(use_accelerator=cfg.use_accelerator)
    return mesh


def experiment_device(cfg: ExperimentConfig, mesh=None) -> torch.device:
    """The device ``config.use_accelerator`` asks for (the mesh's device
    on a mesh); on the card, fp32 runs with TF32 off and cuDNN restricted
    to deterministic algorithms."""
    device = mesh.device if mesh is not None else resolve_device(
        None if cfg.use_accelerator else "cpu")
    if device.type == "cuda":
        pin_fp32_precision()
        pin_deterministic_kernels()
    return device


def forward_flops(graph: ComputationGraph, batch: int) -> int:
    """Multiply-add FLOPs (2 per MAC) of one forward pass of ``graph`` at
    ``batch`` rows, counting its dense, convolution and transposed
    convolution layers only. A transposed convolution scatters each input
    pixel through the whole kernel, so it counts ``H_in·W_in·kh·kw·Cin·Cout``
    MACs; counted by its output pixels it would read s² times too many."""
    total = 0
    for v in graph.vertices:
        if isinstance(v.layer, Deconvolution2D):
            kh, kw, cin, cout = v.layer.param_shapes(v.in_type)["W"]
            ih, iw, _ = v.in_type.shape
            total += 2 * batch * ih * iw * kh * kw * cin * cout
        elif isinstance(v.layer, ConvolutionLayer):
            kh, kw, cin, cout = v.layer.param_shapes(v.in_type)["W"]
            oh, ow, _ = v.out_type.shape
            total += 2 * batch * oh * ow * kh * kw * cin * cout
        elif isinstance(v.layer, DenseLayer):
            n_in, n_out = v.layer.param_shapes(v.in_type)["W"]
            total += 2 * batch * n_in * n_out
    return total


class GanExperiment:
    """The application loop, assembled from the port's layers."""

    def __init__(self, config: ExperimentConfig = ExperimentConfig(), mesh=None):
        self.config = config.validate()
        cfg = config
        self.mesh = experiment_mesh(cfg, mesh)
        self.device = dev = experiment_device(cfg, self.mesh)
        self.family = registry.get(cfg.model_family)
        self.model_cfg = self.family.make_model_config(cfg)
        self.dis_to_gan, self.gan_to_gen = self.family.sync_maps(self.model_cfg)
        # class conditioning widens only the gen and gan graphs' input; the
        # weight-sync maps are keyed by layer name and carry over unchanged
        self._cond_classes = cfg.num_classes if cfg.conditioning == "class" else 0
        gen_cfg = (dataclasses.replace(self.model_cfg, z_size=self.model_cfg.z_size + self._cond_classes)
                   if self._cond_classes else self.model_cfg)

        # the three graphs + the transfer classifier (mnist only); gen and
        # gan are initialised separately, as in the reference
        self.dis = self.family.build_discriminator(self.model_cfg)
        self.gen = self.family.build_generator(gen_cfg)
        self.gan = self.family.build_gan(gen_cfg)
        dis_params = self.dis.init(device=dev)
        self.dis_trainer = self._make_trainer(self.dis)
        self.gan_trainer = self._make_trainer(self.gan)
        self.dis_state = self.dis_trainer.init_state(params=dis_params)
        self.gan_state = self.gan_trainer.init_state(device=dev)
        self.cv = self.cv_trainer = self.cv_state = None
        if self.family.build_transfer_classifier is not None:
            self.cv, cv_params = self.family.build_transfer_classifier(
                self.dis, dis_params, self.model_cfg
            )
            self.cv_trainer = self._make_trainer(self.cv)
            self.cv_state = self.cv_trainer.init_state(params=cv_params)
        self.gen_params = self.gen.init(device=dev)
        self._compute_dtype = parse_compute_dtype(cfg.compute_dtype)
        self._param_dtype = parse_compute_dtype(cfg.param_dtype)
        self.dis_state = self._cast_state(self.dis_state)
        self.gan_state = self._cast_state(self.gan_state)
        self.cv_state = self._cast_state(self.cv_state)
        self.gen_params = self._cast_state(self.gen_params)
        if cfg.update_sharding:
            self._enable_update_sharding()

        # label-softening noise, sampled once like the reference (:404-406)
        self._noise_rng = np.random.default_rng(cfg.seed)
        b = cfg.batch_size_train
        self._eps_real = self._soft_noise(b)
        self._eps_fake = self._soft_noise(b)
        self._soft_cache: Dict[int, tuple] = {}
        self._z_grid = self._with_condition(latent_grid(cfg.latent_grid, cfg.z_size))
        self.z_source = self._draw_z

        self.timer = PhaseTimer()
        self.metrics = MetricsLogger(cfg.metrics_jsonl if self._writes else None)
        self.batch_counter = 0
        self._epilogue_active = False
        averaging = cfg.distributed == "param_averaging"
        self.graphs = CapturedIterations(self._avg_body if averaging else self._body, dev,
                                         captured=self._captured())

    # -- the mesh ---------------------------------------------------------
    @property
    def _writes(self) -> bool:
        """Whether this process writes files (rank 0 of a mesh)."""
        return self.mesh is None or self.mesh.rank == 0

    @property
    def _world(self) -> int:
        return 1 if self.mesh is None else self.mesh.size

    def _captured(self) -> bool:
        """Windows run as CUDA-graph replays on the card, unless the mesh is
        gloo's, whose collectives are host calls a graph cannot hold: then
        the device body runs uncaptured on the same buffers."""
        return self.device.type == "cuda" and (self.mesh is None or self.mesh.capturable)

    def _make_trainer(self, graph: ComputationGraph):
        """The JAX package's ``_make_trainer``: the parameter-averaging
        trainer under ``param_averaging``, a mesh ``GraphTrainer`` under
        ``pmean``, a single-device one otherwise."""
        cfg = self.config
        if cfg.distributed == "param_averaging":
            return ParameterAveragingTrainer(graph, self.mesh,
                                             batch_size_per_worker=cfg.batch_size_per_worker,
                                             averaging_frequency=cfg.averaging_frequency)
        return GraphTrainer(graph, mesh=self.mesh if cfg.distributed == "pmean" else None)

    def _enable_update_sharding(self) -> None:
        """Partition every trainer's update and updater state over the
        mesh. The partition is taken over the whole ``_flat_state()``
        namespace, so compute shard k owns the updater keys checkpoint
        shard k writes."""
        from gan_deeplearning4j_tpu_torch.parallel.update_sharding import UpdateShardingPlan

        global_keys = {k: _element_count(v) for k, v in self._flat_state().items()}
        models = [("dis", self.dis_trainer, "dis_state"), ("gan", self.gan_trainer, "gan_state")]
        if self.cv is not None:
            models.append(("CV", self.cv_trainer, "cv_state"))
        for name, trainer, attr in models:
            state = getattr(self, attr)
            trainer.enable_update_sharding(UpdateShardingPlan(
                trainer.graph, trainer.optimizer, state.params, self.mesh, model_name=name,
                global_keys=global_keys))
            setattr(self, attr, TrainState(state.params, trainer.plan.pack_state(state.opt_state),
                                           state.step))

    def _tree_state(self, trainer, state: TrainState) -> TrainState:
        """The tree form of a state (what checkpoints and digests take):
        itself, or under update sharding with the updater rows gathered (a
        collective)."""
        if getattr(trainer, "shard_updates", False) and state is not None:
            return TrainState(state.params, trainer.plan.unpack_state(state.opt_state), state.step)
        return state

    def _local_rows(self, x, n: int):
        """This rank's rows of a global ``(…, n, …)`` batch axis 1 (a
        window), after truncating ``n`` to a multiple of the world size as
        ``DataSet.shard_batch`` does; ``x`` itself without a mesh."""
        if self.mesh is None or x is None:
            return x
        usable = n // self.mesh.size * self.mesh.size
        if usable == 0:
            raise ValueError(f"batch of {n} cannot be split over {self.mesh.size} shards")
        return x[:, self.mesh.rows(usable)]

    # -- randomness -------------------------------------------------------
    def _soft_noise(self, n: int) -> np.ndarray:
        return self.config.label_softening * self._noise_rng.standard_normal((n, 1)).astype(np.float32)

    def _with_condition(self, z: np.ndarray) -> np.ndarray:
        """Host latents widened by a cycling one-hot block (row i conditions
        on class i mod C); ``z`` itself when unconditional."""
        if not self._cond_classes:
            return z
        onehot = np.eye(self._cond_classes, dtype=np.float32)[np.arange(z.shape[0]) % self._cond_classes]
        return np.concatenate([z, onehot], axis=1)

    def _draw_z(self, dis_step: int, batch: int) -> torch.Tensor:
        """The default z source: ``(2, batch, z_size)`` uniform in [−1, 1)
        (z for the fakes, then z for the generator step), drawn on the CPU
        from the step's generator."""
        g = step_generator(self.config.seed + 2, dis_step)
        z = torch.rand((2, batch, self.model_cfg.z_size), generator=g)
        return z.mul_(2.0).sub_(1.0)

    def _resampled_soft_labels(self, dis_step: int, batch: int):
        """Fresh (1+ε, 0+ε) for ``resample_label_noise``, from the step's
        own generator on a separate key (host tensors)."""
        g = step_generator(self.config.seed + 3, dis_step)
        eps = self.config.label_softening * torch.randn((2, batch, 1), generator=g)
        return 1.0 + eps[0], 0.0 + eps[1]

    def _eps_slices(self, b: int):
        """The once-sampled label noise for batch size ``b``, extended (once)
        when a larger batch appears."""
        if b > self._eps_real.shape[0]:
            extra = b - self._eps_real.shape[0]
            self._eps_real = np.concatenate([self._eps_real, self._soft_noise(extra)])
            self._eps_fake = np.concatenate([self._eps_fake, self._soft_noise(extra)])
        return self._eps_real[:b], self._eps_fake[:b]

    def _soft_labels(self, b: int):
        """Fixed softened labels (1+ε, 0+ε) for batch size ``b`` (host
        tensors), cached per batch size."""
        if b not in self._soft_cache:
            eps_r, eps_f = self._eps_slices(b)
            self._soft_cache[b] = (torch.from_numpy(1.0 + eps_r), torch.from_numpy(0.0 + eps_f))
        return self._soft_cache[b]

    def _dis_lr_scale(self, dis_step: int) -> Optional[float]:
        """The staircase decay factor of the discriminator's learning rate
        (two dis steps per iteration); None when the schedule is off."""
        cfg = self.config
        if not cfg.dis_lr_decay_every or cfg.dis_lr_decay_rate == 1.0:
            return None
        iteration = dis_step // 2
        return float(np.float32(cfg.dis_lr_decay_rate) ** np.float32(iteration // cfg.dis_lr_decay_every))

    def _to_device(self, x) -> torch.Tensor:
        """Rows (batches, draws) as float32 on the device, through pinned
        memory from the host: they are never cast to the param dtype."""
        t = torch.as_tensor(x, dtype=torch.float32)
        if self.device.type == "cuda" and t.device.type == "cpu":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def _cast_state(self, state):
        """Under bf16 storage, a ``TrainState`` or params tree with every
        float leaf in bf16 (the JAX package's ``_cast_state``; int leaves
        and the step stay); otherwise ``state`` itself."""
        if self._param_dtype is None or state is None:
            return state
        if isinstance(state, TrainState):
            return TrainState(cast_float_leaves(state.params, self._param_dtype),
                              cast_float_leaves(state.opt_state, self._param_dtype), state.step)
        return cast_float_leaves(state, self._param_dtype)

    # -- the iteration ----------------------------------------------------
    def _global_draws(self, dis_step: int, n: int):
        """``(z (2, n, z_size), soft1 (n, 1), soft0 (n, 1))`` of the
        iteration at ``dis_step`` for ``n`` global rows (host tensors)."""
        z = torch.as_tensor(self.z_source(dis_step, n), dtype=torch.float32)
        if self.config.resample_label_noise:
            soft1, soft0 = self._resampled_soft_labels(dis_step, n)
        else:
            soft1, soft0 = self._soft_labels(n)
        return z, soft1, soft0

    def _step_draws(self, dis_step: int, b: int) -> torch.Tensor:
        """Every input the iteration at ``dis_step`` keys by step, as one
        float32 host row: z ``(2, b, z_size)``, soft1 and soft0 ``(b, 1)``
        (fixed or resampled), then the dis-LR scale when that schedule is
        on (``_unpack_draws`` reads it back). On a mesh, ``b`` is this
        rank's rows: the global draws are made and its rows taken."""
        z, soft1, soft0 = self._global_draws(dis_step, b * self._world)
        if self.mesh is not None:
            rows = self.mesh.rows(b * self._world)
            z, soft1, soft0 = z[:, rows], soft1[rows], soft0[rows]
        parts = [z.reshape(-1), soft1.reshape(-1), soft0.reshape(-1)]
        scale = self._dis_lr_scale(dis_step)
        if scale is not None:
            parts.append(torch.tensor([scale], dtype=torch.float32))
        return torch.cat(parts)

    def _window_draws(self, k: int, b: int) -> torch.Tensor:
        """``(k, n)`` draws of the next ``k`` iterations (two dis steps
        each), moved to the device in one copy."""
        step = self.dis_state.step
        return self._to_device(torch.stack([self._step_draws(step + 2 * i, b) for i in range(k)]))

    def _unpack_draws(self, draws: torch.Tensor, b: int):
        """``(z, soft1, soft0, dis_scale)``: views of one draws row; the
        scale a 0-d tensor, or None when the schedule is off."""
        n = 2 * b * self.model_cfg.z_size
        z = draws[:n].view(2, b, self.model_cfg.z_size)
        soft1, soft0 = draws[n:n + b].view(b, 1), draws[n + b:n + 2 * b].view(b, 1)
        scale = draws[n + 2 * b] if self._dis_lr_scale(0) is not None else None
        return z, soft1, soft0, scale

    def _body(self, trees: Dict, inputs: Dict[str, torch.Tensor]):
        """The device body: one alternating iteration on ``trees`` (``dis``,
        ``gan``, ``cv``, ``gen``) and ``inputs`` (``features``, ``labels``
        where the family has a classifier or the run is conditional,
        ``draws``), functional. Returns the new trees and the ``(d_loss,
        g_loss, cv_loss)`` row."""
        real_f, real_l = inputs["features"], inputs.get("labels")
        b = real_f.shape[0]
        z, soft1, soft0, dis_scale = self._unpack_draws(inputs["draws"], b)
        z_fake, z_gan = z[0], z[1]
        if self._cond_classes:
            # both generator passes conditioned on the real batch's labels;
            # the base-z draws are the unconditional ones
            onehot = real_l.float()
            z_fake = torch.cat([z_fake, onehot], dim=1)
            z_gan = torch.cat([z_gan, onehot], dim=1)
        dis_state, gan_state, cv_state, gen_params = trees["dis"], trees["gan"], trees["cv"], trees["gen"]
        with compute_dtype_scope(self._compute_dtype):
            # (a) fake batch from the frozen sampler
            with torch.no_grad(), record_function("iteration.sample_fake"):
                fake = self.gen.output(gen_params, z_fake, train=False).reshape(real_f.shape)
            # (b) dis fit: real→soft1 then fake→soft0, two optimizer steps
            with record_function("iteration.dis_real"):
                dis_state, d1 = self.dis_trainer.train_step(dis_state, real_f, soft1, dis_scale)
            with record_function("iteration.dis_fake"):
                dis_state, d2 = self.dis_trainer.train_step(dis_state, fake, soft0, dis_scale)
            # (c) dis → gan frozen tail
            gan_state = _rebind(dis_state, gan_state, self.dis_to_gan)
            # (d) generator step through the frozen D on [z, ones]
            ones = torch.ones((b, 1), dtype=torch.float32, device=real_f.device)
            with record_function("iteration.gan"):
                gan_state, g = self.gan_trainer.train_step(gan_state, z_gan, ones)
            # (e) gan → gen refresh; dis → classifier features
            gen_params = ComputationGraph.copy_params(gan_state.params, gen_params, self.gan_to_gen)
            if self.cv is None:
                c = torch.full((), float("nan"), device=real_f.device)
            else:
                cv_state = _rebind(dis_state, cv_state, self.family.dis_to_cv)
                # (f) classifier step on the real labelled batch
                with record_function("iteration.cv"):
                    cv_state, c = self.cv_trainer.train_step(cv_state, real_f, real_l)
        new = {"dis": dis_state, "gan": gan_state, "cv": cv_state, "gen": gen_params}
        return new, torch.stack([(d1 + d2) / 2.0, g, c])

    def _avg_body(self, trees: Dict, inputs: Dict[str, torch.Tensor]):
        """The per-fit averaging body (the JAX ``_build_fused_avg_body``):
        each fit is one local optimizer step on this worker's rows (two, real
        then fake, for the discriminator's 2-minibatch fit), then params and
        updater state are averaged over the mesh; the losses are the
        workers' means. Functional, like ``_body``."""
        real_f, real_l = inputs["features"], inputs.get("labels")
        b = real_f.shape[0]
        z, soft1, soft0, dis_scale = self._unpack_draws(inputs["draws"], b)
        dis, gan, cv = self.dis_trainer, self.gan_trainer, self.cv_trainer
        dis_state, gan_state, cv_state, gen_params = trees["dis"], trees["gan"], trees["cv"], trees["gen"]
        with compute_dtype_scope(self._compute_dtype):
            with torch.no_grad(), record_function("iteration.sample_fake"):
                fake = self.gen.output(gen_params, z[0], train=False).reshape(real_f.shape)
            with record_function("iteration.dis_real"):
                dis_state, d1 = dis.local.train_step(dis_state, real_f, soft1, dis_scale)
            with record_function("iteration.dis_fake"):
                dis_state, d2 = dis.local.train_step(dis_state, fake, soft0, dis_scale)
            with record_function("iteration.average"):
                dis_state = dis.average(dis_state)
            gan_state = _rebind(dis_state, gan_state, self.dis_to_gan)
            ones = torch.ones((b, 1), dtype=torch.float32, device=real_f.device)
            with record_function("iteration.gan"):
                gan_state, g = gan.local.train_step(gan_state, z[1], ones)
            with record_function("iteration.average"):
                gan_state = gan.average(gan_state)
            gen_params = ComputationGraph.copy_params(gan_state.params, gen_params, self.gan_to_gen)
            if self.cv is None:
                c = torch.full((), float("nan"), device=real_f.device)
            else:
                cv_state = _rebind(dis_state, cv_state, self.family.dis_to_cv)
                with record_function("iteration.cv"):
                    cv_state, c = cv.local.train_step(cv_state, real_f, real_l)
                with record_function("iteration.average"):
                    cv_state = cv.average(cv_state)
        row = collectives.mean([torch.stack([(d1 + d2) / 2.0, g, c])], self.mesh)[0]
        return {"dis": dis_state, "gan": gan_state, "cv": cv_state, "gen": gen_params}, row

    def _phased_iteration(self, real_features, real_labels) -> Dict:
        """The JAX package's phased iteration under ``param_averaging``
        (``_train_iteration`` without a fused program): every fit is a
        ``ParameterAveragingTrainer.fit`` over the global rows, the
        discriminator's real and fake rows as one fit of two minibatches.
        z comes from ``z_source`` (fakes, then the generator step) at the
        global batch; the losses are host floats."""
        cfg = self.config
        dev = self.device
        real_f = self._to_device(real_features)
        real_l = None if real_labels is None else self._to_device(real_labels)
        b = real_f.shape[0]
        dis_step = self.dis_state.step
        z, soft1, soft0 = self._global_draws(dis_step, b)
        z = z.to(dev)
        with compute_dtype_scope(self._compute_dtype):
            with self.timer.phase("sample_fake"), torch.no_grad():
                fake = self.gen.output(self.gen_params, z[0], train=False).reshape(b, cfg.num_features)
            with self.timer.phase("train_dis"):
                feats = torch.cat([real_f, fake])
                labels = torch.cat([soft1, soft0]).to(dev)
                self.dis_state, d_losses = self.dis_trainer.fit(
                    self.dis_state, _Batches(feats, labels, b))
            self.gan_state = _rebind(self.dis_state, self.gan_state, self.dis_to_gan)
            with self.timer.phase("train_gan"):
                ones = torch.ones((b, 1), dtype=torch.float32, device=dev)
                self.gan_state, g_losses = self.gan_trainer.fit(self.gan_state, _Batches(z[1], ones, b))
            self.gen_params = ComputationGraph.copy_params(self.gan_state.params, self.gen_params,
                                                           self.gan_to_gen)
            cv_losses: List[float] = []
            if self.cv is not None:
                self.cv_state = _rebind(self.dis_state, self.cv_state, self.family.dis_to_cv)
                with self.timer.phase("train_cv"):
                    self.cv_state, cv_losses = self.cv_trainer.fit(
                        self.cv_state, _Batches(real_f, real_l, b))

        def mean(xs):
            return float(np.mean(xs)) if xs else float("nan")

        return {"d_loss": mean(d_losses), "g_loss": mean(g_losses), "cv_loss": mean(cv_losses)}

    def _trees(self) -> Dict:
        return {"dis": self.dis_state, "gan": self.gan_state, "cv": self.cv_state,
                "gen": self.gen_params}

    def _set_trees(self, trees: Dict) -> None:
        self.dis_state, self.gan_state = trees["dis"], trees["gan"]
        self.cv_state, self.gen_params = trees["cv"], trees["gen"]

    def _window(self, features, labels, local: bool = False) -> Dict:
        """K iterations of the device body over a ``(K, B, …)`` window
        (``graphs.run``: K replays on the card). Returns ``(K,)`` device
        loss vectors, freshly allocated. On a mesh the window holds global
        batches, of which this rank takes its rows, unless ``local`` says
        they are its rows already (a mesh iterator's)."""
        if not local:
            n = features.shape[1]
            features, labels = self._local_rows(features, n), self._local_rows(labels, n)
        feats = self._to_device(features)
        window = {"features": feats}
        # the classifier step and the generator's condition read labels
        if self.cv is not None or self._cond_classes:
            if labels is None:
                raise ValueError("the transfer classifier and class conditioning train on "
                                 "labels; the batch has none")
            window["labels"] = self._to_device(labels)
            if self._cond_classes and window["labels"].shape[-1] != self._cond_classes:
                raise ValueError(
                    f"class conditioning needs one-hot labels of width {self._cond_classes} "
                    f"(num_classes); the batch's labels are {tuple(window['labels'].shape[2:])}")
        window["draws"] = self._window_draws(feats.shape[0], feats.shape[1])
        trees, rows = self.graphs.run(self._trees(), window)
        self._set_trees(trees)
        return {"d_loss": rows[:, 0], "g_loss": rows[:, 1], "cv_loss": rows[:, 2]}

    def train_iteration(self, real_features, real_labels, local: bool = False) -> Dict:
        """One full alternating iteration (a window of one). Inputs:
        features (B, num_features) in [0,1] and one-hot labels (B, classes),
        host arrays or tensors: the global batch on a mesh (``local``: this
        rank's rows). Returns device scalars (no host read); under
        ``param_averaging`` the phased iteration, with host floats."""
        if self.config.distributed == "param_averaging":
            if local:
                raise ValueError("the phased averaging iteration fits the global rows")
            return self._phased_iteration(real_features, real_labels)

        def one(x):
            return None if x is None else torch.as_tensor(x)[None]

        with self.timer.phase("train_fused"):
            losses = self._window(one(real_features), one(real_labels), local)
        return {k: v[0] for k, v in losses.items()}

    def train_iterations(self, features, labels, local: bool = False) -> Dict:
        """K iterations over a ``(K, B, num_features)`` / ``(K, B, classes)``
        window, moved to the device once; on the card K graph replays,
        bit-equal to K calls of ``train_iteration``. Returns ``(K,)`` device
        loss vectors. Under ``param_averaging`` each is the per-fit
        averaging body."""
        return self._window(features, labels, local)

    def flops_per_iteration(self, batch_size: Optional[int] = None) -> int:
        """FLOPs of the dense and (transposed) convolution layers in one
        iteration, from shapes: the sampler's forward pass, then forward,
        input-gradient and weight-gradient passes (3× forward) of the two
        dis steps, the gan step and the cv step (where the family has a
        classifier). Every such layer needs its input gradient here (a
        trainable BatchNorm sits in front of each graph's first conv or
        dense layer). Elementwise work is not counted."""
        b = batch_size or self.config.batch_size_train
        steps = 2 * forward_flops(self.dis, b) + forward_flops(self.gan, b)
        if self.cv is not None:
            steps += forward_flops(self.cv, b)
        return forward_flops(self.gen, b) + 3 * steps

    # -- exports ----------------------------------------------------------
    def export_manifold(self, index: int) -> str:
        """Decode the z-grid and write ``{prefix}_out_{index}.csv``:
        (grid², num_features) rows, one device→host copy."""
        cfg = self.config
        path = os.path.join(cfg.output_dir, f"{cfg.file_prefix}_out_{index}.csv")
        if not self._writes:
            return path
        with torch.no_grad(), compute_dtype_scope(self._compute_dtype):
            out = self.gen.output(self.gen_params, self._to_device(self._z_grid), train=False)
        out = out.cpu().numpy().reshape(self._z_grid.shape[0], cfg.num_features)
        os.makedirs(cfg.output_dir, exist_ok=True)
        write_csv(path, out, precision=6)
        return path

    def export_predictions(self, test_iterator, index: int) -> str:
        """Batched test-set inference → ``{prefix}_test_predictions_{index}.csv``."""
        cfg = self.config
        if self.cv is None:
            raise ValueError(
                f"family {self.family.name!r} has no transfer classifier to predict with"
            )
        path = os.path.join(cfg.output_dir, f"{cfg.file_prefix}_test_predictions_{index}.csv")
        if not self._writes:
            return path
        test_iterator.reset()
        chunks: List[np.ndarray] = []
        while test_iterator.has_next():
            batch = test_iterator.next()
            with compute_dtype_scope(self._compute_dtype):
                out = self.cv_trainer.output(self.cv_state, self._to_device(batch.features))
            chunks.append(out.cpu().numpy())
        preds = np.vstack(chunks) if chunks else np.zeros((0, cfg.num_classes))
        os.makedirs(cfg.output_dir, exist_ok=True)
        write_csv(path, preds, precision=6)
        return path

    # -- checkpoints ------------------------------------------------------
    def _publish_step(self) -> int:
        """The step counter published artifacts are labelled with (the gan
        graph steps once per iteration)."""
        return int(self.gan_state.step)

    def digest_states(self) -> Dict:
        """Every trained state, by model name, in tree form: what
        bit-exactness checks compare (``flatten_states`` flattens it).
        Under update sharding a collective (the updater rows are
        gathered)."""
        states = {"dis": self._tree_state(self.dis_trainer, self.dis_state),
                  "gan": self._tree_state(self.gan_trainer, self.gan_state),
                  "gen": self.gen_params}
        if self.cv is not None:
            states["CV"] = self._tree_state(self.cv_trainer, self.cv_state)
        return states

    def rounding_only_keys(self) -> List[str]:
        """``flatten_states`` keys that ``state_divergence`` should report
        apart (``rounding_only``): none here. The graphs have such biases
        (``rounding_only_params``), but RmsProp adds its eps inside the
        square root, so a rounding-sized gradient (≪ 1e-4) moves a param
        by far less than ``lr``."""
        return []

    def save_models(self, directory: Optional[str] = None) -> List[str]:
        """Every model, with updater state, as the JAX package's zips
        ``{prefix}_{dis,gan,gen,CV}_model.zip`` (no ``CV`` where the family
        has no classifier)."""
        cfg = self.config
        directory = directory or cfg.output_dir
        states = self.digest_states()
        graphs = {"dis": self.dis, "gan": self.gan, "gen": self.gen, "CV": self.cv}
        out = []
        for name, state in states.items():
            path = os.path.join(directory, f"{cfg.file_prefix}_{name}_model.zip")
            if self._writes:
                write_model(path, graphs[name], state, save_updater=True)
            out.append(path)
        return out

    # -- mesh-sharded checkpoints -----------------------------------------
    def _flat_state(self) -> Dict:
        """Every trained state as one flat ``<model>/{params|updater|step}/
        ...`` dict, the namespace mesh checkpoints shard over (the JAX
        package's keys; the step counters 0-d int32 arrays)."""
        flat: Dict = {}
        for name, state in self.digest_states().items():
            if isinstance(state, TrainState):
                _flatten(f"{name}/params", state.params, flat)
                _flatten(f"{name}/updater", state.opt_state, flat)
                flat[f"{name}/step"] = np.asarray(state.step, np.int32)
            else:
                _flatten(f"{name}/params", state, flat)
        return flat

    def save_model_shard(self, directory: str, shard_index: int, shard_count: int) -> List[str]:
        """Write shard ``shard_index`` of ``shard_count`` of the trained state
        (its keys of ``serializer.shard_keys``) into ``directory``, as the
        JAX package's mesh writer names and fills it. Returns the file name
        written. Under update sharding a collective."""
        flat = self._flat_state()
        mine = shard_keys(flat, shard_index, shard_count)
        name = f"{self.config.file_prefix}_state_shard-{shard_index:04d}-of-{shard_count:04d}.zip"
        write_state_shard(os.path.join(directory, name), {k: flat[k] for k in mine}, meta={
            "shard_index": int(shard_index),
            "shard_count": int(shard_count),
            "step": self._publish_step(),
            "total_keys": len(flat),
            "update_sharding": bool(self.config.update_sharding),
        })
        return [name]

    @staticmethod
    def _merged_shard_state(directory: str, shard_files: List[str]) -> Dict:
        """A mesh generation's shards merged into one flat dict, checked
        for disjoint keys, one shard count, every shard, and the writer's
        key count."""
        counts, indices, flat, total_keys = set(), [], {}, None
        for name in shard_files:
            arrays, meta = read_state_shard(os.path.join(directory, name))
            counts.add(int(meta["shard_count"]))
            indices.append(int(meta["shard_index"]))
            total_keys = int(meta["total_keys"])
            overlap = set(arrays) & set(flat)
            if overlap:
                raise ValueError(f"mesh shards overlap on keys {sorted(overlap)[:3]}... "
                                 f"— not one consistent generation")
            flat.update(arrays)
        if len(counts) != 1:
            raise ValueError(f"mesh shards disagree on shard_count ({sorted(counts)}) — "
                             f"files from different generations are mixed")
        want = counts.pop()
        if sorted(indices) != list(range(want)):
            raise ValueError(f"mesh generation incomplete: have shards {sorted(indices)} "
                             f"of {want} — refusing a partial restore")
        if total_keys is not None and len(flat) != total_keys:
            raise ValueError(f"mesh generation torn: merged {len(flat)} keys, writer "
                             f"recorded {total_keys}")
        return flat

    def _shard_files(self, directory: str) -> List[str]:
        return sorted(n for n in os.listdir(directory)
                      if _MESH_SHARD_RE.search(n) and n.startswith(self.config.file_prefix))

    def _restored(self, flat: Dict, model: str, trainer) -> TrainState:
        """One model's state from a merged flat dict, checked against the
        trainer's graph, on the experiment's device, in its storage dtype
        (re-packed onto this mesh's partition under update sharding)."""
        from gan_deeplearning4j_tpu_torch.interop import train_state_from_numpy

        params = _unflatten(flat, f"{model}/params")
        opt_state = _unflatten(flat, f"{model}/updater")
        base = getattr(trainer.optimizer, "base", trainer.optimizer)
        if not opt_state:
            opt_state = base.init(params_from_numpy(params, self.device, graph=trainer.graph))
        state = train_state_from_numpy(
            {"params": params, "opt_state": opt_state, "step": int(np.asarray(flat[f"{model}/step"]))},
            self.device, graph=trainer.graph)
        return self._stored(state, trainer)

    def _stored(self, state: TrainState, trainer) -> TrainState:
        """A restored tree-form state in the storage dtype, its updater
        state re-packed under update sharding."""
        state = self._cast_state(state)
        if getattr(trainer, "shard_updates", False):
            state = TrainState(state.params, trainer.plan.pack_state(state.opt_state), state.step)
        return state

    def _load_models_sharded(self, directory: str, shard_files: List[str]) -> int:
        flat = self._merged_shard_state(directory, shard_files)
        self.dis_state = self._restored(flat, "dis", self.dis_trainer)
        self.gan_state = self._restored(flat, "gan", self.gan_trainer)
        if self.cv is not None:
            self.cv_state = self._restored(flat, "CV", self.cv_trainer)
        self.gen_params = self._cast_state(
            params_from_numpy(_unflatten(flat, "gen/params"), self.device, graph=self.gen))
        self.batch_counter = int(self.gan_state.step)
        return self.batch_counter

    def load_models(self, directory: Optional[str] = None) -> int:
        """Resume: restore every state ``save_models`` wrote (params, updater
        state, step), from either package. Returns the restored iteration
        count. A bf16 checkpoint restores as bf16; under bf16 storage an
        fp32 checkpoint is cast on entry."""
        cfg = self.config
        directory = directory or cfg.output_dir
        shard_files = self._shard_files(directory)
        if shard_files:
            return self._load_models_sharded(directory, shard_files)
        prefix = os.path.join(directory, cfg.file_prefix)
        self.dis_state = self._restore(f"{prefix}_dis_model.zip", self.dis_trainer)
        self.gan_state = self._restore(f"{prefix}_gan_model.zip", self.gan_trainer)
        if self.cv is not None:
            self.cv_state = self._restore(f"{prefix}_CV_model.zip", self.cv_trainer)
        _, gen_params, _, _ = read_model(
            f"{prefix}_gen_model.zip", load_updater=False, device=self.device
        )
        self.gen_params = self._cast_state(gen_params)
        self.batch_counter = int(self.gan_state.step)
        return self.batch_counter

    def _restore(self, path: str, trainer) -> TrainState:
        """One checkpoint with updater state, on the experiment's device, in
        its storage dtype (re-packed under update sharding)."""
        tree = types.SimpleNamespace(graph=trainer.graph,
                                     optimizer=getattr(trainer.optimizer, "base", trainer.optimizer))
        return self._stored(ModelSerializer.restore_train_state(path, tree, device=self.device),
                            trainer)

    def publish_for_serving(self, directory: Optional[str] = None, store=None) -> Dict:
        """Publish the inference artifacts (the generator and, where the
        family has one, the transfer classifier, without updater state) and
        a ``serving.json`` manifest key for key as the JAX package writes
        it, so either package's ``ServingEngine.from_bundle`` loads the
        bundle; a generator-only bundle has ``classifier`` and
        ``feature_vertex`` null. Every file lands by temp file and
        rename."""
        if store is not None:
            raise NotImplementedError(
                f"publishing into a CheckpointStore is not ported yet: {_OPERATIONS_WAITS}"
            )
        cfg = self.config
        directory = directory or os.path.join(cfg.output_dir, "serving")
        writes = self._writes
        if writes:
            os.makedirs(directory, exist_ok=True)
        gen_name = f"{cfg.file_prefix}_gen_serving.zip"
        if writes:
            write_model(os.path.join(directory, gen_name), self.gen, self.gen_params, save_updater=False)
        cv_name = feature_vertex = None
        if self.cv is not None:
            cv_name = f"{cfg.file_prefix}_CV_serving.zip"
            if writes:
                write_model(os.path.join(directory, cv_name), self.cv, self.cv_state, save_updater=False)
            # the deepest dis-derived layer: the classifier's transfer features
            feature_vertex = list(self.family.dis_to_cv.values())[-1]
        manifest = {
            "format_version": 1,
            "family": self.family.name,
            "generator": gen_name,
            "classifier": cv_name,
            "feature_vertex": feature_vertex,
            "z_size": int(self.model_cfg.z_size),
            "num_features": int(cfg.num_features),
            "num_classes": int(cfg.num_classes),
            "step": self._publish_step(),
            "generation": None,
        }
        from gan_deeplearning4j_tpu_torch.zoo.manifest import scenario_from_config

        scenario = scenario_from_config(cfg)
        if scenario is not None:
            manifest["zoo"] = scenario.to_dict()
        if writes:
            write_bundle_manifest(directory, manifest)
        return {**manifest, "directory": directory}

    # -- the loop ---------------------------------------------------------
    def _window_limit(self, have_predictions: bool) -> int:
        """How many iterations may run before the host must step in. An
        export after iteration j needs the state at j, so an export index
        may only be a window's last element; per-iteration checkpoints,
        ``loss_fetch_every=1`` and an epilogue hook force windows of 1."""
        cfg = self.config
        if (
            (cfg.save_models and cfg.checkpoint_every <= 1)
            or cfg.loss_fetch_every <= 1
            or self._epilogue_active
        ):
            return 1
        i = self.batch_counter
        w = min(cfg.loss_fetch_every, cfg.num_iterations - i)
        bounds = [cfg.print_every]
        if cfg.save_models:
            bounds.append(cfg.checkpoint_every)
        if have_predictions:
            bounds.append(cfg.save_every)
        for every in bounds:
            r = i % every
            w = min(w, 1 if r == 0 else every - r + 1)
        return max(1, w)

    def run(self, train_iterator, test_iterator=None, eval_callback=None,
            epilogue_callback=None) -> Dict:
        """The training loop: the host cuts the batches into windows and the
        device runs them.

        Windows follow the JAX package's rules: a power-of-two length (the
        JAX package compiles one program per length), ended early at every
        export and checkpoint boundary, with a ragged epoch tail or the
        power-of-two remainder carried to the next window. Loss scalars stay
        on the device and come back in one copy per ``loss_fetch_every``
        iterations; ``images_per_sec`` is the average over that flush.

        ``eval_callback(experiment, index)`` fires at every ``print_every``
        boundary, outside the throughput window. ``epilogue_callback(
        experiment, index)`` fires after every iteration (windows of 1); a
        ``False`` return stops the loop cleanly.

        ``prefetch > 0`` wraps an iterator that has no ``next_window`` in
        ``DevicePrefetchIterator``; one that has it (``DeviceResidentIterator``)
        serves each window as one device slice."""
        cfg = self.config
        self._epilogue_active = epilogue_callback is not None
        if cfg.prefetch > 0 and not hasattr(train_iterator, "next_window"):
            # under pmean each rank prefetches only its rows; the phased
            # averaging iteration fits the global rows
            mesh = self.mesh if cfg.distributed == "pmean" else None
            train_iterator = DevicePrefetchIterator(train_iterator, depth=cfg.prefetch,
                                                    device=self.device, mesh=mesh)
        # a mesh iterator hands this rank its rows of each global batch
        local = getattr(train_iterator, "mesh", None) is not None
        scale = self._world if local else 1
        rank_rows = {"local": True} if local else {}
        history: List[Dict[str, float]] = []
        pending: List[tuple] = []  # (start iteration, loss record, images list)
        pending_iters = 0
        window_t0 = time.perf_counter()

        def flush() -> None:
            """One device→host copy for every pending loss value."""
            nonlocal window_t0, pending_iters
            if not pending:
                return
            keys = list(pending[0][1].keys())
            rows = torch.cat([
                torch.stack([torch.atleast_1d(rec[k]).float() for k in keys], dim=1)
                for _, rec, _ in pending
            ])
            values = rows.cpu().numpy()  # the only device→host read
            elapsed = time.perf_counter() - window_t0
            per_iter = elapsed / len(values)
            row = 0
            for start, _, images in pending:
                for k, n_images in enumerate(images):
                    entry = dict(zip(keys, (float(v) for v in values[row])))
                    entry["images_per_sec"] = n_images / per_iter if per_iter > 0 else 0.0
                    self.metrics.log(start + k, entry)
                    history.append(entry)
                    row += 1
            pending.clear()
            pending_iters = 0
            window_t0 = time.perf_counter()

        have_predictions = test_iterator is not None and self.cv is not None
        carry: deque = deque()  # consumed but unprocessed batches

        def pull():
            if carry:
                return carry.popleft()
            if train_iterator.has_next():
                return train_iterator.next()
            return None

        stop = False
        with device_trace(cfg.profile_dir):
            while (carry or train_iterator.has_next()) and self.batch_counter < cfg.num_iterations:
                # -- assemble the window (a power of two) ----------------
                wmax = self._window_limit(have_predictions)
                target = 1 << (wmax.bit_length() - 1)
                window = None
                if target > 1 and not carry and hasattr(train_iterator, "next_window"):
                    window = train_iterator.next_window(target)  # one device slice
                if window is not None:
                    n_window = int(window[0].shape[0])
                    images = [int(window[0].shape[1]) * scale] * n_window
                    with self.timer.phase("train_window"):
                        losses = self.train_iterations(*window, **rank_rows)
                else:
                    batches = [pull()]
                    while len(batches) < target:
                        nxt = pull()
                        if nxt is None:
                            break
                        if tuple(nxt.features.shape) != tuple(batches[0].features.shape):
                            carry.appendleft(nxt)  # ragged tail: a later window
                            break
                        batches.append(nxt)
                    keep = 1 << (len(batches).bit_length() - 1)
                    while len(batches) > keep:  # epoch remainder → next turn
                        carry.appendleft(batches.pop())
                    n_window = len(batches)
                    images = [b.num_examples() * scale for b in batches]
                    if n_window == 1:
                        losses = self.train_iteration(batches[0].features, batches[0].labels,
                                                      **rank_rows)
                    else:
                        with self.timer.phase("train_window"):
                            losses = self.train_iterations(
                                _stack([b.features for b in batches]),
                                None if batches[0].labels is None
                                else _stack([b.labels for b in batches]),
                                **rank_rows,
                            )
                pending.append((self.batch_counter, losses, images))
                pending_iters += n_window

                # -- per-iteration epilogue (exports land on window ends) -
                for _ in range(n_window):
                    index = self.batch_counter + 1
                    at_print = self.batch_counter % cfg.print_every == 0
                    if at_print:
                        with self.timer.phase("export_manifold"):
                            self.export_manifold(index)
                    if have_predictions and self.batch_counter % cfg.save_every == 0:
                        with self.timer.phase("export_predictions"):
                            self.export_predictions(test_iterator, index)
                    if at_print and eval_callback is not None:
                        flush()
                        with self.timer.phase("eval_callback"):
                            eval_callback(self, index)
                        window_t0 = time.perf_counter()
                    if cfg.save_models and self.batch_counter % cfg.checkpoint_every == 0:
                        with self.timer.phase("checkpoint"):
                            self.save_models()
                    logger.info("Completed Batch %d!", self.batch_counter)
                    self.batch_counter += 1
                    stop = epilogue_callback is not None and epilogue_callback(self, index) is False
                    if stop:
                        break
                if pending_iters >= max(1, cfg.loss_fetch_every):
                    flush()
                if stop:
                    break
                if not carry and not train_iterator.has_next():
                    train_iterator.reset()  # (:600-602)
        flush()
        if (
            cfg.save_models
            and cfg.checkpoint_every > 1
            and self.batch_counter > 0
            and (self.batch_counter - 1) % cfg.checkpoint_every != 0
        ):
            # final-state checkpoint under a sparse cadence, so resume and
            # publish see the weights the run finished with
            with self.timer.phase("checkpoint"):
                self.save_models()
        return {
            "iterations": self.batch_counter,
            "history": history,
            "timings": dict(self.timer.totals),
        }
