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

The iteration runs eagerly: every op goes to PyTorch's kernels (cuDNN,
cuBLAS, ATen) on the experiment's device. The losses stay on the device
until ``run()`` reads a window of them back in one copy. Each stage is a
``torch.profiler.record_function`` range (``iteration.sample_fake``,
``iteration.dis_real``, ``iteration.dis_fake``, ``iteration.gan``,
``iteration.cv``), so a profiler trace splits the iteration's host and
device time by stage.

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

Not ported yet, each raising with its ROADMAP.md item: meshes and the
parameter-averaging path ('Parallel training'), mesh-sharded checkpoints
and store publishing ('The operations planes').
"""

from __future__ import annotations

import logging
import os
import re
import time
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from gan_deeplearning4j_tpu_torch.data import write_csv
from gan_deeplearning4j_tpu_torch.harness.config import ExperimentConfig
from gan_deeplearning4j_tpu_torch.models import registry
from gan_deeplearning4j_tpu_torch.nn import ComputationGraph
from gan_deeplearning4j_tpu_torch.nn.layers import (
    BatchNormalization,
    ConvolutionLayer,
    Deconvolution2D,
    DenseLayer,
)
from gan_deeplearning4j_tpu_torch.parallel import GraphTrainer, TrainState
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
from gan_deeplearning4j_tpu_torch.utils.serializer import ModelSerializer, read_model, write_model

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


def experiment_device(cfg: ExperimentConfig) -> torch.device:
    """The device ``config.use_accelerator`` asks for; on the card, fp32
    runs with TF32 off and cuDNN restricted to deterministic algorithms."""
    device = resolve_device(None if cfg.use_accelerator else "cpu")
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
        if mesh is not None:
            raise NotImplementedError(
                "mesh experiments are not ported yet: ROADMAP.md queue 1, 'Parallel training'"
            )
        self.config = config.validate()
        cfg = config
        self.device = dev = experiment_device(cfg)
        self.family = registry.get(cfg.model_family)
        self.model_cfg = self.family.make_model_config(cfg)
        self.dis_to_gan, self.gan_to_gen = self.family.sync_maps(self.model_cfg)

        # the three graphs + the transfer classifier (mnist only); gen and
        # gan are initialised separately, as in the reference
        self.dis = self.family.build_discriminator(self.model_cfg)
        self.gen = self.family.build_generator(self.model_cfg)
        self.gan = self.family.build_gan(self.model_cfg)
        dis_params = self.dis.init(device=dev)
        self.dis_trainer = GraphTrainer(self.dis)
        self.gan_trainer = GraphTrainer(self.gan)
        self.dis_state = self.dis_trainer.init_state(params=dis_params)
        self.gan_state = self.gan_trainer.init_state(device=dev)
        self.cv = self.cv_trainer = self.cv_state = None
        if self.family.build_transfer_classifier is not None:
            self.cv, cv_params = self.family.build_transfer_classifier(
                self.dis, dis_params, self.model_cfg
            )
            self.cv_trainer = GraphTrainer(self.cv)
            self.cv_state = self.cv_trainer.init_state(params=cv_params)
        self.gen_params = self.gen.init(device=dev)
        self._compute_dtype = parse_compute_dtype(cfg.compute_dtype)
        self._param_dtype = parse_compute_dtype(cfg.param_dtype)
        self.dis_state = self._cast_state(self.dis_state)
        self.gan_state = self._cast_state(self.gan_state)
        self.cv_state = self._cast_state(self.cv_state)
        self.gen_params = self._cast_state(self.gen_params)

        # label-softening noise, sampled once like the reference (:404-406)
        self._noise_rng = np.random.default_rng(cfg.seed)
        b = cfg.batch_size_train
        self._eps_real = self._soft_noise(b)
        self._eps_fake = self._soft_noise(b)
        self._soft_cache: Dict[int, tuple] = {}
        self._z_grid = latent_grid(cfg.latent_grid, cfg.z_size)
        self.z_source = self._draw_z

        self.timer = PhaseTimer()
        self.metrics = MetricsLogger(cfg.metrics_jsonl)
        self.batch_counter = 0
        self._epilogue_active = False

    # -- randomness -------------------------------------------------------
    def _soft_noise(self, n: int) -> np.ndarray:
        return self.config.label_softening * self._noise_rng.standard_normal((n, 1)).astype(np.float32)

    def _draw_z(self, dis_step: int, batch: int) -> torch.Tensor:
        """The default z source: ``(2, batch, z_size)`` uniform in [−1, 1)
        (z for the fakes, then z for the generator step), drawn on the CPU
        from the step's generator into pinned memory when the run is on the
        card."""
        g = step_generator(self.config.seed + 2, dis_step)
        z = torch.rand((2, batch, self.model_cfg.z_size), generator=g,
                       pin_memory=self.device.type == "cuda")
        return z.mul_(2.0).sub_(1.0)

    def _resampled_soft_labels(self, dis_step: int, batch: int):
        """Fresh (1+ε, 0+ε) for ``resample_label_noise``, from the step's
        own generator on a separate key."""
        g = step_generator(self.config.seed + 3, dis_step)
        eps = self.config.label_softening * torch.randn((2, batch, 1), generator=g)
        eps = eps.to(self.device)
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
        """Fixed softened labels (1+ε, 0+ε) for batch size ``b``, resident on
        the device, cached per batch size."""
        if b not in self._soft_cache:
            eps_r, eps_f = self._eps_slices(b)
            self._soft_cache[b] = (
                torch.from_numpy(1.0 + eps_r).to(self.device),
                torch.from_numpy(0.0 + eps_f).to(self.device),
            )
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
        """Host rows (batches, z, ε) as float32 on the device: they are
        never cast to the param dtype."""
        return torch.as_tensor(x, dtype=torch.float32).to(self.device, non_blocking=True)

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
    def _fused(self, real_f: torch.Tensor, real_l: torch.Tensor) -> torch.Tensor:
        """One alternating iteration on device tensors; returns the
        ``(d_loss, g_loss, cv_loss)`` device vector."""
        with compute_dtype_scope(self._compute_dtype):
            return self._fused_in_scope(real_f, real_l)

    def _fused_in_scope(self, real_f: torch.Tensor, real_l: torch.Tensor) -> torch.Tensor:
        cfg = self.config
        b = real_f.shape[0]
        step = self.dis_state.step
        z = self._to_device(self.z_source(step, b))
        if cfg.resample_label_noise:
            soft1, soft0 = self._resampled_soft_labels(step, b)
        else:
            soft1, soft0 = self._soft_labels(b)
        dis_scale = self._dis_lr_scale(step)
        # (a) fake batch from the frozen sampler
        with torch.no_grad(), record_function("iteration.sample_fake"):
            fake = self.gen.output(self.gen_params, z[0], train=False).reshape(real_f.shape)
        # (b) dis fit: real→soft1 then fake→soft0, two optimizer steps
        with record_function("iteration.dis_real"):
            self.dis_state, d1 = self.dis_trainer.train_step(self.dis_state, real_f, soft1, dis_scale)
        with record_function("iteration.dis_fake"):
            self.dis_state, d2 = self.dis_trainer.train_step(self.dis_state, fake, soft0, dis_scale)
        # (c) dis → gan frozen tail
        self.gan_state = _rebind(self.dis_state, self.gan_state, self.dis_to_gan)
        # (d) generator step through the frozen D on [z, ones]
        ones = torch.ones((b, 1), dtype=torch.float32, device=self.device)
        with record_function("iteration.gan"):
            self.gan_state, g = self.gan_trainer.train_step(self.gan_state, z[1], ones)
        # (e) gan → gen refresh; dis → classifier features
        self.gen_params = ComputationGraph.copy_params(
            self.gan_state.params, self.gen_params, self.gan_to_gen
        )
        if self.cv is None:
            c = torch.full((), float("nan"), device=self.device)
        else:
            self.cv_state = _rebind(self.dis_state, self.cv_state, self.family.dis_to_cv)
            # (f) classifier step on the real labelled batch
            with record_function("iteration.cv"):
                self.cv_state, c = self.cv_trainer.train_step(self.cv_state, real_f, real_l)
        return torch.stack([(d1 + d2) / 2.0, g, c])

    def train_iteration(self, real_features, real_labels) -> Dict:
        """One full alternating iteration. Inputs: features (B, num_features)
        in [0,1] and one-hot labels (B, classes), host arrays or tensors.
        Returns device scalars (no host read)."""
        with self.timer.phase("train_fused"):
            losses = self._fused(self._to_device(real_features), self._to_device(real_labels))
        return {"d_loss": losses[0], "g_loss": losses[1], "cv_loss": losses[2]}

    def train_iterations(self, features, labels) -> Dict:
        """K iterations over a ``(K, B, num_features)`` / ``(K, B, classes)``
        window, moved to the device once; identical math to K calls of
        ``train_iteration``. Returns ``(K,)`` device loss vectors."""
        feats, labs = self._to_device(features), self._to_device(labels)
        rows = torch.stack([self._fused(feats[k], labs[k]) for k in range(feats.shape[0])])
        return {"d_loss": rows[:, 0], "g_loss": rows[:, 1], "cv_loss": rows[:, 2]}

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
        with torch.no_grad(), compute_dtype_scope(self._compute_dtype):
            out = self.gen.output(self.gen_params, self._to_device(self._z_grid), train=False)
        out = out.cpu().numpy().reshape(self._z_grid.shape[0], cfg.num_features)
        os.makedirs(cfg.output_dir, exist_ok=True)
        path = os.path.join(cfg.output_dir, f"{cfg.file_prefix}_out_{index}.csv")
        write_csv(path, out, precision=6)
        return path

    def export_predictions(self, test_iterator, index: int) -> str:
        """Batched test-set inference → ``{prefix}_test_predictions_{index}.csv``."""
        cfg = self.config
        if self.cv is None:
            raise ValueError(
                f"family {self.family.name!r} has no transfer classifier to predict with"
            )
        test_iterator.reset()
        chunks: List[np.ndarray] = []
        while test_iterator.has_next():
            batch = test_iterator.next()
            with compute_dtype_scope(self._compute_dtype):
                out = self.cv_trainer.output(self.cv_state, self._to_device(batch.features))
            chunks.append(out.cpu().numpy())
        preds = np.vstack(chunks) if chunks else np.zeros((0, cfg.num_classes))
        os.makedirs(cfg.output_dir, exist_ok=True)
        path = os.path.join(cfg.output_dir, f"{cfg.file_prefix}_test_predictions_{index}.csv")
        write_csv(path, preds, precision=6)
        return path

    # -- checkpoints ------------------------------------------------------
    def _publish_step(self) -> int:
        """The step counter published artifacts are labelled with (the gan
        graph steps once per iteration)."""
        return int(self.gan_state.step)

    def digest_states(self) -> Dict:
        """Every trained state, by model name: what bit-exactness checks
        compare (``flatten_states`` flattens it)."""
        states = {"dis": self.dis_state, "gan": self.gan_state, "gen": self.gen_params}
        if self.cv is not None:
            states["CV"] = self.cv_state
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
        os.makedirs(directory, exist_ok=True)
        out = []
        models = [
            ("dis", self.dis, self.dis_state),
            ("gan", self.gan, self.gan_state),
            ("gen", self.gen, self.gen_params),
        ]
        if self.cv is not None:
            models.append(("CV", self.cv, self.cv_state))
        for name, graph, state in models:
            path = os.path.join(directory, f"{cfg.file_prefix}_{name}_model.zip")
            write_model(path, graph, state, save_updater=True)
            out.append(path)
        return out

    def load_models(self, directory: Optional[str] = None) -> int:
        """Resume: restore every state ``save_models`` wrote (params, updater
        state, step), from either package. Returns the restored iteration
        count. A bf16 checkpoint restores as bf16; under bf16 storage an
        fp32 checkpoint is cast on entry."""
        cfg = self.config
        directory = directory or cfg.output_dir
        if any(_MESH_SHARD_RE.search(n) and n.startswith(cfg.file_prefix)
               for n in os.listdir(directory)):
            raise NotImplementedError(
                f"mesh-sharded checkpoints are not ported yet: {_OPERATIONS_WAITS}"
            )
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
        its storage dtype."""
        return self._cast_state(ModelSerializer.restore_train_state(path, trainer, device=self.device))

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
        os.makedirs(directory, exist_ok=True)
        gen_name = f"{cfg.file_prefix}_gen_serving.zip"
        write_model(os.path.join(directory, gen_name), self.gen, self.gen_params, save_updater=False)
        cv_name = feature_vertex = None
        if self.cv is not None:
            cv_name = f"{cfg.file_prefix}_CV_serving.zip"
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
        ``False`` return stops the loop cleanly."""
        cfg = self.config
        self._epilogue_active = epilogue_callback is not None
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
                batches = [pull()]
                while len(batches) < target:
                    nxt = pull()
                    if nxt is None:
                        break
                    if np.shape(nxt.features) != np.shape(batches[0].features):
                        carry.appendleft(nxt)  # ragged tail: a later window
                        break
                    batches.append(nxt)
                keep = 1 << (len(batches).bit_length() - 1)
                while len(batches) > keep:  # epoch remainder → next turn
                    carry.appendleft(batches.pop())
                n_window = len(batches)
                images = [b.num_examples() for b in batches]
                if n_window == 1:
                    losses = self.train_iteration(batches[0].features, batches[0].labels)
                else:
                    with self.timer.phase("train_window"):
                        losses = self.train_iterations(
                            np.stack([b.features for b in batches]),
                            np.stack([b.labels for b in batches]),
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
