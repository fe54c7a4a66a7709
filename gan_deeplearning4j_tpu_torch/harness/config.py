"""ExperimentConfig — counterpart of
``gan_deeplearning4j_tpu/harness/config.py``: the reference's
hyperparameter block as one typed config, field for field with the same
defaults, overridable from JSON and argparse.

``validate()`` makes the JAX package's checks, in its order and with its
messages (the WGAN-GP family's, class conditioning's and the distributed
modes' included). ``distributed="pmean"`` (per-step gradient sync,
optionally with ``update_sharding``) and ``"param_averaging"`` run over a
``DataMesh`` (``runtime/environment.py``): the backend and the world size
belong to the mesh the launcher builds, not to this config.
``conditioning="class"`` widens
the generator's input to ``[z | one-hot(class)]`` (``harness/
experiment.py``); the discriminator and the classifier stay
unconditional. ``prefetch > 0``
makes ``run()`` keep that many batches ahead on the device
(``DevicePrefetchIterator``).

Precision, as in the JAX package: ``compute_dtype="bf16"`` runs the dense
and convolution products in bf16 with fp32 accumulation while params stay
fp32 (mixed precision); ``param_dtype="bf16"`` also stores params and
updater state in bf16 and implies ``compute_dtype="bf16"``. Unknown names
raise ``ValueError``.

``use_accelerator`` (the reference's ``useGpu``) picks the device: True
means the card, ``cuda:0``, and raises without CUDA; False means the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Optional, Sequence

from gan_deeplearning4j_tpu_torch.runtime.dtype import parse_compute_dtype


@dataclasses.dataclass
class ExperimentConfig:
    # -- model family ("mnist" is the reference application) -----------------
    model_family: str = "mnist"

    # -- batching & shapes (dl4jGANComputerVision.java:66-81) ---------------
    batch_size_train: int = 200
    batch_size_pred: int = 500
    num_features: int = 784
    num_classes: int = 10
    num_classes_dis: int = 1
    num_iterations: int = 2  # the while-loop bound (:72,408)
    latent_grid: int = 10  # 10×10 sample grid (:74-75)
    height: int = 28
    width: int = 28
    channels: int = 1
    z_size: int = 2

    # -- learning rates & reg (:82-86) --------------------------------------
    dis_learning_rate: float = 0.002
    gen_learning_rate: float = 0.004
    frozen_learning_rate: float = 0.0
    l2: float = 1e-4
    grad_clip: float = 1.0
    seed: int = 666  # (:85)

    # -- cadences & paths (:76-77,87-90) -------------------------------------
    print_every: int = 1
    save_every: int = 1
    data_dir: str = "data"
    output_dir: str = "output"
    file_prefix: str = "mnist"
    save_models: bool = True
    # checkpoint every k-th iteration (the reference: every iteration); a
    # larger k also lets the loop run windows of iterations between saves
    checkpoint_every: int = 1
    resume: bool = False  # restore states from output_dir before training

    # -- model zoo scenario axes ---------------------------------------------
    # "none" | "class": a class-conditional generator takes [z | one-hot],
    # trained on the real batch's labels; the discriminator stays unconditional
    conditioning: str = "none"
    dataset: str = "mnist"  # the identity of the real rows, written to serving.json

    # -- WGAN-GP (ignored by the XENT families) -------------------------------
    n_critic: int = 5
    gp_lambda: float = 10.0

    # -- dis-LR step decay ------------------------------------------------------
    # every `dis_lr_decay_every` iterations the discriminator's effective
    # learning rate is multiplied by `dis_lr_decay_rate` (staircase); 0 = off,
    # the reference's constant rate
    dis_lr_decay_every: int = 0
    dis_lr_decay_rate: float = 1.0

    # -- label softening (:404-406) ------------------------------------------
    label_softening: float = 0.05
    # the reference samples the ±0.05·randn noise once and reuses it every
    # batch; True redraws it every iteration
    resample_label_noise: bool = False

    # -- distributed (the reference's Spark block, :317-330) ------------------
    distributed: str = "none"  # "none" | "pmean" | "param_averaging"
    update_sharding: bool = False
    averaging_frequency: int = 10
    batch_size_per_worker: int = 200
    prefetch: int = 0  # workerPrefetchNumBatches (:328); >0 enables device prefetch
    use_accelerator: bool = True  # the useGpu flag (:92): True = cuda:0, False = CPU
    # None / "f32": full precision; "bf16": dense and convolution products in
    # bf16 with fp32 accumulation, params fp32 (mixed precision)
    compute_dtype: Optional[str] = None
    # None / "f32": fp32 params and updater state; "bf16": both stored in
    # bf16 (implies compute_dtype="bf16" when that is unset)
    param_dtype: Optional[str] = None

    # -- observability --------------------------------------------------------
    metrics_jsonl: Optional[str] = None
    profile_dir: Optional[str] = None  # torch.profiler trace of the run, when set
    # read the loss scalars back from the device once every k iterations, in
    # one batched copy: a per-step read would wait for the device every step
    loss_fetch_every: int = 128

    def __post_init__(self) -> None:
        if self.param_dtype is not None and self.compute_dtype is None:
            if parse_compute_dtype(self.param_dtype) is not None:
                # bf16 storage implies bf16 compute, as in the JAX package
                self.compute_dtype = "bf16"

    def validate(self) -> "ExperimentConfig":
        if self.model_family != "tabular" and self.num_features != (
            self.height * self.width * self.channels
        ):
            raise ValueError(
                f"num_features {self.num_features} != h*w*c "
                f"{self.height * self.width * self.channels}"
            )
        if self.distributed not in ("none", "pmean", "param_averaging"):
            raise ValueError(f"unknown distributed mode {self.distributed!r}")
        if self.update_sharding and self.distributed != "pmean":
            raise ValueError(
                "update_sharding requires distributed='pmean' (the per-step "
                "gradient-sync mesh path); param_averaging workers hold "
                "divergent local updater state and 'none' has no mesh axis "
                "to shard over"
            )
        if self.dis_lr_decay_every < 0:
            raise ValueError("dis_lr_decay_every must be >= 0 (0 = off)")
        if self.checkpoint_every < 1:
            raise ValueError("checkpoint_every must be >= 1")
        if self.dis_lr_decay_every and not 0.0 < self.dis_lr_decay_rate <= 1.0:
            raise ValueError(
                f"dis_lr_decay_rate {self.dis_lr_decay_rate} must be in (0, 1]"
            )
        if self.conditioning not in ("none", "class"):
            raise ValueError(
                f"unknown conditioning {self.conditioning!r} "
                f"(want 'none' or 'class')"
            )
        if self.conditioning == "class":
            if self.num_classes < 2:
                raise ValueError(
                    "class-conditional training needs num_classes >= 2 "
                    "(the one-hot label embedding is the condition)"
                )
            if self.distributed == "param_averaging":
                raise ValueError(
                    "conditioning='class' runs on the fused paths (single-"
                    "chip or pmean); the param-averaging phased path keeps "
                    "the reference's unconditional loop"
                )
        parse_compute_dtype(self.compute_dtype)  # raises on an unknown dtype
        parse_compute_dtype(self.param_dtype)
        from gan_deeplearning4j_tpu_torch.models import registry

        family = registry.get(self.model_family)  # raises on an unknown family
        if family.name == "wgan_gp":
            if self.conditioning == "class":
                raise ValueError(
                    "conditioning='class' is a GraphTrainer-family feature "
                    "(the fused alternating loop concatenates the label "
                    "embedding); the WGAN-GP critic-round program is "
                    "unconditional — queued in ROADMAP.md"
                )
            if self.n_critic < 1 or self.batch_size_train % self.n_critic:
                raise ValueError(
                    f"wgan_gp: batch_size_train {self.batch_size_train} must be "
                    f"divisible by n_critic {self.n_critic}"
                )
            if self.distributed == "param_averaging":
                raise ValueError(
                    "wgan_gp supports distributed='pmean' (per-step sync over "
                    "the mesh); k-step parameter averaging is a reference-"
                    "parity mode for the XENT families"
                )
            if self.update_sharding:
                raise ValueError(
                    "update_sharding is implemented for the GraphTrainer "
                    "families; the WGAN-GP trainer keeps the replicated "
                    "update (its critic-round program is its own)"
                )
        return self

    # -- overrides ------------------------------------------------------------
    @staticmethod
    def from_json(path: str) -> "ExperimentConfig":
        with open(path) as fh:
            return ExperimentConfig(**json.load(fh)).validate()

    def to_json(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump(dataclasses.asdict(self), fh, indent=2)

    @staticmethod
    def parser() -> argparse.ArgumentParser:
        """Argparse with one flag per field (the CLI the reference echoes but
        ignores, made real)."""
        p = argparse.ArgumentParser(
            prog="gan_deeplearning4j_tpu_torch",
            description="GAN experiment, every model family (PyTorch port)",
        )
        p.add_argument("--config", type=str, default=None, help="JSON config file")
        for f in dataclasses.fields(ExperimentConfig):
            arg = "--" + f.name.replace("_", "-")
            if f.type == "bool" or isinstance(f.default, bool):
                p.add_argument(arg, type=lambda s: s.lower() in ("1", "true", "yes"),
                               default=None, metavar="BOOL")
            elif f.default is None or f.type.startswith("Optional"):
                p.add_argument(arg, type=str, default=None)
            else:
                p.add_argument(arg, type=type(f.default), default=None)
        return p

    @staticmethod
    def from_args(argv: Optional[Sequence[str]] = None) -> "ExperimentConfig":
        args = vars(ExperimentConfig.parser().parse_args(argv))
        config_path = args.pop("config", None)
        base = (
            ExperimentConfig.from_json(config_path)
            if config_path
            else ExperimentConfig()
        )
        overrides = {k: v for k, v in args.items() if v is not None}
        return dataclasses.replace(base, **overrides).validate()

