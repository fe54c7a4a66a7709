"""GAN family registry — counterpart of
``gan_deeplearning4j_tpu/models/registry.py``: one handle per model family
with its graph builders, weight-sync maps, synthetic data source and (MNIST
only) the transfer classifier, so the experiment runs any family through
the same alternating loop. WGAN-GP brings its own experiment class.

Families: ``mnist`` (the reference application), ``tabular``, ``image``
(aliases ``cifar10`` and ``celeba64``) and ``wgan_gp``; ``register`` adds a
user-defined one and ``unregister`` removes it (built-ins stay). An unknown
name raises ``KeyError``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from gan_deeplearning4j_tpu_torch.models import dcgan_image, dcgan_mnist, mlp_gan, wgan_gp


@dataclasses.dataclass(frozen=True)
class GanFamily:
    """Uniform model-family handle consumed by GanExperiment."""

    name: str
    make_model_config: Callable  # ExperimentConfig-like -> family config
    build_discriminator: Callable
    build_generator: Callable
    # None for a family with a loop of its own (wgan_gp): make_experiment
    # then supplies the experiment class
    build_gan: Optional[Callable] = None
    sync_maps: Optional[Callable] = None  # family config -> (DIS_TO_GAN, GAN_TO_GEN)
    synthetic_data: Optional[Callable] = None  # (num, family config, seed) -> (N, F) f32
    build_transfer_classifier: Optional[Callable] = None
    dis_to_cv: Optional[Dict[str, str]] = None
    # (ExperimentConfig, mesh) -> an experiment with the GanExperiment surface
    make_experiment: Optional[Callable] = None


def _mnist_config(cfg) -> dcgan_mnist.DcganConfig:
    return dcgan_mnist.DcganConfig(
        height=cfg.height, width=cfg.width, channels=cfg.channels,
        num_features=cfg.num_features, num_classes=cfg.num_classes,
        num_classes_dis=cfg.num_classes_dis, z_size=cfg.z_size,
        dis_learning_rate=cfg.dis_learning_rate,
        gen_learning_rate=cfg.gen_learning_rate,
        frozen_learning_rate=cfg.frozen_learning_rate,
        seed=cfg.seed, l2=cfg.l2, grad_clip=cfg.grad_clip,
    )


def _mnist_synthetic(num: int, model_cfg, seed: int) -> np.ndarray:
    from gan_deeplearning4j_tpu_torch.data.mnist import synthetic_mnist

    (x, _), _ = synthetic_mnist(num_train=num, num_test=1, seed=seed)
    return x


def _mlp_config(cfg) -> mlp_gan.MlpGanConfig:
    return mlp_gan.MlpGanConfig(
        num_features=cfg.num_features, z_size=cfg.z_size,
        dis_learning_rate=cfg.dis_learning_rate,
        gen_learning_rate=cfg.gen_learning_rate,
        frozen_learning_rate=cfg.frozen_learning_rate,
        seed=cfg.seed, l2=cfg.l2, grad_clip=cfg.grad_clip,
    )


def _image_config(cfg) -> dcgan_image.ImageGanConfig:
    return dcgan_image.ImageGanConfig(
        height=cfg.height, width=cfg.width, channels=cfg.channels,
        z_size=cfg.z_size,
        dis_learning_rate=cfg.dis_learning_rate,
        gen_learning_rate=cfg.gen_learning_rate,
        frozen_learning_rate=cfg.frozen_learning_rate,
        seed=cfg.seed, l2=cfg.l2, grad_clip=cfg.grad_clip,
    )


def _wgan_config(cfg) -> wgan_gp.WganGpConfig:
    return wgan_gp.WganGpConfig(
        height=cfg.height, width=cfg.width, channels=cfg.channels,
        z_size=cfg.z_size, seed=cfg.seed,
        n_critic=cfg.n_critic, gp_lambda=cfg.gp_lambda,
    )


def _wgan_experiment(cfg, mesh):
    from gan_deeplearning4j_tpu_torch.harness.wgan_experiment import WganGpExperiment

    return WganGpExperiment(cfg, mesh=mesh)


_FAMILIES: Dict[str, GanFamily] = {
    "mnist": GanFamily(
        name="mnist",
        make_model_config=_mnist_config,
        build_discriminator=dcgan_mnist.build_discriminator,
        build_generator=dcgan_mnist.build_generator,
        build_gan=dcgan_mnist.build_gan,
        sync_maps=lambda cfg: (dcgan_mnist.DIS_TO_GAN, dcgan_mnist.GAN_TO_GEN),
        synthetic_data=_mnist_synthetic,
        build_transfer_classifier=dcgan_mnist.build_transfer_classifier,
        dis_to_cv=dcgan_mnist.DIS_TO_CV,
    ),
    "tabular": GanFamily(
        name="tabular",
        make_model_config=_mlp_config,
        build_discriminator=mlp_gan.build_discriminator,
        build_generator=mlp_gan.build_generator,
        build_gan=mlp_gan.build_gan,
        sync_maps=mlp_gan.sync_maps,
        synthetic_data=lambda num, cfg, seed: mlp_gan.synthetic_transactions(
            num, num_features=cfg.num_features, seed=seed
        ),
    ),
    "image": GanFamily(
        name="image",
        make_model_config=_image_config,
        build_discriminator=dcgan_image.build_discriminator,
        build_generator=dcgan_image.build_generator,
        build_gan=dcgan_image.build_gan,
        sync_maps=dcgan_image.sync_maps,
        synthetic_data=lambda num, cfg, seed: dcgan_image.synthetic_images(num, cfg, seed=seed),
    ),
    "wgan_gp": GanFamily(
        name="wgan_gp",
        make_model_config=_wgan_config,
        build_discriminator=wgan_gp.build_critic,
        build_generator=wgan_gp.build_generator,
        synthetic_data=lambda num, cfg, seed: dcgan_image.synthetic_images(num, cfg, seed=seed),
        make_experiment=_wgan_experiment,
    ),
}
# BASELINE.md config aliases
_ALIASES = {"cifar10": "image", "celeba64": "image"}
_BUILTINS = frozenset(_FAMILIES)


def register(family: GanFamily, *, overwrite: bool = False) -> GanFamily:
    """Add a user-defined family to the registry; the experiment harness
    and the CLI then accept ``family.name`` like a built-in one."""
    if family.name in _ALIASES:
        # get() resolves aliases first: a family of that name would be unreachable
        raise ValueError(
            f"family name {family.name!r} collides with the "
            f"{_ALIASES[family.name]!r} alias"
        )
    if family.name in _BUILTINS:
        # unregister refuses built-ins, so a replaced one could not come back
        raise ValueError(f"cannot replace built-in family {family.name!r}")
    if family.name in _FAMILIES and not overwrite:
        raise ValueError(f"family {family.name!r} already registered")
    _FAMILIES[family.name] = family
    return family


def unregister(name: str) -> None:
    """Remove a user-registered family; built-ins stay."""
    if name in _BUILTINS:
        raise ValueError(f"cannot unregister built-in family {name!r}")
    _FAMILIES.pop(name, None)


def names() -> Tuple[str, ...]:
    return tuple(_FAMILIES) + tuple(_ALIASES)


def get(name: str) -> GanFamily:
    key = _ALIASES.get(name, name)
    if key not in _FAMILIES:
        raise KeyError(f"unknown model family {name!r}; known: {sorted(names())}")
    return _FAMILIES[key]
