"""GAN family registry — counterpart of
``gan_deeplearning4j_tpu/models/registry.py``: one handle per model family
with its graph builders, weight-sync maps and (MNIST only) the transfer
classifier, so the experiment runs any family through the
same alternating loop.

The port has the ``mnist`` family, the reference application. The JAX
package's other families (``tabular``, ``image`` and its aliases,
``wgan_gp``) raise ``NotImplementedError`` naming the ROADMAP item that
brings them; an unknown name raises ``KeyError``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

from gan_deeplearning4j_tpu_torch.models import dcgan_mnist


@dataclasses.dataclass(frozen=True)
class GanFamily:
    """Uniform model-family handle consumed by GanExperiment."""

    name: str
    make_model_config: Callable  # ExperimentConfig-like -> family config
    build_discriminator: Callable
    build_generator: Callable
    build_gan: Optional[Callable] = None
    sync_maps: Optional[Callable] = None  # family config -> (DIS_TO_GAN, GAN_TO_GEN)
    build_transfer_classifier: Optional[Callable] = None
    dis_to_cv: Optional[Dict[str, str]] = None


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


_FAMILIES: Dict[str, GanFamily] = {
    "mnist": GanFamily(
        name="mnist",
        make_model_config=_mnist_config,
        build_discriminator=dcgan_mnist.build_discriminator,
        build_generator=dcgan_mnist.build_generator,
        build_gan=dcgan_mnist.build_gan,
        sync_maps=lambda cfg: (dcgan_mnist.DIS_TO_GAN, dcgan_mnist.GAN_TO_GEN),
        build_transfer_classifier=dcgan_mnist.build_transfer_classifier,
        dis_to_cv=dcgan_mnist.DIS_TO_CV,
    ),
}
#: the JAX package's families that the port does not have yet
_NOT_YET_PORTED = ("tabular", "image", "wgan_gp")
_ALIASES = {"cifar10": "image", "celeba64": "image"}


def names() -> Tuple[str, ...]:
    return tuple(_FAMILIES) + _NOT_YET_PORTED + tuple(_ALIASES)


def get(name: str) -> GanFamily:
    key = _ALIASES.get(name, name)
    if key in _NOT_YET_PORTED:
        raise NotImplementedError(
            f"model family {name!r} is not ported yet: ROADMAP.md queue 1, 'Other families'"
        )
    if key not in _FAMILIES:
        raise KeyError(f"unknown model family {name!r}; known: {sorted(names())}")
    return _FAMILIES[key]
