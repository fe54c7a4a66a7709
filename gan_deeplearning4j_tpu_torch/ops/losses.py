"""Loss functions — counterpart of ``gan_deeplearning4j_tpu/ops/losses.py``.

The reference uses XENT on sigmoid outputs (discriminator and stacked GAN)
and MCXENT on softmax outputs (the transfer classifier). DL4J clips the
probabilities to ``[1e-5, 1-1e-5]`` before the log, and its score is the
mean over the batch of the per-example loss summed over features. So
these are not ``F.binary_cross_entropy``, which clamps the log at -100 and
averages over elements.

The clip is ``minimum(hi, maximum(lo, p))``, as ``jnp.clip`` computes it,
so that the gradient at a probability exactly on a bound is split as in
the reference (``torch.clamp`` would pass all of it).

``wasserstein`` is the WGAN critic's score loss; ``gradient_penalty`` is
WGAN-GP's penalty, a gradient of the critic's input gradient, which
``torch.autograd.grad(..., create_graph=True)`` differentiates again.
"""

from __future__ import annotations

import torch

XENT_CLIP_EPS = 1e-5

def _clip(p, eps: float):
    lo = torch.full((), eps, dtype=p.dtype, device=p.device)
    hi = torch.full((), 1.0 - eps, dtype=p.dtype, device=p.device)
    return torch.minimum(hi, torch.maximum(lo, p))


def _per_example_mean(per_element):
    """Sum over every axis but the batch axis, then mean over the batch.
    (``sum(dim=())`` would reduce every axis, so 1-D input skips it.)"""
    if per_element.ndim > 1:
        per_element = torch.sum(per_element, dim=tuple(range(1, per_element.ndim)))
    return torch.mean(per_element)


def binary_xent(probs, labels, *, eps: float = XENT_CLIP_EPS):
    """XENT on sigmoid outputs (probabilities), DL4J LossBinaryXENT."""
    p = _clip(probs, eps)
    return _per_example_mean(-(labels * torch.log(p) + (1.0 - labels) * torch.log(1.0 - p)))


def categorical_xent(probs, labels, *, eps: float = XENT_CLIP_EPS):
    """MCXENT on softmax outputs (probabilities), DL4J LossMCXENT."""
    p = _clip(probs, eps)
    return torch.mean(-torch.sum(labels * torch.log(p), dim=-1))


def mse(preds, labels):
    return _per_example_mean((preds - labels) ** 2)


def wasserstein(critic_scores, labels):
    """Wasserstein critic loss: labels are +1 (real) and -1 (fake), so this
    minimizes -E[D(real)] + E[D(fake)]."""
    return -torch.mean(critic_scores * labels)


def gradient_penalty(critic_fn, real, fake, epsilon, *, target: float = 1.0):
    """WGAN-GP penalty E[(‖∇_x D(x̂)‖₂ − target)²] at x̂ = ε·real + (1−ε)·fake.

    ``critic_fn`` maps a batch to per-example scores; ``epsilon`` has shape
    ``(B, 1, ...)`` and is drawn by the caller (the JAX package draws it
    inside, from a key the caller passes). The input gradient is taken with
    ``create_graph=True``, so the penalty is differentiable in the critic's
    params. The 1e-12 sits inside the square root, as in the reference, so
    the norm's derivative at a zero gradient is 0, not 0/0."""
    with torch.enable_grad():
        x_hat = epsilon * real + (1.0 - epsilon) * fake
        if not x_hat.requires_grad:
            x_hat.requires_grad_(True)
        scores = torch.sum(critic_fn(x_hat))
        grads = None
        if scores.requires_grad:
            (grads,) = torch.autograd.grad(scores, x_hat, create_graph=True, allow_unused=True)
        if grads is None:  # a critic that does not read its input
            grads = torch.zeros_like(x_hat)
        norms = torch.sqrt(torch.sum(grads ** 2, dim=tuple(range(1, grads.ndim))) + 1e-12)
        return torch.mean((norms - target) ** 2)


_REGISTRY = {
    "xent": binary_xent,
    "binary_xent": binary_xent,
    "mcxent": categorical_xent,
    "categorical_xent": categorical_xent,
    "mse": mse,
    "wasserstein": wasserstein,
}


def get(name_or_fn):
    if callable(name_or_fn):
        return name_or_fn
    key = str(name_or_fn).lower()
    if key not in _REGISTRY:
        raise KeyError(f"unknown loss {name_or_fn!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[key]
