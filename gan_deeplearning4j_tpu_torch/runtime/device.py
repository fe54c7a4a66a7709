"""Device resolution and fp32 numerics for the PyTorch port.

Counterpart of ``gan_deeplearning4j_tpu/runtime/environment.py`` for the
one thing the serving path needs from it: which device runs the model.

- ``resolve_device(None)`` is the card, ``cuda:0``. When CUDA is absent it
  raises: an entry point never continues on the CPU by itself. The CPU
  path exists only for a caller that passes ``device="cpu"`` (the tests).
- ``resolve_devices(device, replicas, devices)`` is the counterpart of the
  JAX engine's ``jax.local_devices()[:replicas]``: the serving engine's
  tuple of replica devices.
- ``pin_fp32_precision()`` makes fp32 convolutions and matmuls run in full
  fp32 on the card. cuDNN's default lets fp32 convolutions run in TF32
  (about three decimal digits), while the JAX reference computes them in
  fp32; with TF32 on, the port would drift from the reference by ~1e-3.
- ``pin_deterministic_kernels()`` makes cuDNN pick deterministic
  algorithms only, with no autotuning, so that a training run replays bit
  for bit on the same card (resume is exact).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence, Tuple, Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for another one. Raises ``RuntimeError`` when CUDA is requested (or
    defaulted to) and absent."""
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "port on the CPU explicitly"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def resolve_devices(device: DeviceLike = None, replicas=1,
                    devices: Optional[Sequence[DeviceLike]] = None) -> Tuple[torch.device, ...]:
    """The devices of a multi-replica serving engine, one per replica.

    - On the card (``device`` None or CUDA): the cards from ``device``'s
      index on (``cuda:0 ... cuda:R-1`` for the default), one replica
      each. ``replicas=None`` or ``"all"`` takes every one of them.
    - ``device="cpu"``: one device, so one replica.
    - ``devices=``: an explicit pool of devices, which may repeat one, in
      place of the cards. It is the counterpart of the JAX tests' forced
      host devices (XLA's ``--xla_force_host_platform_device_count``):
      ``devices=("cpu", "cpu"), replicas=2`` is two replicas on the CPU,
      and ``devices=("cuda:0", "cuda:0"), replicas=2`` two replicas on one
      card, each with its own stream, graph pool and captures. ``device``
      is ignored then.

    Either way ``replicas`` takes the first R devices of the pool, as the
    JAX engine takes ``jax.local_devices()[:replicas]``.

    ``replicas`` above the devices available raises ``ValueError`` with the
    JAX engine's wording; requesting CUDA without a card raises
    ``RuntimeError`` as :func:`resolve_device` does (no fallback to the
    CPU)."""
    if devices is not None:
        pool = [resolve_device(d) for d in devices]
    else:
        first = resolve_device(device)
        if first.type == "cuda":
            pool = [torch.device("cuda", i) for i in range(first.index, torch.cuda.device_count())]
        else:
            pool = [first]
    if replicas is None or replicas == "all":
        replicas = len(pool)
    replicas = int(replicas)
    if not 1 <= replicas <= len(pool):
        raise ValueError(f"replicas={replicas} but {len(pool)} local device(s) are available")
    return tuple(pool[:replicas])


def pin_fp32_precision() -> None:
    """Run fp32 convolutions and matmuls in full fp32 (no TF32), process
    wide. Idempotent; called by the serving engine at load for fp32
    bundles."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def pin_deterministic_kernels() -> None:
    """cuDNN: deterministic algorithms only (its default may pick weight-
    gradient algorithms that accumulate with atomics) and no benchmark-mode
    autotuning, whose choice can differ between runs. cuBLAS: one fixed
    workspace configuration (``CUBLAS_WORKSPACE_CONFIG``, unless the caller
    set one), read when a handle's workspace is first made: a captured
    iteration runs on a side stream with a workspace of its own, and its
    GEMMs must pick what the eager ones pick. Process wide; idempotent;
    called by the trainer when it runs on the card, so set before its
    first GEMM."""
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
