"""Device resolution and fp32 numerics for the PyTorch port.

Counterpart of ``gan_deeplearning4j_tpu/runtime/environment.py`` for the
one thing the serving path needs from it: which device runs the model.

- ``resolve_device(None)`` is the card, ``cuda:0``. When CUDA is absent it
  raises: an entry point never continues on the CPU by itself. The CPU
  path exists only for a caller that passes ``device="cpu"`` (the tests).
- ``pin_fp32_precision()`` makes fp32 convolutions and matmuls run in full
  fp32 on the card. cuDNN's default lets fp32 convolutions run in TF32
  (about three decimal digits), while the JAX reference computes them in
  fp32; with TF32 on, the port would drift from the reference by ~1e-3.
- ``pin_deterministic_kernels()`` makes cuDNN pick deterministic
  algorithms only, with no autotuning, so that a training run replays bit
  for bit on the same card (resume is exact).
"""

from __future__ import annotations

from typing import Union

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
    autotuning, whose choice can differ between runs. Process wide;
    idempotent; called by the trainer when it runs on the card."""
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
