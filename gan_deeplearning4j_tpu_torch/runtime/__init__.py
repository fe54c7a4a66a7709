"""Runtime support for the PyTorch port: device resolution and numerics."""

from gan_deeplearning4j_tpu_torch.runtime.device import (
    pin_deterministic_kernels,
    pin_fp32_precision,
    resolve_device,
)

__all__ = ["pin_deterministic_kernels", "pin_fp32_precision", "resolve_device"]
