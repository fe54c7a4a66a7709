"""Runtime support for the PyTorch port: device resolution, numerics, the
process group and data mesh (``environment.py``), the JAX package's key
stream (``threefry.py``, ``prng.py::RngStream``) and the array factory
(``factory.py``)."""

from gan_deeplearning4j_tpu_torch.runtime.device import (
    pin_deterministic_kernels,
    pin_fp32_precision,
    resolve_device,
)
from gan_deeplearning4j_tpu_torch.runtime.environment import (
    DataMesh,
    backend_info,
    initialize_distributed,
    make_mesh,
)
from gan_deeplearning4j_tpu_torch.runtime.prng import RngStream
from gan_deeplearning4j_tpu_torch.runtime.dtype import (
    cast_float_leaves,
    compute_dtype_scope,
    default_dtype_scope,
    get_compute_dtype,
    get_default_dtype,
    parse_compute_dtype,
    set_compute_dtype,
    set_default_dtype,
    weak_scalar,
)

__all__ = [
    "DataMesh",
    "RngStream",
    "backend_info",
    "initialize_distributed",
    "make_mesh",
    "cast_float_leaves",
    "compute_dtype_scope",
    "default_dtype_scope",
    "get_compute_dtype",
    "get_default_dtype",
    "parse_compute_dtype",
    "pin_deterministic_kernels",
    "pin_fp32_precision",
    "resolve_device",
    "set_compute_dtype",
    "set_default_dtype",
    "weak_scalar",
]
