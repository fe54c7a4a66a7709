"""Native (C++) pieces of the port around its compute path, bound with
ctypes: the CSV reader and writer (``csv_loader``), counterpart of the JAX
package's ``native/``. Built with g++ at first use; where no toolchain
exists the data layer (``data/records.py``) reads and writes with numpy."""

from gan_deeplearning4j_tpu_torch.native import build, csv_loader

__all__ = ["build", "csv_loader"]
