"""Utilities of the PyTorch port: checkpoints in the JAX package's zip
format, and the serving pipeline's stage timing."""

from gan_deeplearning4j_tpu_torch.utils.serializer import member_digest, read_model, write_model

__all__ = ["member_digest", "read_model", "write_model"]
