"""Model graphs of the PyTorch port (the DCGAN-MNIST family so far)."""

from gan_deeplearning4j_tpu_torch.models import dcgan_mnist

__all__ = ["dcgan_mnist"]
