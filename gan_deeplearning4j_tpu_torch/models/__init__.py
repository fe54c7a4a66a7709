"""Model graphs of the PyTorch port (the DCGAN-MNIST family so far) and
the family registry the experiment builds from."""

from gan_deeplearning4j_tpu_torch.models import dcgan_mnist, registry

__all__ = ["dcgan_mnist", "registry"]
