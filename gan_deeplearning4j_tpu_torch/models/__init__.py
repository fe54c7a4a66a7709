"""Model graphs of the PyTorch port (the DCGAN-MNIST, tabular MLP-GAN,
image DCGAN and WGAN-GP families) and the family registry the experiment
builds from."""

from gan_deeplearning4j_tpu_torch.models import dcgan_image, dcgan_mnist, mlp_gan, registry, wgan_gp

__all__ = ["dcgan_image", "dcgan_mnist", "mlp_gan", "registry", "wgan_gp"]
