"""Evaluation of the PyTorch port: accuracy on exported predictions and the
latent-manifold PNG (the reference notebook's offline checks). FID waits
for ROADMAP.md queue 1, 'Data and eval'."""

from gan_deeplearning4j_tpu_torch.eval.accuracy import accuracy_from_csvs, accuracy_score
from gan_deeplearning4j_tpu_torch.eval.images import render_manifold, tile_images, write_png

__all__ = [
    "accuracy_from_csvs",
    "accuracy_score",
    "render_manifold",
    "tile_images",
    "write_png",
]
