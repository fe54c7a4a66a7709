"""Evaluation of the PyTorch port: accuracy on exported predictions, the
latent-manifold PNG (the reference notebook's offline checks), the FID
harness and the seeded quality probe the deploy canary runs.
``inception_feature_fn`` and ``quick_fid_scorer`` wait for ROADMAP.md
queue 1, 'Data and eval'."""

from gan_deeplearning4j_tpu_torch.eval.accuracy import accuracy_from_csvs, accuracy_score
from gan_deeplearning4j_tpu_torch.eval.fid import (
    FeatureStats,
    fid_from_stats,
    fid_score,
    frozen_feature_fn,
    graph_feature_fn,
)
from gan_deeplearning4j_tpu_torch.eval.images import render_manifold, tile_images, write_png
from gan_deeplearning4j_tpu_torch.eval.quality import quality_probe, sample_generator_rows

__all__ = [
    "accuracy_from_csvs",
    "accuracy_score",
    "FeatureStats",
    "fid_from_stats",
    "fid_score",
    "frozen_feature_fn",
    "graph_feature_fn",
    "quality_probe",
    "render_manifold",
    "sample_generator_rows",
    "tile_images",
    "write_png",
]
