"""Evaluation of the PyTorch port: accuracy on exported predictions and
in process, the latent-manifold PNG (the reference notebook's offline
checks), the FID harness (the frozen, Inception-schema and graph feature
spaces, the quick-FID tracker), the seeded quality probe the deploy
canary runs, and the quality run (``python -m
gan_deeplearning4j_tpu_torch.eval.quality_run``)."""

from gan_deeplearning4j_tpu_torch.eval.accuracy import (
    accuracy_from_csvs,
    accuracy_score,
    evaluate_classifier,
)
from gan_deeplearning4j_tpu_torch.eval.fid import (
    FeatureStats,
    fid_from_stats,
    fid_score,
    frozen_feature_fn,
    graph_feature_fn,
    inception_feature_fn,
    quick_fid_scorer,
)
from gan_deeplearning4j_tpu_torch.eval.images import render_manifold, tile_images, write_png
from gan_deeplearning4j_tpu_torch.eval.quality import quality_probe, sample_generator_rows

__all__ = [
    "accuracy_from_csvs",
    "accuracy_score",
    "evaluate_classifier",
    "FeatureStats",
    "fid_from_stats",
    "fid_score",
    "frozen_feature_fn",
    "graph_feature_fn",
    "inception_feature_fn",
    "quick_fid_scorer",
    "quality_probe",
    "render_manifold",
    "sample_generator_rows",
    "tile_images",
    "write_png",
]
