"""Trainer CLI — ``python -m gan_deeplearning4j_tpu_torch [flags]``, the
counterpart of ``python -m gan_deeplearning4j_tpu``, with the same flags
(one per ``ExperimentConfig`` field, see ``--help``) and the same outputs:
the manifold CSVs, the checkpoints and ``DCGAN_Generated_Images.png``, and
for ``mnist`` (the one family with a transfer classifier) the prediction
CSVs and the accuracy line. ``--model-family`` picks ``mnist``,
``tabular``, ``image`` (or ``cifar10`` / ``celeba64``) or ``wgan_gp``; the
shape flags (``--height``, ``--width``, ``--channels``, ``--num-features``)
must match the family's data. ``--conditioning class`` trains a
class-conditional generator (``mnist`` and ``image``) on the labelled
rows, e.g. ``python -m gan_deeplearning4j_tpu_torch --conditioning class
--num-iterations 10``.

It runs on the card (``cuda:0``) and raises without CUDA unless
``--use-accelerator false`` asks for the CPU. Data: reference-format CSVs
under ``--data-dir`` are used if present; otherwise, for ``mnist``,
``prepare_mnist`` writes them there (real MNIST on disk > scikit-learn
digits > synthetic), and for the other families the family's synthetic
source does.
"""

from __future__ import annotations

import logging
import os
import re
import sys

import torch

from gan_deeplearning4j_tpu_torch.data import (
    CSVRecordReader,
    FileSplit,
    RecordReaderDataSetIterator,
    prepare_mnist,
    write_csv,
)
from gan_deeplearning4j_tpu_torch.harness import ExperimentConfig, make_experiment


def _csv_iterator(path: str, batch: int, label_index: int, num_classes: int):
    reader = CSVRecordReader(0, ",")
    reader.initialize(FileSplit(path))
    return RecordReaderDataSetIterator(reader, batch, label_index, num_classes)


def _prepare_synthetic(config: ExperimentConfig, experiment) -> None:
    """The family's synthetic CSVs (features…, label) for a non-MNIST
    family: two training batches and one prediction batch of rows, labels
    cycling over the classes."""
    import numpy as np

    os.makedirs(config.data_dir, exist_ok=True)
    for split, n, seed in (("train", 2 * config.batch_size_train, 0),
                           ("test", config.batch_size_pred, 1)):
        feats = experiment.family.synthetic_data(n, experiment.model_cfg, seed)
        labels = (np.arange(n) % config.num_classes).reshape(-1, 1).astype(np.float32)
        path = os.path.join(config.data_dir, f"{config.file_prefix}_{split}.csv")
        write_csv(path, np.hstack([feats, labels]), precision=6)


def _latest(directory: str, prefix: str, pattern: str):
    """Highest-index export ``{prefix}_{pattern}_{N}.csv`` (exports follow
    the print/save cadences, so the last iteration may have none)."""
    candidates = []
    for name in os.listdir(directory):
        m = re.fullmatch(re.escape(prefix) + "_" + pattern + r"_(\d+)\.csv", name)
        if m:
            candidates.append((int(m.group(1)), name))
    return os.path.join(directory, max(candidates)[1]) if candidates else None


def main(argv=None) -> int:
    logging.basicConfig(
        level=logging.INFO, format="%(asctime)s %(name)s %(levelname)s %(message)s"
    )
    print("Program arguments:", sys.argv[1:] if argv is None else argv)
    config = ExperimentConfig.from_args(argv)
    experiment = make_experiment(config)
    device = experiment.device
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    print(f"Execution backend: torch {torch.__version__} on {device} ({name})")

    train_csv = os.path.join(config.data_dir, f"{config.file_prefix}_train.csv")
    test_csv = os.path.join(config.data_dir, f"{config.file_prefix}_test.csv")
    if not (os.path.exists(train_csv) and os.path.exists(test_csv)):
        if config.model_family == "mnist":
            print(f"No CSVs under {config.data_dir!r}; preparing MNIST data there.")
            prepare_mnist(config.data_dir, prefix=config.file_prefix)
        else:
            print(f"No CSVs under {config.data_dir!r}; generating synthetic data there.")
            _prepare_synthetic(config, experiment)
    train_it = _csv_iterator(train_csv, config.batch_size_train, config.num_features, config.num_classes)
    test_it = _csv_iterator(test_csv, config.batch_size_pred, config.num_features, config.num_classes)
    if config.resume:
        print(f"Resumed from iteration {experiment.load_models()}")
    result = experiment.run(train_it, test_it)
    print(f"Done: {result['iterations']} iterations")
    print(experiment.timer.report())

    # offline eval, as the reference notebook does it: accuracy of the
    # latest predictions export (mnist) and the latent-manifold PNG
    if result["iterations"] > 0:
        from gan_deeplearning4j_tpu_torch.eval import accuracy_from_csvs, render_manifold

        preds = None
        if experiment.cv is not None:
            preds = _latest(config.output_dir, config.file_prefix, "test_predictions")
        manifold = _latest(config.output_dir, config.file_prefix, "out")
        if preds:
            acc = accuracy_from_csvs(preds, test_csv, config.num_features)
            print(f"Transfer-classifier accuracy: {acc * 100:.2f}%")
        # tabular rows are no images: their manifold stays a CSV
        if manifold and config.num_features == config.height * config.width * config.channels:
            png = render_manifold(
                manifold,
                os.path.join(config.output_dir, "DCGAN_Generated_Images.png"),
                grid=config.latent_grid,
                side=config.height,
                channels=config.channels,
            )
            print(f"Manifold image: {png}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
