"""Classifier accuracy — counterpart of
``gan_deeplearning4j_tpu/eval/accuracy.py``.

The reference's acceptance test is offline: read the predictions CSV,
take the argmax per row, compare with the test labels. ``evaluate_classifier``
is the in-process path: the classifier run directly, in the reference's
500-row prediction batches."""

from __future__ import annotations

import numpy as np
import torch


def accuracy_score(pred_probs: np.ndarray, labels: np.ndarray) -> float:
    """mean(argmax(probs) == y). ``labels`` may be integer class ids or
    one-hot rows."""
    pred_probs = np.asarray(pred_probs)
    labels = np.asarray(labels)
    if labels.ndim > 1:
        labels = labels.argmax(axis=1)
    if pred_probs.shape[0] != labels.shape[0]:
        raise ValueError(f"{pred_probs.shape[0]} predictions vs {labels.shape[0]} labels")
    return float(np.mean(pred_probs.argmax(axis=1) == labels))


def accuracy_from_csvs(predictions_csv: str, test_csv: str, num_features: int = 784) -> float:
    """Predictions CSV (N×classes probabilities, as
    ``GanExperiment.export_predictions`` writes it) against the
    reference-format test CSV whose last column is the integer label."""
    preds = np.loadtxt(predictions_csv, delimiter=",", ndmin=2)
    test = np.loadtxt(test_csv, delimiter=",", ndmin=2)
    return accuracy_score(preds, test[:, num_features].astype(np.int64))


def evaluate_classifier(graph, params, features: np.ndarray, labels: np.ndarray,
                        batch_size: int = 500) -> float:
    """In-process accuracy: ``graph``'s predictions on ``features`` in
    ``batch_size``-row batches on the params' device, then argmax against
    ``labels``. Raises ``ValueError`` on an empty set."""
    device = next(t for lp in params.values() for t in lp.values()).device
    features = np.asarray(features, dtype=np.float32)
    chunks = []
    with torch.inference_mode():
        for i in range(0, len(features), batch_size):
            x = torch.from_numpy(np.ascontiguousarray(features[i:i + batch_size])).to(device)
            chunks.append(graph.output(params, x, train=False).float().cpu().numpy())
    if not chunks:
        raise ValueError("no features to evaluate")
    return accuracy_score(np.vstack(chunks), labels)
