"""The quality probe — the port's copy of ``scripts/quality_run.py``'s
``quality_probe`` and ``sample_generator_rows``.

``quality_probe`` is one seeded, deterministic FID / classifier-accuracy
measurement returning a plain dict; the deploy canary
(``deploy/canary.py``) runs it on candidate and incumbent engines, so
"quality" means the same in a quality run and in an admission decision.
The z stream is ``default_rng(seed)`` uniform in [-1, 1), drawn with numpy
exactly as the reference draws it.
"""

from __future__ import annotations

import numpy as np
import torch

from gan_deeplearning4j_tpu_torch.eval.accuracy import accuracy_score
from gan_deeplearning4j_tpu_torch.eval.fid import FeatureStats, fid_from_stats
from gan_deeplearning4j_tpu_torch.runtime.device import DeviceLike, resolve_device
from gan_deeplearning4j_tpu_torch.runtime.dtype import compute_dtype_scope


def sample_generator_rows(gen_fwd, z_size: int, num_samples: int, seed: int, *,
                          num_features=None, batch_size: int = 2500, compute_dtype=None,
                          device: DeviceLike = None) -> np.ndarray:
    """Seeded latent draws → generator rows, ``batch_size`` samples per
    host-device round trip. ``gen_fwd`` maps a (n, z_size) tensor on
    ``device`` (the card unless the caller asks for the CPU) to sample rows;
    the z stream is ``default_rng(seed)`` uniform in [-1, 1), drawn chunk
    by chunk in order."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    fakes = []
    with torch.inference_mode(), compute_dtype_scope(compute_dtype):
        for i in range(0, num_samples, batch_size):
            n = min(batch_size, num_samples - i)
            z = rng.random((n, z_size), dtype=np.float32) * 2.0 - 1.0
            out = gen_fwd(torch.from_numpy(z).to(dev))
            fakes.append(out.float().cpu().numpy().reshape(
                n, num_features if num_features is not None else -1))
    return np.concatenate(fakes, axis=0)


def quality_probe(sample_fn, real_rows, *, z_size: int, num_samples: int = 256,
                  seed: int = 666, classify_fn=None, labels=None, feature_fn=None) -> dict:
    """One seeded quality measurement:

    - ``sample_fn(z)`` maps a seeded (num_samples, z_size) latent batch in
      [-1, 1) to sample rows; the FID is the Fréchet distance between those
      rows and ``real_rows`` under ``feature_fn`` (identity when None:
      raw-row features);
    - ``classify_fn(real_rows)`` (optional) returns class probabilities;
      accuracy is argmax against ``labels`` (ids or one-hot), None when
      either is missing.
    """
    if num_samples < 2:
        raise ValueError("num_samples must be >= 2 (covariance fit)")
    real_rows = np.asarray(real_rows, dtype=np.float32)
    rng = np.random.default_rng(seed)
    z = rng.random((num_samples, z_size), dtype=np.float32) * 2.0 - 1.0
    fakes = np.asarray(sample_fn(z), dtype=np.float32).reshape(num_samples, -1)
    featurize = feature_fn if feature_fn is not None else (lambda rows: rows)
    fid = fid_from_stats(FeatureStats.from_features(featurize(real_rows)),
                         FeatureStats.from_features(featurize(fakes)))
    accuracy = None
    if classify_fn is not None and labels is not None:
        accuracy = accuracy_score(np.asarray(classify_fn(real_rows)), labels)
    return {
        "fid": float(fid),
        "accuracy": accuracy,
        "num_samples": int(num_samples),
        "num_real": int(real_rows.shape[0]),
        "seed": int(seed),
    }
