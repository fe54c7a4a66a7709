"""A schema ``.npz`` for ``eval/fid.py::inception_feature_fn`` with
InceptionV3's published topology: its stem and first mixed block, with
seeded random weights.

The layout is TF-slim's InceptionV3 (Szegedy et al., "Rethinking the
Inception Architecture", 2015):

- the stem: ``Conv2d_1a_3x3`` (3×3 stride 2, 32, VALID), ``Conv2d_2a_3x3``
  (3×3, 32, VALID), ``Conv2d_2b_3x3`` (3×3, 64, SAME), ``MaxPool_3a_3x3``
  (3 stride 2, VALID), ``Conv2d_3b_1x1`` (80), ``Conv2d_4a_3x3`` (3×3,
  192, VALID), ``MaxPool_5a_3x3`` (3 stride 2, VALID);
- ``Mixed_5b``: four branches, 1×1 64 | 1×1 48 → 5×5 64 | 1×1 64 → 3×3 96
  → 3×3 96 | avgpool 3 SAME → 1×1 32, joined on channels (256), then a
  global average pool: 256 features.

Every conv has a bias and a relu (the published net folds its BatchNorm
into them). Weights are He-scaled normals from
``numpy.random.default_rng(seed)``: the schema exercises the interpreter
at the real net's shapes and costs; it is not the trained network, which
can only be mounted, never fetched. The input is normalised to [-1, 1]
(mean 0.5, std 0.5), as Inception's preprocessing does.
"""

from __future__ import annotations

import json
from typing import Dict, List, Tuple

import numpy as np

#: (name, input, kernel, stride, out channels, padding) of each conv;
#: a pool is (name, input, "maxpool"/"avgpool", size, stride, padding)
_STEM = [
    ("Conv2d_1a_3x3", "input", 3, 2, 32, "VALID"),
    ("Conv2d_2a_3x3", "Conv2d_1a_3x3", 3, 1, 32, "VALID"),
    ("Conv2d_2b_3x3", "Conv2d_2a_3x3", 3, 1, 64, "SAME"),
    ("MaxPool_3a_3x3", "Conv2d_2b_3x3", "maxpool", 3, 2, "VALID"),
    ("Conv2d_3b_1x1", "MaxPool_3a_3x3", 1, 1, 80, "VALID"),
    ("Conv2d_4a_3x3", "Conv2d_3b_1x1", 3, 1, 192, "VALID"),
    ("MaxPool_5a_3x3", "Conv2d_4a_3x3", "maxpool", 3, 2, "VALID"),
]
_MIXED_5B = [
    ("Mixed_5b/Branch_0/Conv2d_0a_1x1", "MaxPool_5a_3x3", 1, 1, 64, "SAME"),
    ("Mixed_5b/Branch_1/Conv2d_0a_1x1", "MaxPool_5a_3x3", 1, 1, 48, "SAME"),
    ("Mixed_5b/Branch_1/Conv2d_0b_5x5", "Mixed_5b/Branch_1/Conv2d_0a_1x1", 5, 1, 64, "SAME"),
    ("Mixed_5b/Branch_2/Conv2d_0a_1x1", "MaxPool_5a_3x3", 1, 1, 64, "SAME"),
    ("Mixed_5b/Branch_2/Conv2d_0b_3x3", "Mixed_5b/Branch_2/Conv2d_0a_1x1", 3, 1, 96, "SAME"),
    ("Mixed_5b/Branch_2/Conv2d_0c_3x3", "Mixed_5b/Branch_2/Conv2d_0b_3x3", 3, 1, 96, "SAME"),
    ("Mixed_5b/Branch_3/AvgPool_0a_3x3", "MaxPool_5a_3x3", "avgpool", 3, 1, "SAME"),
    ("Mixed_5b/Branch_3/Conv2d_0b_1x1", "Mixed_5b/Branch_3/AvgPool_0a_3x3", 1, 1, 32, "SAME"),
]
_BRANCH_OUTPUTS = ["Mixed_5b/Branch_0/Conv2d_0a_1x1", "Mixed_5b/Branch_1/Conv2d_0b_5x5",
                   "Mixed_5b/Branch_2/Conv2d_0c_3x3", "Mixed_5b/Branch_3/Conv2d_0b_1x1"]


def inception_v3_stem(height: int = 299, width: int = 299,
                      seed: int = 666) -> Tuple[dict, Dict[str, np.ndarray]]:
    """The schema and its arrays (HWIO kernels, biases) for an input of
    ``height × width × 3``; the stem needs at least 32×32."""
    rng = np.random.default_rng(seed)
    nodes: List[dict] = []
    arrays: Dict[str, np.ndarray] = {}
    channels = {"input": 3}
    for name, src, kind, *rest in _STEM + _MIXED_5B:
        if kind in ("maxpool", "avgpool"):
            size, stride, padding = rest
            nodes.append({"name": name, "op": kind, "in": src, "size": size, "stride": stride,
                          "padding": padding})
            channels[name] = channels[src]
            continue
        stride, c_out, padding = rest
        c_in = channels[src]
        fan_in = kind * kind * c_in
        arrays[f"{name}/kernel"] = (rng.standard_normal((kind, kind, c_in, c_out))
                                    * np.sqrt(2.0 / fan_in)).astype(np.float32)
        arrays[f"{name}/bias"] = (rng.standard_normal(c_out) * 0.01).astype(np.float32)
        nodes.append({"name": name, "op": "conv", "in": src, "stride": stride, "padding": padding,
                      "activation": "relu", "kernel": f"{name}/kernel", "bias": f"{name}/bias"})
        channels[name] = c_out
    nodes.append({"name": "Mixed_5b", "op": "concat", "in": list(_BRANCH_OUTPUTS)})
    nodes.append({"name": "pool", "op": "global_avgpool", "in": "Mixed_5b"})
    schema = {"input": {"height": height, "width": width, "channels": 3,
                        "mean": [0.5, 0.5, 0.5], "std": [0.5, 0.5, 0.5]},
              "nodes": nodes, "output": "pool"}
    return schema, arrays


def write_schema(path: str, schema: dict, arrays: Dict[str, np.ndarray]) -> str:
    """Write ``schema`` and its arrays as the ``.npz`` that
    ``inception_feature_fn`` (and ``$INCEPTION_WEIGHTS``) reads."""
    np.savez(path, __schema__=np.array(json.dumps(schema)), **arrays)
    return path


__all__ = ["inception_v3_stem", "write_schema"]
