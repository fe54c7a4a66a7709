"""Per-step scalar metrics — counterpart of
``gan_deeplearning4j_tpu/utils/metrics.py``: every logged iteration emits
D-loss, G-loss, CV-loss and images/s through the standard logger and,
optionally, as one JSON line per step to a file."""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Dict, Optional

logger = logging.getLogger("gan_deeplearning4j_tpu_torch.metrics")


class MetricsLogger:
    """Step-keyed scalar sink: stdlib logging + optional JSONL file."""

    def __init__(self, jsonl_path: Optional[str] = None):
        self.jsonl_path = jsonl_path
        self._fh = None
        if jsonl_path is not None:
            os.makedirs(os.path.dirname(os.path.abspath(jsonl_path)), exist_ok=True)
            self._fh = open(jsonl_path, "a", buffering=1)
        self.history: list = []

    def log(self, step: int, scalars: Dict[str, float]) -> None:
        record = {"step": int(step), "time": time.time()}
        record.update({k: float(v) for k, v in scalars.items()})
        self.history.append(record)
        logger.info(
            "step %d | %s",
            step,
            " ".join(f"{k}={v:.5g}" for k, v in record.items() if k not in ("step", "time")),
        )
        if self._fh is not None:
            self._fh.write(json.dumps(record) + "\n")

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "MetricsLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
