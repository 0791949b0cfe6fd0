"""Stdout + JSONL training observability (the port's copy of
``cfun_tpu/utils/logging.py``).

The reference logs through prints and an ASCII progress bar
(model.py:28-58); here every epoch also lands in a machine-readable
``train_metrics.jsonl``, so runs can be followed and compared.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Dict, Optional


class MetricsLogger:
    """Appends one JSON record a line to ``<log_dir>/<prefix>_metrics.jsonl``
    (nowhere without a ``log_dir``), each with its wall seconds since the
    logger was made."""

    def __init__(self, log_dir: Optional[str] = None, prefix: str = "train"):
        self._file = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._file = open(os.path.join(log_dir, f"{prefix}_metrics.jsonl"),
                              "a", buffering=1)
        self._t0 = time.time()

    def log(self, record: Dict) -> None:
        record = dict(record, wall_s=round(time.time() - self._t0, 3))
        if self._file:
            self._file.write(json.dumps(record) + "\n")

    def close(self) -> None:
        if self._file:
            self._file.close()


def progress(step: int, total: int, metrics: Dict[str, float],
             prefix: str = "") -> None:
    """A one-line progress bar with ``metrics``, redrawn in place."""
    parts = " - ".join(f"{k}: {float(v):.5f}" for k, v in metrics.items())
    bar_len = 30
    filled = int(bar_len * step / max(total, 1))
    bar = "#" * filled + "-" * (bar_len - filled)
    sys.stdout.write(f"\r{prefix}{step}/{total} |{bar}| {parts}")
    if step >= total:
        sys.stdout.write("\n")
    sys.stdout.flush()
