"""Metric rows: a durable JSONL mirror and the training CLIs' logger.

Counterpart of ``recformer_tpu/utils/logging.py``. :func:`append_jsonl`
writes one JSON object per line, flushed and fsync'd as it is written, so a
run that dies loses no row it had produced. :class:`MetricsLogger` writes
each logged row to ``<log_dir>/<name>.jsonl``, repeats it in the mirror
file, and mirrors it to TensorBoard when a writer is importable.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


def append_jsonl(path: Optional[str], row: Dict) -> None:
    """Append ``row`` to ``path`` (nothing when ``path`` is empty)."""
    if not path:
        return
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(row, default=str) + "\n")
        f.flush()
        os.fsync(f.fileno())


class MetricsLogger:
    """Rows ``{"step", "time", <metric>: float}`` in ``<log_dir>/<name>.jsonl``
    (nothing when ``log_dir`` is empty), each repeated in ``mirror_path``."""

    def __init__(self, log_dir: Optional[str], name: str = "metrics",
                 mirror_path: Optional[str] = None):
        self.log_dir = log_dir
        self._file = None
        self._tb = None
        self.mirror_path = mirror_path
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._file = open(os.path.join(log_dir, f"{name}.jsonl"), "a")
            try:  # optional TensorBoard mirror
                from torch.utils.tensorboard import SummaryWriter  # type: ignore
            except ImportError:
                SummaryWriter = None
            if SummaryWriter is not None:
                self._tb = SummaryWriter(log_dir)

    def log(self, step: int, metrics: Dict[str, float], prefix: str = "") -> None:
        if self._file is None:
            return
        row = {"step": int(step), "time": time.time()}
        for k, v in metrics.items():
            try:
                row[prefix + k] = float(v)
            except (TypeError, ValueError):
                continue
        self._file.write(json.dumps(row) + "\n")
        self._file.flush()
        append_jsonl(self.mirror_path, row)
        if self._tb is not None:
            for k, v in row.items():
                if k not in ("step", "time"):
                    self._tb.add_scalar(k, v, step)

    def close(self) -> None:
        if self._file:
            self._file.close()
        if self._tb:
            self._tb.close()
