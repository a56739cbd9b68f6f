"""Durable metric rows.

Counterpart of ``append_jsonl`` in ``recformer_tpu/utils/logging.py``: one
JSON object per line, flushed and fsync'd as it is written, so a run that
dies loses no row it had produced. The JAX package's ``MetricsLogger``
(JSONL plus TensorBoard) comes with the port's host-side slice.
"""

from __future__ import annotations

import json
import os
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
