"""Training metrics log: append-only JSONL (the port's copy of the JSONL
half of ``animate3d_tpu/utils/logging.py::MetricsLogger``)."""

from __future__ import annotations

import json
import os
from typing import Any, Dict


class MetricsLogger:
    def __init__(self, path: str):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def log(self, step: int, metrics: Dict[str, Any]) -> None:
        """Append ``{"step": step, **metrics}`` as one line (values as floats)."""
        rec = {"step": step, **{k: float(v) for k, v in metrics.items()}}
        with open(self.path, "a") as f:
            f.write(json.dumps(rec) + "\n")
