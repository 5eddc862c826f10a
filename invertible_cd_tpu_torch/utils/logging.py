"""Training observability: an append-only JSONL metrics log.

This package's own copy of `MetricLogger` from
`invertible_cd_tpu/utils/logging.py`, with the JSONL sink only (one row per
call: step, wall time, and every metric that converts to a float).
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict


class MetricLogger:
    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self._f = open(self.path, "a", buffering=1)

    def log(self, step: int, metrics: Dict, prefix: str = "") -> None:
        row = {"step": int(step), "time": time.time()}
        for k, v in metrics.items():
            try:
                row[f"{prefix}{k}"] = float(v)
            except (TypeError, ValueError):
                continue
        self._f.write(json.dumps(row) + "\n")

    def close(self) -> None:
        self._f.close()
