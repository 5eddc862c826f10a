"""Training observability: an append-only JSONL metrics log, and image
panels to TensorBoard or as PNG files.

This package's own copy of `MetricLogger` from
`invertible_cd_tpu/utils/logging.py`: one JSONL row per `log` call (step,
wall time, and every metric that converts to a float), and `log_images`
panels. As in JAX, scalars and panels also go to TensorBoard whenever
`torch.utils.tensorboard` imports, and without it the panels are written
as PNG files (with this package's own encoder, `utils.images.encode_png`).
"""
from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional

import numpy as np

from .images import encode_png


class MetricLogger:
    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, "metrics.jsonl")
        self.samples_dir = os.path.join(log_dir, "samples")
        self._f = open(self.path, "a", buffering=1)
        self._tb = None
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:  # the panels go to PNG files
            pass
        else:
            self._tb = SummaryWriter(log_dir)

    def log(self, step: int, metrics: Dict, prefix: str = "") -> None:
        row = {"step": int(step), "time": time.time()}
        for k, v in metrics.items():
            key = f"{prefix}{k}"
            try:
                row[key] = float(v)
            except (TypeError, ValueError):
                continue
            if self._tb is not None:
                self._tb.add_scalar(key, row[key], int(step))
        self._f.write(json.dumps(row) + "\n")

    def log_images(self, step: int, tag: str, images01: np.ndarray) -> Optional[str]:
        """(B, H, W, 3) float [0, 1] -> a TensorBoard image batch, or without
        TensorBoard one PNG of the images side by side
        (`samples/<tag with / as _>_<step>.png`, as JAX writes it), whose
        path it returns (None on the TensorBoard sink)."""
        arr = np.asarray(images01)
        if self._tb is not None:
            self._tb.add_images(tag, arr.transpose(0, 3, 1, 2), int(step))
            return None
        os.makedirs(self.samples_dir, exist_ok=True)
        grid = (np.concatenate(list(arr), axis=1) * 255).astype(np.uint8)
        path = os.path.join(self.samples_dir, f"{tag.replace('/', '_')}_{step}.png")
        with open(path, "wb") as f:
            f.write(encode_png(grid))
        return path

    def close(self) -> None:
        self._f.close()
        if self._tb is not None:
            self._tb.close()
