"""Stage timing for per-stage latency breakdowns.

The port's counterpart of `StageTimer` in `invertible_cd_tpu/utils/
profiling.py`: wall-clock totals per named stage, fenced on the device.
JAX blocks on a stage's output (`block_until_ready`); CUDA work is queued
the same way, so `result` synchronizes the device of a CUDA tensor (or of
any CUDA tensor in a tuple, list or dict of them). JAX's `trace` and
`annotate` map to `torch.profiler`, which callers use directly.
"""
from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import torch


def _cuda_devices(value, out: set) -> set:
    if isinstance(value, torch.Tensor):
        if value.is_cuda:
            out.add(value.device)
    elif isinstance(value, dict):
        for v in value.values():
            _cuda_devices(v, out)
    elif isinstance(value, (list, tuple)):
        for v in value:
            _cuda_devices(v, out)
    return out


class StageTimer:
    """Wall-clock stage timings with device fencing.

    timer = StageTimer()
    with timer.stage("unet"):
        out = timer.result(step(...))   # waits for the stage's device work
    print(timer.summary())              # mean seconds per stage
    """

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self._current: Optional[str] = None

    @contextlib.contextmanager
    def stage(self, name: str):
        self._current = name
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1
            self._current = None

    def result(self, value):
        """Call inside a stage with the stage's output so that its device
        time is included (CUDA kernels run after the call returns)."""
        for device in _cuda_devices(value, set()):
            torch.cuda.synchronize(device)
        return value

    def summary(self) -> Dict[str, float]:
        return {name: self.totals[name] / max(self.counts[name], 1) for name in self.totals}
