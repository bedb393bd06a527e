"""Step timing and throughput (counterpart of
``merlin_tpu/utils/profiling.py``).

* :class:`StepTimer` - rolling wall-clock per step with tokens/s and the
  model-flops utilization against one H100's dense bf16 peak;
* :func:`train_step_flops` - the 6ND (8ND with remat) estimate;
* :func:`annotate` - a named region in a ``torch.profiler`` trace.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import torch

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)


def annotate(name: str):
    return torch.profiler.record_function(name)


class StepTimer:
    """Rolling wall-clock per step + throughput/MFU."""

    def __init__(self, *, tokens_per_step: int = 0,
                 flops_per_step: float = 0.0,
                 peak_flops: float = PEAK_BF16_FLOPS,
                 window: int = 20):
        self.tokens_per_step = tokens_per_step
        self.flops_per_step = flops_per_step
        self.peak_flops = peak_flops
        self.window = window
        self._times = []
        self._last: Optional[float] = None

    def tick(self) -> Dict[str, float]:
        now = time.perf_counter()
        if self._last is not None:
            self._times.append(now - self._last)
            self._times = self._times[-self.window:]
        self._last = now
        return self.stats()

    def stats(self) -> Dict[str, float]:
        if not self._times:
            return {}
        dt = sum(self._times) / len(self._times)
        out = {"step_time_s": dt}
        if self.tokens_per_step:
            out["tokens_per_sec"] = self.tokens_per_step / dt
        if self.flops_per_step:
            out["mfu"] = self.flops_per_step / dt / self.peak_flops
        return out


def train_step_flops(n_params: int, tokens_per_step: int,
                     remat: bool = True) -> float:
    """6ND (+2ND for remat recompute) transformer training FLOPs estimate."""
    mult = 8.0 if remat else 6.0
    return mult * n_params * tokens_per_step
