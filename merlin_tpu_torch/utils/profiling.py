"""Tracing, step timing and throughput (counterpart of
``merlin_tpu/utils/profiling.py``).

* :func:`trace` - a context manager around ``torch.profiler`` that writes
  a TensorBoard-loadable trace directory;
* :class:`StepTimer` - rolling wall-clock per step with tokens/s and the
  model-flops utilization against one H100's dense bf16 peak;
* :func:`train_step_flops` - the 6ND (8ND with remat) estimate;
* :func:`annotate` - a named region in a ``torch.profiler`` trace.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator, Optional

import torch

PEAK_BF16_FLOPS = 989e12  # H100 SXM dense bf16 (NVIDIA data sheet)


@contextlib.contextmanager
def trace(log_dir: str, *, device="cuda") -> Iterator[torch.profiler.profile]:
    """Profile the block into ``log_dir`` (``tensorboard_trace_handler``:
    one ``*.pt.trace.json`` a run, which TensorBoard's profiler plugin and
    Perfetto load). On the card (the default) it records the device's
    kernels and copies beside the host's operators and :func:`annotate`
    spans, and raises when there is no card rather than trace the host
    alone; ``device="cpu"`` records the host only. Yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("trace: no CUDA device to trace; pass "
                               "device='cpu' to trace the host alone")
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir))
    with prof:
        yield prof


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
