"""Tracing, step timing and throughput (counterpart of
``merlin_tpu/utils/profiling.py``).

* :func:`trace` - a context manager around ``torch.profiler`` that writes
  a TensorBoard-loadable trace directory;
* :class:`StepTimer` - rolling wall-clock per step with tokens/s and the
  model-flops utilization against one H100's dense bf16 peak;
* :func:`train_step_flops` - the 6ND (8ND with remat) estimate;
* :func:`annotate` - a named span of the program: a region in a
  ``torch.profiler`` trace, and, once :func:`enable_spans` was called, a
  record in the process's span store (:func:`spans`).

The span store is off by default; then :func:`annotate` checks two flags
and returns a shared no-op context. Once on, each span closed on any thread
appends ``(name, start_ns, end_ns, parent, req, thread)`` to a ring of the
last :data:`SPAN_STORE_SIZE` records: ``time.perf_counter_ns`` stamps,
the enclosing span's name on the same thread (None at the top), the
serving engine's ``req_id`` where the span belongs to one request, and
``threading.get_ident()``. Under an active ``torch.profiler`` every span
also enters ``record_function(name)``, so the program's spans sit in the
trace beside the operators they issue. Span names start with ``merlin.``.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import time
from typing import Dict, Iterator, List, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

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


SPAN_STORE_SIZE = 1 << 17

Span = collections.namedtuple(
    "Span", "name start_ns end_ns parent req thread")


@dataclasses.dataclass(frozen=True)
class SpanSnapshot:
    """The store's records in the order their spans closed, and how many
    closed records it overwrote since :func:`enable_spans` (``wrapped``
    when any)."""
    records: List[Span]
    dropped: int

    @property
    def wrapped(self) -> bool:
        return self.dropped > 0


class _Store:
    def __init__(self, size: int):
        self.lock = threading.Lock()
        self.records: "collections.deque[Span]" = collections.deque(
            maxlen=size)
        self.closed = 0

    def add(self, record: Span) -> None:
        with self.lock:
            self.records.append(record)
            self.closed += 1

    def snapshot(self) -> SpanSnapshot:
        with self.lock:
            return SpanSnapshot(list(self.records),
                                self.closed - len(self.records))


class _Open(threading.local):
    """The names of the spans open on this thread, innermost last."""

    def __init__(self):
        self.names: List[str] = []


_store = _Store(SPAN_STORE_SIZE)
_open = _Open()
_recording = False
_NO_SPAN = contextlib.nullcontext()


class _Span:
    __slots__ = ("name", "req", "parent", "start", "recording", "region")

    def __init__(self, name: str, req: Optional[int]):
        self.name, self.req = name, req

    def __enter__(self):
        self.region = None
        if _autograd_profiler._is_profiler_enabled:
            self.region = torch.profiler.record_function(self.name)
            self.region.__enter__()
        self.recording = _recording
        if self.recording:
            names = _open.names
            self.parent = names[-1] if names else None
            names.append(self.name)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self.recording:
            _open.names.pop()
            _store.add(Span(self.name, self.start, end, self.parent,
                            self.req, threading.get_ident()))
        if self.region is not None:
            self.region.__exit__(*exc)
        return False


def annotate(name: str, req: Optional[int] = None):
    """A span of the program named ``name`` (``merlin.`` first), around a
    ``with`` block; ``req`` is the serving engine's ``req_id`` of the one
    request it belongs to. A no-op unless spans are on or a profiler is
    active."""
    if _recording or _autograd_profiler._is_profiler_enabled:
        return _Span(name, req)
    return _NO_SPAN


def enable_spans() -> None:
    """Empty the span store and record every span from now on."""
    global _store, _recording
    _store = _Store(SPAN_STORE_SIZE)
    _recording = True


def disable_spans() -> None:
    """Stop recording; what the store holds stays readable."""
    global _recording
    _recording = False


def spans() -> SpanSnapshot:
    """A snapshot of the span store."""
    return _store.snapshot()


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
