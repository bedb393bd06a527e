"""The device trace of a traced run (``--trace 1``) and its reduction.

A traced run profiles one steady stretch inside the measured window, not
the whole window: a decode step launches some forty kernels a layer, and a
whole window would hold over a million device events. The profiler's set-up
is this module's own (``torch.profiler`` with the CPU and CUDA activities),
so a later change to the program's tracing leaves the yardstick alone. The
raw events are read from the profiler's result without building its
per-event Python objects.

The benchmark's own spans (``portbench.step``, ``portbench.submit``) are
profiler annotations, in the trace's clock, so that idle gaps on the device
can be labelled by what the host was doing.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Optional, Sequence, Tuple

from portbench.record import Trace

STRETCH = "portbench.stretch"


class Tracer:
    """Profiles [start_at, start_at + length) on the host clock; ``tick``
    is called by the driver's loop between the program's calls."""

    def __init__(self, enabled: bool, start_at: float = 0.0,
                 length: float = 0.0):
        self.enabled = enabled
        self.start_at, self.length = start_at, length
        self._prof = self._stretch = None
        self._events = None
        self._result: Optional[Trace] = None
        # the part of the window the profiler perturbs: from its start to
        # the end of its stop (host clock)
        self.perturbed: Optional[Tuple[float, float]] = None

    def span(self, name: str):
        if self._prof is None:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function(name)

    def tick(self, now: float) -> None:
        if not self.enabled or self.perturbed is not None:
            return
        if self._prof is None and now >= self.start_at:
            self._start()
        elif self._prof is not None and now >= self._host_t0 + self.length:
            self._stop()

    def close(self) -> None:
        """End a stretch still open when the window closed."""
        if self._prof is not None:
            self._stop()

    @property
    def result(self) -> Optional[Trace]:
        """The stretch's :class:`Trace`, reduced after the window (the
        reduction is no part of what the window measures)."""
        if self._result is None and self._events is not None:
            self._result = reduce_events(self._events, self._host_span)
            self._events = None
        return self._result

    def _start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        self._begin = time.perf_counter()
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._stretch = torch.profiler.record_function(STRETCH)
        self._stretch.__enter__()
        self._host_t0 = time.perf_counter()

    def _stop(self) -> None:
        host_t1 = time.perf_counter()
        self._stretch.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        self._events = self._prof.profiler.kineto_results.events()
        self._host_span = (self._host_t0, host_t1)
        self._prof = self._stretch = None
        self.perturbed = (self._begin, time.perf_counter())


def reduce_events(events, host_span) -> Trace:
    """Kineto events -> a :class:`Trace`: device operations (kernels,
    copies, sets) and host events, in microseconds of the trace's clock."""
    import torch

    device, host, span = [], [], None
    for e in events:
        start, dur = e.start_ns() / 1e3, e.duration_ns() / 1e3
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            # the device's row also mirrors the host's annotations
            if not e.is_user_annotation() \
                    and not name.startswith("portbench."):
                device.append((name, start, dur))
            continue
        if name == STRETCH:
            span = (start, start + dur)
        else:
            host.append((name, start, dur))
    if span is None:
        raise RuntimeError("the trace holds no stretch annotation")
    return Trace(device=device, host=host, span=span, host_span=host_span)


def clipped(events: Sequence[Tuple[str, float, float]],
            span: Tuple[float, float]) -> List[Tuple[str, float, float]]:
    """Events cut to the stretch: (name, start, duration) inside it."""
    lo, hi = span
    out = []
    for name, start, dur in events:
        a, b = max(start, lo), min(start + dur, hi)
        if b > a:
            out.append((name, a, b - a))
    return out


def busy_intervals(device, span) -> List[Tuple[float, float]]:
    """The union of the device operations' intervals inside the stretch."""
    merged: List[List[float]] = []
    for _, start, dur in sorted(clipped(device, span), key=lambda e: e[1]):
        end = start + dur
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return [(a, b) for a, b in merged]


def busy_us(trace: Trace) -> float:
    return sum(b - a for a, b in busy_intervals(trace.device, trace.span))


def family_us(trace: Trace, keys: Sequence[str]) -> float:
    """Device time of the operations whose name holds any of ``keys``."""
    return sum(dur for name, _, dur in clipped(trace.device, trace.span)
               if any(k in name for k in keys))


def top_ops(trace: Trace, n: int = 10) -> List[List]:
    totals: Dict[str, float] = {}
    for name, _, dur in clipped(trace.device, trace.span):
        totals[name] = totals.get(name, 0.0) + dur
    ranked = sorted(totals.items(), key=lambda kv: -kv[1])[:n]
    return [[name[:160], us / 1e6] for name, us in ranked]


def idle_gaps(trace: Trace, n: int = 10) -> List[List]:
    """The longest gaps with no device operation inside the stretch, each
    named by the benchmark's span around it and the innermost host event
    running at its middle (a synchronisation shows as its runtime call)."""
    lo, hi = trace.span
    edges = [lo] + [t for ab in busy_intervals(trace.device, trace.span)
                    for t in ab] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    out = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:n]:
        mid = (a + b) / 2
        covering = [(start, name) for name, start, dur in trace.host
                    if start <= mid <= start + dur]
        ours = [name for start, name in sorted(covering)
                if name.startswith("portbench.")]
        inner = max(covering)[1] if covering else "no host event"
        if inner.startswith("portbench."):
            inner = "python between operations"
        label = (ours[-1] if ours else "outside the benchmark's spans") \
            + " / " + inner
        out.append([label[:160], (b - a) / 1e6])
    return out
