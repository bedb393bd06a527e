"""What one run leaves for the metric readers: the requests as the traffic
saw them, the benchmark's spans around the program's calls, the device
trace of a steady stretch (traced runs), and the shapes the arithmetic of
the yardstick needs. Times are the host's ``time.perf_counter`` seconds."""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple


@dataclasses.dataclass
class Req:
    prompt_len: int
    max_new: int
    due: float = 0.0            # when the traffic meant to send it
    submitted: float = 0.0      # when it reached ServingEngine.submit
    first: Optional[float] = None   # first token seen by the client
    last: Optional[float] = None    # last token seen by the client
    token_times: List[float] = dataclasses.field(default_factory=list)
    done: bool = False
    error: Optional[str] = None
    # prompt ids and served tokens, kept for the check of correctness
    ids: Any = None
    tokens: List[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class Trace:
    """Device operations and host annotations of the traced stretch, in
    the profiler's clock (microseconds), and the stretch in both clocks."""
    device: List[Tuple[str, float, float]]      # (name, start, duration)
    host: List[Tuple[str, float, float]]        # annotations and runtime
    span: Tuple[float, float]                   # stretch, profiler clock
    host_span: Tuple[float, float]              # stretch, host clock


@dataclasses.dataclass
class Record:
    lm: Dict[str, Any]              # the configuration's decoder widths
    page_bytes: float               # bytes a cached K or V value takes
    window: Tuple[float, float]
    requests: List[Req]
    steps: List[Tuple[float, float, int]]   # step() spans and its return
    setup_s: float = 0.0
    # the configuration's decoder family (``portbench/families``): the
    # work-count readers count with it
    family: Any = None
    trace: Optional[Trace] = None
    memory_peak_bytes: int = 0
    # the part of the window a traced run's profiler perturbs
    perturbed: Optional[Tuple[float, float]] = None
    # pages of the engine's pool that requests may hold, and after each
    # step() (its end, host clock) how many they hold
    pages_reserved: int = 0
    pages_used: List[Tuple[float, int]] = dataclasses.field(
        default_factory=list)

    def in_window(self, t: Optional[float], span=None) -> bool:
        lo, hi = span or self.window
        return t is not None and lo <= t <= hi

    def steps_in(self, span=None):
        lo, hi = span or self.window
        return [s for s in self.steps if s[0] >= lo and s[1] <= hi]

    def pages_mean(self) -> float:
        """Pages in use, averaged over the window's steps (a traced run:
        outside its profiled part); nan with no step."""
        used = [n for t, n in self.pages_used
                if any(self.in_window(t, span) for span in self.quiet())]
        return sum(used) / len(used) if used else float("nan")

    def quiet(self) -> List[Tuple[float, float]]:
        """The window without the part the profiler perturbs: what the
        host-clock readers of a traced run read."""
        lo, hi = self.window
        if self.perturbed is None:
            return [(lo, hi)]
        a, b = self.perturbed
        return [(x, y) for x, y in ((lo, min(a, hi)), (max(b, lo), hi))
                if y > x]
