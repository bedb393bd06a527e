"""The program's own spans (``merlin_tpu_torch.utils.profiling``'s span
store), as the per-layer readers of a traced run read them.

Importing this module turns the program's spans on. ``run.py`` loads the
per-layer readers of a traced run, and only those, before it builds the
model and sends the traffic, so a traced run records the program's spans
from its start; an untraced run loads only the end-to-end readers, which
do not import this module, and runs with the spans off. A checkout of the program that keeps no span
store leaves :func:`snapshot` None, and each reader that needs it reads
nothing.

Times here are the host clock's seconds (``time.perf_counter``, as in
``Record``). :func:`to_trace` maps them into a traced stretch's clock.
"""

from __future__ import annotations

import bisect
import collections
from typing import Dict, List, Optional, Sequence, Tuple

from portbench.stats import busy_steps


def _enable():
    try:
        from merlin_tpu_torch.utils import profiling
        profiling.enable_spans()
    except (ImportError, AttributeError):
        return None
    return profiling


_PROFILING = _enable()

SUBMIT = "merlin.engine.submit"
PREFILL = "merlin.engine.prefill"
WINDOW = "merlin.engine.window"
INSERT = "merlin.engine.insert"
FIRST_TOKEN = "merlin.engine.first_token"
DECODE = "merlin.engine.decode"
READBACK = "merlin.engine.readback"
LAYERS = "merlin.decoder.layers"

Span = collections.namedtuple("Span", "name start end parent req thread")


def snapshot(since: float) -> Optional[List[Span]]:
    """The store's spans, times in seconds; None when the program keeps no
    store, or when it has overwritten a span that closed after ``since``
    (it wrapped past it)."""
    if _PROFILING is None:
        return None
    snap = _PROFILING.spans()
    out = [Span(s.name, s.start_ns * 1e-9, s.end_ns * 1e-9, s.parent,
                s.req, s.thread) for s in snap.records]
    if snap.wrapped and (not out or out[0].end > since):
        return None
    return out


def per_step(rec, names: Sequence[str], parent: Optional[str] = None
             ) -> Optional[List[float]]:
    """Seconds spent in spans named ``names`` (with that ``parent``, when
    given) inside each busy step of the window that the profiler left
    alone; None when there is no such step or no such span."""
    steps = busy_steps(rec)
    spans = snapshot(min(a for a, _, _ in steps)) if steps else None
    if spans is None:
        return None
    chosen = sorted((s.start, s.end) for s in spans if s.name in names
                    and (parent is None or s.parent == parent))
    if not chosen:
        return None
    starts = [a for a, _ in chosen]
    out = []
    for lo, hi, _ in steps:
        i, total = bisect.bisect_left(starts, lo), 0.0
        while i < len(chosen) and chosen[i][0] <= hi:
            if chosen[i][1] <= hi:
                total += chosen[i][1] - chosen[i][0]
            i += 1
        out.append(total)
    return out


def admissions(rec) -> Optional[List[Tuple[float, float, float]]]:
    """(submit, admission start, first token) of each request whose life
    from its first submit to its first token lies inside one part of the
    window that the profiler left alone. A request's admission starts with
    its first prefill or prefill window and ends with the first-token
    read-back that follows its first insert (the one that returned its
    token); a preempted request counts from its first submit and its first
    admission. Only spans from the window's start on are read (an
    engine's ``req_id`` counts from 0). None when the store is missing or
    wrapped."""
    spans = snapshot(rec.window[0])
    if spans is None:
        return None
    submit: Dict[int, float] = {}
    start: Dict[int, float] = {}
    inserted: Dict[int, float] = {}
    for s in sorted(spans, key=lambda s: s.start):
        if s.req is None or s.start < rec.window[0]:
            continue
        if s.name == SUBMIT:
            submit.setdefault(s.req, s.start)
        elif s.name in (PREFILL, WINDOW):
            start.setdefault(s.req, s.start)
        elif s.name == INSERT:
            inserted.setdefault(s.req, s.end)
    reads = sorted((s.start, s.end) for s in spans if s.name == FIRST_TOKEN)
    read_starts = [a for a, _ in reads]
    out = []
    for req, t in inserted.items():
        i = bisect.bisect_left(read_starts, t)
        if i == len(reads) or req not in submit or req not in start:
            continue
        life = (submit[req], start[req], reads[i][1])
        if any(lo <= life[0] and life[2] <= hi for lo, hi in rec.quiet()):
            out.append(life)
    return out


def to_trace(trace, t: float) -> float:
    """A host-clock time (seconds) in the traced stretch's clock
    (microseconds). Both clocks count real time, so the map is a shift: the
    one that takes the stretch's last host stamp onto its annotation's end,
    which is stamped as the host stamps it (the start is not: the
    profiler's first annotation sets up after taking its stamp)."""
    return trace.span[1] + (t - trace.host_span[1]) * 1e6


def in_trace(trace, names: Sequence[str]
             ) -> Optional[List[Tuple[float, float]]]:
    """The spans named ``names`` as (start, end) in the trace's clock; None
    when the store is missing or wrapped past the stretch's start."""
    spans = snapshot(trace.host_span[0])
    if spans is None:
        return None
    return [(to_trace(trace, s.start), to_trace(trace, s.end))
            for s in spans if s.name in names]
