"""Counting over a run's record, shared by the metric readers."""

from __future__ import annotations

from typing import Iterable, List, Optional, Tuple

import numpy as np

from portbench.record import Record


def percentile(values: Iterable[float], p: float) -> Optional[float]:
    """The ``p``-th percentile (linear between order statistics), or None
    with no value."""
    values = list(values)
    if not values:
        return None
    return float(np.percentile(np.asarray(values, np.float64), p))


def due_in_window(rec: Record):
    """Requests due in the window; in a traced run, due in the parts of it
    that the profiler left alone."""
    return [r for r in rec.requests
            if any(rec.in_window(r.due, span) for span in rec.quiet())]


def emitted(rec: Record, span: Tuple[float, float]):
    """(request, token index) of each token the clients saw in ``span``."""
    lo, hi = span
    return [(r, j) for r in rec.requests
            for j, t in enumerate(r.token_times) if lo <= t <= hi]


def admitted(rec: Record, span: Tuple[float, float]):
    """Requests whose first token the clients saw in ``span``: their
    prefill ran just before (an admission reads its token back at once)."""
    return [r for r in rec.requests if rec.in_window(r.first, span)]


def model_flops(rec: Record, span: Tuple[float, float]) -> float:
    """What the work seen in ``span`` needs: each admission's prefill and
    each later token's decode step over its context, as the record's
    decoder family counts them."""
    lm, family = rec.lm, rec.family
    work = sum(family.prefill_flops(lm, r.prompt_len)
               for r in admitted(rec, span))
    work += sum(family.decode_flops(lm, r.prompt_len + j)
                for r, j in emitted(rec, span) if j >= 1)
    return work


def busy_steps(rec: Record, span=None) -> List[Tuple[float, float, int]]:
    """``step()`` calls inside ``span`` that had a slot to run; by default
    those of the window that the profiler left alone."""
    spans = [span] if span else rec.quiet()
    return [s for sp in spans for s in rec.steps_in(sp) if s[2] > 0]
