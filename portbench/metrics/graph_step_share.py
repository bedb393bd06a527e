"""Share of the busy steps (a step() that had a slot to run, in the window
outside a traced run's profiled part) whose decode issue replayed the
program's captured decode step, in %: the steps that hold a
``merlin.engine.graph_replay`` span. A decode chunk issued eagerly leaves
an empty ``merlin.engine.eager_chunk`` span instead. None where the
program records neither span."""

import bisect

from portbench import spans
from portbench.stats import busy_steps

GRAPH_REPLAY = "merlin.engine.graph_replay"
EAGER_CHUNK = "merlin.engine.eager_chunk"


def _in_steps(starts, steps):
    """The steps holding one of the sorted ``starts``."""
    return [bisect.bisect_left(starts, lo) < bisect.bisect_right(starts, hi)
            for lo, hi, _ in steps]


def read(rec):
    steps = busy_steps(rec)
    got = spans.snapshot(min(a for a, _, _ in steps)) if steps else None
    if got is None:
        return None
    replays = sorted(s.start for s in got if s.name == GRAPH_REPLAY)
    eager = sorted(s.start for s in got if s.name == EAGER_CHUNK)
    replayed = _in_steps(replays, steps)
    if not any(replayed) and not any(_in_steps(eager, steps)):
        return None
    return 100.0 * sum(replayed) / len(steps)
