"""Share of the traced stretch's device-idle time that falls while the
host is inside the program's ``merlin.engine.decode`` span (the decode
chunk's issue): the store's spans mapped into the trace's clock, against
the gaps between the device's operations."""

from portbench import spans
from portbench.trace import busy_intervals


def read(rec):
    trace = rec.trace
    if trace is None or not trace.device:
        return None
    issue = spans.in_trace(trace, (spans.DECODE,))
    if not issue:
        return None
    lo, hi = trace.span
    edges = [lo] + [t for ab in busy_intervals(trace.device, trace.span)
                    for t in ab] + [hi]
    idle = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    total = sum(b - a for a, b in idle)
    if total <= 0:
        return None
    # the issue spans merged (busy_intervals merges any intervals)
    issue = busy_intervals([("", a, b - a) for a, b in issue], trace.span)
    inside, j = 0.0, 0
    for a, b in idle:
        while j < len(issue) and issue[j][1] <= a:
            j += 1
        k = j
        while k < len(issue) and issue[k][0] < b:
            inside += min(b, issue[k][1]) - max(a, issue[k][0])
            k += 1
    return 100.0 * inside / total
