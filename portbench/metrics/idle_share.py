"""Share of the traced stretch in which no operation ran on the device."""

from portbench.trace import busy_us


def read(rec):
    if rec.trace is None:
        return None
    lo, hi = rec.trace.span
    return 100.0 * (1.0 - busy_us(rec.trace) / (hi - lo))
