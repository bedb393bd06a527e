"""Device time of the projections (cuBLAS products and the casts of
their weights) per engine step in the traced stretch."""

from portbench.stats import busy_steps
from portbench.trace import family_us
from portbench.yardstick import CAST_KEYS, GEMM_KEYS


def read(rec):
    if rec.trace is None:
        return None
    steps = busy_steps(rec, rec.trace.host_span)
    if not steps:
        return None
    return family_us(rec.trace, GEMM_KEYS + CAST_KEYS) / 1e3 / len(steps)
