"""Device time of the projections (cuBLAS products, the casts of their
weights, int8 weights to bf16) per thousand tokens processed in the traced
stretch: prompt tokens prefilled and decode tokens served."""

from portbench.stats import admitted, busy_steps
from portbench.trace import family_us
from portbench.yardstick import CAST_KEYS, GEMM_KEYS


def read(rec):
    if rec.trace is None:
        return None
    span = rec.trace.host_span
    tokens = sum(r.prompt_len for r in admitted(rec, span)) + sum(
        n for _, _, n in busy_steps(rec, span))
    if not tokens:
        return None
    return family_us(rec.trace, GEMM_KEYS + CAST_KEYS) / 1e3 / (tokens / 1e3)
