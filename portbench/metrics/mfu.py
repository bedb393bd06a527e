"""The whole step's share of the chip's bf16 peak: model FLOPs the
window's served work needs (prefills and decode steps, attention over the
real contexts; nothing recomputed or padded) over window x 989 TFLOP/s.
In a traced run, over the window's parts the profiler left alone."""

from portbench.stats import model_flops
from portbench.yardstick import PEAK_BF16_FLOPS


def read(rec):
    spans = rec.quiet()          # a traced run: outside the profiled part
    seconds = sum(hi - lo for lo, hi in spans)
    work = sum(model_flops(rec, span) for span in spans)
    return 100.0 * work / (seconds * PEAK_BF16_FLOPS)
