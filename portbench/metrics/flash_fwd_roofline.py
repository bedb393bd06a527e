"""B2 (``flash_attention_fwd_kernel``) against its compute bound: the causal
attention operations of the real prompt lengths admitted in the traced
stretch, as the record's decoder family counts them, at 989 TFLOP/s, over
the kernel's device time there."""

from portbench import yardstick
from portbench.stats import admitted
from portbench.trace import family_us


def read(rec):
    if rec.trace is None:
        return None
    kernel_us = family_us(rec.trace, yardstick.FLASH_FWD_KEYS)
    ops = sum(rec.family.attention_flops(rec.lm, r.prompt_len)
              for r in admitted(rec, rec.trace.host_span))
    if kernel_us <= 0 or ops <= 0:
        return None
    return 100.0 * yardstick.bound_s(ops, 0.0) / (kernel_us / 1e6)
