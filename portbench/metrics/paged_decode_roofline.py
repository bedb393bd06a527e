"""B3 (``paged_rows_kernel``) against its byte bound. The bytes a decode step
needs come from the traffic's record of prompts and served tokens: each
decode token's query reads its prompt and every token before it (K and V,
once), plus its q and output rows, as the record's decoder family counts
them; their sum over the window's served tokens, over the window's busy
steps, is one step's need. B3's time a step is its device time in the
traced stretch over its launches there, a launch per layer and step. The
share is the need at 3.35 TB/s over that time."""

from portbench import yardstick
from portbench.stats import busy_steps, emitted
from portbench.trace import clipped


def read(rec):
    if rec.trace is None:
        return None
    lm, family = rec.lm, rec.family
    launches = [dur for name, _, dur in clipped(rec.trace.device,
                                                rec.trace.span)
                if any(k in name for k in yardstick.PAGED_ROWS_KEYS)]
    spans = rec.quiet()
    steps = sum(len(busy_steps(rec, span)) for span in spans)
    rows = family.decode_rows_bytes(lm)
    need = sum(family.kv_bytes(lm, r.prompt_len + j, rec.page_bytes) + rows
               for span in spans for r, j in emitted(rec, span) if j >= 1)
    if not launches or not steps or need <= 0:
        return None
    step_s = sum(launches) / 1e6 / (len(launches) / lm["num_hidden_layers"])
    return 100.0 * yardstick.bound_s(0.0, need / steps) / step_s
