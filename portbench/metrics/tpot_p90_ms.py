"""90th percentile, over the requests due in the window, of (last token -
first token) / (tokens - 1) at the client."""

from portbench.stats import due_in_window, percentile


def read(rec):
    return percentile(((r.last - r.first) * 1e3 / (len(r.tokens) - 1)
                       for r in due_in_window(rec)
                       if r.done and len(r.tokens) > 1), 90)
