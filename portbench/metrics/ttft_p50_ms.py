"""Median, over every request due in the window, of the time from when it
was due to its first token at the client."""

from portbench.stats import due_in_window, percentile


def read(rec):
    return percentile(((r.first - r.due) * 1e3 for r in due_in_window(rec)
                       if r.first is not None), 50)
