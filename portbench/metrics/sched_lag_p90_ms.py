"""The load generator's lateness: 90th percentile, over the requests due
in the window, of submission time - due time."""

from portbench.stats import due_in_window, percentile


def read(rec):
    return percentile(((r.submitted - r.due) * 1e3
                       for r in due_in_window(rec) if r.submitted), 90)
