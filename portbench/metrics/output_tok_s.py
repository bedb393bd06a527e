"""Tokens the clients received in the window over the window's length."""

from portbench.stats import emitted


def read(rec):
    lo, hi = rec.window
    return len(emitted(rec, rec.window)) / (hi - lo)
