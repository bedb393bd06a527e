"""Set-up: process start to the window's opening (loading, weights,
warm-up, the first wave or lead-in; the kernels' build on a first run)."""


def read(rec):
    return rec.setup_s
