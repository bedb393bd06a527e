"""Share of the pages that the engine's pool reserves for requests which
requests hold, averaged over the window's steps (a traced run: outside its
profiled part): how much of the cache the deployment reserves the traffic
fills."""

import math


def read(rec):
    mean = rec.pages_mean()
    if not rec.pages_reserved or math.isnan(mean):
        return None
    return 100.0 * mean / rec.pages_reserved
