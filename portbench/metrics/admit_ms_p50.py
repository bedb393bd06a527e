"""Median time of a request's admission: the start of its first prefill
(or prefill window) to the end of the ``merlin.engine.first_token``
read-back that returned its first token (prefill issue, ``_insert``, the
other admissions of that step, and the host's wait for the card), over the
requests whose submit and first token both lie in one part of the window
the profiler left alone."""

from portbench import spans
from portbench.stats import percentile


def read(rec):
    lives = spans.admissions(rec)
    if not lives:
        return None
    return 1e3 * percentile([end - start for _, start, end in lives], 50)
