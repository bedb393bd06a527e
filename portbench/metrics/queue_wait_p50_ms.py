"""Median time a request waits in the engine's queue: its
``merlin.engine.submit`` span to the start of its admission (its first
prefill or prefill window), over the requests whose submit and first
token both lie in one part of the window the profiler left alone."""

from portbench import spans
from portbench.stats import percentile


def read(rec):
    lives = spans.admissions(rec)
    if not lives:
        return None
    return 1e3 * percentile([start - submit for submit, start, _ in lives],
                            50)
