"""Mean host time per busy step (in the window outside a traced run's
profiled part) blocked on the card: the program's
``merlin.engine.readback`` (the decode chunks' read-back in ``_drain``)
and ``merlin.engine.first_token`` (the admissions' first tokens) spans."""

from portbench import spans


def read(rec):
    per = spans.per_step(rec, (spans.READBACK, spans.FIRST_TOKEN))
    return None if per is None else 1e3 * sum(per) / len(per)
