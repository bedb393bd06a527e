"""Mean host time per busy step (a step() that had a slot to run, in the
window outside a traced run's profiled part) in the program's
``merlin.engine.decode`` span: issuing the decode chunk, its inputs'
uploads included."""

from portbench import spans


def read(rec):
    per = spans.per_step(rec, (spans.DECODE,))
    return None if per is None else 1e3 * sum(per) / len(per)
