"""Mean host time of one ServingEngine.step() that had a slot to run, in
the window (a traced run: outside its profiled part): the step period,
host issue and the read-back wait together."""

from portbench.stats import busy_steps


def read(rec):
    steps = busy_steps(rec)
    if not steps:
        return None
    return sum(b - a for a, b, _ in steps) / len(steps) * 1e3
