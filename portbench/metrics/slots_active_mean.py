"""Mean slots decoded a step (step()'s return) over the window's steps
(a traced run: outside its profiled part)."""

from portbench.stats import busy_steps


def read(rec):
    steps = busy_steps(rec)
    return sum(n for _, _, n in steps) / len(steps) if steps else None
