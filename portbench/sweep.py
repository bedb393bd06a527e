"""The knee of an open-loop cell: the highest arrival rate the system
sustains, found once, by a sweep on the chip (not run by the benchmark's
own runs). The cell's traffic file then carries a fixed rate below it.

    python3 portbench/sweep.py --workload <cell> --rates 1,1.5,2 \
        --seconds 20 --seed <n>

One process builds the cell's model and engine once, then runs the cell's
schedule at each rate for a window of ``--seconds`` (after its lead-in,
until every request due in the window has finished) and drains the engine
before the next. A rate is sustained when the requests due in the last
quarter of the window wait no longer for their first token than those of
the first quarter, within a half: a growing backlog shows as a growing wait.
One JSON line a rate on standard output.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

if not __package__:
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
from portbench import run as _run  # noqa: E402,F401  (path, environment)
from portbench import manifest, serving, stats  # noqa: E402
from portbench.drivers import open_loop  # noqa: E402
from portbench.record import Record  # noqa: E402


def reading(reqs, t0, t1, rate):
    due = sorted((r for r in reqs if t0 <= r.due <= t1), key=lambda r: r.due)
    waits = [(r.first - r.due) * 1e3 for r in due if r.first is not None]
    q = max(len(waits) // 4, 1)
    first, last = waits[:q], waits[-q:]
    mean = lambda xs: sum(xs) / len(xs)   # noqa: E731
    return {"rate": rate, "due": len(due), "served": len(waits),
            "queued_at_close": sum(1 for r in due
                                   if r.first is None or r.first > t1),
            "ttft_p50_ms": stats.percentile(waits, 50),
            "ttft_p90_ms": stats.percentile(waits, 90),
            "wait_first_quarter_ms": mean(first),
            "wait_last_quarter_ms": mean(last),
            "sustained": mean(last) <= 1.5 * mean(first) + 50.0}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=20.0)
    p.add_argument("--seed", type=int, default=1)
    args = p.parse_args(argv)
    cell = manifest.cell(manifest.load(), args.workload)
    config, traffic, family = cell["config"], cell["traffic"], cell["family"]
    model = serving.build_model(family, config, args.seed, "cuda")
    engine = serving.make_engine(model, config, traffic["engine"], "cuda")
    del model
    for rate in (float(r) for r in args.rates.split(",")):
        reqs = open_loop.schedule(traffic, args.seed, args.seconds,
                                  config["vocab_size"], rate=rate)
        serving.warm_up(engine, [r.prompt_len for r in reqs],
                        config["vocab_size"])
        rec = Record(lm=family.widths(config), family=family, page_bytes=0.0,
                     window=(0.0, 0.0), requests=[], steps=[])
        open_loop.serve(engine, rec, reqs, args.seconds, traffic, False)
        engine.run_until_idle()
        print(json.dumps(reading(rec.requests, *rec.window, rate)),
              flush=True)
    serving.close(engine)
    return 0


if __name__ == "__main__":
    sys.exit(main())
