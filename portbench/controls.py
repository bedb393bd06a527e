"""The readings that a cell's correctness limit is set from (not run by the
benchmark's own runs).

    python3 portbench/controls.py --workload <cell> --seeds 11,12,13 \
        --seconds 10 [--sample 6]

For each seed, in one process: one run of the cell at its own sizes and
load (a short window), then, on a sample of the requests it finished, the
widest gap of the served tokens against the plain reference (the lower
reading: what a sound run gives) and each control's widest gap: the gap, in
the reference's logits, of the tokens that the reference computed in a
precision below the configuration's (``controls`` in its file: fp8 for
bf16 compute, int4 for int8 weights) puts first at the same positions (the
upper reading). Each is judged as a run of the benchmark is judged
(``portbench.check.judge``): the program's tokens have to come out correct
and each control's not. One JSON line a seed on standard output, with the
window's memory peak and the pages in use.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

if not __package__:
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
from portbench import run as _run  # noqa: E402  (path, environment)
from portbench import manifest  # noqa: E402


def readings(cell, seed: int, seconds: float, sample: int, device):
    config = cell["config"]
    cell = dict(cell, traffic=dict(cell["traffic"], check_sample=sample))
    driver = manifest.load_module(cell["driver"])
    rec = driver.run(cell, seed, seconds, False, device,
                     time.perf_counter())
    _, failed, verdicts = _run.outcome(cell, rec, seed, device,
                                       config["controls"])
    (program, checks), controls = verdicts[0], verdicts[1:]
    return {"seed": seed, "program_gap": checks["gap_max"]["value"],
            "program_correct": program, "failed": failed,
            "controls": {name: {"gap": c["gap_max"]["value"],
                                "correct": ok}
                         for name, (ok, c) in zip(config["controls"],
                                                  controls)},
            "served_tokens": checks["served_tokens_min"]["value"],
            "limit": config["gap_limit"],
            "memory_peak_bytes": rec.memory_peak_bytes,
            "pages_in_use": rec.pages_mean(),
            "pages_reserved": rec.pages_reserved}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--sample", type=int, default=0,
                   help="requests compared a seed (0: the traffic's own)")
    args = p.parse_args(argv)
    cell = manifest.cell(manifest.load(), args.workload)
    sample = args.sample or cell["traffic"]["check_sample"]
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(cell, seed, args.seconds, sample, "cuda")),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
