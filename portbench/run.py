"""Benchmark of the PyTorch/CUDA port (``merlin_tpu_torch``): one run of one
cell of ``BENCHMARK.json``.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks for.
The cell's configuration, decoder family, traffic mix, driver and metric
readers are found by name (``portbench/manifest.py``). The run builds the
model with weights made from the seed on the card, warms every shape its
traffic uses (set-up), measures for ``--seconds``, frees the program's
state, and checks a sample of what the timed path served against the plain
reference. The last line of
standard output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics from a profiled stretch of the window), ``device``,
``breakdown`` (traced runs) and ``checks``, each compared number beside its
limit, which also end standard error.

Exit codes: 0 for a run that printed its result, 3 when the cards the cell
asks for are not there, 4 when JAX or the JAX package was loaded (checked
at start-up, once the window has closed, and before the result is
printed).
"""

from __future__ import annotations

import os
import sys
import time

T_START = time.perf_counter()
HERE = os.path.dirname(os.path.abspath(__file__))
CHECKOUT = os.path.dirname(HERE)
# the checkout first; this directory off the path, so that its modules
# shadow nothing of the standard library (``trace``)
sys.path[:] = [CHECKOUT] + [p for p in sys.path
                            if os.path.abspath(p or ".") != HERE]
# transformers must not load JAX or TensorFlow behind the port's back
for _flag in ("USE_FLAX", "USE_JAX", "USE_TF"):
    os.environ[_flag] = "0"
# build and kernel caches at fixed paths inside the checkout
_CACHE = os.path.join(CHECKOUT, ".portbench_cache")
os.environ["TRITON_CACHE_DIR"] = os.path.join(_CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(_CACHE, "torch_extensions")

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402

from portbench import manifest  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "merlin_tpu")


def forbidden_modules():
    """Top-level names of loaded modules that the port must not load,
    compared whole (``merlin_tpu_torch`` is not ``merlin_tpu``)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)}
                  & set(FORBIDDEN))


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def failures(rec, attempted, pipeline: int):
    """Requests that erred, or that should have finished by the close and
    have not: one due by the close (open loop: the driver waits past the
    close until those due in the window have finished), or one sent long
    enough before the close that its tokens would have come at the
    window's slowest busy step (closed loop: counted from the window's
    opening, with a step for its admission, one for the call it was sent
    in, ``pipeline`` for the read-back, and the profiled stretch of a
    traced run on top)."""
    from portbench.stats import busy_steps

    t0, t1 = rec.window
    slowest = max((b - a for a, b, _ in busy_steps(rec)), default=math.inf)
    held = rec.perturbed[1] - rec.perturbed[0] if rec.perturbed else 0.0

    def late(r):
        if r.done:
            return False
        if r.due:
            return True
        steps = r.max_new + pipeline + 2
        return max(r.submitted, t0) + steps * slowest + held <= t1
    return [r for r in attempted if r.error is not None or late(r)]


def outcome(cell, rec, seed, device, controls=()):
    """(attempted, failed, verdicts): every request due or sent by the
    close counts as attempted, and :func:`failures` as failed; a sample of
    the finished ones goes through the reference. ``verdicts`` holds
    (correct, checks) for the served tokens, then one for the tokens that
    each precision of ``controls`` puts first (``portbench/controls.py``),
    judged alike."""
    from portbench import check

    config, traffic = cell["config"], cell["traffic"]
    attempted = [r for r in rec.requests
                 if (r.due or r.submitted) <= rec.window[1]]
    failed = failures(rec, attempted, traffic["engine"]["pipeline"])
    sample = check.sample(rec.requests, traffic["check_sample"], seed)
    served = sum(len(r.tokens) for r in sample)
    precisions = [config["precision"], *controls]
    gaps = (check.widest_gaps(cell["family"], config, seed, sample,
                              precisions, device)
            if sample else [math.nan] * len(precisions))
    verdicts = [check.judge(config, traffic, gap, len(failed), served)
                for gap in gaps]
    return len(attempted), len(failed), verdicts


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_start: float = T_START):
    """One run of ``cell`` on ``device``: the result line's object, or
    None when a module the port must not load was loaded."""
    import torch

    kinds = ("per_layer",) if trace else ("end_to_end",)
    wanted = [m for kind in kinds for m in cell[kind]]
    readers = manifest.readers(wanted)
    driver = manifest.load_module(cell["driver"])
    rec = driver.run(cell, seed, seconds, trace, device, t_start)
    lo, hi = rec.window
    print(f"portbench: seed {seed}: set-up {rec.setup_s:.3f} s, window "
          f"{hi - lo:.3f} s, {len(rec.steps)} steps, {len(rec.requests)} "
          f"requests, window's peak {rec.memory_peak_bytes} bytes, pages "
          f"in use {rec.pages_mean():.1f} of {rec.pages_reserved}",
          file=sys.stderr, flush=True)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: loaded {bad}: the port must not import JAX or "
              "the JAX package", file=sys.stderr)
        return None
    attempted, failed, [(correct, checks)] = outcome(cell, rec, seed,
                                                     device)
    metrics = {}
    for m in wanted:
        value = readers[m["name"]](rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    kind = (torch.cuda.get_device_name(0) if torch.cuda.is_available()
            else "cpu")
    dev = {"platform": "gpu", "kind": kind,
           "count": cell["workload"]["chips"],
           "memory_peak_bytes": rec.memory_peak_bytes}
    result = {"correct": bool(correct), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": dev}
    if trace:
        from portbench import trace as tr

        if rec.trace is None:
            raise RuntimeError("the traced stretch did not run")
        lo, hi = rec.trace.span
        dev["busy_s"] = tr.busy_us(rec.trace) / 1e6
        dev["window_s"] = (hi - lo) / 1e6
        result["breakdown"] = {"device_ops": tr.top_ops(rec.trace),
                               "idle_gaps": tr.idle_gaps(rec.trace)}
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    args = parse(argv)
    cell = manifest.cell(manifest.load(), args.workload)
    chips = cell["workload"]["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA card(s); "
              f"available: {torch.cuda.is_available()}, count "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 3
    if forbidden_modules():
        print(f"portbench: loaded {forbidden_modules()} at start-up",
              file=sys.stderr)
        return 4
    torch.set_num_threads(4)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda")
    if result is None:
        return 4
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    if forbidden_modules():
        print(f"portbench: loaded {forbidden_modules()} by the end of the "
              "run", file=sys.stderr)
        return 4
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
