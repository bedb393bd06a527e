"""An open loop of independent users over the port's ``ServingEngine``:
requests arrive on a Poisson schedule at a fixed rate whether or not the
earlier ones are served. A generator thread submits each when it is due,
as the worker's HTTP threads do, while the benchmark's thread runs
``step()`` as the worker's ``_engine_loop`` does (sleeping 5 ms when no
slot is busy).

Parameters (a traffic file): ``rate`` (requests/s); ``prompt_len`` and
``output_len`` distributions; ``block``: arrivals come in blocks of that
many, each spanning block / rate seconds and holding the same gaps and
lengths in its own order; ``lead_in_s`` (a whole number of blocks), arrivals before the window
opens, so that it opens in steady state; ``grace_s``, how long past the
close the requests due in the window may take to finish; ``engine``;
``check_sample``; ``trace_seconds``. Every seed gets the same gaps and
lengths in its own order, and its own token ids. Arrivals go on after the
window closes until each request due in it has finished, so the last ones
meet the same load as the first.
"""

from __future__ import annotations

import math
import threading
import time

import numpy as np

from portbench import serving
from portbench.record import Record, Req
from portbench.trace import Tracer

IDLE_SLEEP_S = 0.005


def schedule(traffic, seed: int, seconds: float, vocab: int, rate=None):
    """Requests with ``due`` as offsets in seconds from the first
    arrival's clock, enough to cover the lead-in, the window and the
    grace. Each block of ``block`` arrivals spans block / rate seconds
    exactly (its exponential gaps scaled to that sum)."""
    rate = rate or traffic["rate"]
    block = traffic["block"]
    horizon = traffic["lead_in_s"] + seconds + traffic["grace_s"] + 5
    n = int(math.ceil(rate * horizon / block)) * block
    rng = serving.seed_rng(seed, 2)

    def gap_quantiles(q):
        gaps = -np.log1p(-q)
        return gaps * (len(q) / rate / gaps.sum())
    gaps = serving.stratified(rng, n, block, gap_quantiles)
    prompts = serving.stratified(rng, n, block, serving.quantile_fn(
        traffic["prompt_len"]))
    outs = serving.stratified(rng, n, block, serving.quantile_fn(
        traffic["output_len"]))
    # each block's last arrival a microsecond before its span ends, so a
    # window of whole blocks holds whole blocks
    due = np.cumsum(gaps) - 1e-6
    return [Req(prompt_len=int(p), max_new=int(o), due=float(d),
                ids=serving.prompt_ids(rng, int(p), vocab))
            for d, p, o in zip(due, prompts, outs)]


class Generator(threading.Thread):
    """Submits each request at its due time (host clock)."""

    def __init__(self, engine, reqs, tracer):
        super().__init__(daemon=True)
        self.engine, self.reqs, self.tracer = engine, reqs, tracer
        self.stop = threading.Event()
        self.failure = None

    def run(self):
        try:
            for r in self.reqs:
                wait = r.due - time.perf_counter()
                if wait > 0 and self.stop.wait(wait):
                    return
                if self.stop.is_set():
                    return
                with self.tracer.span("portbench.submit"):
                    serving.submit(self.engine, r)
        except Exception as e:   # reported by the driver, which stops
            self.failure = e


def serve(engine, rec, reqs, seconds, traffic, trace: bool):
    """Run the schedule from now, into ``rec``: its window, requests and
    steps; returns the tracer."""
    start = time.perf_counter() + 0.01
    for r in reqs:
        r.due += start
    t0 = start + traffic["lead_in_s"]
    t1 = t0 + seconds
    tracer = Tracer(trace, t0 + max(0.0, (seconds - traffic["trace_seconds"])
                                    / 2), traffic["trace_seconds"])
    gen = Generator(engine, reqs, tracer)
    due_in_window = [r for r in reqs if t0 <= r.due <= t1]

    def finished(now):
        if gen.failure is not None:
            return True
        if now < t1:
            return False
        return now > t1 + traffic["grace_s"] or all(
            r.done for r in due_in_window)

    gen.start()
    try:
        serving.step_loop(engine, rec, tracer, finished, IDLE_SLEEP_S,
                          opens_at=t0)
    finally:
        gen.stop.set()
        gen.join(timeout=30)
        tracer.close()
    if gen.is_alive():
        raise RuntimeError("the request generator did not stop")
    if gen.failure is not None:
        raise gen.failure
    rec.window = (t0, t1)
    # every request due by the close, whether or not it was sent
    rec.requests = [r for r in reqs if r.submitted or r.due <= t1]
    return tracer


def run(cell, seed: int, seconds: float, trace: bool, device, t_start):
    config, traffic, family = cell["config"], cell["traffic"], cell["family"]
    model = serving.build_model(family, config, seed, device)
    engine = serving.make_engine(model, config, traffic["engine"], device)
    del model
    rec = Record(lm=family.widths(config), family=family,
                 page_bytes=serving.value_bytes(config), window=(0.0, 0.0),
                 requests=[], steps=[],
                 pages_reserved=engine.pool.free_pages)
    reqs = schedule(traffic, seed, seconds, config["vocab_size"])
    serving.warm_up(engine, [r.prompt_len for r in reqs],
                    config["vocab_size"])
    tracer = serve(engine, rec, reqs, seconds, traffic, trace)
    rec.memory_peak_bytes = serving.close(engine)
    rec.setup_s = rec.window[0] - t_start
    rec.trace, rec.perturbed = tracer.result, tracer.perturbed
    return rec
