"""A closed loop of clients over the port's ``ServingEngine``: each client
sends its next request when the engine has served the last token of its
previous one, as batch and agent callers that keep a fixed number of
requests in flight do.

Parameters (a traffic file): ``clients``; ``prompt_len`` and
``output_len`` distributions, drawn in blocks of ``block`` requests that
each hold the same lengths; ``first_wave_output_len``, the budgets of
the requests in flight when the window opens, so that it opens in steady
state; ``pool``, how many requests the seed draws; ``engine``, the
engine's settings; ``check_sample``; ``trace_seconds``. Every seed gets
the same lengths in its own order, and its own token ids.
"""

from __future__ import annotations

import time

from portbench import serving
from portbench.record import Record, Req
from portbench.trace import Tracer


def requests(traffic, seed: int, vocab: int):
    """(first wave, pool) of :class:`Req` as the seed draws them."""
    rng = serving.seed_rng(seed, 1)
    n, clients, block = traffic["pool"], traffic["clients"], traffic["block"]
    prompts = serving.stratified(rng, n, block, serving.quantile_fn(
        traffic["prompt_len"]))
    outs = serving.stratified(rng, n, block, serving.quantile_fn(
        traffic["output_len"]))
    first = serving.stratified(rng, clients, clients, serving.quantile_fn(
        traffic["first_wave_output_len"]))
    pool = [Req(prompt_len=int(p), max_new=int(o),
                ids=serving.prompt_ids(rng, int(p), vocab))
            for p, o in zip(prompts, outs)]
    wave = [Req(prompt_len=r.prompt_len, max_new=int(o), ids=r.ids)
            for r, o in zip(pool[:clients], first)]
    return wave, pool[clients:]


def run(cell, seed: int, seconds: float, trace: bool, device, t_start):
    config, traffic, family = cell["config"], cell["traffic"], cell["family"]
    model = serving.build_model(family, config, seed, device)
    engine = serving.make_engine(model, config, traffic["engine"], device)
    del model
    rec = Record(lm=family.widths(config), family=family,
                 page_bytes=serving.value_bytes(config), window=(0.0, 0.0),
                 requests=[], steps=[],
                 pages_reserved=engine.pool.free_pages)
    wave, pool = requests(traffic, seed, config["vocab_size"])
    serving.warm_up(engine, [r.prompt_len for r in wave + pool],
                    config["vocab_size"])
    state = {"next": 0, "open": True}

    def next_request(_done=None):
        if not state["open"]:
            return
        src = pool[state["next"] % len(pool)]
        state["next"] += 1
        rec.requests.append(serving.submit(engine, Req(
            prompt_len=src.prompt_len, max_new=src.max_new, ids=src.ids),
            next_request))

    for r in wave:
        rec.requests.append(serving.submit(engine, r, next_request))
    engine.step()            # admits the whole first wave
    t0 = time.perf_counter()
    t1 = t0 + seconds
    tracer = Tracer(trace, t0 + max(0.0, (seconds - traffic["trace_seconds"])
                                    / 2), traffic["trace_seconds"])
    serving.step_loop(engine, rec, tracer, lambda now: now >= t1)
    rec.window = (t0, time.perf_counter())
    state["open"] = False
    tracer.close()
    rec.memory_peak_bytes = serving.close(engine)
    rec.setup_s = t0 - t_start
    rec.trace, rec.perturbed = tracer.result, tracer.perturbed
    return rec
