"""The port's spans and counters on the CPU: ``utils.profiling``'s span
store (off by default, on any thread, bounded), the spans
``ServingEngine.step`` and the decoder record on both admission routes,
``ServingEngine.stats()`` over a scripted run with a forced preemption, and
the worker's status carrying those counters."""

import threading
import time

import numpy as np
import pytest
import torch

from merlin_tpu_torch.models.decoder import CausalLM
from merlin_tpu_torch.models.families import tiny
from merlin_tpu_torch.serve.engine import ServingEngine
from merlin_tpu_torch.utils import profiling

BASE = dict(num_slots=2, max_len=64, eos_id=-1, pad_id=0, prompt_bucket=16,
            page_size=16, cache_dtype=torch.float32, device="cpu")
PROMPTS = [[5, 17, 33, 41], [7, 9, 11], [21, 22], list(range(3, 20))]
CHUNKED = dict(page_size=8, prefill_chunk=8, chunk_steps=1)

STEP = "merlin.engine.step"
UNDER_STEP = {"merlin.engine.admit", "merlin.engine.grow_pages",
              "merlin.engine.decode", "merlin.engine.drain"}
PER_REQUEST = {"merlin.engine.submit", "merlin.engine.prefill",
               "merlin.engine.insert", "merlin.engine.window"}


@pytest.fixture(autouse=True)
def _one_thread_spans_off():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    profiling.disable_spans()
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def model():
    torch.manual_seed(0)
    return CausalLM(tiny()).eval()


def _serve(engine, prompts, max_new=6):
    """Serve ``prompts`` to idle; each request's first emit time (ns)."""
    first = {}

    def emitter(i):
        def emit(token, done):
            first.setdefault(i, time.perf_counter_ns())
        return emit
    reqs = [engine.submit(p, max_new_tokens=max_new, emit=emitter(i))
            for i, p in enumerate(prompts)]
    engine.run_until_idle()
    assert all(r.done and r.error is None for r in reqs)
    return reqs, [first[i] for i in range(len(prompts))]


def test_disabled_spans_record_nothing(model):
    profiling.enable_spans()
    profiling.disable_spans()
    # the shared no-op: no object is made a call
    assert profiling.annotate("merlin.a") is profiling.annotate("merlin.b")
    _serve(ServingEngine(model, **BASE), PROMPTS[:2])
    snap = profiling.spans()
    assert snap.records == [] and not snap.wrapped


@pytest.mark.parametrize("kw,route", [({}, "merlin.engine.prefill"),
                                      (CHUNKED, "merlin.engine.window")],
                         ids=["whole_prompt", "chunked"])
def test_engine_span_tree(model, kw, route):
    engine = ServingEngine(model, **dict(BASE, **kw))
    profiling.enable_spans()
    reqs, first = _serve(engine, PROMPTS)
    profiling.disable_spans()
    snap = profiling.spans()
    assert not snap.wrapped
    spans = snap.records
    names = {s.name for s in spans}
    # a CPU engine issues every decode chunk eagerly, each marked by an
    # empty eager-chunk span
    assert {STEP, route, "merlin.engine.insert", "merlin.engine.first_token",
            "merlin.engine.readback", "merlin.decoder.layers",
            "merlin.decoder.head", "merlin.engine.eager_chunk"} \
        | UNDER_STEP <= names
    parents = {
        STEP: {None}, "merlin.engine.submit": {None},
        "merlin.engine.admit": {STEP}, "merlin.engine.grow_pages": {STEP},
        "merlin.engine.decode": {STEP},
        "merlin.engine.eager_chunk": {"merlin.engine.decode"},
        # a forced drain settles the pipeline from page growth too
        "merlin.engine.drain": {STEP, "merlin.engine.grow_pages"},
        "merlin.engine.readback": {"merlin.engine.drain"},
        "merlin.engine.prefill": {"merlin.engine.admit"},
        "merlin.engine.window": {"merlin.engine.admit"},
        "merlin.engine.insert": {"merlin.engine.admit"},
        "merlin.engine.first_token": {"merlin.engine.admit"},
        "merlin.decoder.layers": {route, "merlin.engine.decode"},
        "merlin.decoder.head": {route, "merlin.engine.decode"},
    }
    ids = {r.req_id for r in reqs}
    for s in spans:
        assert s.parent in parents[s.name], s
        assert (s.req in ids) if s.name in PER_REQUEST else s.req is None, s
        assert s.start_ns <= s.end_ns
    # the children of each step cover it up to its own bookkeeping
    steps = [s for s in spans if s.name == STEP]
    kids = [s for s in spans if s.parent == STEP]
    covered = sum(k.end_ns - k.start_ns for k in kids)
    total = sum(s.end_ns - s.start_ns for s in steps)
    assert all(any(s.start_ns <= k.start_ns and k.end_ns <= s.end_ns
                   for s in steps) for k in kids)
    assert covered >= 0.95 * total, covered / total
    # each request: first token seen = queue wait + admission, where the
    # admission ends with the first-token read-back after its insert
    reads = sorted((s.start_ns, s.end_ns) for s in spans
                   if s.name == "merlin.engine.first_token")
    for req, emit in zip(reqs, first):
        mine = sorted((s.start_ns, s.end_ns, s.name) for s in spans
                      if s.req == req.req_id)
        submit = next(a for a, _, n in mine if n == "merlin.engine.submit")
        start = next(a for a, _, n in mine if n == route)
        inserted = next(b for _, b, n in mine
                        if n == "merlin.engine.insert")
        end = next(b for a, b in reads if a >= inserted)
        queue, admit = start - submit, end - start
        assert queue >= 0 and admit > 0
        assert 0 <= emit - (submit + queue + admit) < 1_000_000
    windows = [s for s in spans if s.name == "merlin.engine.window"]
    assert bool(windows) == (route == "merlin.engine.window")


def test_submits_from_another_thread_are_recorded(model):
    engine = ServingEngine(model, **BASE)
    profiling.enable_spans()
    got = []
    thread = threading.Thread(target=lambda: got.extend(
        engine.submit(p, max_new_tokens=2) for p in PROMPTS))
    thread.start()
    thread.join()
    engine.run_until_idle()
    spans = profiling.spans().records
    submits = [s for s in spans if s.name == "merlin.engine.submit"]
    assert sorted(s.req for s in submits) == [r.req_id for r in got]
    assert {s.thread for s in submits} == {thread.ident}
    assert all(s.thread == threading.get_ident()
               for s in spans if s.name == STEP)


def test_the_store_wraps_and_says_so():
    size = profiling.SPAN_STORE_SIZE
    assert size >= 1 << 17
    profiling.enable_spans()
    for i in range(size + 5):
        with profiling.annotate("merlin.x", i):
            pass
    snap = profiling.spans()
    assert len(snap.records) == size and snap.dropped == 5 and snap.wrapped
    assert snap.records[0].req == 5 and snap.records[-1].req == size + 4
    profiling.enable_spans()            # a fresh store
    assert profiling.spans().records == []


def test_concurrent_threads_lose_no_span_and_keep_their_own_parents():
    """More threads than cores append at once, switching as often as the
    interpreter allows: every span is kept, each under its own thread's
    enclosing span."""
    import os
    import sys

    threads, each = 2 * (os.cpu_count() or 1) + 2, 300
    profiling.enable_spans()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        # all alive until all are done: no thread's ident is reused
        done = threading.Barrier(threads)

        def work(t):
            for i in range(each):
                with profiling.annotate(f"merlin.outer{t}", t):
                    with profiling.annotate(f"merlin.inner{t}", i):
                        pass
            done.wait(timeout=120)
        pool = [threading.Thread(target=work, args=(t,))
                for t in range(threads)]
        for th in pool:
            th.start()
        for th in pool:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in pool)
    finally:
        sys.setswitchinterval(interval)
    snap = profiling.spans()
    assert snap.dropped == 0 and len(snap.records) == 2 * threads * each
    owner = {}
    for s in snap.records:
        kind, t = s.name[:12], int(s.name[12:])     # merlin.outer / .inner
        if kind == "merlin.inner":
            assert s.parent == f"merlin.outer{t}", s
        else:
            assert s.parent is None and s.req == t, s
        owner.setdefault(s.thread, set()).add(t)
    assert len(owner) == threads
    assert all(len(ts) == 1 for ts in owner.values()), owner


def test_spans_nest_per_thread_and_enter_the_profiler():
    profiling.enable_spans()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.annotate("merlin.outer"):
            with profiling.annotate("merlin.inner", 7):
                torch.ones(8).sum()
    spans = {s.name: s for s in profiling.spans().records}
    assert spans["merlin.inner"].parent == "merlin.outer"
    assert spans["merlin.inner"].req == 7
    assert spans["merlin.outer"].parent is None
    traced = {e.name for e in prof.events()}
    assert {"merlin.outer", "merlin.inner"} <= traced


def test_disabled_annotate_costs_under_a_microsecond():
    annotate, n = profiling.annotate, 20000
    best = float("inf")
    for _ in range(5):
        t = time.perf_counter()
        for _ in range(n):
            with annotate("merlin.x"):
                pass
        best = min(best, (time.perf_counter() - t) / n)
    assert best < 1e-6, best


def test_counters_follow_a_scripted_run_with_a_preemption(model):
    # two 40-token prompts on a pool one page short: growth preempts
    engine = ServingEngine(model, **dict(BASE, chunk_steps=4))
    reserved = engine.pool.free_pages
    zero = dict(queued=0, active=0, prefilling=0, admitted=0, finished=0,
                failed=0, preempted=0, pages_used=0, pages_reserved=reserved,
                graph_replays=0, eager_chunks=0)
    assert engine.stats() == zero
    too_long = engine.submit(list(range(3, 80)), max_new_tokens=2)
    reqs = [engine.submit(p, max_new_tokens=8)
            for p in (range(5, 45), range(7, 47))]
    assert engine.stats()["queued"] == 3
    engine.step()
    # the oversized prompt fails; both long ones admit (3 pages each), and
    # growing the first to 4 pages preempts the second back to the queue
    assert too_long.error is not None
    assert engine.stats() == dict(zero, queued=1, active=1, admitted=2,
                                  failed=1, preempted=1, pages_used=4,
                                  eager_chunks=1)
    assert engine.pool.free_pages == reserved - 4
    engine.run_until_idle()
    s = engine.stats()
    assert all(r.done and r.error is None for r in reqs)
    assert s["preempted"] >= 1 and s["eager_chunks"] > 1
    # a CPU engine never replays: every decode chunk is eager
    assert s == dict(zero, admitted=2 + s["preempted"], finished=2,
                     failed=1, preempted=s["preempted"],
                     eager_chunks=s["eager_chunks"])
    # a request left in flight counts as failed by fail_all
    engine.submit([5, 6, 7], max_new_tokens=8)
    engine.step()
    engine.fail_all("test")
    assert engine.stats() == dict(s, admitted=s["admitted"] + 1, failed=2,
                                  eager_chunks=s["eager_chunks"] + 1)


def test_counters_count_chunked_prefill(model):
    engine = ServingEngine(model, **dict(BASE, max_len=96, **CHUNKED,
                                         prefill_windows_per_step=1))
    first = engine.submit([5, 17, 33, 41], max_new_tokens=12)
    engine.step()
    engine.submit(list(range(7, 44)), max_new_tokens=4)
    engine.step()
    s = engine.stats()
    assert (s["active"], s["prefilling"], s["admitted"]) == (1, 1, 2)
    engine.run_until_idle()
    assert first.done
    assert engine.stats()["finished"] == 2


def test_worker_status_carries_the_engine_counters():
    from merlin_tpu_torch.models import builder
    from merlin_tpu_torch.serve.worker import ModelWorker
    from merlin_tpu_torch.train import arguments

    bundle = builder.build_model_tokenizer(
        arguments.ModelArguments(), arguments.DataArguments(image_size=16),
        arguments.TrainingArguments(gradient_checkpointing=False,
                                    model_max_length=128), tiny=True)
    builder.init_or_load_params(bundle, generator=torch.Generator().manual_seed(
        3), device="cpu")
    plain = ModelWorker(bundle, worker_address="http://127.0.0.1:1",
                        device="cpu")
    assert plain.status()["engine"] is None
    worker = ModelWorker(bundle, worker_address="http://127.0.0.1:1",
                         use_engine=True, engine_cache_dtype="f32",
                         engine_max_len=256, device="cpu")
    try:
        status = worker.status()
        assert {"model_names", "speed", "queue_length"} < set(status)
        assert set(status["engine"]) == {
            "queued", "active", "prefilling", "admitted", "finished",
            "failed", "preempted", "pages_used", "pages_reserved",
            "graph_replays", "eager_chunks"}
        chunks = list(worker.generate_stream(
            {"prompt": "hello there", "temperature": 0.0,
             "max_new_tokens": 2}))
        assert chunks
        deadline = time.time() + 60
        while worker.status()["engine"]["finished"] < 1:
            assert time.time() < deadline
            time.sleep(0.01)
        engine = worker.status()["engine"]
        assert engine["admitted"] == 1 and engine["failed"] == 0
        assert engine["pages_reserved"] > 0
    finally:
        worker.stop()
        plain.stop()


def test_decoder_spans_wrap_the_layers_and_the_head(model):
    profiling.enable_spans()
    with torch.no_grad():
        model(torch.tensor(np.arange(1, 9)[None]))
    spans = profiling.spans().records
    assert [s.name for s in spans] == ["merlin.decoder.layers",
                                       "merlin.decoder.head"]
    layers, head = spans
    assert layers.end_ns <= head.start_ns
