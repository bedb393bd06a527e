"""``ServingEngine``'s replayed decode step against the plain eager engine,
on the CPU and without JAX.

A CPU has no CUDA graphs, so the engine's one capture helper
(``serve.engine._capture``) is replaced by a stand-in whose "replay" runs
the captured function again, into the same buffers. Each case serves one
script of submissions and steps on two engines over the same model: the
stand-in's, and one kept eager by its test hook (``_eager_only``). Every
request's tokens and error, and every counter of ``stats()`` but the two
that split the decode chunks, must agree; the chunks each engine issued
must add up alike. The cases cover admissions mid-run, requests finishing
mid-chunk, a preemption, ``fail_all`` and new requests after it,
``pipeline`` 0 / 2 / 8 and ``chunk_steps`` 1 / 3, chunked prefill, the
stacked layout, the tiny RoPE and ALiBi models over bf16 and int8 pools; a
sampled request, whose chunks stay eager; a speculative engine and a CPU
engine without the stand-in, which never replay. Also: a replay counts the
launches its capture counted, and the drain waits for every chunk but the
newest.
"""

import numpy as np
import pytest
import torch

from merlin_tpu_torch.models.decoder import CausalLM
from merlin_tpu_torch.models.families import tiny
from merlin_tpu_torch.serve import engine as engine_mod
from merlin_tpu_torch.serve.engine import ServingEngine

EOS, PAD = 2, 0
BASE = dict(num_slots=3, max_len=64, eos_id=EOS, pad_id=PAD,
            prompt_bucket=16, page_size=16)
SPLIT = ("graph_replays", "eager_chunks")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _model(positional, scan=False):
    torch.manual_seed(0 if positional == "rope" else 1)
    model = CausalLM(tiny(positional=positional, scan_layers=scan)).eval()
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn_like(p))
    return model


@pytest.fixture(scope="module")
def models():
    return {"rope": _model("rope"), "alibi": _model("alibi"),
            "scan": _model("rope", scan=True)}


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(3, 120, n).tolist()


# (action, arguments): submit (prompt, max_new, temperature), step (count),
# fail_all, idle (run until idle)
MID_RUN = [
    ("submit", (_prompt(1, 5), 7, 0.0)), ("submit", (_prompt(2, 11), 5, 0.0)),
    ("step", 3),
    ("submit", (_prompt(3, 3), 8, 0.0)), ("submit", (_prompt(4, 19), 4, 0.0)),
    ("step", 2),
    ("submit", (_prompt(5, 7), 6, 0.0)),
    ("idle", None)]
# two 40-token prompts whose growth cannot both fit the 3-slot pool
PREEMPT = [
    ("submit", (_prompt(6, 40), 9, 0.0)), ("submit", (_prompt(7, 41), 9, 0.0)),
    ("submit", (_prompt(8, 38), 9, 0.0)),
    ("idle", None)]
FAIL_ALL = [
    ("submit", (_prompt(9, 6), 9, 0.0)), ("submit", (_prompt(10, 13), 9, 0.0)),
    ("step", 4), ("fail_all", None),
    ("submit", (_prompt(11, 4), 6, 0.0)), ("submit", (_prompt(12, 9), 5, 0.0)),
    ("idle", None)]
SAMPLED = [
    ("submit", (_prompt(13, 6), 8, 0.0)), ("submit", (_prompt(14, 9), 3, 0.9)),
    ("step", 2),
    ("submit", (_prompt(15, 5), 7, 0.0)),
    ("idle", None)]

CASES = {
    # name: (model, pool, script, engine options)
    "rope_bf16_mid_run_p0_c1": ("rope", torch.bfloat16, MID_RUN,
                                dict(pipeline=0, chunk_steps=1)),
    "rope_int8_mid_run_p2_c3": ("rope", torch.int8, MID_RUN,
                                dict(pipeline=2, chunk_steps=3)),
    "alibi_bf16_mid_run_p8_c1": ("alibi", torch.bfloat16, MID_RUN,
                                 dict(pipeline=8, chunk_steps=1)),
    "alibi_int8_mid_run_p2_c3": ("alibi", torch.int8, MID_RUN,
                                 dict(pipeline=2, chunk_steps=3)),
    "rope_bf16_preempt_p2_c1": ("rope", torch.bfloat16, PREEMPT,
                                dict(pipeline=2, chunk_steps=1)),
    "alibi_int8_preempt_p0_c3": ("alibi", torch.int8, PREEMPT,
                                 dict(pipeline=0, chunk_steps=3)),
    "rope_int8_fail_all_p2_c1": ("rope", torch.int8, FAIL_ALL,
                                 dict(pipeline=2, chunk_steps=1)),
    "alibi_bf16_fail_all_p8_c3": ("alibi", torch.bfloat16, FAIL_ALL,
                                  dict(pipeline=8, chunk_steps=3)),
    "rope_bf16_chunked_p2_c1": ("rope", torch.bfloat16, MID_RUN,
                                dict(pipeline=2, chunk_steps=1,
                                     prefill_chunk=16, prefill_chunk_min=8)),
    "scan_bf16_mid_run_p2_c3": ("scan", torch.bfloat16, MID_RUN,
                                dict(pipeline=2, chunk_steps=3)),
    "rope_bf16_sampled_p2_c1": ("rope", torch.bfloat16, SAMPLED,
                                dict(pipeline=2, chunk_steps=1)),
}
# engines that never replay: (model, pool, script, options, stand-in)
NEVER = {
    "spec_draft": ("rope", torch.bfloat16, MID_RUN,
                   dict(pipeline=2, chunk_steps=1, spec_draft=3), True),
    "cpu_without_stand_in": ("alibi", torch.int8, MID_RUN,
                             dict(pipeline=2, chunk_steps=3), False),
}


def _replaying(fn, device):
    """The stand-in capture: each replay runs ``fn`` again."""
    del device
    return fn


def _run(engine, script):
    """Play ``script``; returns each request's (tokens, error) and the
    engine's counters."""
    reqs = []
    for action, arg in script:
        if action == "submit":
            prompt, max_new, temperature = arg
            reqs.append(engine.submit(prompt, max_new_tokens=max_new,
                                      temperature=temperature))
        elif action == "step":
            for _ in range(arg):
                engine.step()
        elif action == "fail_all":
            engine.fail_all("reset")
        else:
            engine.run_until_idle()
    assert all(r.done for r in reqs)
    return [(r.generated, r.error) for r in reqs], engine.stats()


def _pair(models, monkeypatch, name, pool, script, kw, stand_in=True):
    """(replaying engine's result, eager engine's result)."""
    if stand_in:
        monkeypatch.setattr(engine_mod, "_capture", _replaying)
    opts = dict(BASE, cache_dtype=pool, device="cpu", rng_seed=3, **kw)
    graph = ServingEngine(models[name], **opts)
    eager = ServingEngine(models[name], **opts)
    eager._eager_only = True
    return _run(graph, script), _run(eager, script)


def _same_service(got, want):
    (g_reqs, g_stats), (w_reqs, w_stats) = got, want
    assert g_reqs == w_reqs
    assert {k: v for k, v in g_stats.items() if k not in SPLIT} == \
        {k: v for k, v in w_stats.items() if k not in SPLIT}
    assert w_stats["graph_replays"] == 0
    assert sum(g_stats[k] for k in SPLIT) == w_stats["eager_chunks"]


@pytest.mark.parametrize("case", sorted(CASES))
def test_replayed_decode_matches_eager(models, monkeypatch, case):
    name, pool, script, kw = CASES[case]
    got, want = _pair(models, monkeypatch, name, pool, script, kw)
    _same_service(got, want)
    g_reqs, g_stats = got
    assert any(tokens for tokens, _ in g_reqs)
    # the first chunk that can replay runs eagerly, then captures
    assert g_stats["graph_replays"] > 0 and g_stats["eager_chunks"] >= 1
    if case.startswith("rope_bf16_preempt"):
        assert g_stats["preempted"] > 0
    if "fail_all" in case:
        assert g_stats["failed"] == 2
    if "sampled" in case:
        # the sampled request's chunks stay eager: more than the one
        # before the capture
        assert g_stats["eager_chunks"] > 1


@pytest.mark.parametrize("case", sorted(NEVER))
def test_engines_that_never_replay(models, monkeypatch, case):
    name, pool, script, kw, stand_in = NEVER[case]
    got, want = _pair(models, monkeypatch, name, pool, script, kw,
                      stand_in)
    _same_service(got, want)
    assert got[1]["graph_replays"] == 0
    assert got[1]["eager_chunks"] == want[1]["eager_chunks"] > 0


def test_replay_counts_captured_launches(monkeypatch):
    """A replay calls no kernel wrapper: it adds the launches its capture
    counted, and the capture itself counts none."""
    from merlin_tpu_torch.ops import _build

    def wrapper():
        pass
    wrapper.launches = wrapper.launches_f32 = 0

    def step():
        for _ in range(3):
            _build.count_launch(wrapper, False)
        _build.count_launch(wrapper, True)

    class Graph:
        def __init__(self):
            self.replays = 0

        def replay(self):
            self.replays += 1

    class Capturing:
        def __init__(self, graph, capture_error_mode):
            assert capture_error_mode == "thread_local"

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    graph = Graph()
    monkeypatch.setattr(torch.cuda, "CUDAGraph", lambda: graph)
    monkeypatch.setattr(torch.cuda, "graph", Capturing)
    assert engine_mod._capture(step, torch.device("cpu")) is None
    replay = engine_mod._capture(step, torch.device("cuda"))
    assert (wrapper.launches, wrapper.launches_f32) == (0, 0)
    replay()
    replay()
    assert graph.replays == 2
    assert (wrapper.launches, wrapper.launches_f32) == (6, 2)


def test_drain_waits_for_all_but_the_newest_chunk(models):
    """Below the pipeline depth the drain reads nothing back but waits
    until the card has finished every chunk but the newest, so an
    admission's prefill queues behind one chunk at most."""
    engine = ServingEngine(models["rope"], cache_dtype=torch.bfloat16,
                           device="cpu", pipeline=8, **BASE)
    waited = []

    class Done:
        def __init__(self, i):
            self.i = i

        def synchronize(self):
            waited.append(self.i)

    chunk = torch.zeros((BASE["num_slots"], 1), dtype=torch.int32)
    for i in range(3):
        engine._inflight.append((chunk, [None] * BASE["num_slots"], Done(i)))
        engine._drain()
    assert waited == [0, 1]
    assert len(engine._inflight) == 3
