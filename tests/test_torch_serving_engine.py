"""The port's continuous-batching ``ServingEngine`` against the JAX one on
the CPU, token for token, with one set of flax params bridged into the port
by ``params_from_flax``.

Each case runs both engines in the same configuration on the same prompts
and compares every request's tokens, how often each admission route ran
(whole prompt, prefill window), how many preemptions happened, and the free
pages left. Everything runs in f32 (trap C6: bf16 rounding flips near-tied
argmaxes on random weights). The cases follow ``tests/test_serving_engine.py``
for one device and a float cache: ``chunk_steps`` 1 and 8, chunked prefill,
hybrid routing, preemption, more requests than slots, interleaving, an
oversized prompt, ``fail_all``, ``close()``, an ALiBi model and an int8
pool; the speculative cases are in ``test_torch_engine_speculative.py``
and more int8 ones in ``test_torch_int8_serving.py``. Also here:
``Generator(kv_layout="paged")`` against JAX's.
"""

import collections

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from merlin_tpu.generate.decode import GenerateConfig as JGenerateConfig
from merlin_tpu.generate.decode import Generator as JGenerator
from merlin_tpu.models.decoder import CausalLM as JCausalLM
from merlin_tpu.models.families import tiny as j_tiny
from merlin_tpu.serve.engine import ServingEngine as JServingEngine

from merlin_tpu_torch.generate.decode import GenerateConfig, Generator
from merlin_tpu_torch.models.bridge import params_from_flax
from merlin_tpu_torch.models.decoder import CausalLM
from merlin_tpu_torch.models.families import tiny
from merlin_tpu_torch.serve.engine import ServingEngine, _multi_query_model

EOS, PAD = 2, 0
BASE = dict(num_slots=2, max_len=64, eos_id=EOS, pad_id=PAD,
            prompt_bucket=16, page_size=16)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _models(positional):
    """The same random params in both packages (flax init, every leaf
    perturbed so that norm scales are not trivially 1)."""
    jmodel = JCausalLM(j_tiny(positional=positional))
    params = nn.unbox(jmodel.init(jax.random.key(0),
                                  jnp.ones((1, 4), jnp.int32))["params"])
    rng = np.random.default_rng(1)
    params = jax.tree.map(
        lambda x: np.asarray(x) + 0.05 * rng.normal(size=x.shape).astype(
            np.float32), params)
    tmodel = CausalLM(tiny(positional=positional)).eval()
    tmodel.load_state_dict(params_from_flax(params), strict=True)
    return jmodel, params, tmodel


@pytest.fixture(scope="module")
def rope():
    return _models("rope")


@pytest.fixture(scope="module")
def alibi():
    return _models("alibi")


def _engines(models, **kw):
    jmodel, params, tmodel = models
    cfg = dict(BASE, **kw)
    return (JServingEngine(jmodel, params, cache_dtype=jnp.float32, **cfg),
            ServingEngine(tmodel, cache_dtype=torch.float32, device="cpu",
                          **cfg))


def _serve(engine, prompts, max_new):
    """Serve ``prompts`` to idle; returns (tokens per request, calls of
    each admission route and of preemption, free pages left)."""
    calls = collections.Counter()
    for name in ("_prefill", "_prefill_window", "_preempt_youngest"):
        fn = getattr(engine, name, None)
        if fn is not None:
            setattr(engine, name, lambda *a, _f=fn, _n=name, **k: (
                calls.update([_n]), _f(*a, **k))[1])
    reqs = [engine.submit(p, max_new_tokens=max_new) for p in prompts]
    engine.run_until_idle()
    assert all(r.done and r.error is None for r in reqs)
    return [r.generated for r in reqs], dict(calls), engine.pool.free_pages


PROMPTS = [[5, 17, 33, 41], [7, 9, 11], [21, 22], [3, 4, 5, 6, 8]]
CHUNKED = [[5, 17, 33, 41], [7, 9, 11], list(range(3, 16)),
           list(range(40, 56))]
LONG = [list(range(5, 45)), list(range(7, 47))]

CASES = {
    # name: (prompts, max_new_tokens, engine options)
    "chunk_steps_8": (PROMPTS, 6, {}),
    "chunk_steps_1": (PROMPTS, 6, dict(chunk_steps=1)),
    "pipeline_0": (PROMPTS, 6, dict(chunk_steps=4, pipeline=0)),
    "one_slot_recycles": ([[5, 17, 33], [6, 17, 33], [7, 17, 33]], 4,
                          dict(num_slots=1)),
    "chunked_C8_wps4": (CHUNKED, 6, dict(page_size=8, prefill_chunk=8)),
    # two-page windows under the one-window-per-step budget
    "chunked_C16_wps1": ([[5, 17, 33, 41], list(range(3, 24)),
                          list(range(40, 72))], 6,
                         dict(page_size=8, prefill_chunk=16,
                              prefill_windows_per_step=1)),
    "hybrid": ([[5, 17, 33, 41], list(range(7, 28))], 6,
               dict(page_size=8, prefill_chunk=8, prefill_chunk_min=8)),
    # two 40-token prompts on a pool one page short: growth preempts
    "preemption": (LONG, 8, dict(chunk_steps=4)),
    # a victim re-admits with its grown prompt (> 45): chunked this time
    "preemption_hybrid": (LONG, 8, dict(chunk_steps=4, prefill_chunk=8,
                                        prefill_chunk_min=45)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_matches_jax(rope, case):
    prompts, max_new, kw = CASES[case]
    jeng, teng = _engines(rope, **kw)
    got, want = _serve(teng, prompts, max_new), _serve(jeng, prompts, max_new)
    assert got == want
    if "preemption" in case:
        assert got[1]["_preempt_youngest"] > 0, "the pool forces preemption"


@pytest.mark.parametrize("kw", [{}, dict(page_size=8, prefill_chunk=8,
                                         prefill_chunk_min=4)],
                         ids=["whole_prompt", "hybrid"])
def test_engine_alibi_matches_jax(alibi, kw):
    """ALiBi reaches B4 on decode and B6 on prefill windows on the card."""
    jeng, teng = _engines(alibi, **kw)
    prompts = [[5, 17, 33, 41], list(range(7, 20)), [9, 9, 4]]
    assert _serve(teng, prompts, 6) == _serve(jeng, prompts, 6)


@pytest.mark.parametrize("kw,long_prompt", [
    ({}, [7, 9, 11]),
    (dict(max_len=96, page_size=8, prefill_chunk=8, chunk_steps=1,
          prefill_windows_per_step=1), list(range(7, 44)))],
    ids=["whole_prompt", "chunked"])
def test_engine_interleaved_admission_matches_jax(rope, kw, long_prompt):
    """A request submitted while another decodes joins without disturbing
    it; a chunked one admits window by window between decode steps."""
    outs = []
    for engine in _engines(rope, **kw):
        r1 = engine.submit([5, 17, 33, 41], max_new_tokens=12)
        engine.step()
        engine.step()
        r2 = engine.submit(long_prompt, max_new_tokens=6)
        mid_prefill = False
        for _ in range(4):
            engine.step()
            mid_prefill = mid_prefill or bool(engine._prefilling)
        engine.run_until_idle()
        outs.append((r1.generated, r2.generated, mid_prefill))
    assert outs[0] == outs[1]
    assert outs[0][2] == ("prefill_chunk" in kw)


def test_engine_streams_and_fails_oversized_prompt_only(rope):
    """A prompt that can never fit a slot fails that request alone (error
    sentinel -1 with done) while the others stream their tokens."""
    jeng, teng = _engines(rope)
    prompts = [[5, 17, 33, 41], list(range(5, 205)), [7, 9, 11]]
    want, _, _ = _serve_with_errors(jeng, prompts)
    got, events, reqs = _serve_with_errors(teng, prompts)
    assert got == want
    assert reqs[1].done and "pages_per_seq" in reqs[1].error
    assert events[1] == [(-1, True)]
    for i in (0, 2):
        assert [t for t, _ in events[i]] == reqs[i].generated
        assert [d for _, d in events[i]] == [False] * 5 + [True]


def _serve_with_errors(engine, prompts):
    events = {i: [] for i in range(len(prompts))}
    reqs = [engine.submit(p, max_new_tokens=6,
                          emit=lambda t, d, _i=i: events[_i].append((t, d)))
            for i, p in enumerate(prompts)]
    engine.run_until_idle()
    return [r.generated for r in reqs], events, reqs


def test_engine_fail_all_recovers(rope):
    """fail_all fails every active and queued request with the error
    sentinel, drains the pool, and the engine serves new requests."""
    jeng, teng = _engines(rope)
    events = []
    r1 = teng.submit([5, 17, 33], max_new_tokens=6,
                     emit=lambda t, d: events.append((t, d)))
    r2 = teng.submit([7, 9, 11], max_new_tokens=6)
    r_queued = teng.submit([8, 9, 10], max_new_tokens=6)
    teng.step()
    teng.fail_all("synthetic device loss")
    assert r1.done and "device loss" in r1.error
    assert r2.done and r2.error and r_queued.done and r_queued.error
    assert events[-1] == (-1, True)
    assert all(s is None for s in teng.slots)
    # only the trash page stays pinned
    assert teng.pool.free_pages == teng.num_slots * teng.pages_per_slot - 1
    prompt = [[5, 17, 33, 41]]
    assert _serve(teng, prompt, 6)[0] == _serve(jeng, prompt, 6)[0]


def test_engine_close_releases_buffers(rope):
    _, teng = _engines(rope)
    r = teng.submit([5, 17, 33], max_new_tokens=6)
    teng.run_until_idle()
    assert r.done
    teng.close()
    assert teng.cache is None and teng.model is None
    assert teng.multi_model is None and teng._tokens_dev is None
    teng.close()  # idempotent


def test_multi_query_model_shares_parameters(rope):
    """The window model is a second module tree over the SAME tensors: no
    copy of the weights, only cfg.paged_multi_query differs."""
    tmodel = rope[2]
    multi = _multi_query_model(tmodel)
    assert multi.cfg.paged_multi_query and not tmodel.cfg.paged_multi_query
    assert all(b.attn.cfg.paged_multi_query for b in multi.blocks)
    pairs = list(zip(tmodel.parameters(), multi.parameters()))
    assert len(pairs) == len(list(tmodel.parameters()))
    assert all(a is b for a, b in pairs)


def test_engine_int8_pages_match_jax(rope):
    """An int8 pool (f32 scale pages beside the values) serves the JAX
    engine's tokens; the other int8 cases are in test_torch_int8_serving.py."""
    jmodel, params, tmodel = rope
    want = _serve(JServingEngine(jmodel, params, cache_dtype=jnp.int8,
                                 **BASE), PROMPTS, 6)
    engine = ServingEngine(tmodel, cache_dtype=torch.int8, device="cpu",
                           **BASE)
    assert engine.cache["layers"][0]["k_scales"].dtype == torch.float32
    assert _serve(engine, PROMPTS, 6) == want


@pytest.mark.parametrize("models", ["rope", "alibi"])
def test_paged_generator_matches_jax(request, models):
    """Generator over a paged cache: identity-mapped bulk prefill, then
    one-token paged steps, a ragged batch, token for token."""
    jmodel, params, tmodel = request.getfixturevalue(models)
    batch = np.full((3, 13), PAD, np.int32)
    batch[0] = np.arange(5, 18)
    batch[1, :9] = [7, 9, 11, 7, 9, 11, 30, 31, 32]
    batch[2, :4] = [21, 22, 23, 24]
    kw = dict(max_new_tokens=8, eos_id=EOS, pad_id=PAD, prompt_bucket=8,
              kv_layout="paged")
    want = JGenerator(jmodel, JGenerateConfig(
        cache_dtype=jnp.float32, **kw))(params, batch)
    got = Generator(tmodel, GenerateConfig(cache_dtype=torch.float32, **kw),
                    device="cpu")(batch)
    assert got.tolist() == np.asarray(want).tolist()
