"""The port's engine-integrated speculative decoding (prompt-lookup drafts
scored by (k+1)-token paged verify windows) against the JAX engine on the
CPU, token for token at f32, with one set of flax params bridged by
``params_from_flax``. The cases follow ``tests/test_engine_speculative.py``
for one device and a float cache: k in {2, 3, 4} with various
``chunk_steps``, more requests than slots, ``pipeline=0``, chunked prefill
composed with the windows, ALiBi, and sampled requests riding along.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from merlin_tpu.models.decoder import CausalLM as JCausalLM
from merlin_tpu.models.families import tiny as j_tiny
from merlin_tpu.serve.engine import ServingEngine as JServingEngine

from merlin_tpu_torch.models.bridge import params_from_flax
from merlin_tpu_torch.models.decoder import CausalLM
from merlin_tpu_torch.models.families import tiny
from merlin_tpu_torch.serve.engine import ServingEngine

EOS, PAD = 2, 0
# max_len well above prompt + new tokens + the chunk margin: spec chunks
# reserve windows * (k+1) tokens
BASE = dict(num_slots=2, max_len=128, eos_id=EOS, pad_id=PAD,
            prompt_bucket=16, page_size=16)
# prompts with internal repetition, so prompt lookup accepts drafts
PROMPTS = [[5, 17, 33, 41, 5, 17, 33], [7, 9, 11, 7, 9],
           [21, 22, 21, 22, 21], [3, 4, 5, 6, 8, 3, 4, 5]]


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _models(positional):
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
def models():
    return {"rope": _models("rope"), "alibi": _models("alibi")}


def _run(engine, prompts, max_new, temperatures=None):
    temperatures = temperatures or [0.0] * len(prompts)
    reqs = [engine.submit(p, max_new_tokens=max_new, temperature=t)
            for p, t in zip(prompts, temperatures)]
    engine.run_until_idle()
    assert all(r.done and r.error is None for r in reqs)
    return [r.generated for r in reqs]


def _both(models, prompts, max_new, **kw):
    jmodel, params, tmodel = models
    cfg = dict(BASE, **kw)
    want = _run(JServingEngine(jmodel, params, cache_dtype=jnp.float32,
                               **cfg), prompts, max_new)
    got = _run(ServingEngine(tmodel, cache_dtype=torch.float32,
                             device="cpu", **cfg), prompts, max_new)
    return got, want


CASES = {
    # name: (model, prompts, max_new_tokens, engine options)
    "k3_chunk4": ("rope", PROMPTS, 8, dict(spec_draft=3, chunk_steps=4)),
    "k4_chunk1": ("rope", PROMPTS, 8, dict(spec_draft=4, chunk_steps=1)),
    "k2_chunk8": ("rope", PROMPTS, 8, dict(spec_draft=2, chunk_steps=8)),
    "more_requests_than_slots": (
        "rope", PROMPTS + [[11, 12, 13, 11, 12], [9, 9, 9, 9]], 6,
        dict(spec_draft=3, chunk_steps=2)),
    "pipeline_0": ("rope", PROMPTS, 8,
                   dict(spec_draft=3, chunk_steps=2, pipeline=0)),
    "chunked_prefill": ("rope", [[5, 17, 33, 41, 5, 17, 33],
                                 [7, 9, 11, 7, 9, 11, 7, 9, 11],
                                 list(range(3, 24))], 8,
                        dict(max_len=64, page_size=8, prefill_chunk=8,
                             spec_draft=2, chunk_steps=2)),
    "alibi_chunked": ("alibi", PROMPTS, 8,
                      dict(page_size=8, prefill_chunk=8, spec_draft=2,
                           chunk_steps=2)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_spec_engine_matches_jax(models, case):
    name, prompts, max_new, kw = CASES[case]
    got, want = _both(models[name], prompts, max_new, **kw)
    assert got == want


def test_scatter_rows_matches_jax():
    """The history write of a verify window: masked, writes past a row's
    end dropped."""
    from merlin_tpu.generate.speculative import _scatter_rows as j_scatter
    from merlin_tpu_torch.generate.speculative import _scatter_rows

    rng = np.random.default_rng(8)
    buf = rng.integers(0, 50, size=(3, 10)).astype(np.int32)
    start = np.asarray([0, 4, 8], np.int32)
    vals = rng.integers(50, 99, size=(3, 4)).astype(np.int32)
    mask = np.asarray([[1, 1, 0, 0], [1, 1, 1, 1], [1, 1, 1, 0]], bool)
    want = np.asarray(j_scatter(jnp.asarray(buf), jnp.asarray(start),
                                jnp.asarray(vals), jnp.asarray(mask)))
    before = buf.copy()
    got = _scatter_rows(torch.from_numpy(buf), torch.from_numpy(start),
                        torch.from_numpy(vals), torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(buf, before)


def test_spec_engine_emits_what_the_plain_engine_emits(models):
    """Acceptance changes how many forwards a request takes, never its
    greedy tokens: the spec engine equals the port's plain engine."""
    tmodel = models["rope"][2]
    plain = _run(ServingEngine(tmodel, cache_dtype=torch.float32,
                               device="cpu", **dict(BASE, chunk_steps=4)),
                 PROMPTS, 8)
    spec = _run(ServingEngine(tmodel, cache_dtype=torch.float32,
                              device="cpu", **dict(BASE, spec_draft=3,
                                                   chunk_steps=2)),
                PROMPTS, 8)
    assert spec == plain


def test_spec_engine_sampled_slots_ride_along(models):
    """A sampled request completes next to a greedy one, whose tokens stay
    exactly the JAX engine's (sampled tokens come from another generator
    than JAX's and are not compared)."""
    jmodel, params, tmodel = models["rope"]
    kw = dict(BASE, max_len=64, chunk_steps=2, spec_draft=3)
    want = _run(JServingEngine(jmodel, params, cache_dtype=jnp.float32,
                               **kw), PROMPTS[:1], 8)
    greedy, sampled = _run(
        ServingEngine(tmodel, cache_dtype=torch.float32, device="cpu", **kw),
        PROMPTS[:2], 8, temperatures=[0.0, 0.9])
    assert greedy == want[0]
    assert 1 <= len(sampled) <= 8
