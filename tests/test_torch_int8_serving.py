"""int8 KV pages in the port against the JAX package on the CPU, at f32,
with one set of flax params bridged by ``params_from_flax``:

  * ``ServingEngine(cache_dtype=torch.int8)`` against JAX's, token for token:
    whole-prompt, chunked, hybrid, speculative, preemption and ALiBi cases
    (as ``tests/test_serving_engine.py:214,496`` and
    ``tests/test_engine_speculative.py:151``), with each admission route's
    calls and the free pages;
  * the engine's admission scatter moves the scale pages with the values;
  * ``Generator(kv_layout="paged", cache_dtype=torch.int8)`` against JAX's.

The decoder's int8-page steps and the int8 weights are held to JAX in
``test_torch_int8_model.py``.

Token-exact checks run at f32 (trap C6). Both sides dequantize int8 pages
to bf16 before attention (the JAX decoder's CPU route), whatever the
model's dtype.
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
from merlin_tpu_torch.models.decoder import CausalLM, init_kv_cache
from merlin_tpu_torch.models.families import tiny
from merlin_tpu_torch.serve.engine import ServingEngine

EOS, PAD = 2, 0
BASE = dict(num_slots=2, max_len=64, eos_id=EOS, pad_id=PAD,
            prompt_bucket=16, page_size=16)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _models(positional, **kw):
    jmodel = JCausalLM(j_tiny(positional=positional, **kw))
    params = nn.unbox(jmodel.init(jax.random.key(0),
                                  jnp.ones((1, 4), jnp.int32))["params"])
    rng = np.random.default_rng(1)
    params = jax.tree.map(
        lambda x: np.asarray(x) + 0.05 * rng.normal(size=x.shape).astype(
            np.float32), params)
    tmodel = CausalLM(tiny(positional=positional, **kw)).eval()
    tmodel.load_state_dict(params_from_flax(params), strict=True)
    return jmodel, params, tmodel


@pytest.fixture(scope="module")
def models():
    return {"rope": _models("rope"), "alibi": _models("alibi"),
            "gqa": _models("rope", num_kv_heads=2)}


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
REPEATING = [[5, 17, 33, 41, 5, 17, 33], [7, 9, 11, 7, 9],
             [21, 22, 21, 22, 21], [3, 4, 5, 6, 8, 3, 4, 5]]
LONG = [list(range(5, 45)), list(range(7, 47))]

ENGINE_CASES = {
    # name: (model, prompts, max_new_tokens, engine options)
    "whole_prompt": ("rope", PROMPTS, 6, dict(chunk_steps=4)),
    "chunked": ("gqa", [[5, 17, 33, 41], list(range(3, 16)),
                        list(range(40, 56))], 6,
                dict(page_size=8, prefill_chunk=8)),
    "hybrid_alibi": ("alibi", [[5, 17, 33, 41], list(range(7, 28))], 6,
                     dict(page_size=8, prefill_chunk=8, prefill_chunk_min=8)),
    "speculative": ("rope", REPEATING, 8,
                    dict(max_len=128, spec_draft=3, chunk_steps=2)),
    "chunked_speculative": ("alibi", REPEATING, 8,
                            dict(max_len=128, page_size=8, prefill_chunk=8,
                                 spec_draft=2, chunk_steps=2)),
    # two 40-token prompts on a pool one page short: growth preempts
    "preemption": ("rope", LONG, 8, dict(chunk_steps=4)),
}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_int8_engine_matches_jax(models, case):
    name, prompts, max_new, kw = ENGINE_CASES[case]
    jmodel, params, tmodel = models[name]
    cfg = dict(BASE, **kw)
    want = _serve(JServingEngine(jmodel, params, cache_dtype=jnp.int8, **cfg),
                  prompts, max_new)
    got = _serve(ServingEngine(tmodel, cache_dtype=torch.int8, device="cpu",
                               **cfg), prompts, max_new)
    assert got == want
    if case == "preemption":
        assert got[1]["_preempt_youngest"] > 0, "the pool forces preemption"


def test_int8_engine_admission_moves_scale_pages(models):
    """A whole-prompt admission scatters the prefill's scale pages into the
    pool pages of its table, beside the values."""
    tmodel = models["rope"][2]
    engine = ServingEngine(tmodel, cache_dtype=torch.int8, device="cpu",
                           **dict(BASE, chunk_steps=1))
    layer = engine.cache["layers"][0]
    assert layer["k_scales"].dtype == torch.float32
    req = engine.submit(list(range(5, 25)), max_new_tokens=2)
    engine._admit()
    table = engine.pool.tables[req.req_id]
    assert len(table) == 2                                 # 20 tokens, pages of 16
    scales = layer["k_scales"][table].reshape(-1, 128)[:20]
    values = layer["k_pages"][table].reshape(-1, layer["k_pages"].shape[2])
    hkv = tmodel.cfg.kv_heads
    stride = 128 // hkv
    assert (scales[:, 0:hkv * stride:stride] > 1e-8).all()
    assert (values[:20] != 0).any(dim=1).all()
    # nothing was written anywhere else: the rest of the pool is empty
    rest = [p for p in range(layer["k_scales"].shape[0]) if p not in table]
    assert (layer["k_scales"][rest] == 0).all()
    assert (layer["v_scales"][rest] == 0).all()


@pytest.mark.parametrize("name", ["rope", "alibi"])
def test_int8_paged_generator_matches_jax(models, name):
    """Generator over an int8 paged cache: identity-mapped bulk prefill
    quantized into pages, then one-token steps, a ragged batch."""
    jmodel, params, tmodel = models[name]
    batch = np.full((3, 13), PAD, np.int32)
    batch[0] = np.arange(5, 18)
    batch[1, :9] = [7, 9, 11, 7, 9, 11, 30, 31, 32]
    batch[2, :4] = [21, 22, 23, 24]
    kw = dict(max_new_tokens=8, eos_id=EOS, pad_id=PAD, prompt_bucket=8,
              kv_layout="paged")
    want = JGenerator(jmodel, JGenerateConfig(
        cache_dtype=jnp.int8, **kw))(params, batch)
    got = Generator(tmodel, GenerateConfig(cache_dtype=torch.int8, **kw),
                    device="cpu")(batch)
    assert got.tolist() == np.asarray(want).tolist()


def test_dense_int8_cache_is_refused(models):
    """A dense int8 cache has no scales (trap C10): refused, not cast."""
    with pytest.raises(ValueError, match="paged"):
        init_kv_cache(models["rope"][2].cfg, 1, 16, torch.int8, device="cpu")
