"""An f32 model served over each page dtype, the port's ``ServingEngine``
against JAX's on the CPU, with one set of flax params bridged by
``params_from_flax``: bf16 pages (JAX's default, the f32 model's q over
bf16 pages, trap C48's pair), f32 pages (``--engine-cache-dtype f32``) and
int8 pages, each in E1's shape (whole prompt + decode), E2's (chunked
prefill + speculative windows) and hybrid admission, with an ALiBi model
over bf16 pages too. Tokens, each admission route's calls and the free
pages must be equal.

On the CPU both packages take the references (p in f32; int8 pages
dequantized to bf16 first), so the tokens agree exactly; on the card the
same paths run the f32 kernels, held to the TPU kernels' rounding by
``chip_smoke.py`` (phase 2) and served in its phase F.
"""

import collections

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
BASE = dict(num_slots=2, max_len=64, eos_id=EOS, pad_id=PAD,
            prompt_bucket=16, page_size=16)
POOLS = {"bf16": (jnp.bfloat16, torch.bfloat16),
         "f32": (jnp.float32, torch.float32),
         "int8": (jnp.int8, torch.int8)}
PROMPTS = [[5, 17, 33, 41, 5, 17, 33], [7, 9, 11, 7, 9],
           [21, 22, 21, 22, 21], [3, 4, 5, 6, 8, 3, 4, 5]]
LONG = [[5, 17, 33, 41, 5, 17, 33], list(range(3, 24)),
        [7, 9, 11, 7, 9, 11, 7, 9, 11]]
SETUPS = {
    # name: (prompts, max new tokens, engine options)
    "whole_decode": (PROMPTS, 6, dict(chunk_steps=4)),
    "chunked_spec": (LONG, 8, dict(page_size=8, prefill_chunk=8,
                                   spec_draft=3, chunk_steps=2)),
    "hybrid": (LONG, 6, dict(page_size=8, prefill_chunk=8,
                             prefill_chunk_min=10)),
}


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _models(positional):
    """f32 params in both packages (flax init, every leaf perturbed)."""
    jmodel = JCausalLM(j_tiny(positional=positional))
    params = nn.unbox(jmodel.init(jax.random.key(0),
                                  jnp.ones((1, 4), jnp.int32))["params"])
    rng = np.random.default_rng(1)
    params = jax.tree.map(
        lambda x: np.asarray(x) + 0.05 * rng.normal(size=x.shape).astype(
            np.float32), params)
    tmodel = CausalLM(tiny(positional=positional)).eval()
    tmodel.load_state_dict(params_from_flax(params), strict=True)
    assert all(p.dtype == torch.float32 for p in tmodel.parameters())
    return jmodel, params, tmodel


@pytest.fixture(scope="module")
def rope():
    return _models("rope")


@pytest.fixture(scope="module")
def alibi():
    return _models("alibi")


def _serve(engine, prompts, max_new):
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


def _check(models, pool, setup):
    jmodel, params, tmodel = models
    prompts, max_new, kw = SETUPS[setup]
    cfg = dict(BASE, **kw)
    jdt, tdt = POOLS[pool]
    want = _serve(JServingEngine(jmodel, params, cache_dtype=jdt, **cfg),
                  prompts, max_new)
    engine = ServingEngine(tmodel, cache_dtype=tdt, device="cpu", **cfg)
    assert engine.cache["layers"][0]["k_pages"].dtype == tdt
    got = _serve(engine, prompts, max_new)
    assert got == want
    assert got[2] == engine.pool.free_pages


@pytest.mark.parametrize("setup", sorted(SETUPS))
@pytest.mark.parametrize("pool", sorted(POOLS))
def test_f32_model_serves_like_jax_over_each_pool(rope, pool, setup):
    _check(rope, pool, setup)


@pytest.mark.parametrize("setup", ["hybrid", "chunked_spec"])
def test_f32_alibi_model_over_bf16_pages_serves_like_jax(alibi, setup):
    _check(alibi, "bf16", setup)
