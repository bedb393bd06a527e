"""The port's logit warps and sampling against ``merlin_tpu/ops/sampling.py``
on the CPU. The warps are deterministic and hold to 1e-6 (f32); sampling
draws from a ``torch.Generator``, which gives other numbers than
``jax.random`` from the same seed, so it is checked for reproducibility and
for never drawing a token the warps removed."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from merlin_tpu.ops import sampling as js

from merlin_tpu_torch.ops import sampling as ts


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _logits(seed=0, shape=(3, 50)):
    return np.random.default_rng(seed).normal(size=shape).astype(
        np.float32) * 3.0


@pytest.mark.parametrize("warp,arg", [("apply_temperature", 0.7),
                                      ("apply_top_k", 5),
                                      ("apply_top_k", 0),
                                      ("apply_top_p", 0.8),
                                      ("apply_top_p", 1.0)])
def test_warps_match_jax(warp, arg):
    x = _logits()
    want = np.asarray(getattr(js, warp)(jnp.asarray(x), arg))
    got = getattr(ts, warp)(torch.from_numpy(x), arg).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


def test_greedy_is_argmax_like_jax():
    x = _logits(1)
    got = ts.sample_token(torch.from_numpy(x), do_sample=False).numpy()
    want = np.asarray(js.sample_token(None, jnp.asarray(x), do_sample=False))
    np.testing.assert_array_equal(got, want)


def test_sampling_reproducible_and_inside_the_nucleus():
    x = torch.from_numpy(_logits(2, (4, 64)))
    kw = dict(temperature=1.3, top_k=10, top_p=0.9, do_sample=True)
    draws = [ts.sample_token(x, generator=torch.Generator().manual_seed(s),
                             **kw) for s in (5, 5, 6)]
    assert draws[0].tolist() == draws[1].tolist()
    kept = ts.apply_top_p(ts.apply_top_k(x / 1.3, 10), 0.9) > ts.NEG_INF
    for d in draws:
        assert kept[torch.arange(4), d].all()


@pytest.fixture(scope="module")
def sampler():
    """A tiny random CausalLM (std 1 weights, so sampling at temperature 1
    spreads over many tokens) behind a sampled ``Generator``."""
    from merlin_tpu_torch.generate.decode import GenerateConfig, Generator
    from merlin_tpu_torch.models.bridge import init_params
    from merlin_tpu_torch.models.decoder import CausalLM
    from merlin_tpu_torch.models.families import tiny

    model = CausalLM(tiny()).eval()
    init_params(model, torch.Generator().manual_seed(3), std=1.0,
                dtype=torch.float32, device="cpu")
    cfg = GenerateConfig(max_new_tokens=12, do_sample=True, temperature=1.0,
                         eos_id=-1, prompt_bucket=0)
    return Generator(model, cfg, device="cpu")


@pytest.mark.parametrize("how", ["call", "stream"])
def test_sampled_decode_without_a_generator_is_seeded_0(sampler, how):
    """C32: with no generator a sampled decode draws from one seeded 0, as
    JAX's takes ``jax.random.key(0)``: the same prompts give the same tokens
    whatever the global random state, and the tokens a generator seeded 0
    gives; another seed gives others."""
    ids = np.random.default_rng(4).integers(3, 120, size=(2, 9))

    def run(**kw):
        if how == "call":
            return sampler(ids, **kw)
        return np.stack(list(sampler.stream(ids, **kw)), axis=1)

    torch.manual_seed(1)
    first = run()
    torch.manual_seed(2)
    assert np.array_equal(run(), first)
    assert np.array_equal(run(generator=torch.Generator().manual_seed(0)),
                          first)
    assert not np.array_equal(
        run(generator=torch.Generator().manual_seed(1)), first)
    assert len(set(first.reshape(-1).tolist())) > 6    # it did sample
    assert np.array_equal(np.stack(list(sampler.stream(ids)), axis=1),
                          sampler(ids))
