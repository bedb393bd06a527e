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
