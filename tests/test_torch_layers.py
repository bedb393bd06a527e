"""The port's building blocks (``merlin_tpu_torch.models.layers``) against
the flax modules of the JAX package, with the same params, on the CPU.

f32 cases hold to 1e-5 (summation order only); the bf16 norm case to one
bf16 ulp at magnitude ~4 (3e-2), since both sides round the f32 result once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from merlin_tpu.models import layers as jl

from merlin_tpu_torch.models import layers as tl
from merlin_tpu_torch.models.bridge import params_from_flax

TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _pair(jmod, tmod, x, seed=0):
    """Init the flax module, perturb every param, load it into the torch
    module; return (flax output, torch output) on ``x``."""
    params = fnn.unbox(jmod.init(jax.random.key(seed), jnp.asarray(x))["params"])
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda p: np.asarray(p) + 0.1 * rng.normal(size=p.shape).astype(
            np.float32), params)
    tmod.load_state_dict(params_from_flax(params), strict=True)
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = tmod(torch.from_numpy(np.asarray(x))).numpy()
    return want, got


def _x(shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("kind", ["rms", "ln"])
def test_norms_match_flax_f32(kind):
    x = _x((2, 5, 24)) * 3.0 + 0.5
    if kind == "rms":
        pair = (jl.RMSNorm(eps=1e-5, dtype=jnp.float32), tl.RMSNorm(24, 1e-5))
    else:
        pair = (jl.LayerNorm(eps=1e-5, dtype=jnp.float32),
                tl.LayerNorm(24, 1e-5))
    want, got = _pair(*pair, x)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_rms_norm_bf16_keeps_f32_statistics():
    x = (_x((2, 5, 64)) * 4.0).astype(np.float32)
    jmod, tmod = jl.RMSNorm(dtype=jnp.bfloat16), tl.RMSNorm(64)
    params = {"scale": np.linspace(0.5, 1.5, 64, dtype=np.float32)}
    tmod.load_state_dict(params_from_flax(params))
    want = jmod.apply({"params": params}, jnp.asarray(x, jnp.bfloat16))
    got = tmod(torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().detach().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=3e-2, rtol=1e-2)


@pytest.mark.parametrize("case", ["in_heads", "heads_out", "bias"])
def test_dense_general_matches_flax(case):
    if case == "in_heads":
        jmod = jl.DenseGeneral((4, 8), dtype=jnp.float32)
        tmod = tl.DenseGeneral(32, (4, 8), dtype=torch.float32)
        x = _x((2, 3, 32))
    elif case == "heads_out":
        jmod = jl.DenseGeneral((32,), axis=(-2, -1), dtype=jnp.float32)
        tmod = tl.DenseGeneral((4, 8), 32, dtype=torch.float32)
        x = _x((2, 3, 4, 8))
    else:
        jmod = jl.DenseGeneral((16,), use_bias=True, dtype=jnp.float32)
        tmod = tl.DenseGeneral(32, 16, use_bias=True, dtype=torch.float32)
        x = _x((5, 32))
    want, got = _pair(jmod, tmod, x)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_embed_and_attend_match_flax():
    jmod = jl.Embed(50, 16, dtype=jnp.float32)
    tmod = tl.Embed(50, 16, dtype=torch.float32)
    ids = np.asarray([[0, 7, 49, 3]], np.int32)
    params = fnn.unbox(jmod.init(jax.random.key(0), jnp.asarray(ids))["params"])
    tmod.load_state_dict(params_from_flax(params))
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(ids)))
    got = tmod(torch.from_numpy(ids).long()).detach().numpy()
    np.testing.assert_array_equal(got, want)
    h = _x((2, 3, 16))
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(h),
                                 method="attend"))
    got = tmod.attend(torch.from_numpy(h)).detach().numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


@pytest.mark.parametrize("d,rotary_frac,scale,theta", [
    (16, 1.0, 1.0, 10000.0), (20, 0.4, 1.0, 10000.0), (16, 1.0, 2.0, 500.0)])
def test_rope_matches_jax(d, rotary_frac, scale, theta):
    x = _x((2, 7, 3, d))
    pos = np.random.default_rng(2).integers(0, 300, size=(2, 7)).astype(
        np.int32)
    rd = int(d * rotary_frac)
    want = jl.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta=theta,
                         linear_scale=scale, rotary_dim=rd)
    got = tl.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                        theta=theta, linear_scale=scale, rotary_dim=rd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-5)
    np.testing.assert_allclose(
        tl.rope_frequencies(d, theta, rd).numpy(),
        np.asarray(jl.rope_frequencies(d, theta, rd)), rtol=1e-6)
    if rd < d:   # the pass-through channels are untouched
        np.testing.assert_array_equal(got.numpy()[..., rd:], x[..., rd:])


@pytest.mark.parametrize("n", [8, 12, 32, 40])
def test_alibi_slopes_match_jax(n):
    np.testing.assert_allclose(tl.alibi_slopes(n).numpy(),
                               np.asarray(jl.alibi_slopes(n)), rtol=1e-7)


@pytest.mark.parametrize("activation", ["gated", "gelu_new", "gelu",
                                        "quick_gelu", "relu"])
def test_mlps_match_flax(activation):
    x = _x((2, 3, 16))
    if activation == "gated":
        jmod = jl.GatedMLP(24, dtype=jnp.float32)
        tmod = tl.GatedMLP(16, 24, dtype=torch.float32)
    else:
        jmod = jl.SimpleMLP(24, activation=activation, dtype=jnp.float32)
        tmod = tl.SimpleMLP(16, 24, activation=activation,
                            dtype=torch.float32)
    want, got = _pair(jmod, tmod, x)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
