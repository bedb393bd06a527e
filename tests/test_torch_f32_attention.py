"""The dense attention kernels' f32 contract on the CPU: what the wrappers
take, how they count, and the plain versions at f32 against the JAX
package's Pallas kernels in TPU interpret mode (every product in f32).

  * ``check_qkv`` takes q, k and v of one dtype, bf16 or f32, and looks at
    the dtype before the device, so an f16 or a mixed call is refused for
    what it is;
  * every dense wrapper (B1, B2, B10-B13) keeps two counts, ``launches``
    (the bf16 kernel) and ``launches_f32`` (the f32 kernel), and takes its
    plain version for CPU tensors at f32 without counting;
  * the combinations an f32 model runs, at small sizes: B2 + the backward
    (B10/B11) with GQA, ALiBi and packed segments together at d = 128 and
    256, against ``_flash_fwd_pallas`` + ``_flash_bwd_pallas``; B1, B12
    and B13 at the towers' head dims 64, 80 and 104 against
    ``onepass_attention`` and ``jax.vjp`` of it.

f32 on both sides: they differ in summation order and exp vs exp2 only,
2e-5 absolute and relative on values of magnitude ~1 (seen ~1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from merlin_tpu.ops.flash_attention import _flash_bwd_pallas, _flash_fwd_pallas
from merlin_tpu.ops.onepass_attention import onepass_attention as j_onepass

from merlin_tpu_torch.ops import _build
from merlin_tpu_torch.ops import flash_attention as fa
from merlin_tpu_torch.ops import onepass_attention as oa

TOL = 2e-5
WRAPPERS = (fa.flash_attention, fa.flash_attention_bwd_dq,
            fa.flash_attention_bwd_dkv, fa.flash_attention_bwd,
            oa.onepass_attention, oa.onepass_attention_lse,
            oa.onepass_attention_bwd)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _meta(dtype, shape=(1, 130, 2, 64)):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("dtypes, match", [
    ((torch.float16,) * 3, "bfloat16 or float32"),
    ((torch.float32, torch.bfloat16, torch.float32), "k must be"),
    ((torch.bfloat16, torch.bfloat16, torch.float32), "v must be"),
    ((torch.float32,) * 3, "CUDA"),
], ids=["f16", "f32_bf16_k", "bf16_f32_v", "f32_not_cuda"])
def test_check_qkv_takes_one_dtype_of_two(dtypes, match):
    q, k, v = (_meta(dt) for dt in dtypes)
    with pytest.raises(ValueError, match=match):
        _build.check_qkv("t", q, k, v, max_d=256)
    before = [(w.launches, w.launches_f32) for w in WRAPPERS]
    with pytest.raises(ValueError, match=match):
        fa.flash_attention(q, k, v)
    with pytest.raises(ValueError, match=match):
        oa.onepass_attention(q, k, v)
    assert [(w.launches, w.launches_f32) for w in WRAPPERS] == before


def test_count_launch_keeps_the_two_kernels_apart():
    def wrapper():
        pass

    wrapper.launches = wrapper.launches_f32 = 0
    _build.count_launch(wrapper, True)
    _build.count_launch(wrapper, False)
    _build.count_launch(wrapper, True)
    assert (wrapper.launches, wrapper.launches_f32) == (1, 2)
    for w in WRAPPERS:
        assert isinstance(w.launches, int) and isinstance(w.launches_f32, int)


def _inputs(seed, b, s, h, hkv, d):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, s, h, d)).astype(np.float32)
    k = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    do = rng.normal(size=(b, s, h, d)).astype(np.float32)
    return q, k, v, do


@pytest.mark.parametrize("d", [128, 256])
def test_flash_f32_all_masks_match_pallas_interpret(d):
    """B2 and the backward at f32 with GQA 4/2, ALiBi and two packed
    sequences at once, as an f32 Baichuan-style decoder trains; through
    the wrappers (CPU: plain), which count nothing."""
    b, s, h, hkv = 1, 128, 4, 2
    q, k, v, do = _inputs(40 + d, b, s, h, hkv, d)
    seg = np.ones((b, s), np.int32)
    seg[:, 77:] = 2
    slopes = np.asarray([2.0 ** -(i + 1) for i in range(h)], np.float32)
    kw = dict(causal=True, scale=d ** -0.5, block_q=128, block_k=128,
              use_alibi=True, use_segments=True)
    jx = [jnp.asarray(x) for x in (q, k, v)]
    with pltpu.force_tpu_interpret_mode():
        out, lse = _flash_fwd_pallas(*jx, jnp.asarray(seg), jnp.asarray(seg),
                                     jnp.asarray(slopes), **kw)
        grads = _flash_bwd_pallas(*jx, out, lse, jnp.asarray(do),
                                  jnp.asarray(seg), jnp.asarray(seg),
                                  jnp.asarray(slopes), **kw)
    want = [np.asarray(x) for x in (out, lse[:, :, 0], *grads)]
    t = [torch.from_numpy(x) for x in (q, k, v, do)]
    tkw = dict(causal=True, segment_ids_q=torch.from_numpy(seg),
               segment_ids_kv=torch.from_numpy(seg),
               alibi_slopes=torch.from_numpy(slopes))
    before = [(w.launches, w.launches_f32) for w in WRAPPERS]
    got_out, got_lse = fa.flash_attention(*t[:3], **tkw)
    got = fa.flash_attention_bwd(*t[:3], got_out, got_lse, t[3], **tkw)
    assert [(w.launches, w.launches_f32) for w in WRAPPERS] == before
    for name, g, w in zip(("out", "lse", "dq", "dk", "dv"),
                          (got_out, got_lse, *got), want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, atol=TOL, rtol=TOL,
                                   err_msg=name)


@pytest.mark.parametrize("d", [64, 80, 104])
def test_onepass_f32_matches_pallas_interpret(d):
    """B1, B12 and B13 at f32 at the towers' head dims (CLIP-L 64,
    MetaCLIP-H 80, Qwen-bigG 104) against ``onepass_attention`` and
    ``jax.vjp`` of it (its Pallas dq and dk/dv kernels)."""
    q, k, v, do = _inputs(50 + d, 2, 130, 2, 2, d)
    jx = [jnp.asarray(x) for x in (q, k, v)]
    with pltpu.force_tpu_interpret_mode():
        want_out, vjp = jax.vjp(j_onepass, *jx)
        want_grads = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    out = oa.onepass_attention(tq, tk, tv)
    out_lse, lse = oa.onepass_attention_lse(tq, tk, tv)
    np.testing.assert_array_equal(out.numpy(), out_lse.numpy())
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=TOL,
                               rtol=TOL)
    got = oa.onepass_attention_bwd(tq, tk, tv, tdo, lse, out_lse)
    for name, g, w in zip(("dq", "dk", "dv"), got, want_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL,
                                   rtol=TOL, err_msg=name)
