"""The numerics of the port's dense f32 attention kernels on the CPU.

On the card, ``csrc/attention_f32.cu`` (B1, B2, B12) and
``csrc/flash_attention_bwd_f32.cu`` (B10, B11, B13) do every product as
3xTF32 on the tensor cores: each f32 operand x is split into big = tf32(x)
and small = tf32(x - big), and a product a b is taken as small_a big_b +
big_a small_b + big_a big_b, summed in f32. The kernels chop (big is x with
its low 13 mantissa bits cleared, and the tensor core reads small's top 19
bits); ``cvt.rna.tf32.f32`` would round to nearest, ties away from zero:
(bits + 0x1000) & 0xffffe000.

A kernel cannot run here, so this file emulates that arithmetic in torch
(every product of the forward and the backward through the split) and
holds it, with either rounding, against the JAX package's Pallas kernels
in TPU interpret mode (every product in f32) at the tolerance the plain
versions are held to, 2e-5 absolute and relative on values of magnitude
~1: B2 and its backward with GQA, ALiBi and packed segments at d = 128 and
256; B1/B12 and B13 at the towers' head dims 64, 80 and 104. One TF32 pass
(big_a big_b alone) misses that tolerance, which is why the kernels pay
for three.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from merlin_tpu.ops.flash_attention import _flash_bwd_pallas, _flash_fwd_pallas
from merlin_tpu.ops.onepass_attention import onepass_attention as j_onepass

TOL = 2e-5
NEG_INF = -1e30
ROUNDINGS = ("chop", "rna")


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def tf32(x: torch.Tensor, rounding: str) -> torch.Tensor:
    """x (f32) to tf32, kept in f32: the low 13 mantissa bits cleared,
    after adding half of the dropped unit for "rna" (the bit pattern is
    sign-magnitude, so ties go away from zero)."""
    bits = x.contiguous().view(torch.int32)
    if rounding == "rna":
        bits = bits + 0x1000
    return (bits & -0x2000).view(torch.float32)


def split(x, rounding):
    big = tf32(x, rounding)
    return big, tf32(x - big, rounding)


def matmul(a, b, rounding, passes=3):
    """a @ b (f32, batched) with both operands split: 3 passes as the
    kernels do, or 1 (big_a big_b, one TF32 product)."""
    a_big, a_small = split(a, rounding)
    b_big, b_small = split(b, rounding)
    out = a_big @ b_big
    if passes == 3:
        out = out + (a_small @ b_big + a_big @ b_small)
    return out


def emulated_attention(q, k, v, do, *, causal, scale, rounding, passes=3,
                       seg=None, slopes=None):
    """Forward (out, natural-log lse) and backward (dq, dk, dv) of
    attention on (b, s, h, d) f32 inputs, every product through
    :func:`matmul`: the kernels' contract (top-left causal, segment ids,
    ALiBi slope * (k - q), GQA; masked p = 0)."""
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    group = h // hkv
    qh = q.permute(0, 2, 1, 3)
    kh = k.repeat_interleave(group, dim=2).permute(0, 2, 1, 3)
    vh = v.repeat_interleave(group, dim=2).permute(0, 2, 1, 3)
    doh = do.permute(0, 2, 1, 3)
    mm = functools.partial(matmul, rounding=rounding, passes=passes)
    s = mm(qh, kh.transpose(-1, -2)) * scale
    qpos = torch.arange(sq)[:, None]
    kpos = torch.arange(skv)[None, :]
    if slopes is not None:
        s = s + slopes[None, :, None, None] * (kpos - qpos)
    mask = torch.ones((b, 1, sq, skv), dtype=torch.bool)
    if seg is not None:
        mask = mask & (seg[:, None, :, None] == seg[:, None, None, :])
    if causal:
        mask = mask & (kpos <= qpos)
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(-1, keepdim=True)
    out = mm(p, vh) / torch.where(l > 0, l, 1.0)
    lse = torch.where(l > 0, m + torch.log(l), NEG_INF)[..., 0]
    di = (out * doh).sum(-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    ds = p * (mm(doh, vh.transpose(-1, -2)) - di) * scale
    dq = mm(ds, kh)
    dk = mm(ds.transpose(-1, -2), qh)
    dv = mm(p.transpose(-1, -2), doh)

    def kv_grad(x):              # (b, h, skv, d) -> (b, skv, hkv, d)
        return x.reshape(b, hkv, group, skv, d).sum(2).permute(0, 2, 1, 3)

    return (out.permute(0, 2, 1, 3), lse, dq.permute(0, 2, 1, 3),
            kv_grad(dk), kv_grad(dv))


def _inputs(seed, b, s, h, hkv, d):
    rng = np.random.default_rng(seed)
    shapes = ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d), (b, s, h, d))
    return [rng.normal(size=sh).astype(np.float32) for sh in shapes]


@functools.lru_cache(maxsize=None)
def _flash_case(d):
    """B2 + the backward at f32 with GQA 4/2, ALiBi and two packed
    sequences, through ``_flash_fwd_pallas`` / ``_flash_bwd_pallas`` in
    interpret mode: (inputs, masks, [out, lse, dq, dk, dv])."""
    b, s, h, hkv = 1, 128, 4, 2
    q, k, v, do = _inputs(60 + d, b, s, h, hkv, d)
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
    return (q, k, v, do), (seg, slopes), want


@functools.lru_cache(maxsize=None)
def _onepass_case(d):
    """B1/B12 and B13 at f32: ``onepass_attention`` and ``jax.vjp`` of it
    in interpret mode: (inputs, [out, dq, dk, dv])."""
    q, k, v, do = _inputs(70 + d, 2, 130, 2, 2, d)
    with pltpu.force_tpu_interpret_mode():
        out, vjp = jax.vjp(j_onepass, *(jnp.asarray(x) for x in (q, k, v)))
        grads = vjp(jnp.asarray(do))
    return (q, k, v, do), [np.asarray(x) for x in (out, *grads)]


def _flash_emulated(d, rounding, passes=3):
    (q, k, v, do), (seg, slopes), want = _flash_case(d)
    t = [torch.from_numpy(x) for x in (q, k, v, do)]
    got = emulated_attention(*t, causal=True, scale=d ** -0.5,
                             rounding=rounding, passes=passes,
                             seg=torch.from_numpy(seg),
                             slopes=torch.from_numpy(slopes))
    return got, want


def _onepass_emulated(d, rounding, passes=3):
    (q, k, v, do), want = _onepass_case(d)
    t = [torch.from_numpy(x) for x in (q, k, v, do)]
    out, _, *grads = emulated_attention(*t, causal=False, scale=d ** -0.5,
                                        rounding=rounding, passes=passes)
    return [out, *grads], want


def _worst(got, want):
    """The largest |got - want| over TOL (1 + |want|): above 1 fails
    ``assert_allclose(atol=TOL, rtol=TOL)``."""
    return max(float(np.max(np.abs(g.numpy() - w) / (TOL * (1 + np.abs(w)))))
               for g, w in zip(got, want))


@pytest.mark.parametrize("rounding", ROUNDINGS)
def test_split_is_exact_and_tf32(rounding):
    """big and small are tf32 (13 low bits 0); big + small is x to within
    small's own tf32 step; big holds x to 2^-10 (chop) or 2^-11 (rna)."""
    x = torch.from_numpy((np.random.default_rng(1).normal(size=4096)
                          * 10.0 ** np.arange(-4, 4).repeat(512)
                          ).astype(np.float32))
    big, small = split(x, rounding)
    for part in (big, small):
        assert not (part.view(torch.int32) & 0x1FFF).any()
    step = 2.0 ** (-10 if rounding == "chop" else -11)
    assert ((x - big).abs() <= step * x.abs()).all()
    assert ((x - big - small).abs() <= step * (x - big).abs()).all()
    if rounding == "rna":
        want = np.float32(1.0) + np.float32(2.0 ** -10)   # tie: away
        got = tf32(torch.tensor([1.0 + 2.0 ** -11], dtype=torch.float32),
                   "rna")
        assert got.item() == want


@pytest.mark.parametrize("rounding", ROUNDINGS)
def test_three_passes_hold_f32_products(rounding):
    """A 3-pass product of (64, 1024) x (1024, 64) N(0, 1) matrices is
    within 1e-5 of float64 relative to its largest entry; one pass is not
    (~1e-3)."""
    rng = np.random.default_rng(2)
    a, b = (rng.normal(size=sh).astype(np.float32)
            for sh in ((64, 1024), (1024, 64)))
    exact = a.astype(np.float64) @ b.astype(np.float64)
    scale = np.abs(exact).max()
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    three = np.abs(matmul(ta, tb, rounding).numpy() - exact).max() / scale
    one = np.abs(matmul(ta, tb, rounding, 1).numpy() - exact).max() / scale
    assert three < 1e-5 < one


@pytest.mark.parametrize("d", [128, 256])
@pytest.mark.parametrize("rounding", ROUNDINGS)
def test_flash_three_passes_match_pallas_interpret(d, rounding):
    got, want = _flash_emulated(d, rounding)
    for name, g, w in zip(("out", "lse", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=TOL, rtol=TOL,
                                   err_msg=name)


@pytest.mark.parametrize("d", [64, 80, 104])
@pytest.mark.parametrize("rounding", ROUNDINGS)
def test_onepass_three_passes_match_pallas_interpret(d, rounding):
    got, want = _onepass_emulated(d, rounding)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=TOL, rtol=TOL,
                                   err_msg=name)


@pytest.mark.parametrize("case, d", [("flash", 128), ("onepass", 64)])
def test_one_tf32_pass_misses_the_tolerance(case, d):
    """big_a big_b alone: the same comparison fails by far."""
    fn = _flash_emulated if case == "flash" else _onepass_emulated
    got, want = fn(d, "chop", passes=1)
    assert _worst(got, want) > 10
    got3, _ = fn(d, "chop")
    assert _worst(got3, want) <= 1
