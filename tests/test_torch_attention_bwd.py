"""The port's attention backward (B10-B13 plain versions, their autograd
functions) against the JAX package on the CPU.

  * B10/B11: ``flash_attention_bwd_dq_plain`` / ``_dkv_plain`` against the
    Pallas ``_flash_fwd_pallas`` + ``_flash_bwd_pallas`` in TPU interpret
    mode: causal with segment ids, ALiBi, GQA 4/2, non-causal, and a ragged
    length (which the JAX side pads to its block, with the padding in its
    own segment); the fused entry ``flash_attention_bwd`` (one launch for
    dq, dk and dv on the card) on the CPU against both;
  * B12: ``onepass_attention_lse_plain`` against ``_onepass_fwd(emit_lse=
    True)`` in interpret mode;
  * B13: ``onepass_attention_bwd_plain`` against ``jax.vjp`` of
    ``onepass_attention`` (whose backward rule always runs its Pallas
    kernels) in interpret mode;
  * the autograd functions against ``torch.autograd`` of ``mha_reference``.

All at f32, where the two differ only in summation order: tolerance 2e-5
absolute and relative on values of magnitude ~1 (seen: ~1e-6).
"""

import ast
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from merlin_tpu.ops.flash_attention import _flash_bwd_pallas, _flash_fwd_pallas
from merlin_tpu.ops.onepass_attention import _onepass_fwd, _trained_pad
from merlin_tpu.ops.onepass_attention import onepass_attention as j_onepass

from merlin_tpu_torch.ops import flash_attention as fa
from merlin_tpu_torch.ops import onepass_attention as oa
from merlin_tpu_torch.ops.attention import attention, mha_reference

TOL = 2e-5


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(seed, b, s, h, hkv, d):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, s, h, d)).astype(np.float32)
    k = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, s, hkv, d)).astype(np.float32)
    do = rng.normal(size=(b, s, h, d)).astype(np.float32)
    return q, k, v, do


def _jax_flash(q, k, v, do, seg, slopes, *, causal, block=128):
    """Pallas forward + backward in interpret mode -> numpy
    (out, lse (b, h, s), dq, dk, dv)."""
    b, s, h, d = q.shape
    use_segments = seg is not None
    use_alibi = slopes is not None
    seg = seg if use_segments else np.ones((b, s), np.int32)
    slopes = slopes if use_alibi else np.zeros((h,), np.float32)
    kw = dict(causal=causal, scale=d ** -0.5, block_q=block, block_k=block,
              use_alibi=use_alibi, use_segments=use_segments)
    args = [jnp.asarray(x) for x in (q, k, v)]
    with pltpu.force_tpu_interpret_mode():
        out, lse = _flash_fwd_pallas(*args, jnp.asarray(seg),
                                     jnp.asarray(seg), jnp.asarray(slopes),
                                     **kw)
        dq, dk, dv = _flash_bwd_pallas(*args, out, lse, jnp.asarray(do),
                                       jnp.asarray(seg), jnp.asarray(seg),
                                       jnp.asarray(slopes), **kw)
    return [np.asarray(x) for x in (out, lse[:, :, 0], dq, dk, dv)]


def _port_flash(q, k, v, do, seg, slopes, *, causal):
    t = [torch.from_numpy(x) for x in (q, k, v, do)]
    kw = dict(causal=causal,
              segment_ids_q=None if seg is None else torch.from_numpy(seg),
              segment_ids_kv=None if seg is None else torch.from_numpy(seg),
              alibi_slopes=None if slopes is None else torch.from_numpy(slopes))
    out, lse = fa.flash_attention_plain(*t[:3], **kw)
    di = fa.attention_di(out, t[3])
    dq = fa.flash_attention_bwd_dq(*t, lse, di, **kw)
    dk, dv = fa.flash_attention_bwd_dkv(*t, lse, di, **kw)
    return [x.numpy() for x in (out, lse, dq, dk, dv)]


def _segments(b, s, cut):
    seg = np.ones((b, s), np.int32)
    seg[-1, cut:] = 2                      # a packed second sequence
    return seg


FLASH_CASES = {
    "causal_segments": dict(b=1, s=256, h=4, hkv=2, causal=True,
                            seg=True, alibi=False),
    "alibi": dict(b=1, s=128, h=4, hkv=4, causal=True, seg=False, alibi=True),
    "gqa_4_2": dict(b=2, s=128, h=4, hkv=2, causal=True, seg=False,
                    alibi=False),
    "non_causal": dict(b=1, s=128, h=4, hkv=4, causal=False, seg=True,
                       alibi=False),
    # widths past the 64/128 forms: phi-2's d = 80, and d = 256 (the
    # backward's column-split form, C19)
    "causal_segments_d80": dict(b=1, s=128, h=2, hkv=2, causal=True,
                                seg=True, alibi=False, d=80),
    "causal_segments_d256": dict(b=1, s=128, h=2, hkv=2, causal=True,
                                 seg=True, alibi=False, d=256),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_bwd_plain_matches_pallas_interpret(case):
    c = FLASH_CASES[case]
    q, k, v, do = _inputs(1, c["b"], c["s"], c["h"], c["hkv"],
                          c.get("d", 64))
    seg = _segments(c["b"], c["s"], c["s"] // 2 + 3) if c["seg"] else None
    slopes = (np.asarray([2.0 ** -(i + 1) for i in range(c["h"])],
                         np.float32) if c["alibi"] else None)
    want = _jax_flash(q, k, v, do, seg, slopes, causal=c["causal"])
    got = _port_flash(q, k, v, do, seg, slopes, causal=c["causal"])
    for name, g, w in zip(("out", "lse", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL, err_msg=name)


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_fused_flash_bwd_matches_separate_plain_and_pallas(case):
    """``flash_attention_bwd`` (the fused B10 + B11 entry, which takes the
    forward's out instead of di) on CPU tensors: equal to the B10 and B11
    plain versions fed ``attention_di``, and to the Pallas backward in
    interpret mode within TOL."""
    c = FLASH_CASES[case]
    q, k, v, do = _inputs(8, c["b"], c["s"], c["h"], c["hkv"],
                          c.get("d", 64))
    seg = _segments(c["b"], c["s"], c["s"] // 2 + 3) if c["seg"] else None
    slopes = (np.asarray([2.0 ** -(i + 1) for i in range(c["h"])],
                         np.float32) if c["alibi"] else None)
    want = _jax_flash(q, k, v, do, seg, slopes, causal=c["causal"])
    t = [torch.from_numpy(x) for x in (q, k, v, do)]
    kw = dict(causal=c["causal"],
              segment_ids_q=None if seg is None else torch.from_numpy(seg),
              segment_ids_kv=None if seg is None else torch.from_numpy(seg),
              alibi_slopes=None if slopes is None else torch.from_numpy(slopes))
    out, lse = fa.flash_attention_plain(*t[:3], **kw)
    got = fa.flash_attention_bwd(*t[:3], out, lse, t[3], **kw)
    di = fa.attention_di(out, t[3])
    separate = (fa.flash_attention_bwd_dq_plain(*t, lse, di, **kw),
                *fa.flash_attention_bwd_dkv_plain(*t, lse, di, **kw))
    for name, g, s_, w in zip(("dq", "dk", "dv"), got, separate, want[2:]):
        assert torch.equal(g, s_), name
        np.testing.assert_allclose(g.numpy(), w, atol=TOL, rtol=TOL,
                                   err_msg=name)


def test_flash_bwd_ragged_length_matches_padded_pallas():
    """The port's backward takes sq = 200 as it is; the JAX kernels take
    it padded to their 128-row block, the padding in a segment of its own
    (0) that no real row sees, with zero cotangent."""
    s, pad = 200, 256
    q, k, v, do = _inputs(2, 1, s, 4, 2, 64)
    padded = [np.pad(x, ((0, 0), (0, pad - s), (0, 0), (0, 0)))
              for x in (q, k, v, do)]
    seg = np.zeros((1, pad), np.int32)
    seg[:, :s] = 1
    want = _jax_flash(*padded, seg, None, causal=True)
    got = _port_flash(q, k, v, do, None, None, causal=True)
    for name, g, w in zip(("out", "lse", "dq", "dk", "dv"), got, want):
        w = w[:, :, :s] if name == "lse" else w[:, :s]
        np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL, err_msg=name)


def test_onepass_lse_plain_matches_pallas_interpret():
    """B12: the forward of the trained path, with its natural-log LSE."""
    q, k, v, _ = _inputs(3, 1, 200, 4, 4, 64)
    sq_pad = _trained_pad(200)
    qp, kp, vp = (np.pad(x, ((0, 0), (0, sq_pad - 200), (0, 0), (0, 0)))
                  for x in (q, k, v))
    with pltpu.force_tpu_interpret_mode():
        out, lse = _onepass_fwd(jnp.asarray(qp), jnp.asarray(kp),
                                jnp.asarray(vp), scale=64 ** -0.5,
                                kv_len=200, emit_lse=True,
                                assume_bounded=False)
    got_out, got_lse = oa.onepass_attention_lse(
        *(torch.from_numpy(x) for x in (q, k, v)))
    np.testing.assert_allclose(got_out.numpy(), np.asarray(out)[:, :200],
                               atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got_lse.numpy(),
                               np.asarray(lse)[:, :, 0, :200],
                               atol=TOL, rtol=TOL)


def _check_onepass_bwd(q, k, v, do):
    """B13 from B12's out and LSE against jax.vjp of onepass_attention in
    interpret mode, within TOL."""
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(j_onepass, *(jnp.asarray(x) for x in (q, k, v)))
        want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    out, lse = oa.onepass_attention_lse(tq, tk, tv)
    got = oa.onepass_attention_bwd(tq, tk, tv, tdo, lse, out)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=TOL,
                                   rtol=TOL, err_msg=name)


def test_onepass_bwd_plain_matches_jax_vjp_interpret():
    """B13: the one-pass backward from B12's out and LSE against jax.vjp of
    onepass_attention (its Pallas dq and dk/dv kernels)."""
    _check_onepass_bwd(*_inputs(4, 1, 200, 4, 4, 64))


@pytest.mark.parametrize("d", [80, 104])
def test_onepass_bwd_plain_matches_jax_vjp_interpret_wide(d):
    """B13 at the metaclip ViT-H/14 (d = 80) and Qwen-VL bigG (d = 104)
    towers' widths."""
    _check_onepass_bwd(*_inputs(5, 1, 130, 2, 2, d))


def _dispatcher_head_dim_bounds():
    """The head-dim bounds written in ``attention()``: calls with ``d >
    N`` go to the plain reference, so N is the flash route's widest d;
    ``d <= M`` is the one-pass route's term."""
    fn = ast.parse(inspect.getsource(attention)).body[0]
    bounds = {}
    for n in ast.walk(fn):
        if (isinstance(n, ast.Compare) and isinstance(n.left, ast.Name)
                and n.left.id == "d" and len(n.ops) == 1
                and isinstance(n.comparators[0], ast.Constant)):
            bounds[type(n.ops[0]).__name__] = n.comparators[0].value
    return bounds["Gt"], bounds["LtE"]


def test_backward_takes_every_head_dim_the_forward_routes():
    """C19: every head dim the dispatcher sends to a kernel route can train
    there. The widest d of the flash route must be within B2's limit and
    the fused backward's (B10/B11), the one-pass route's within B1/B12's
    and the same backward's (B13): a forward that runs where its backward
    raises fails here."""
    flash_d, onepass_d = _dispatcher_head_dim_bounds()
    assert flash_d <= fa.FWD_MAX_D <= fa.BWD_MAX_D
    assert onepass_d <= oa.MAX_D <= fa.BWD_MAX_D
    # the JAX dispatcher's widths (merlin_tpu/ops/attention.py:192)
    assert (flash_d, onepass_d) == (256, 128)


def _autograd(fn, q, k, v, do):
    q, k, v = (x.clone().requires_grad_() for x in (q, k, v))
    out = fn(q, k, v)
    return (out.detach(),) + torch.autograd.grad(out, (q, k, v), do)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidir"])
def test_flash_autograd_matches_reference_autograd(causal):
    """FlashAttentionFn (B2 forward, B10 + B11 backward, plain on the
    CPU) against torch.autograd through mha_reference: GQA, ALiBi and
    packed segments (no row is fully masked, trap C2)."""
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(5, 2, 96, 4, 2, 32))
    seg = torch.from_numpy(_segments(2, 96, 40))
    slopes = torch.tensor([0.5, 0.25, 0.125, 0.0625])
    kw = dict(causal=causal, segment_ids_q=seg, segment_ids_kv=seg,
              alibi_slopes=slopes)
    got = _autograd(lambda *a: fa.differentiable_flash_attention(*a, **kw),
                    q, k, v, do)
    want = _autograd(lambda *a: mha_reference(*a, **kw), q, k, v, do)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=TOL,
                                   rtol=TOL, err_msg=name)


def test_onepass_autograd_matches_reference_autograd():
    """OnepassAttentionFn (B12 forward, B13 backward) against autograd
    through mha_reference, and ``differentiable_onepass_attention`` takes
    it only when a gradient is asked for (else B1, the inference path)."""
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(6, 2, 77, 4, 4, 32))
    got = _autograd(oa.differentiable_onepass_attention, q, k, v, do)
    want = _autograd(lambda *a: mha_reference(*a, causal=False), q, k, v, do)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=TOL,
                                   rtol=TOL, err_msg=name)
    qg = q.clone().requires_grad_()
    assert "OnepassAttentionFn" in type(
        oa.differentiable_onepass_attention(qg, k, v).grad_fn).__name__
    with torch.no_grad():
        out = oa.differentiable_onepass_attention(qg, k, v)
    assert out.grad_fn is None
    np.testing.assert_allclose(out.numpy(), got[0].numpy(),
                               atol=TOL, rtol=TOL)


def test_dispatcher_is_differentiable_on_cpu():
    """The dispatcher's CPU route (mha_reference) carries gradients to q,
    k and v, for the decoder's causal call and the tower's bidirectional
    one."""
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(7, 1, 130, 2, 2, 16))
    for causal in (True, False):
        got = _autograd(lambda *a: attention(*a, causal=causal), q, k, v, do)
        want = _autograd(lambda *a: mha_reference(*a, causal=causal),
                         q, k, v, do)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), w.numpy())
