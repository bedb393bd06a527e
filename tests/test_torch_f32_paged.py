"""The port's paged attention at f32 and at mixed (q, page) dtypes against
the JAX package on the CPU.

JAX's paged kernels follow their operands' dtypes: q . k at the promoted
dtype, p rounded to the page dtype before P V, out in q's dtype
(``paged_attention.py:83,147``). Its references, the CPU route, keep p in
f32. The two disagree as soon as q is f32 and the pages bf16 (trap C48),
so the port keeps both rules: the plain versions follow the references,
and with ``kernel_rounding`` the kernels (on blocks of a page, the TPU
BlockSpec kernels' block).

  * float pages, every pair of (bf16, f32) q x (bf16, f32) pages but (bf16,
    bf16): the plain versions against ``paged_attention_reference`` /
    ``paged_attention_multi_reference``, and with ``kernel_rounding``
    against B4 (``_paged_kernel``) and B6 (``_paged_multi_blocked_kernel``)
    in TPU interpret mode. B3 and B5 stay on the references (C8).
  * C48 planted: at f32 q over bf16 pages the JAX kernel and the JAX
    reference differ, and each of the port's two rules matches its own
    and not the other.
  * int8 pages at f32 q: with ``kernel_rounding`` against B8 and B9 in
    interpret mode (K/V dequantized to q's dtype, ``:820-823``); B7's rule
    (``bf16_operands``, trap C49: bf16 operands whatever q's dtype) against
    a JAX composition of its steps (``:1033-1034,1067,1131``), and apart
    from B9's.
  * every wrapper takes the plain version (no rounding) for CPU tensors at
    every pair and counts no launch; the pair picks the kernel; the
    wrappers refuse f16 q and a page dtype they do not read.

Tolerances: out in f32 from f32 operands, 1e-5 of max |want| (summation
order only); with bf16 pages or a bf16 rule, 1e-4 of max |want| (p's bf16
rounding may flip at a few elements between two f32 orders of the same
sum; seen <= 3.5e-7, against rule gaps of 1.2e-3 to 4.2e-3, so GAP =
5e-4 keeps them apart); out in bf16, one bf16 ulp of max |want|.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from merlin_tpu.models.layers import alibi_slopes as j_alibi_slopes
from merlin_tpu.ops import paged_attention as jpa

from merlin_tpu_torch.ops import paged_attention as pa

F32_TOL = 1e-5
ROUNDED_TOL = 1e-4
BF16_ULP = 2.0 ** -7
GAP = 5e-4           # the least distance between two rules held apart

DT = {"bf16": (torch.bfloat16, jnp.bfloat16), "f32": (torch.float32,
                                                        jnp.float32)}
PAIRS = [("bf16", "f32"), ("f32", "bf16"), ("f32", "f32")]


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _t(x, dtype=None):
    t = torch.from_numpy(np.array(x, copy=True))
    return t.to(dtype) if dtype is not None else t


def _j(x, dtype=None):
    return jnp.asarray(x, dtype) if dtype is not None else jnp.asarray(x)


def _np(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _inputs(seed, lengths, h, hkv, d, s_q=0, page=8, pps=4):
    """Normal q and pools (b * pps + 1 pages), tables of permuted pages 1..
    with unused entries on page 0; numpy (q, kp, vp, lengths, tables)."""
    rng = np.random.default_rng(seed)
    b = len(lengths)
    total = b * pps + 1
    kp = rng.normal(size=(total, page, hkv * d)).astype(np.float32)
    vp = rng.normal(size=(total, page, hkv * d)).astype(np.float32)
    perm = (rng.permutation(total - 1) + 1).reshape(b, pps)
    tables = np.zeros((b, pps), np.int32)
    for i, n in enumerate(lengths):
        tables[i, :-(-n // page)] = perm[i, :-(-n // page)]
    q = rng.normal(size=(b, s_q, h, d) if s_q else (b, h, d)).astype(
        np.float32)
    return q, kp, vp, np.asarray(lengths, np.int32), tables


def _close(got, want, tol):
    want = np.asarray(want, np.float32)
    err = np.abs(np.asarray(got, np.float32) - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def _dist(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a - b).max() / np.abs(b).max()


def _tol(q_name, p_name):
    if q_name == "bf16":
        return BF16_ULP
    return F32_TOL if p_name == "f32" else ROUNDED_TOL


DECODE = {
    # name: (lengths, h, hkv, alibi, page)
    "mha": ([1, 8, 29, 17], 4, 4, False, 8),
    "gqa": ([5, 32, 16], 8, 2, False, 8),
    "g16_alibi": ([3, 32, 17], 32, 2, True, 8),
    "page16": ([20, 64, 33], 8, 2, False, 16),
}


@pytest.mark.parametrize("pair", PAIRS, ids=["-".join(p) for p in PAIRS])
@pytest.mark.parametrize("case", sorted(DECODE))
def test_decode_rules_match_jax_at_dtype_pairs(case, pair):
    """B3/B4's plain version against JAX's reference (p in f32), and with
    ``kernel_rounding`` against B4 in interpret mode (p rounded to the page
    dtype), at the (q, page) pair."""
    lengths, h, hkv, alibi, page = DECODE[case]
    (tq, jq), (tp, jp) = DT[pair[0]], DT[pair[1]]
    q, kp, vp, lens, tables = _inputs(30, lengths, h, hkv, 16, page=page,
                                      pps=64 // page)
    slopes = np.asarray(j_alibi_slopes(h)) if alibi else None
    jargs = (_j(q, jq), _j(kp, jp), _j(vp, jp), _j(lens), _j(tables))
    jsl = None if slopes is None else _j(slopes)
    want_ref = jpa.paged_attention_reference(*jargs, alibi_slopes=jsl)
    with pltpu.force_tpu_interpret_mode():
        want_kernel = jpa.paged_attention(*jargs, alibi_slopes=jsl)
    assert want_kernel.dtype == jq and want_ref.dtype == jq
    targs = (_t(q, tq), _t(kp, tp), _t(vp, tp), _t(lens), _t(tables))
    tsl = None if slopes is None else _t(slopes)
    got_ref = pa.paged_attention_plain(*targs, alibi_slopes=tsl)
    got_kernel = pa.paged_attention_plain(*targs, alibi_slopes=tsl,
                                          kernel_rounding=True)
    assert got_ref.dtype == tq and got_kernel.dtype == tq
    tol = _tol(*pair)
    _close(got_ref.float().numpy(), _np(want_ref), tol)
    _close(got_kernel.float().numpy(), _np(want_kernel), tol)
    for wrapper in (pa.paged_attention_dma, pa.paged_attention):
        kw = {} if wrapper is pa.paged_attention_dma else dict(
            alibi_slopes=tsl)
        if wrapper is pa.paged_attention_dma and alibi:
            continue
        before = (wrapper.launches, wrapper.launches_f32)
        np.testing.assert_array_equal(
            wrapper(*targs, **kw).float().numpy(), got_ref.float().numpy())
        assert (wrapper.launches, wrapper.launches_f32) == before


WINDOWS = {
    # name: (lengths, s_q, h, hkv, alibi, page); group * s_q % 8 == 0 (B6)
    "mha": ([9, 30, 17], 8, 2, 2, False, 8),
    "gqa_alibi": ([12, 25], 4, 8, 2, True, 8),
    "g16": ([16, 31], 1, 32, 2, False, 8),
}


@pytest.mark.parametrize("pair", PAIRS, ids=["-".join(p) for p in PAIRS])
@pytest.mark.parametrize("case", sorted(WINDOWS))
def test_window_rules_match_jax_at_dtype_pairs(case, pair):
    """B5/B6's plain version against JAX's multi reference, and with
    ``kernel_rounding`` against B6 in interpret mode."""
    lengths, s_q, h, hkv, alibi, page = WINDOWS[case]
    (tq, jq), (tp, jp) = DT[pair[0]], DT[pair[1]]
    q, kp, vp, lens, tables = _inputs(31, lengths, h, hkv, 16, s_q=s_q,
                                      page=page)
    slopes = np.asarray(j_alibi_slopes(h)) if alibi else None
    jargs = (_j(q, jq), _j(kp, jp), _j(vp, jp), _j(lens), _j(tables))
    jsl = None if slopes is None else _j(slopes)
    want_ref = jpa.paged_attention_multi_reference(*jargs, alibi_slopes=jsl)
    with pltpu.force_tpu_interpret_mode():
        want_kernel = jpa.paged_attention_multi_blocked(*jargs,
                                                        alibi_slopes=jsl)
    targs = (_t(q, tq), _t(kp, tp), _t(vp, tp), _t(lens), _t(tables))
    tsl = None if slopes is None else _t(slopes)
    got_ref = pa.paged_attention_multi_plain(*targs, alibi_slopes=tsl)
    got_kernel = pa.paged_attention_multi_plain(
        *targs, alibi_slopes=tsl, kernel_rounding=True)
    tol = _tol(*pair)
    _close(got_ref.float().numpy(), _np(want_ref), tol)
    _close(got_kernel.float().numpy(), _np(want_kernel), tol)
    for wrapper in (pa.paged_attention_dma_multi,
                    pa.paged_attention_multi_blocked,
                    pa.paged_window_attention):
        np.testing.assert_array_equal(
            wrapper(*targs, alibi_slopes=tsl).float().numpy(),
            got_ref.float().numpy())


def test_c48_kernel_and_reference_rules_are_kept_apart():
    """Trap C48 at the measured setup (b = 1, h = 8, hkv = 2, d = 128,
    pages of 16, length 20, normal inputs from seed 0): at f32 q over bf16
    pages JAX's B4 rounds p to bf16 and its reference does not, ~1e-3
    apart. The port's plain version matches the reference, and with
    ``kernel_rounding`` the kernel; each is GAP or more from the other."""
    rng = np.random.default_rng(0)
    q = rng.normal(size=(1, 8, 128)).astype(np.float32)
    kp = rng.normal(size=(3, 16, 2 * 128)).astype(np.float32)
    vp = rng.normal(size=(3, 16, 2 * 128)).astype(np.float32)
    lens = np.asarray([20], np.int32)
    tables = np.asarray([[2, 1]], np.int32)
    jargs = (_j(q), _j(kp, jnp.bfloat16), _j(vp, jnp.bfloat16), _j(lens),
             _j(tables))
    want_ref = _np(jpa.paged_attention_reference(*jargs))
    with pltpu.force_tpu_interpret_mode():
        want_kernel = _np(jpa.paged_attention(*jargs))
    assert _dist(want_kernel, want_ref) > GAP
    targs = (_t(q), _t(kp, torch.bfloat16), _t(vp, torch.bfloat16),
             _t(lens), _t(tables))
    got_ref = pa.paged_attention_plain(*targs).numpy()
    got_kernel = pa.paged_attention_plain(*targs,
                                          kernel_rounding=True).numpy()
    _close(got_ref, want_ref, F32_TOL)
    _close(got_kernel, want_kernel, ROUNDED_TOL)
    assert _dist(got_ref, want_kernel) > GAP
    assert _dist(got_kernel, want_ref) > GAP


def _q8_inputs(seed, lengths, h, hkv, d, s_q=0, page=8, pps=4):
    """As :func:`_inputs`, with both pools quantized by JAX's
    ``quantize_pages``: numpy (q, kv, ks, vv, vs, lengths, tables)."""
    q, kp, vp, lens, tables = _inputs(seed, lengths, h, hkv, d, s_q, page,
                                      pps)
    kv, ks = (np.asarray(x) for x in jpa.quantize_pages(_j(kp), d))
    vv, vs = (np.asarray(x) for x in jpa.quantize_pages(_j(vp), d))
    return q, kv, ks, vv, vs, lens, tables


Q8_DECODE = {
    "mha": ([1, 8, 29, 17], 4, 4, False),
    "gqa_alibi": ([5, 32, 16], 8, 2, True),
    "hkv3": ([1, 24, 13], 6, 3, False),
}


@pytest.mark.parametrize("q_name", ["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(Q8_DECODE))
def test_b9_kernel_rule_matches_pallas_interpret(case, q_name):
    """B9 in interpret mode dequantizes to q's dtype and rounds p to it:
    at f32 q every product is f32."""
    lengths, h, hkv, alibi = Q8_DECODE[case]
    tq, jq = DT[q_name]
    q, kv, ks, vv, vs, lens, tables = _q8_inputs(32, lengths, h, hkv, 16)
    slopes = np.asarray(j_alibi_slopes(h)) if alibi else None
    with pltpu.force_tpu_interpret_mode():
        want = jpa.paged_attention_quantized(
            _j(q, jq), _j(kv), _j(ks), _j(vv), _j(vs), _j(lens), _j(tables),
            alibi_slopes=None if slopes is None else _j(slopes))
    got = pa.paged_attention_q8_plain(
        _t(q, tq), _t(kv), _t(ks), _t(vv), _t(vs), _t(lens), _t(tables),
        alibi_slopes=None if slopes is None else _t(slopes),
        kernel_rounding=True)
    assert got.dtype == tq
    _close(got.float().numpy(), _np(want),
           F32_TOL if q_name == "f32" else BF16_ULP)


Q8_WINDOWS = {
    "mha": ([9, 30, 17], 8, 2, 2, False),
    "gqa_alibi": ([12, 25], 4, 8, 2, True),
}


@pytest.mark.parametrize("case", sorted(Q8_WINDOWS))
def test_b8_kernel_rule_matches_pallas_interpret_f32(case):
    """B8 in interpret mode at f32 q: K/V dequantized to f32 (``:820-823``),
    p kept f32."""
    lengths, s_q, h, hkv, alibi = Q8_WINDOWS[case]
    q, kv, ks, vv, vs, lens, tables = _q8_inputs(33, lengths, h, hkv, 16,
                                                 s_q=s_q)
    slopes = np.asarray(j_alibi_slopes(h)) if alibi else None
    with pltpu.force_tpu_interpret_mode():
        want = jpa.paged_attention_multi_blocked_q8(
            _j(q), _j(kv), _j(ks), _j(vv), _j(vs), _j(lens), _j(tables),
            alibi_slopes=None if slopes is None else _j(slopes))
    targs = (_t(q), _t(kv), _t(ks), _t(vv), _t(vs), _t(lens), _t(tables))
    tsl = None if slopes is None else _t(slopes)
    got = pa.paged_attention_multi_q8_plain(*targs, alibi_slopes=tsl,
                                            kernel_rounding=True)
    _close(got.numpy(), _np(want), F32_TOL)
    # the CPU route: JAX's decoder dequantizes to bf16 first
    for wrapper in (pa.paged_attention_multi_blocked_q8,
                    pa.paged_attention_dma_multi_q8,
                    pa.paged_window_attention_q8):
        before = (pa.paged_attention_multi_blocked_q8.launches_f32,
                  pa.paged_attention_dma_multi_q8.launches_f32)
        np.testing.assert_array_equal(
            wrapper(*targs, alibi_slopes=tsl).numpy(),
            pa.paged_attention_multi_q8_plain(*targs,
                                              alibi_slopes=tsl).numpy())
        assert (pa.paged_attention_multi_blocked_q8.launches_f32,
                pa.paged_attention_dma_multi_q8.launches_f32) == before


def _j_b7(q, kv, ks, vv, vs, lens, tables, slopes):
    """B7's steps composed in JAX over the whole table as one block: q
    packed to bf16 (``:1131``), the int8 K/V cast to bf16 (``:1033-1034``),
    the scores times the per-key k scale and the scale, p * v_scale rounded
    to bf16 for P V (``:1067``), out in q's dtype."""
    b, s_q, h, d = q.shape
    hkv = kv.shape[2] // d
    group = h // hkv
    n_keys = tables.shape[1] * kv.shape[1]
    lanes = ks.shape[-1]
    stride = max(lanes // hkv, 1)
    k = kv[tables].reshape(b, n_keys, hkv, d).astype(jnp.bfloat16)
    v = vv[tables].reshape(b, n_keys, hkv, d).astype(jnp.bfloat16)
    k_sc = ks[tables].reshape(b, n_keys, lanes)[..., 0:hkv * stride:stride]
    v_sc = vs[tables].reshape(b, n_keys, lanes)[..., 0:hkv * stride:stride]
    qb = q.astype(jnp.bfloat16).reshape(b, s_q, hkv, group, d)
    s = jnp.einsum("bthgd,bkhd->bhgtk", qb, k,
                   preferred_element_type=jnp.float32)
    s = s * k_sc.transpose(0, 2, 1)[:, :, None, None, :] * d ** -0.5
    k_pos = jnp.arange(n_keys)
    q_pos = lens[:, None] - s_q + jnp.arange(s_q)[None]
    if slopes is not None:
        dist = (k_pos[None, None, :] - q_pos[:, :, None]).astype(jnp.float32)
        s = s + slopes.reshape(hkv, group)[None, :, :, None, None] \
            * dist[:, None, None]
    s = jnp.where((k_pos[None, None, :] <= q_pos[:, :, None])[:, None, None],
                  s, jpa.NEG_INF)
    m = s.max(-1, keepdims=True)
    p = jnp.exp(s - m)
    pv = (p * v_sc.transpose(0, 2, 1)[:, :, None, None, :]).astype(
        jnp.bfloat16)
    acc = jnp.einsum("bhgtk,bkhd->bhgtd", pv, v,
                     preferred_element_type=jnp.float32)
    out = acc / p.sum(-1, keepdims=True)
    return out.transpose(0, 3, 1, 2, 4).reshape(b, s_q, h, d).astype(q.dtype)


@pytest.mark.parametrize("case", sorted(Q8_WINDOWS) + ["decode"])
def test_b7_bf16_rule_matches_jax_composition(case):
    """Trap C49: B7 computes with bf16 operands whatever q's dtype. Its
    rule (``bf16_operands``) matches the JAX composition of its steps, and
    sits GAP or more from B9's rule (dequantize to q's dtype, all f32 at f32
    q) on the same inputs."""
    if case == "decode":
        lengths, s_q, h, hkv, alibi = [5, 32, 16], 1, 8, 2, True
    else:
        lengths, s_q, h, hkv, alibi = Q8_WINDOWS[case]
    q, kv, ks, vv, vs, lens, tables = _q8_inputs(34, lengths, h, hkv, 16,
                                                 s_q=s_q)
    slopes = np.asarray(j_alibi_slopes(h)) if alibi else None
    want = _np(_j_b7(_j(q), _j(kv), _j(ks), _j(vv), _j(vs), _j(lens),
                     _j(tables), None if slopes is None else _j(slopes)))
    targs = (_t(q), _t(kv), _t(ks), _t(vv), _t(vs), _t(lens), _t(tables))
    kw = dict(alibi_slopes=None if slopes is None else _t(slopes),
              kernel_rounding=True, block_keys=tables.shape[1] * kv.shape[1])
    got = pa.paged_attention_multi_q8_plain(*targs, bf16_operands=True, **kw)
    assert got.dtype == torch.float32
    _close(got.numpy(), want, ROUNDED_TOL)
    f32_rule = pa.paged_attention_multi_q8_plain(*targs, **kw).numpy()
    assert _dist(f32_rule, want) > GAP
    if s_q == 1:
        dec = pa.paged_attention_q8_plain(
            targs[0][:, 0], *targs[1:], bf16_operands=True, **kw)
        np.testing.assert_array_equal(dec.numpy(), got[:, 0].numpy())


@pytest.mark.parametrize("q_name", ["bf16", "f32"])
@pytest.mark.parametrize("p_name", ["bf16", "f32", "int8"])
def test_the_pair_picks_the_kernel(q_name, p_name):
    """bf16 q over bf16 or int8 pages runs the bf16 kernels; every other
    pair the f32 kernel."""
    q = torch.empty((1, 2, 16), dtype=DT[q_name][0])
    pages = torch.empty((2, 8, 32), dtype={"bf16": torch.bfloat16,
                                            "f32": torch.float32,
                                            "int8": torch.int8}[p_name])
    assert pa._f32_kernel(q, pages) == (q_name == "f32" or p_name == "f32")


def test_wrappers_refuse_what_no_kernel_reads():
    """f16 q, pages of a dtype the call does not read and mixed page
    dtypes are refused before the device is looked at."""
    lengths = torch.empty((2,), dtype=torch.int32, device="meta")
    tables = torch.empty((2, 4), dtype=torch.int32, device="meta")
    f32 = torch.empty((9, 16, 128), dtype=torch.float32, device="meta")
    bf16 = torch.empty((9, 16, 128), dtype=torch.bfloat16, device="meta")
    i8 = torch.empty((9, 16, 128), dtype=torch.int8, device="meta")
    q16 = torch.empty((2, 4, 32), dtype=torch.float16, device="meta")
    q = torch.empty((2, 4, 32), dtype=torch.float32, device="meta")
    for call, match in (
            (lambda: pa.paged_attention(q16, f32, f32, lengths, tables),
             "bfloat16 or float32"),
            (lambda: pa.paged_attention(q, i8, i8, lengths, tables),
             "pages must be"),
            (lambda: pa.paged_attention(q, f32, bf16, lengths, tables),
             "pages must be"),
            (lambda: pa.paged_attention_dma_q8(q, f32, f32, f32, f32,
                                               lengths, tables),
             "pages must be"),
            (lambda: pa.paged_attention(q, f32, f32, lengths, tables),
             "CUDA")):
        with pytest.raises(ValueError, match=match):
            call()


def test_every_wrapper_counts_both_kernels():
    for wrapper in (pa.paged_attention_dma, pa.paged_attention,
                    pa.paged_attention_dma_multi,
                    pa.paged_attention_multi_blocked,
                    pa.paged_attention_dma_q8, pa.paged_attention_quantized,
                    pa.paged_attention_dma_multi_q8,
                    pa.paged_attention_multi_blocked_q8):
        assert isinstance(wrapper.launches, int)
        assert isinstance(wrapper.launches_f32, int)
