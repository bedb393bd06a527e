"""The port's int8-page ops against the JAX package on the CPU.

  * ``_scale_row`` (the strided scale lanes: head i at lane i * (128 // hkv),
    stride 128, 64, 42 and 3 for hkv 1, 2, 3 and 40), ``quantize_pages``,
    ``dequantize_pages`` and both int8 page writes: exact, int8 values and
    f32 scales alike, tokens whose rows are all zero included (the 1e-8
    scale floor);
  * the plain versions of B8 and B9 against their Pallas kernels run in TPU
    interpret mode, at bf16 q as the serving path runs them: one bf16 ulp of
    the output's largest magnitude, since the TPU kernels round p to bf16
    for P@V where the plain version keeps it in f32;
  * the plain version of B7 (``paged_attention_dma_q8`` at s_q = 1 and
    ``paged_attention_dma_multi_q8``) against ``dequantize_pages`` and the
    JAX references, at f32 to 1e-5 (summation order only): B7's Pallas
    kernel cannot run in interpret mode, because its prefetch predicate
    reads ``lengths[b]`` one past the end on the last grid step (trap C8);
  * every int8 wrapper takes its plain version for CPU tensors and counts
    no launch; the int8 window router sends <= 16 rows per kv head to B7;
  * a write past a table row changes no page and no scale, as JAX drops it
    (trap C9).

Inputs come from numpy with a seed: ragged lengths (1, a page multiple, a
ragged last page), permuted page tables with unused entries on page 0,
GQA up to 32 query heads per kv head, ALiBi and hkv = 3 (a stride that
does not divide 128).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from merlin_tpu.models.layers import alibi_slopes as j_alibi_slopes
from merlin_tpu.ops import paged_attention as jpa

from merlin_tpu_torch.ops import paged_attention as pa

F32_TOL = 1e-5
BF16_ULP = 2.0 ** -7    # relative spacing of bf16 values in [1, 2)


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


def _q8_inputs(seed, lengths, h, hkv, d, s_q=0, page=8, pps=4):
    """q and an int8 pool quantized by JAX's ``quantize_pages`` from normal
    values (b * pps + 1 pages), tables of permuted pages 1.. with unused
    entries on page 0. Returns numpy (q, kv, ks, vv, vs, lengths, tables)."""
    rng = np.random.default_rng(seed)
    b = len(lengths)
    total = b * pps + 1
    pools = []
    for _ in range(2):
        x = rng.normal(size=(total, page, hkv * d)).astype(np.float32)
        vals, scales = jpa.quantize_pages(_j(x), d)
        pools += [np.asarray(vals), np.asarray(scales)]
    perm = (rng.permutation(total - 1) + 1).reshape(b, pps)
    tables = np.zeros((b, pps), np.int32)
    for i, n in enumerate(lengths):
        used = -(-n // page)
        tables[i, :used] = perm[i, :used]
    qshape = (b, s_q, h, d) if s_q else (b, h, d)
    q = rng.normal(size=qshape).astype(np.float32)
    kv, ks, vv, vs = pools
    return q, kv, ks, vv, vs, np.asarray(lengths, np.int32), tables


@pytest.mark.parametrize("hkv", [1, 2, 3, 40])
def test_scale_row_matches_jax(hkv):
    sc = np.random.default_rng(hkv).uniform(0.1, 2.0, size=(3, 5, hkv)) \
        .astype(np.float32)
    want = np.asarray(jpa._scale_row(_j(sc), 128))
    got = pa._scale_row(_t(sc), 128)
    np.testing.assert_array_equal(got.numpy(), want)
    stride = max(128 // hkv, 1)
    assert (got[..., ::stride][..., :hkv] == _t(sc)).all()


@pytest.mark.parametrize("hkv", [1, 3])
def test_quantize_and_dequantize_pages_match_jax(hkv):
    d = 16
    x = np.random.default_rng(10 + hkv).normal(size=(3, 4, hkv * d)) \
        .astype(np.float32) * 3.0
    x[1, 2] = 0.0                      # an all-zero token: the 1e-8 floor
    x[2, 0, :d] = 0.0                  # one zero head of a token
    jv, js = jpa.quantize_pages(_j(x), d)
    tv, ts = pa.quantize_pages(_t(x), d)
    assert tv.dtype == torch.int8 and ts.dtype == torch.float32
    assert tuple(ts.shape) == (3, 4, 128)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert ts[1, 2, 0].item() == np.float32(1e-8)
    for dtype, jdtype in ((torch.bfloat16, jnp.bfloat16),
                          (torch.float32, jnp.float32)):
        want = np.asarray(jpa.dequantize_pages(jv, js, d, jdtype)
                          .astype(jnp.float32))
        got = pa.dequantize_pages(tv, ts, d, dtype)
        assert got.dtype == dtype
        np.testing.assert_array_equal(got.float().numpy(), want)
    # bf16 is the default, as the JAX decoder's CPU route relies on
    assert pa.dequantize_pages(tv, ts, d).dtype == torch.bfloat16


def _empty_pools(rng, total, page, hkv, d):
    vals = rng.integers(-127, 128, size=(total, page, hkv * d)).astype(np.int8)
    scales = rng.uniform(0.0, 1.0, size=(total, page, 128)).astype(np.float32)
    return vals, scales


def test_write_token_to_pages_q8_matches_jax():
    rng = np.random.default_rng(11)
    hkv, d, page = 3, 8, 4
    kv, ks = _empty_pools(rng, 7, page, hkv, d)
    vv, vs = _empty_pools(rng, 7, page, hkv, d)
    tables = np.asarray([[3, 1, 0], [5, 6, 2]], np.int32)
    k_new = rng.normal(size=(2, hkv, d)).astype(np.float32)
    v_new = rng.normal(size=(2, hkv, d)).astype(np.float32)
    v_new[1, 2] = 0.0
    pos = np.asarray([6, 9], np.int32)
    want = jpa.write_token_to_pages_q8(
        _j(kv), _j(ks), _j(vv), _j(vs), _j(k_new), _j(v_new),
        positions=_j(pos), page_tables=_j(tables))
    arrays = [_t(a) for a in (kv, ks, vv, vs)]
    out = pa.write_token_to_pages_q8(*arrays, _t(k_new), _t(v_new),
                                     positions=_t(pos),
                                     page_tables=_t(tables))
    assert all(o is a for o, a in zip(out, arrays))       # in place
    for got, w in zip(arrays, want):
        np.testing.assert_array_equal(got.numpy(), np.asarray(w))


def test_write_tokens_to_pages_q8_matches_jax():
    """A window crossing a page boundary, through permuted tables."""
    rng = np.random.default_rng(12)
    hkv, d, page, s_q = 2, 8, 4, 5
    kv, ks = _empty_pools(rng, 9, page, hkv, d)
    vv, vs = _empty_pools(rng, 9, page, hkv, d)
    tables = np.asarray([[4, 7, 2, 0], [1, 8, 3, 6]], np.int32)
    k_new = rng.normal(size=(2, s_q, hkv, d)).astype(np.float32)
    v_new = rng.normal(size=(2, s_q, hkv, d)).astype(np.float32)
    k_new[0, 3] = 0.0
    start = np.asarray([2, 9], np.int32)
    want = jpa.write_tokens_to_pages_q8(
        _j(kv), _j(ks), _j(vv), _j(vs), _j(k_new), _j(v_new),
        start_positions=_j(start), page_tables=_j(tables))
    arrays = [_t(a) for a in (kv, ks, vv, vs)]
    pa.write_tokens_to_pages_q8(*arrays, _t(k_new), _t(v_new),
                                start_positions=_t(start),
                                page_tables=_t(tables))
    for got, w in zip(arrays, want):
        np.testing.assert_array_equal(got.numpy(), np.asarray(w))


# positions (decode) or window starts past 3-page tables of 4-token pages:
# JAX's scatter drops the rows whose logical page is 3 or more. In
# "window_collide" row 1's dropped tokens would clamp to the page its first
# token writes.
PAST_TABLE = {
    "decode_one_past": np.asarray([6, 12], np.int32),
    "decode_all_past": np.asarray([13, 40], np.int32),
    "window_collide": np.asarray([2, 8], np.int32),
    "window_all_past": np.asarray([12, 20], np.int32),
}


@pytest.mark.parametrize("case", sorted(PAST_TABLE))
def test_write_past_table_q8_is_dropped_like_jax(case):
    """C9 over int8 pages: a write past its table row changes no value and
    no scale, as JAX drops it, while the call's other rows land, and a
    dropped window token does not overwrite the live token whose slot it
    would clamp to."""
    rng = np.random.default_rng(13)
    hkv, d, page = 2, 8, 4
    kv, ks = _empty_pools(rng, 7, page, hkv, d)
    vv, vs = _empty_pools(rng, 7, page, hkv, d)
    tables = np.asarray([[3, 1, 4], [5, 6, 2]], np.int32)
    window = case.startswith("window")
    shape = (2, 5, hkv, d) if window else (2, hkv, d)
    k_new = rng.normal(size=shape).astype(np.float32)
    v_new = rng.normal(size=shape).astype(np.float32)
    pos = PAST_TABLE[case]
    key = "start_positions" if window else "positions"
    jfn = (jpa.write_tokens_to_pages_q8 if window
           else jpa.write_token_to_pages_q8)
    pfn = (pa.write_tokens_to_pages_q8 if window
           else pa.write_token_to_pages_q8)
    want = jfn(_j(kv), _j(ks), _j(vv), _j(vs), _j(k_new), _j(v_new),
               page_tables=_j(tables), **{key: _j(pos)})
    arrays = [_t(a) for a in (kv, ks, vv, vs)]
    pfn(*arrays, _t(k_new), _t(v_new), page_tables=_t(tables),
        **{key: _t(pos)})
    for got, w, before in zip(arrays, want, (kv, ks, vv, vs)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(w))
        assert np.array_equal(got.numpy(), before) == case.endswith(
            "all_past")


def _assert_within_one_ulp(got, want):
    """|got - want| <= one bf16 ulp of the largest |want|."""
    want = np.asarray(want, np.float32)
    tol = BF16_ULP * np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=tol, rtol=0)


DECODE_CASES = {
    # name: (lengths, h, hkv, alibi)
    "mha": ([1, 8, 29, 17], 4, 4, False),
    "gqa": ([5, 32, 16], 8, 2, False),
    "hkv3_alibi": ([1, 24, 13], 6, 3, True),
    # query groups above 8: 32 query heads over 2 kv heads and over 1
    "g16": ([3, 32, 17], 32, 2, False),
    "g32_alibi": ([9, 1, 30], 32, 1, True),
}


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_b9_plain_matches_pallas_interpret(case):
    """B9 (``_paged_q8_kernel``) in interpret mode at bf16 q."""
    lengths, h, hkv, alibi = DECODE_CASES[case]
    q, kv, ks, vv, vs, lens, tables = _q8_inputs(20, lengths, h, hkv, 16)
    slopes = np.asarray(j_alibi_slopes(h)) if alibi else None
    with pltpu.force_tpu_interpret_mode():
        want = jpa.paged_attention_quantized(
            _j(q, jnp.bfloat16), _j(kv), _j(ks), _j(vv), _j(vs), _j(lens),
            _j(tables), alibi_slopes=None if slopes is None else _j(slopes))
    args = (_t(q, torch.bfloat16), _t(kv), _t(ks), _t(vv), _t(vs), _t(lens),
            _t(tables))
    sl = None if slopes is None else _t(slopes)
    got = pa.paged_attention_q8_plain(*args, alibi_slopes=sl)
    assert got.dtype == torch.bfloat16
    _assert_within_one_ulp(got.float().numpy(),
                           np.asarray(want.astype(jnp.float32)))
    for wrapper in (pa.paged_attention_quantized, pa.paged_attention_dma_q8):
        before = wrapper.launches
        np.testing.assert_array_equal(
            wrapper(*args, alibi_slopes=sl).float().numpy(),
            got.float().numpy())
        assert wrapper.launches == before


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_b7_decode_plain_matches_jax_reference_f32(case):
    """``paged_attention_dma_q8`` (B7 at s_q = 1) is held to the JAX
    decoder's CPU route: ``dequantize_pages`` (to bf16) and
    ``paged_attention_reference`` (trap C8 keeps B7's Pallas kernel out of
    interpret mode)."""
    lengths, h, hkv, alibi = DECODE_CASES[case]
    q, kv, ks, vv, vs, lens, tables = _q8_inputs(21, lengths, h, hkv, 16)
    slopes = np.asarray(j_alibi_slopes(h)) if alibi else None
    want = np.asarray(jpa.paged_attention_reference(
        _j(q), jpa.dequantize_pages(_j(kv), _j(ks), 16),
        jpa.dequantize_pages(_j(vv), _j(vs), 16), _j(lens), _j(tables),
        alibi_slopes=None if slopes is None else _j(slopes)))
    got = pa.paged_attention_dma_q8(
        _t(q), _t(kv), _t(ks), _t(vv), _t(vs), _t(lens), _t(tables),
        alibi_slopes=None if slopes is None else _t(slopes))
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=F32_TOL)


WINDOW_CASES = {
    # name: (lengths, s_q, h, hkv, alibi); lengths include the window
    "sq1_mha": ([1, 8, 29, 17], 1, 4, 4, False),
    "sq3_gqa_alibi": ([3, 16, 30], 3, 8, 2, True),
    "sq5_hkv3": ([5, 21, 30], 5, 3, 3, False),
    "sq8_mha_alibi": ([8, 16, 27, 9], 8, 4, 4, True),
    "sq8_gqa": ([8, 24, 32], 8, 8, 2, False),
    # 15 query rows per kv head (group 3 x 5), the few-rows kernel's tile
    "sq5_g3": ([5, 21, 30], 5, 6, 2, False),
}


@pytest.mark.parametrize("case", sorted(WINDOW_CASES))
def test_b7_window_plain_matches_jax_reference_f32(case):
    """``paged_attention_dma_multi_q8`` (B7) against ``dequantize_pages``
    and ``paged_attention_multi_reference``: B7's Pallas kernel over-reads
    ``lengths`` in interpret mode (trap C8). Every int8 window wrapper and
    the router take the plain version on the CPU and count no launch."""
    lengths, s_q, h, hkv, alibi = WINDOW_CASES[case]
    q, kv, ks, vv, vs, lens, tables = _q8_inputs(22, lengths, h, hkv, 16,
                                                 s_q=s_q)
    slopes = np.asarray(j_alibi_slopes(h)) if alibi else None
    want = np.asarray(jpa.paged_attention_multi_reference(
        _j(q), jpa.dequantize_pages(_j(kv), _j(ks), 16),
        jpa.dequantize_pages(_j(vv), _j(vs), 16), _j(lens), _j(tables),
        alibi_slopes=None if slopes is None else _j(slopes)))
    args = (_t(q), _t(kv), _t(ks), _t(vv), _t(vs), _t(lens), _t(tables))
    sl = None if slopes is None else _t(slopes)
    got = pa.paged_attention_multi_q8_plain(*args, alibi_slopes=sl)
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=F32_TOL)
    before = (pa.paged_attention_dma_multi_q8.launches,
              pa.paged_attention_multi_blocked_q8.launches)
    for wrapper in (pa.paged_attention_dma_multi_q8,
                    pa.paged_attention_multi_blocked_q8,
                    pa.paged_window_attention_q8):
        np.testing.assert_array_equal(
            wrapper(*args, alibi_slopes=sl).numpy(), got.numpy())
    assert (pa.paged_attention_dma_multi_q8.launches,
            pa.paged_attention_multi_blocked_q8.launches) == before


# B8's cases in interpret mode: name: (lengths, s_q, h, hkv, alibi, page,
# pages per sequence); group * s_q a multiple of 8 sublanes, as JAX asserts
B8_CASES = {
    "sq8_mha_alibi": ([8, 16, 27, 9], 8, 4, 4, True, 8, 4),
    "sq8_gqa": ([8, 24, 32], 8, 8, 2, False, 8, 4),
    # the engine's form: one sequence, a window after a history
    "engine_sq24": ([61], 24, 2, 2, False, 8, 8),
    # a window spanning pages of 16 and of 64 keys; hkv = 3 (scale stride
    # 42)
    "page16_sq24": ([50, 70], 24, 3, 3, True, 16, 8),
    "page64_sq40": ([100, 41], 40, 4, 2, False, 64, 4),
    # 144 rows per kv head (group 2 x s_q 72)
    "rows144_g2": ([80, 126], 72, 4, 2, True, 16, 8),
    # rows that see no key (length 12 < s_q 16), the table full
    "no_key_rows": ([12, 16], 16, 4, 2, False, 8, 2),
}


@pytest.mark.parametrize("case", sorted(B8_CASES))
def test_b8_plain_matches_pallas_interpret(case):
    """B8 (``_paged_multi_blocked_q8_kernel``) in interpret mode at bf16 q
    (it needs group * s_q to be a multiple of 8 sublanes), at the engine's
    one-sequence windows, pages of 8, 16 and 64 keys, more than 128 rows
    per kv head and rows that see no key."""
    lengths, s_q, h, hkv, alibi, page, pps = B8_CASES[case]
    q, kv, ks, vv, vs, lens, tables = _q8_inputs(23, lengths, h, hkv, 16,
                                                 s_q=s_q, page=page, pps=pps)
    slopes = np.asarray(j_alibi_slopes(h)) if alibi else None
    with pltpu.force_tpu_interpret_mode():
        want = jpa.paged_attention_multi_blocked_q8(
            _j(q, jnp.bfloat16), _j(kv), _j(ks), _j(vv), _j(vs), _j(lens),
            _j(tables), alibi_slopes=None if slopes is None else _j(slopes))
    got = pa.paged_attention_multi_blocked_q8(
        _t(q, torch.bfloat16), _t(kv), _t(ks), _t(vv), _t(vs), _t(lens),
        _t(tables), alibi_slopes=None if slopes is None else _t(slopes))
    assert got.dtype == torch.bfloat16
    _assert_within_one_ulp(got.float().numpy(),
                           np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("group,s_q,route", [
    (1, 5, "paged_attention_dma_multi_q8"),
    (4, 4, "paged_attention_dma_multi_q8"),
    (3, 5, "paged_attention_dma_multi_q8"),
    (1, 17, "paged_attention_multi_blocked_q8"),
    (4, 128, "paged_attention_multi_blocked_q8")])
def test_q8_window_route_by_rows_per_kv_head(monkeypatch, group, s_q, route):
    """Verify windows (<= 16 query rows per kv head) go to B7, prefill
    windows to B8."""
    called = []
    for name in ("paged_attention_dma_multi_q8",
                 "paged_attention_multi_blocked_q8"):
        monkeypatch.setattr(pa, name, lambda *a, _n=name, **k: called.append(
            _n))
    q = torch.zeros((1, s_q, 2 * group, 8))
    pages = torch.zeros((1, 8, 16), dtype=torch.int8)
    scales = torch.zeros((1, 8, 128))
    pa.paged_window_attention_q8(q, pages, scales, pages, scales, None, None)
    assert called == [route]
