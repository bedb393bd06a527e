"""The port's paged-attention ops against the JAX package on the CPU.

  * ``paged_attention_plain`` (B3/B4's plain version) and
    ``paged_attention_multi_plain`` (B5/B6's) against the JAX references
    (``paged_attention_reference``, ``paged_attention_multi_reference``),
    and, for B4 and B6, against the Pallas kernels run in TPU interpret
    mode. B3 and B5 are held to the references only: in interpret mode their
    last grid step reads ``lengths[b]`` one past the end (trap C8).
  * each wrapper takes its plain version for CPU tensors and counts no
    launch;
  * ``write_token(s)_to_pages`` and ``PagePool`` against JAX's, writes
    past a table row included (JAX drops them: trap C9);
  * the kernels' shape guards (the wrappers' and ``bad_shape`` in
    ``csrc/paged_attention.cu``) take every query group the JAX kernels
    take.

Inputs come from numpy with a seed: GQA, ALiBi, ragged lengths (1, a page
multiple, a ragged last page), permuted page tables with unused entries on
page 0, query groups up to 32, s_q in {1, 3, 5, 8}. f32 holds to 1e-5
(summation order only), bf16 to 2e-2 (half an ulp of values of magnitude
~1, rounded at other places).
"""

import ast
import inspect
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from merlin_tpu.models.layers import alibi_slopes as j_alibi_slopes
from merlin_tpu.ops import paged_attention as jpa

from merlin_tpu_torch.ops import _build
from merlin_tpu_torch.ops import paged_attention as pa

F32_TOL = 1e-5
BF16_TOL = 2e-2


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _inputs(seed, lengths, h, hkv, d, s_q=0, page=8, pps=4):
    """q, a pool of b * pps + 1 pages, tables: each sequence's pages are a
    random permutation of pages 1.. (page 0 holds the unused entries)."""
    rng = np.random.default_rng(seed)
    b = len(lengths)
    total = b * pps + 1
    kp = rng.normal(size=(total, page, hkv * d)).astype(np.float32)
    vp = rng.normal(size=(total, page, hkv * d)).astype(np.float32)
    perm = (rng.permutation(total - 1) + 1).reshape(b, pps)
    tables = np.zeros((b, pps), np.int32)
    for i, n in enumerate(lengths):
        used = -(-n // page)
        tables[i, :used] = perm[i, :used]
    qshape = (b, s_q, h, d) if s_q else (b, h, d)
    q = rng.normal(size=qshape).astype(np.float32)
    return q, kp, vp, np.asarray(lengths, np.int32), tables


def _t(x, dtype=None):
    t = torch.from_numpy(np.array(x, copy=True))
    return t.to(dtype) if dtype is not None else t


def _j(x, dtype=None):
    return jnp.asarray(x, dtype) if dtype is not None else jnp.asarray(x)


DECODE_CASES = {
    # name: (lengths, h, hkv, alibi)
    "mha": ([1, 8, 29, 17], 4, 4, False),
    "gqa": ([5, 32, 16], 8, 2, False),
    "mha_alibi": ([1, 8, 29, 17], 4, 4, True),
    "gqa_alibi": ([5, 32, 16], 8, 2, True),
    # query groups above 8: 32 query heads over 2 kv heads and over 1
    "g16": ([3, 32, 17], 32, 2, False),
    "g32_alibi": ([9, 1, 30], 32, 1, True),
}


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decode_plain_matches_jax_reference_f32(case):
    lengths, h, hkv, alibi = DECODE_CASES[case]
    q, kp, vp, lens, tables = _inputs(0, lengths, h, hkv, 16)
    slopes = np.asarray(j_alibi_slopes(h)) if alibi else None
    want = np.asarray(jpa.paged_attention_reference(
        _j(q), _j(kp), _j(vp), _j(lens), _j(tables),
        alibi_slopes=None if slopes is None else _j(slopes)))
    args = (_t(q), _t(kp), _t(vp), _t(lens), _t(tables))
    got = pa.paged_attention_plain(
        *args, alibi_slopes=None if slopes is None else _t(slopes))
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=F32_TOL)
    # the wrapper of each route takes the plain path and counts no launch
    wrapper = pa.paged_attention if alibi else pa.paged_attention_dma
    kw = {"alibi_slopes": _t(slopes)} if alibi else {}
    before = wrapper.launches
    np.testing.assert_array_equal(wrapper(*args, **kw).numpy(), got.numpy())
    assert wrapper.launches == before


@pytest.mark.parametrize("case", ["mha_alibi", "gqa_alibi", "gqa", "g16",
                                  "g32_alibi"])
def test_decode_plain_matches_b4_pallas_interpret(case):
    """B4's Pallas kernel (``_paged_kernel``) runs in interpret mode; with
    no slopes its contract is B3's."""
    lengths, h, hkv, alibi = DECODE_CASES[case]
    q, kp, vp, lens, tables = _inputs(1, lengths, h, hkv, 16)
    slopes = np.asarray(j_alibi_slopes(h)) if alibi else None
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jpa.paged_attention(
            _j(q), _j(kp), _j(vp), _j(lens), _j(tables),
            alibi_slopes=None if slopes is None else _j(slopes)))
    got = pa.paged_attention_plain(
        _t(q), _t(kp), _t(vp), _t(lens), _t(tables),
        alibi_slopes=None if slopes is None else _t(slopes))
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=F32_TOL)


def test_decode_plain_matches_jax_reference_bf16():
    q, kp, vp, lens, tables = _inputs(2, [3, 24, 31], 8, 2, 16)
    slopes = np.asarray(j_alibi_slopes(8))
    bf = jnp.bfloat16
    want = np.asarray(jpa.paged_attention_reference(
        _j(q, bf), _j(kp, bf), _j(vp, bf), _j(lens), _j(tables),
        alibi_slopes=_j(slopes)).astype(jnp.float32))
    got = pa.paged_attention_plain(
        _t(q, torch.bfloat16), _t(kp, torch.bfloat16),
        _t(vp, torch.bfloat16), _t(lens), _t(tables),
        alibi_slopes=_t(slopes))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=BF16_TOL,
                               rtol=BF16_TOL)


WINDOW_CASES = {
    # name: (lengths, s_q, h, hkv, alibi); lengths include the window
    "sq1_mha": ([1, 8, 29, 17], 1, 4, 4, False),
    "sq3_gqa": ([3, 16, 30], 3, 8, 2, False),
    "sq3_gqa_alibi": ([3, 16, 30], 3, 8, 2, True),
    "sq8_mha_alibi": ([8, 16, 27, 9], 8, 4, 4, True),
    "sq8_gqa": ([8, 24, 32], 8, 8, 2, False),
    # 15 query rows per kv head (group 3 x 5), the few-rows kernel's tile
    "sq5_g3_alibi": ([5, 20, 31], 5, 6, 2, True),
}


@pytest.mark.parametrize("case", sorted(WINDOW_CASES))
def test_window_plain_matches_jax_reference_f32(case):
    lengths, s_q, h, hkv, alibi = WINDOW_CASES[case]
    q, kp, vp, lens, tables = _inputs(3, lengths, h, hkv, 16, s_q=s_q)
    slopes = np.asarray(j_alibi_slopes(h)) if alibi else None
    want = np.asarray(jpa.paged_attention_multi_reference(
        _j(q), _j(kp), _j(vp), _j(lens), _j(tables),
        alibi_slopes=None if slopes is None else _j(slopes)))
    args = (_t(q), _t(kp), _t(vp), _t(lens), _t(tables))
    sl = None if slopes is None else _t(slopes)
    got = pa.paged_attention_multi_plain(*args, alibi_slopes=sl)
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=F32_TOL)
    for wrapper in (pa.paged_attention_dma_multi,
                    pa.paged_attention_multi_blocked,
                    pa.paged_window_attention):
        np.testing.assert_array_equal(
            wrapper(*args, alibi_slopes=sl).numpy(), got.numpy())
    assert pa.paged_attention_dma_multi.launches == 0
    assert pa.paged_attention_multi_blocked.launches == 0


# B6/B8's cases in interpret mode: name: (lengths, s_q, h, hkv, alibi, page,
# pages per sequence); group * s_q a multiple of 8 sublanes, as JAX asserts
B6_CASES = {
    "sq8_mha_alibi": ([8, 16, 27, 9], 8, 4, 4, True, 8, 4),
    "sq8_gqa": ([8, 24, 32], 8, 8, 2, False, 8, 4),
    # the engine's form: one sequence, a window after a history
    "engine_sq24": ([61], 24, 2, 2, False, 8, 8),
    "engine_sq24_alibi": ([61], 24, 4, 4, True, 8, 8),
    # a window spanning pages of 16 and of 64 keys
    "page16_sq24": ([50, 70], 24, 2, 2, True, 16, 8),
    "page64_sq40": ([100, 41], 40, 4, 2, False, 64, 4),
    # 144 rows per kv head (group 2 x s_q 72): more than one 128-row tile
    "rows144_g2": ([80, 126], 72, 4, 2, True, 16, 8),
    # rows that see no key (length 12 < s_q 16: rows t < 4); the sequence
    # fills its table, so JAX's average over the pages it visits is the
    # plain version's over the table
    "no_key_rows": ([12, 16], 16, 4, 2, False, 8, 2),
}


@pytest.mark.parametrize("case", sorted(B6_CASES))
def test_window_plain_matches_b6_pallas_interpret(case):
    """B6's Pallas kernel in interpret mode (it needs group * s_q to be a
    multiple of 8 sublanes), at the engine's one-sequence windows, pages of
    8, 16 and 64 keys, more than 128 rows per kv head and rows that see no
    key."""
    lengths, s_q, h, hkv, alibi, page, pps = B6_CASES[case]
    q, kp, vp, lens, tables = _inputs(4, lengths, h, hkv, 16, s_q=s_q,
                                      page=page, pps=pps)
    slopes = np.asarray(j_alibi_slopes(h)) if alibi else None
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jpa.paged_attention_multi_blocked(
            _j(q), _j(kp), _j(vp), _j(lens), _j(tables),
            alibi_slopes=None if slopes is None else _j(slopes)))
    got = pa.paged_attention_multi_plain(
        _t(q), _t(kp), _t(vp), _t(lens), _t(tables),
        alibi_slopes=None if slopes is None else _t(slopes))
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=F32_TOL)


def test_window_plain_matches_jax_reference_bf16():
    q, kp, vp, lens, tables = _inputs(5, [5, 20, 32], 8, 2, 16, s_q=5)
    bf = jnp.bfloat16
    want = np.asarray(jpa.paged_attention_multi_reference(
        _j(q, bf), _j(kp, bf), _j(vp, bf), _j(lens), _j(tables)
    ).astype(jnp.float32))
    got = pa.paged_attention_multi_plain(
        _t(q, torch.bfloat16), _t(kp, torch.bfloat16),
        _t(vp, torch.bfloat16), _t(lens), _t(tables))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=BF16_TOL,
                               rtol=BF16_TOL)


@pytest.mark.parametrize("group,s_q,route", [
    (1, 5, "paged_attention_dma_multi"), (4, 4, "paged_attention_dma_multi"),
    (3, 5, "paged_attention_dma_multi"),
    (1, 17, "paged_attention_multi_blocked"),
    (4, 128, "paged_attention_multi_blocked")])
def test_window_route_by_rows_per_kv_head(monkeypatch, group, s_q, route):
    """Verify windows (<= 16 query rows per kv head) go to B5, prefill
    windows to B6."""
    called = []
    for name in ("paged_attention_dma_multi",
                 "paged_attention_multi_blocked"):
        monkeypatch.setattr(pa, name, lambda *a, _n=name, **k: called.append(
            _n))
    q = torch.zeros((1, s_q, 2 * group, 8))
    pages = torch.zeros((1, 8, 16))
    pa.paged_window_attention(q, pages, pages, None, None)
    assert called == [route]


def test_write_token_to_pages_matches_jax():
    rng = np.random.default_rng(6)
    hkv, d, page, pps = 2, 8, 4, 3
    kp = rng.normal(size=(7, page, hkv * d)).astype(np.float32)
    vp = rng.normal(size=(7, page, hkv * d)).astype(np.float32)
    tables = np.asarray([[3, 1, 0], [5, 6, 2]], np.int32)
    k_new = rng.normal(size=(2, hkv, d)).astype(np.float32)
    v_new = rng.normal(size=(2, hkv, d)).astype(np.float32)
    pos = np.asarray([6, 9], np.int32)
    jk, jv = jpa.write_token_to_pages(
        _j(kp), _j(vp), _j(k_new), _j(v_new), positions=_j(pos),
        page_tables=_j(tables))
    tk, tv = _t(kp.copy()), _t(vp.copy())
    out = pa.write_token_to_pages(tk, tv, _t(k_new), _t(v_new),
                                  positions=_t(pos), page_tables=_t(tables))
    assert out[0] is tk and out[1] is tv       # in place
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_write_tokens_to_pages_matches_jax():
    """A window crossing a page boundary, through permuted tables."""
    rng = np.random.default_rng(7)
    hkv, d, page, s_q = 2, 8, 4, 5
    kp = rng.normal(size=(9, page, hkv * d)).astype(np.float32)
    vp = rng.normal(size=(9, page, hkv * d)).astype(np.float32)
    tables = np.asarray([[4, 7, 2, 0], [1, 8, 3, 6]], np.int32)
    k_new = rng.normal(size=(2, s_q, hkv, d)).astype(np.float32)
    v_new = rng.normal(size=(2, s_q, hkv, d)).astype(np.float32)
    start = np.asarray([2, 9], np.int32)
    jk, jv = jpa.write_tokens_to_pages(
        _j(kp), _j(vp), _j(k_new), _j(v_new), start_positions=_j(start),
        page_tables=_j(tables))
    tk, tv = _t(kp.copy()), _t(vp.copy())
    pa.write_tokens_to_pages(tk, tv, _t(k_new), _t(v_new),
                             start_positions=_t(start),
                             page_tables=_t(tables))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


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
def test_write_past_table_is_dropped_like_jax(case):
    """C9: a write whose logical page lies past its table row changes no
    page, as JAX's scatter drops it, while the call's other rows land; a
    dropped window token does not overwrite the live token of the same
    call whose slot it would clamp to."""
    rng = np.random.default_rng(8)
    hkv, d, page = 2, 8, 4
    kp = rng.normal(size=(7, page, hkv * d)).astype(np.float32)
    vp = rng.normal(size=(7, page, hkv * d)).astype(np.float32)
    tables = np.asarray([[3, 1, 4], [5, 6, 2]], np.int32)
    window = case.startswith("window")
    shape = (2, 5, hkv, d) if window else (2, hkv, d)
    k_new = rng.normal(size=shape).astype(np.float32)
    v_new = rng.normal(size=shape).astype(np.float32)
    pos = PAST_TABLE[case]
    key = "start_positions" if window else "positions"
    jfn = jpa.write_tokens_to_pages if window else jpa.write_token_to_pages
    pfn = pa.write_tokens_to_pages if window else pa.write_token_to_pages
    want = jfn(_j(kp), _j(vp), _j(k_new), _j(v_new), page_tables=_j(tables),
               **{key: _j(pos)})
    arrays = [_t(kp), _t(vp)]
    pfn(*arrays, _t(k_new), _t(v_new), page_tables=_t(tables),
        **{key: _t(pos)})
    for got, w, before in zip(arrays, want, (kp, vp)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(w))
        assert np.array_equal(got.numpy(), before) == case.endswith(
            "all_past")


def _bad_shape():
    """``bad_shape`` of ``csrc/paged_attention.cu``, the C entry points'
    shape guard, read from the source and evaluated in Python."""
    src = (_build.CSRC / "paged_attention.cu").read_text()
    m = re.search(r"bool bad_shape\(([^)]*)\) \{\s*return (.*?);\s*\}", src,
                  re.S)
    params = [p_.split()[-1] for p_ in m.group(1).split(",")]
    expr = " ".join(m.group(2).replace("||", " or ").replace("&&", " and ")
                    .replace("/", "//").split())
    return lambda *args: eval(expr, {}, dict(zip(params, args)))


def _group_limits(fn):
    """Comparisons of a query group (``h // hkv`` or ``group``) with a
    number in the source of ``fn``: a refusal of groups above a size."""
    found = []
    for node in ast.walk(ast.parse(inspect.getsource(fn))):
        if not isinstance(node, ast.Compare):
            continue
        sides = [node.left, *node.comparators]
        grouped = any(
            (isinstance(n, ast.BinOp) and isinstance(n.op, ast.FloorDiv))
            or (isinstance(n, ast.Name) and n.id == "group")
            for side in sides for n in ast.walk(side))
        if grouped and any(isinstance(n, ast.Constant) for n in sides):
            found.append(ast.unparse(node))
    return found


def test_kernels_take_every_query_group_jax_takes():
    """The JAX paged kernels take any grouping with h % hkv == 0 (B4's
    block is (1, 1, group, d)); the port's wrappers and the C guard must
    refuse none of them: no limit on the group in the Python checks, and
    ``bad_shape`` false for groups 1..64 at the widths the kernels take."""
    for fn in (pa._check_paged, pa._launch_decode, pa._launch_window,
               pa._split_workspace):
        assert _group_limits(fn) == [], fn.__name__
    bad_shape = _bad_shape()
    for group in (1, 3, 8, 16, 32, 64):
        for hkv in (1, 2, 40):
            for d, s_lanes in ((64, 0), (128, 0), (128, 128), (80, 128)):
                assert not bad_shape(group * hkv, hkv, d, s_lanes), (
                    group, hkv, d, s_lanes)
    # the guard still refuses what the kernels cannot take
    assert bad_shape(5, 2, 128, 0) and bad_shape(8, 2, 136, 0)
    assert bad_shape(8, 2, 60, 0) and bad_shape(256, 256, 64, 128)


def _cu_constants():
    """The integer constants of ``csrc/paged_attention.cu``."""
    src = (_build.CSRC / "paged_attention.cu").read_text()
    return {m.group(1): int(m.group(2)) for m in re.finditer(
        r"constexpr int (\w+) = (\d+);", src)}


def _bad_window():
    """``bad_window`` of ``csrc/paged_attention.cu``, the window kernel's
    launch guard, read from the source and evaluated in Python (a null
    pointer is None)."""
    src = (_build.CSRC / "paged_attention.cu").read_text()
    m = re.search(r"bool bad_window\(([^)]*)\) \{\s*return (.*?);\s*\}",
                  src, re.S)
    params = [p_.split()[-1] for p_ in m.group(1).split(",")]
    expr = " ".join(m.group(2).replace("||", " or ").replace("&&", " and ")
                    .replace("nullptr", "None").split())
    consts = _cu_constants()
    return lambda *args: eval(expr, {}, {**consts,
                                         **dict(zip(params, args))})


def _window_tiles(dp):
    """WindowTiles<dp> of ``csrc/paged_attention.cu`` (warpgroups, keys,
    threads and rows of a CTA), its C ternaries evaluated in Python."""
    src = (_build.CSRC / "paged_attention.cu").read_text()
    body = re.search(r"struct WindowTiles \{(.*?)\};", src, re.S).group(1)
    names = {"DP": dp}
    for name, expr in re.findall(r"static constexpr int (\w+) = (.*?);",
                                 body):
        expr = re.sub(r"(.+?) \? (.+?) : (.+)", r"(\2) if (\1) else (\3)",
                      expr).replace("W::", "")
        names[name] = eval(expr, {}, names)
    return names


def test_window_kernel_takes_every_shape_jax_takes():
    """JAX's B6/B8 take any page size and any group with group * s_q a
    multiple of 8; the port's window wrapper and the C guards (bad_shape,
    bad_window) must refuse none of them at the head dims the kernels take
    (multiples of 8 up to 128), with the grid and workspace the wrapper
    plans; and the wrapper's most splits is the kernel's."""
    for fn in (pa._launch_window, pa._window_workspace, pa.window_plan,
               pa.window_workspace_floats):
        assert _group_limits(fn) == [], fn.__name__
    assert pa.WINDOW_MAX_SPLITS == _cu_constants()["kWindowMaxSplits"]
    bad_shape, bad_window = _bad_shape(), _bad_window()
    for group, s_q in ((1, 128), (2, 72), (3, 8), (8, 16), (32, 8),
                       (64, 1)):
        for hkv in (1, 2, 40):
            for d in range(8, 129, 8):
                for page in (1, 8, 16, 32, 64, 128, 256, 1024):
                    pps = max(1, 2048 // page)
                    for s_lanes in (0, 128):
                        assert not bad_shape(group * hkv, hkv, d, s_lanes)
                    splits, ws, counters = pa.window_plan(
                        1, group * s_q, hkv, d, page, pps, 132)
                    live = object() if splits > 1 else None
                    assert not bad_window(pps, splits, live, live), (
                        group, s_q, hkv, d, page)
    # the guard still refuses what the kernel cannot take
    assert bad_window(8, 0, None, None) and bad_window(8, 2, None, None)
    assert bad_window(8, pa.WINDOW_MAX_SPLITS + 1, 1, 1)


@pytest.mark.parametrize("b,rows,hkv,d,page,pps", [
    (1, 128, 32, 128, 128, 16), (4, 128, 32, 128, 128, 16),
    (1, 128, 40, 128, 16, 128), (2, 144, 2, 64, 16, 8), (3, 72, 4, 80, 8, 4),
    (1, 24, 2, 16, 8, 8), (1, 16, 2, 64, 256, 2), (8, 256, 1, 128, 32, 4)])
def test_window_workspace_covers_every_split_and_counter(b, rows, hkv, d,
                                                         page, pps):
    """The window kernel's workspace holds, for every (sequence, kv head,
    row tile, split) of the planned grid, each thread's O accumulators and
    (m, l) where the kernel writes them (fragment order, float4s NT
    apart); one split takes no workspace; and the shared counters cover
    the window kernel's (sequence, kv head, row tile)s and the few-rows
    kernel's 16-row tiles at the same shape."""
    for sms in (1, 16, 132):
        splits, ws, counters = pa.window_plan(b, rows, hkv, d, page, pps,
                                              sms)
        assert 1 <= splits <= pa.WINDOW_MAX_SPLITS
        if splits == 1:
            assert ws == 0 and counters == 0
            continue
        t = _window_tiles(64 if d <= 64 else 128)
        dp, nt, n_rt = t["DP"], t["kThreads"], -(-rows // t["kRows"])
        blobs = b * hkv * n_rt * splits
        o_float4s = blobs * (dp // 8) * nt
        # the last blob's last thread: its last O float4 and its (m, l)
        assert (blobs - 1) * (dp // 8) * nt + (dp // 8 - 1) * nt + nt <= (
            o_float4s)
        assert 4 * (o_float4s + (blobs - 1) * nt + nt) == ws
        assert b * hkv * n_rt <= counters
        assert b * hkv * -(-rows // 16) <= counters
    # at the engine's prefill window the card holds one wave of CTAs
    assert pa.window_plan(1, 128, 32, 128, 128, 16, 132)[0] == 5


def _pool_trace(pool_cls):
    """The same operations on a pool; returns what each step observed."""
    pool = pool_cls(total_pages=6, page_size=4, pages_per_seq=4)
    seen = [list(pool.allocate("trash", 1))]
    seen.append(list(pool.allocate("a", 6)))            # 2 pages
    seen.append(list(pool.extend("a", 3)))              # 9 tokens: 3 pages
    seen.append(list(pool.allocate("b", 4)))
    try:                                                # needs 3, 1 free
        pool.allocate("c", 12)
    except MemoryError as e:
        seen.append(("MemoryError", str(e), pool.free_pages,
                     "c" in pool.tables))
    try:
        pool.allocate("d", 17)                          # 5 > pages_per_seq
    except ValueError as e:
        seen.append(("ValueError", str(e)))
    try:                                                # b grows atomically
        pool.allocate("b", 16)
    except MemoryError:
        seen.append(("b after failed growth", list(pool.tables["b"]),
                     pool.free_pages))
    pool.release("a")
    seen.append(pool.free_pages)
    seen.append(list(pool.allocate("e", 13)))           # reuses a's pages
    seen.append(pool.table_array(["e", "b", "gone"]).tolist())
    return seen


def test_page_pool_matches_jax():
    """Free-list order (the first page handed out is physical page 0),
    atomic failure, the pages_per_seq refusal, release and reuse."""
    got, want = _pool_trace(pa.PagePool), _pool_trace(jpa.PagePool)
    assert got == want
    assert got[0] == [0]
