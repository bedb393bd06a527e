"""The f32 paged kernels' key splits, in plain PyTorch, against the single
walk of the TPU kernels and against the JAX package on the CPU.

The f32 few-rows and window kernels (``csrc/paged_attention_f32.cu``) split
each sequence's keys over CTAs: a split starts from m = NEG_INF, walks its
64-key blocks from its own first key and rounds p (C48) or p * v_scale
(C49) against its own running max; the splits merge by the LSE rescale in
split order. ``_kernel_rule``'s ``split_keys`` computes that, and
``chip_smoke.py`` holds the kernels against it at the split the wrapper
used. Here:

  * a split that holds every key is the single walk, bit for bit;
  * at f32 pages (p not rounded) a split walk stays within 1e-6 of the
    single walk (the merge's f32 rescale), and with bf16 p or B7's bf16
    p * v_scale within ``OUT_RTOL`` a row (the rounding against another
    max, ~1e-3);
  * splits that end mid-page and mid-block, lengths 0, 1 and the full
    table, a one-split sequence and pages of 16 against an independent
    numpy walk of the same rule;
  * the plain versions with ``split_keys`` covering the keys against B4,
    B6, B8 and B9 in TPU interpret mode, B7's JAX composition (C49) and
    JAX's references where the kernel rule keeps p in f32 (B3, B5: C8
    keeps their Pallas kernels off the CPU);
  * the f32 route takes the bf16 route's few-rows decision and its
    few-rows key splits, and the window plan sized for its own tiles;
  * the TF32 passes by which ``chip_smoke.py`` bounds the kernels, against
    the bits of the operands the rule multiplies.

Tolerances: f32 operands 1e-5 of max |want| (summation order only), a
rounded p 1e-4 (a bf16 rounding may flip at a few elements between two
f32 orders), bf16 out one bf16 ulp; split against single walk as above.
"""

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
SPLIT_F32_TOL = 1e-6
ROUNDED_TOL = 1e-4
BF16_ULP = 2.0 ** -7
OUT_RTOL = 2.0 ** -5   # chip_smoke.py's per-row tolerance of a bf16 rule


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


def _row_err(got, want):
    """chip_smoke.py's bf16 measure: each row's max |error| over d, of the
    row's max |want|, the largest over rows."""
    got, want = (np.asarray(x, np.float64) for x in (got, want))
    den = np.maximum(np.abs(want).max(-1), 1e-30)
    return float((np.abs(got - want).max(-1) / den).max())


def _rule_inputs(seed, b=2, s_q=3, h=4, hkv=2, d=16, keys=200):
    """q, k, v and k/v scales as ``_kernel_rule`` takes them, with rows
    at the last s_q positions of each sequence (lengths keys and 131)."""
    rng = np.random.default_rng(seed)
    q = _t(rng.normal(size=(b, s_q, h, d)).astype(np.float32))
    k = _t(rng.normal(size=(b, keys, hkv, d)).astype(np.float32))
    v = _t(rng.normal(size=(b, keys, hkv, d)).astype(np.float32))
    ks = _t(rng.uniform(0.005, 0.03, size=(b, keys, hkv)).astype(np.float32))
    vs = _t(rng.uniform(0.005, 0.03, size=(b, keys, hkv)).astype(np.float32))
    lengths = torch.tensor([keys, 131][:b])
    q_pos = pa._window_pos(lengths, s_q, "cpu")
    return q, k, v, ks, vs, q_pos


# the three rules a split changes: p kept f32 (f32 pages, B8/B9 at f32 q),
# p rounded to bf16 (bf16 pages, C48), p * v_scale rounded to bf16 (B7, C49)
RULES = ("f32_p", "bf16_p", "b7")


def _rule(rule, q, k, v, ks, vs, q_pos, split_keys=None, alibi=None):
    kw = dict(split_keys=split_keys)
    if rule == "b7":
        kw.update(k_scale=ks, v_scale=vs)
    p_dtype = torch.bfloat16 if rule == "bf16_p" else None
    return pa._kernel_rule(q, k, v, q_pos, alibi, 0.25, p_dtype, 64, **kw)


@pytest.mark.parametrize("rule", RULES)
@pytest.mark.parametrize("split", [200, 201, 4096])
def test_split_holding_every_key_is_the_single_walk(rule, split):
    q, k, v, ks, vs, q_pos = _rule_inputs(40)
    want = _rule(rule, q, k, v, ks, vs, q_pos)
    for split_keys in (split, [split, split]):
        got = _rule(rule, q, k, v, ks, vs, q_pos, split_keys)
        assert torch.equal(got, want)


@pytest.mark.parametrize("split", [64, 128, 40, 17])
def test_split_walk_at_f32_p_is_the_single_walk_to_f32(split):
    """p not rounded: splits change only the f32 order of the sums."""
    q, k, v, ks, vs, q_pos = _rule_inputs(41)
    slopes = torch.tensor(np.asarray(j_alibi_slopes(4)))
    for alibi in (None, slopes):
        want = _rule("f32_p", q, k, v, ks, vs, q_pos, alibi=alibi).numpy()
        got = _rule("f32_p", q, k, v, ks, vs, q_pos, split, alibi).numpy()
        _close(got, want, SPLIT_F32_TOL)


@pytest.mark.parametrize("rule", ["bf16_p", "b7"])
@pytest.mark.parametrize("split", [64, 128, 40])
def test_split_walk_with_rounded_p_stays_within_a_row_tolerance(rule, split):
    """p (or B7's p * v_scale) rounded against each split's own max: within
    OUT_RTOL a row of the single walk, and not equal to it (the split is
    not a no-op)."""
    q, k, v, ks, vs, q_pos = _rule_inputs(42)
    want = _rule(rule, q, k, v, ks, vs, q_pos).numpy()
    got = _rule(rule, q, k, v, ks, vs, q_pos, split).numpy()
    assert _row_err(got, want) <= OUT_RTOL
    assert not np.array_equal(got, want)


def _bf16(x):
    """x (f32) rounded to the nearest bf16, ties to even, as float64."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32).astype(np.float64)


def _np_split_walk(q, k, v, lengths, s_q, scale, split, block, round_p):
    """The split rule written out in numpy (float64, p rounded in bf16 where
    asked): q (b, s_q, h, d), k/v (b, keys, hkv, d). Each split of
    ``split`` keys from key 0 walks its ``block``-key blocks from its own
    first key with its own running max; splits merge by the LSE rescale."""
    b, _, h, d = q.shape
    n_keys, hkv = k.shape[1], k.shape[2]
    group = h // hkv
    out = np.zeros(q.shape)
    for bi in range(b):
        for t in range(s_q):
            pos = lengths[bi] - s_q + t
            for hh in range(h):
                qv = q[bi, t, hh].astype(np.float64)
                kh, vh = k[bi, :, hh // group], v[bi, :, hh // group]
                parts = []
                for s0 in range(0, n_keys, split):
                    s1 = min(s0 + split, n_keys)
                    m, l, acc = pa.NEG_INF, 0.0, np.zeros(d)
                    for k0 in range(s0, s1, block):
                        keys = np.arange(k0, min(k0 + block, s1))
                        seen = keys <= pos
                        sc = np.where(seen, kh[keys] @ qv * scale, pa.NEG_INF)
                        m_new = max(m, sc.max())
                        p = np.where(seen, np.exp(sc - m_new), 0.0)
                        alpha = np.exp(m - m_new)
                        l = alpha * l + p.sum()
                        pr = _bf16(p) if round_p else p
                        acc = alpha * acc + pr @ vh[keys]
                        m = m_new
                    parts.append((m, l, acc))
                top = max(m for m, _, _ in parts)
                lt = sum(l * np.exp(m - top) for m, l, _ in parts)
                at = sum(a * np.exp(m - top) for m, _, a in parts)
                out[bi, t, hh] = at / lt if lt > 0 else 0.0
    return out


SPLIT_EDGES = {
    # name: (lengths, s_q, page, pps, split_keys, block)
    "mid_page_mid_block": ([0, 1, 64, 30], 1, 16, 4, 24, 16),
    "mid_block_window": ([5, 64, 47], 4, 16, 4, 40, 16),
    "one_split_seq": ([10, 64], 2, 16, 4, 48, 16),
    "page8_split_not_a_block": ([1, 32, 19], 1, 8, 4, 12, 8),
}


@pytest.mark.parametrize("pages", ["f32", "bf16"])
@pytest.mark.parametrize("case", sorted(SPLIT_EDGES))
def test_plain_split_walk_matches_numpy_at_the_edges(case, pages):
    """The window plain version with ``split_keys`` against the numpy walk:
    splits ending mid-page and mid-block, lengths 0 (C2: zeros), 1 and the
    full table, a sequence whose keys fit one split, pages of 16 and 8;
    f32 pages keep p in f32, bf16 pages round it (C48)."""
    lengths, s_q, page, pps, split, block = SPLIT_EDGES[case]
    q, kp, vp, lens, tables = _inputs(43, lengths, 4, 2, 16, s_q=s_q,
                                      page=page, pps=pps)
    dt = torch.bfloat16 if pages == "bf16" else torch.float32
    got = pa.paged_attention_multi_plain(
        _t(q), _t(kp, dt), _t(vp, dt), _t(lens), _t(tables),
        kernel_rounding=True, block_keys=block, split_keys=split).numpy()
    k_seq = pa._gather_seq(_t(kp, dt).float(), _t(tables), 2, 16).numpy()
    v_seq = pa._gather_seq(_t(vp, dt).float(), _t(tables), 2, 16).numpy()
    want = _np_split_walk(q, k_seq, v_seq, lengths, s_q, 0.25, split, block,
                          pages == "bf16")
    _close(got, want, ROUNDED_TOL if pages == "bf16" else F32_TOL)
    # a row that sees no key reads 0 (length 0, or a window row below it)
    pos = np.asarray(lengths)[:, None] - s_q + np.arange(s_q)[None]
    assert np.all(got[pos < 0] == 0)


DT = {"bf16": (torch.bfloat16, jnp.bfloat16), "f32": (torch.float32,
                                                        jnp.float32)}
PAIRS = [("bf16", "f32"), ("f32", "bf16"), ("f32", "f32")]
BIG = 1 << 20   # a split that holds every key


def _tol(q_name, p_name):
    if q_name == "bf16":
        return BF16_ULP
    return F32_TOL if p_name == "f32" else ROUNDED_TOL


@pytest.mark.parametrize("pair", PAIRS, ids=["-".join(p) for p in PAIRS])
@pytest.mark.parametrize("alibi", [False, True])
def test_split_aware_decode_matches_pallas_b4(pair, alibi):
    """The decode plain version with a split holding every key against B4
    in interpret mode at the (q, page) pair; at f32 pages also against
    JAX's reference (the rule keeps p in f32 there: B3's kernel, C8)."""
    (tq, jq), (tp, jp) = DT[pair[0]], DT[pair[1]]
    q, kp, vp, lens, tables = _inputs(44, [1, 33, 64, 17], 8, 2, 16,
                                      page=16, pps=4)
    slopes = np.asarray(j_alibi_slopes(8)) if alibi else None
    jargs = (_j(q, jq), _j(kp, jp), _j(vp, jp), _j(lens), _j(tables))
    jsl = None if slopes is None else _j(slopes)
    with pltpu.force_tpu_interpret_mode():
        want = jpa.paged_attention(*jargs, alibi_slopes=jsl)
    targs = (_t(q, tq), _t(kp, tp), _t(vp, tp), _t(lens), _t(tables))
    tsl = None if slopes is None else _t(slopes)
    got = pa.paged_attention_plain(*targs, alibi_slopes=tsl,
                                   kernel_rounding=True, split_keys=BIG)
    assert got.dtype == tq
    _close(got.float().numpy(), _np(want), _tol(*pair))
    if pair[1] == "f32":
        ref = jpa.paged_attention_reference(*jargs, alibi_slopes=jsl)
        _close(got.float().numpy(), _np(ref), _tol(*pair))


@pytest.mark.parametrize("pair", PAIRS, ids=["-".join(p) for p in PAIRS])
@pytest.mark.parametrize("s_q", [4, 16])
def test_split_aware_window_matches_pallas_b6(pair, s_q):
    """The window plain version with a split holding every key against B6
    in interpret mode; at f32 pages also against JAX's multi reference
    (B5's kernel, C8)."""
    (tq, jq), (tp, jp) = DT[pair[0]], DT[pair[1]]
    q, kp, vp, lens, tables = _inputs(45, [s_q + 3, 64, 30], 8, 2, 16,
                                      s_q=s_q, page=16, pps=4)
    jargs = (_j(q, jq), _j(kp, jp), _j(vp, jp), _j(lens), _j(tables))
    with pltpu.force_tpu_interpret_mode():
        want = jpa.paged_attention_multi_blocked(*jargs)
    targs = (_t(q, tq), _t(kp, tp), _t(vp, tp), _t(lens), _t(tables))
    got = pa.paged_attention_multi_plain(*targs, kernel_rounding=True,
                                         split_keys=[BIG, BIG, BIG])
    _close(got.float().numpy(), _np(want), _tol(*pair))
    if pair[1] == "f32":
        ref = jpa.paged_attention_multi_reference(*jargs)
        _close(got.float().numpy(), _np(ref), _tol(*pair))


def _q8_inputs(seed, lengths, h, hkv, d, s_q=0, page=16, pps=4):
    q, kp, vp, lens, tables = _inputs(seed, lengths, h, hkv, d, s_q, page,
                                      pps)
    kv, ks = (np.asarray(x) for x in jpa.quantize_pages(_j(kp), d))
    vv, vs = (np.asarray(x) for x in jpa.quantize_pages(_j(vp), d))
    return q, kv, ks, vv, vs, lens, tables


@pytest.mark.parametrize("alibi", [False, True])
@pytest.mark.parametrize("kind", ["b9_decode", "b8_window"])
def test_split_aware_q8_rule_matches_pallas(kind, alibi):
    """B9 (decode) and B8 (window) at f32 q in interpret mode (K/V
    dequantized to f32, p kept f32) against the int8 plain versions with a
    split holding every key, and, at a split of 16 keys (every page its own
    split), still within f32 tolerance: p is not rounded."""
    s_q = 0 if kind == "b9_decode" else 8
    q, kv, ks, vv, vs, lens, tables = _q8_inputs(46, [9, 64, 30], 8, 2, 16,
                                                 s_q=s_q)
    slopes = np.asarray(j_alibi_slopes(8)) if alibi else None
    jsl = None if slopes is None else _j(slopes)
    jargs = (_j(q), _j(kv), _j(ks), _j(vv), _j(vs), _j(lens), _j(tables))
    with pltpu.force_tpu_interpret_mode():
        fn = (jpa.paged_attention_quantized if kind == "b9_decode"
              else jpa.paged_attention_multi_blocked_q8)
        want = _np(fn(*jargs, alibi_slopes=jsl))
    targs = (_t(q), _t(kv), _t(ks), _t(vv), _t(vs), _t(lens), _t(tables))
    plain = (pa.paged_attention_q8_plain if kind == "b9_decode"
             else pa.paged_attention_multi_q8_plain)
    for split in (BIG, 16):
        got = plain(*targs, alibi_slopes=None if slopes is None
                    else _t(slopes), kernel_rounding=True, block_keys=16,
                    split_keys=split)
        _close(got.numpy(), want, F32_TOL)


def _j_b7(q, kv, ks, vv, vs, lens, tables):
    """B7's steps composed in JAX over the whole table as one block (as
    ``test_torch_f32_paged.py``): q packed to bf16, the int8 K/V cast to
    bf16, the scores times the k scale and the scale, p * v_scale rounded
    to bf16 for P V."""
    b, s_q, h, d = q.shape
    hkv = kv.shape[2] // d
    group = h // hkv
    n_keys = tables.shape[1] * kv.shape[1]
    stride = max(ks.shape[-1] // hkv, 1)
    k = kv[tables].reshape(b, n_keys, hkv, d).astype(jnp.bfloat16)
    v = vv[tables].reshape(b, n_keys, hkv, d).astype(jnp.bfloat16)
    k_sc = ks[tables].reshape(b, n_keys, -1)[..., 0:hkv * stride:stride]
    v_sc = vs[tables].reshape(b, n_keys, -1)[..., 0:hkv * stride:stride]
    qb = q.astype(jnp.bfloat16).reshape(b, s_q, hkv, group, d)
    s = jnp.einsum("bthgd,bkhd->bhgtk", qb, k,
                   preferred_element_type=jnp.float32)
    s = s * k_sc.transpose(0, 2, 1)[:, :, None, None, :] * d ** -0.5
    k_pos = jnp.arange(n_keys)
    q_pos = lens[:, None] - s_q + jnp.arange(s_q)[None]
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


@pytest.mark.parametrize("s_q", [1, 4])
def test_split_aware_b7_rule_matches_jax_composition(s_q):
    """C49: B7's bf16-operand rule with a split holding every key (one
    block of the whole table, as the composition) matches JAX's steps; at
    the few-rows kernel's split it stays within OUT_RTOL a row."""
    q, kv, ks, vv, vs, lens, tables = _q8_inputs(47, [s_q + 2, 64, 30], 8,
                                                 2, 16, s_q=s_q)
    want = _np(_j_b7(_j(q), _j(kv), _j(ks), _j(vv), _j(vs), _j(lens),
                     _j(tables)))
    targs = (_t(q), _t(kv), _t(ks), _t(vv), _t(vs), _t(lens), _t(tables))
    kw = dict(kernel_rounding=True, bf16_operands=True)
    got = pa.paged_attention_multi_q8_plain(*targs, block_keys=64,
                                            split_keys=BIG, **kw).numpy()
    _close(got, want, ROUNDED_TOL)
    split = pa.paged_attention_multi_q8_plain(*targs, block_keys=16,
                                              split_keys=32, **kw).numpy()
    assert _row_err(split, want) <= OUT_RTOL
    if s_q == 1:
        dec = pa.paged_attention_q8_plain(_t(q)[:, 0], *targs[1:],
                                          block_keys=64, split_keys=BIG, **kw)
        np.testing.assert_array_equal(dec.numpy(), got[:, 0])


class _Lib:
    """A stand-in for the kernel library: records each entry point's name
    and arguments, launches nothing."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


@pytest.fixture
def fake_launch(monkeypatch):
    """The wrappers' launch path on CPU tensors: the checks pass the kv
    heads through, the library records, the card has 132 SMs."""
    lib = _Lib()
    monkeypatch.setattr(pa, "_check_paged",
                        lambda name, q, kp, *a, **k: kp.shape[2] // q.shape[-1])
    monkeypatch.setattr(pa._build, "lib", lambda: lib)
    monkeypatch.setattr(pa._build, "check", lambda code, name: None)
    monkeypatch.setattr(pa._build, "stream_handle", lambda device: 0)
    monkeypatch.setattr(pa, "_counters", lambda device, need: 8)
    monkeypatch.setattr(pa, "_sm_count", lambda device: 132)
    return lib


def _route(lib, q_dtype, page_dtype, s_q, h, hkv, d, page, pps, few_rows,
           window):
    """(entry point, split, few_rows) of one wrapper launch."""
    b = 2
    q = torch.zeros((b, s_q, h, d) if window else (b, h, d), dtype=q_dtype)
    pages = torch.zeros((3, page, hkv * d), dtype=page_dtype)
    q8 = page_dtype == torch.int8
    scales = torch.zeros((3, page, 128)) if q8 else None
    lens = torch.zeros((b,), dtype=torch.int32)
    tables = torch.zeros((b, pps), dtype=torch.int32)
    lib.calls.clear()
    if window:
        pa._launch_window("w", q, pages, pages, lens, tables, None, None,
                          few_rows, scales, scales)
    else:
        pa._launch_decode("d", q, pages, pages, lens, tables, None, None,
                          scales, scales)
    (name, args), = lib.calls
    if name == "merlin_paged_attention_f32":
        return name, args[-4], args[-3]
    if name.startswith("merlin_paged_decode"):
        return name, args[-3], 1
    return name, args[-4], args[-2]


SHAPES = [
    # (s_q, h, hkv, d, page, pps): decode and verify windows, prefill
    # windows, groups 16/32, pages of 16 and 256
    (1, 32, 32, 128, 128, 16), (5, 32, 32, 128, 128, 16),
    (128, 32, 32, 128, 128, 16), (1, 32, 2, 128, 16, 128),
    (3, 24, 8, 80, 256, 8), (128, 40, 40, 128, 16, 128),
]


@pytest.mark.parametrize("page_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("shape", SHAPES, ids=[str(s) for s in SHAPES])
def test_f32_route_takes_the_bf16_routes_decision_and_splits(
        fake_launch, shape, page_dtype):
    """At every shape, the f32 route (f32 q) launches the kernel the bf16
    route (bf16 q) launches for the same wrapper: the few-rows kernel for
    decode and for B5/B7 windows, the window kernel for B6/B8, the few-rows
    one with the same pages a key split (``rows_plan``); its window kernel
    takes ``window_plan``'s f32 splits where the bf16 one takes its
    bf16 ones."""
    s_q, h, hkv, d, page, pps = shape
    pd = {"bf16": torch.bfloat16, "int8": torch.int8}[page_dtype]
    for window, few in ((False, True), (True, True), (True, False)):
        if not window and s_q != 1:
            continue
        bf = _route(fake_launch, torch.bfloat16, pd, s_q, h, hkv, d, page,
                    pps, few, window)
        f32 = _route(fake_launch, torch.float32, pd, s_q, h, hkv, d, page,
                     pps, few, window)
        assert f32[0] == "merlin_paged_attention_f32" and bf[0] != f32[0]
        assert f32[2] == bf[2] == int(few)
        rows = h // hkv * s_q
        if few:
            assert f32[1] == bf[1] == pa.rows_plan(2, rows, hkv, d, page,
                                                   pps)[0]
        else:
            assert bf[1] == pa.window_plan(2, rows, hkv, d, page, pps,
                                           132)[0]
            assert f32[1] == pa.window_plan(2, rows, hkv, d, page, pps,
                                            132, f32=True)[0]
    # the f32 pairs without a bf16 counterpart route the same way
    for qd, pdt in ((torch.bfloat16, torch.float32),
                    (torch.float32, torch.float32)):
        for window, few in ((True, True), (True, False)):
            got = _route(fake_launch, qd, pdt, s_q, h, hkv, d, page, pps,
                         few, window)
            assert got[0] == "merlin_paged_attention_f32"
            assert got[2] == int(few)


def _cu_constants():
    src = (_build.CSRC / "paged_attention_f32.cu").read_text()
    return {m.group(1): int(m.group(2)) for m in re.finditer(
        r"constexpr int (\w+) = (\d+);", src)}


@pytest.mark.parametrize("b,rows,hkv,page,pps", [
    (1, 128, 32, 128, 16), (4, 128, 32, 128, 16), (1, 128, 40, 16, 128),
    (2, 144, 2, 16, 8), (1, 24, 2, 8, 8), (8, 256, 1, 32, 4)])
def test_f32_window_plan_fills_the_card_and_covers_its_splits(b, rows, hkv,
                                                              page, pps):
    """The plan's constants are the kernel's; its splits stay within the
    kernel's limit and the table's key tiles; the workspace holds each
    split's 128 threads' 64 accumulators and (m, l); each sequence's
    split keys are whole tiles and cut its keys into at most that many
    splits; the counters cover the 16-row tiles."""
    c = _cu_constants()
    assert pa.F32_WINDOW_TILES[0] == c["kKeys"] == c["kWindowRows"]
    assert pa.F32_TILE_KEYS == c["kKeys"]
    assert pa.WINDOW_MAX_SPLITS == c["kWindowMaxSplits"]
    assert -(-pps // max(1, pa.SPLIT_KEYS // page)) <= c["kMaxSplits"]
    for sms in (1, 16, 132):
        splits, ws, counters = pa.window_plan(b, rows, hkv, 128, page, pps,
                                              sms, f32=True)
        assert 1 <= splits <= pa.WINDOW_MAX_SPLITS
        assert splits <= -(-pps * page // pa.F32_WINDOW_TILES[0])
        if splits == 1:
            assert ws == counters == 0
            continue
        units = b * hkv * -(-rows // pa.F32_WINDOW_TILES[0])
        assert ws == units * splits * c["kThreads"] * (c["kDP"] // 2 + 4)
        assert counters >= b * hkv * -(-rows // 16)
        lengths = [0, 1, 63, 64, 65, pps * page, pps * page + 9][:b + 3]
        for n, keys in zip(lengths, pa.f32_window_split_keys(
                lengths, splits, page, pps)):
            assert keys % pa.F32_WINDOW_TILES[0] == 0
            assert -(-min(n, pps * page) // keys) <= splits
    # the engine's one-sequence prefill window fills 2 CTAs an SM: 5
    # splits of 128 keys at 640 keys
    assert pa.window_plan(1, 128, 32, 128, 128, 16, 132, f32=True)[0] == 5
    assert pa.f32_window_split_keys([640, 1536, 100], 5, 128, 16) == [
        128, 320, 64]


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _one_tf32_term(x):
    """Whether every value of ``x`` is one exact tf32 operand: its low 13
    mantissa bits, which the tensor core does not read, are 0."""
    bits = x.float().contiguous().view(torch.int32)
    return bool(((bits & 0x1FFF) == 0).all())


# (wrapper, q dtype, page dtype): the f32 paged kernels' five (q, page) modes
PASS_CASES = [("B6", "f32", "bf16"), ("B6", "bf16", "f32"),
              ("B3", "f32", "f32"), ("B8", "f32", "int8"),
              ("B7", "f32", "int8")]


@pytest.mark.parametrize("name,q_dtype,page_dtype", PASS_CASES)
def test_bound_passes_follow_the_operands_bits(name, q_dtype, page_dtype):
    """``chip_smoke.py`` bounds each f32 paged row by the TF32 passes its
    products take, from ``f32_paged_passes``: one a product and one more
    for each operand that one tf32 term cannot hold. Held here against the
    operands the kernel multiplies, as the plain rule makes them: q (B7's
    rounded to bf16), K and V (int8 dequantized to f32 for B8/B9, the bare
    integers for B7), p (rounded to bf16 over bf16 pages, C48; p * v_scale
    rounded to bf16 for B7, C49)."""
    rng = np.random.default_rng(7)
    dt = {"f32": torch.float32, "bf16": torch.bfloat16, "int8": torch.int8}
    b7 = name == "B7"
    q = _t(rng.normal(size=4096).astype(np.float32), dt[q_dtype]).float()
    if b7:
        q = q.to(torch.bfloat16).float()
    if page_dtype == "int8":
        ints = _t(rng.integers(-127, 128, size=4096).astype(np.float32))
        scale = _t(rng.uniform(0.005, 0.03, size=4096).astype(np.float32))
        kv = ints if b7 else ints * scale
    else:
        kv = _t(rng.normal(size=4096).astype(np.float32),
                dt[page_dtype]).float()
    p = torch.exp(-_t(rng.uniform(0, 8, size=4096).astype(np.float32)))
    if b7:
        p = (p * scale).to(torch.bfloat16).float()
    elif page_dtype == "bf16":
        p = p.to(torch.bfloat16).float()
    split = [not _one_tf32_term(x) for x in (q, kv, p)]
    want = (1 + split[0] + split[1], 1 + split[1] + split[2])
    cs = _chip_smoke()
    assert cs.f32_paged_passes(name, dt[q_dtype], dt[page_dtype]) == want
