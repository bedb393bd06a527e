"""The port's paged attention at head dims past 128 (128 < d <= 256),
against the JAX package on the CPU.

The CUDA paged kernels take every d that is a multiple of 8 up to 256, in
two forms each (up to 128, and past it). Here, at d = 136 (zero-padded to
the wide form) and 256:

  * the plain versions against the Pallas kernels in TPU interpret mode:
    B4 (``paged_attention``), B6 (``paged_attention_multi_blocked``), B8
    (``paged_attention_multi_blocked_q8``) and B9
    (``paged_attention_quantized``); and against JAX's references for B3,
    B5 and B7, whose Pallas kernels over-read ``lengths`` in interpret mode
    (trap C8); each wrapper takes its plain version for CPU tensors and
    counts no launch;
  * the f32 kernels' rule (``kernel_rounding``, 64-key blocks) walked in
    the key splits the wrappers plan at d = 256, against the single walk
    and, with a split holding every key, against B4, B6 and B8 in
    interpret mode; the window plan's CTAs and workspace at d > 128 (two
    column halves a row tile) against the kernels' constants;
  * the wrappers' guard and the C guards take d = 136 and 256 and refuse
    264 and 252;
  * the port's ``ServingEngine`` against JAX's with a ``head_dim=256``
    decoder at f32, token for token, with the route counts and the free
    pages, over bf16 and int8 pools, chunked prefill and speculative
    decode.

Inputs come from numpy with a seed. Tolerances: f32 1e-5 of max |want|
(summation order only); bf16 q one bf16 ulp of max |want| (the TPU kernels
round p to bf16 for P V where the plain version keeps it in f32); a
rounded p 1e-4 (a bf16 rounding may flip between two f32 orders); a split
walk against the single walk 1e-6 at f32 p and ``OUT_RTOL`` (2^-5) a row
where p is rounded, as ``chip_smoke.py`` holds the kernels.
"""

import collections
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn
from jax.experimental.pallas import tpu as pltpu

from merlin_tpu.models.decoder import CausalLM as JCausalLM
from merlin_tpu.models.families import tiny as j_tiny
from merlin_tpu.models.layers import alibi_slopes as j_alibi_slopes
from merlin_tpu.ops import paged_attention as jpa
from merlin_tpu.serve.engine import ServingEngine as JServingEngine

from merlin_tpu_torch.models.bridge import params_from_flax
from merlin_tpu_torch.models.decoder import CausalLM
from merlin_tpu_torch.models.families import tiny
from merlin_tpu_torch.ops import _build
from merlin_tpu_torch.ops import paged_attention as pa
from merlin_tpu_torch.serve.engine import ServingEngine

F32_TOL = 1e-5
ROUNDED_TOL = 1e-4
SPLIT_F32_TOL = 1e-6
BF16_ULP = 2.0 ** -7
OUT_RTOL = 2.0 ** -5
BIG = 1 << 20           # a split that holds every key: the single walk
DIMS = (136, 256)


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


def _q8_inputs(seed, lengths, h, hkv, d, s_q=0, page=8, pps=4):
    """``_inputs`` with both pools quantized by JAX's ``quantize_pages``:
    numpy (q, kv, ks, vv, vs, lengths, tables)."""
    q, kp, vp, lens, tables = _inputs(seed, lengths, h, hkv, d, s_q, page,
                                      pps)
    kv, ks = (np.asarray(x) for x in jpa.quantize_pages(_j(kp), d))
    vv, vs = (np.asarray(x) for x in jpa.quantize_pages(_j(vp), d))
    return q, kv, ks, vv, vs, lens, tables


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


def _slopes(h, alibi):
    return np.asarray(j_alibi_slopes(h)) if alibi else None


def _no_launch(wrapper, args, kw, want):
    """A wrapper on CPU tensors returns its plain version's answer and
    counts no launch."""
    before = (wrapper.launches, wrapper.launches_f32)
    np.testing.assert_array_equal(wrapper(*args, **kw).float().numpy(),
                                  want.float().numpy())
    assert (wrapper.launches, wrapper.launches_f32) == before


# decode: name -> (lengths, h, hkv, alibi); groups 1, 2 and 4
DECODE = {"mha": ([1, 8, 29, 17], 2, 2, False),
          "g2_alibi": ([5, 32, 16], 4, 2, True),
          "g4_alibi": ([9, 1, 30], 4, 1, True)}


@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("case", sorted(DECODE))
def test_b4_decode_matches_pallas_interpret(case, d):
    """B4's Pallas kernel in interpret mode; B3 (no slopes) and B4 take
    the plain version on the CPU."""
    lengths, h, hkv, alibi = DECODE[case]
    q, kp, vp, lens, tables = _inputs(60, lengths, h, hkv, d)
    slopes = _slopes(h, alibi)
    jsl = None if slopes is None else _j(slopes)
    with pltpu.force_tpu_interpret_mode():
        want = jpa.paged_attention(_j(q), _j(kp), _j(vp), _j(lens),
                                   _j(tables), alibi_slopes=jsl)
    args = (_t(q), _t(kp), _t(vp), _t(lens), _t(tables))
    sl = None if slopes is None else _t(slopes)
    got = pa.paged_attention_plain(*args, alibi_slopes=sl)
    _close(got.numpy(), _np(want), F32_TOL)
    _no_launch(pa.paged_attention, args, {"alibi_slopes": sl}, got)
    if slopes is None:
        _no_launch(pa.paged_attention_dma, args, {}, got)


@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("case", sorted(DECODE))
def test_b3_decode_matches_jax_reference(case, d):
    """B3 against ``paged_attention_reference`` (C8 keeps its Pallas
    kernel off the CPU), at f32 and at bf16."""
    lengths, h, hkv, alibi = DECODE[case]
    q, kp, vp, lens, tables = _inputs(61, lengths, h, hkv, d)
    slopes = _slopes(h, alibi)
    for tdt, jdt, tol in ((torch.float32, jnp.float32, F32_TOL),
                          (torch.bfloat16, jnp.bfloat16, 2e-2)):
        want = jpa.paged_attention_reference(
            _j(q, jdt), _j(kp, jdt), _j(vp, jdt), _j(lens), _j(tables),
            alibi_slopes=None if slopes is None else _j(slopes))
        got = pa.paged_attention_plain(
            _t(q, tdt), _t(kp, tdt), _t(vp, tdt), _t(lens), _t(tables),
            alibi_slopes=None if slopes is None else _t(slopes))
        assert got.dtype == tdt
        _close(got.float().numpy(), _np(want), tol)


# windows: name -> (lengths, s_q, h, hkv, alibi, page, pps); group * s_q a
# multiple of 8 for B6's Pallas kernel
WINDOW = {"sq8_mha_alibi": ([8, 16, 27], 8, 2, 2, True, 8, 4),
          "engine_sq24": ([61], 24, 2, 2, False, 8, 8),
          "page16_sq24_g2": ([50, 70], 24, 4, 2, True, 16, 8),
          "no_key_rows": ([12, 16], 16, 2, 1, False, 8, 2)}


@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("case", sorted(WINDOW))
def test_b6_window_matches_pallas_interpret(case, d):
    """B6's Pallas kernel in interpret mode; B6, B5 and the router take
    the plain version on the CPU."""
    lengths, s_q, h, hkv, alibi, page, pps = WINDOW[case]
    q, kp, vp, lens, tables = _inputs(62, lengths, h, hkv, d, s_q=s_q,
                                      page=page, pps=pps)
    slopes = _slopes(h, alibi)
    with pltpu.force_tpu_interpret_mode():
        want = jpa.paged_attention_multi_blocked(
            _j(q), _j(kp), _j(vp), _j(lens), _j(tables),
            alibi_slopes=None if slopes is None else _j(slopes))
    args = (_t(q), _t(kp), _t(vp), _t(lens), _t(tables))
    kw = {"alibi_slopes": None if slopes is None else _t(slopes)}
    got = pa.paged_attention_multi_plain(*args, **kw)
    _close(got.numpy(), _np(want), F32_TOL)
    for wrapper in (pa.paged_attention_multi_blocked,
                    pa.paged_attention_dma_multi):
        _no_launch(wrapper, args, kw, got)
    np.testing.assert_array_equal(
        pa.paged_window_attention(*args, **kw).numpy(), got.numpy())


@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("s_q,alibi", [(1, False), (5, True)])
def test_b5_window_matches_jax_reference(s_q, alibi, d):
    """B5 (the few-rows windows) against ``paged_attention_multi_reference``
    (C8), 5 rows with ALiBi and GQA."""
    q, kp, vp, lens, tables = _inputs(63, [s_q, 16, 30], 4, 2, d, s_q=s_q)
    slopes = _slopes(4, alibi)
    want = jpa.paged_attention_multi_reference(
        _j(q), _j(kp), _j(vp), _j(lens), _j(tables),
        alibi_slopes=None if slopes is None else _j(slopes))
    args = (_t(q), _t(kp), _t(vp), _t(lens), _t(tables))
    kw = {"alibi_slopes": None if slopes is None else _t(slopes)}
    got = pa.paged_attention_multi_plain(*args, **kw)
    _close(got.numpy(), _np(want), F32_TOL)
    _no_launch(pa.paged_attention_dma_multi, args, kw, got)


@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("alibi", [False, True])
def test_b9_decode_q8_matches_pallas_interpret(alibi, d):
    """B9 (``_paged_q8_kernel``) in interpret mode at bf16 q: one bf16 ulp
    of the largest |want| (its P V takes p rounded to bf16)."""
    q, kv, ks, vv, vs, lens, tables = _q8_inputs(64, [1, 24, 13], 4, 2, d)
    slopes = _slopes(4, alibi)
    with pltpu.force_tpu_interpret_mode():
        want = jpa.paged_attention_quantized(
            _j(q, jnp.bfloat16), _j(kv), _j(ks), _j(vv), _j(vs), _j(lens),
            _j(tables), alibi_slopes=None if slopes is None else _j(slopes))
    args = (_t(q, torch.bfloat16), _t(kv), _t(ks), _t(vv), _t(vs), _t(lens),
            _t(tables))
    kw = {"alibi_slopes": None if slopes is None else _t(slopes)}
    got = pa.paged_attention_q8_plain(*args, **kw)
    assert got.dtype == torch.bfloat16
    _close(got.float().numpy(), _np(want), BF16_ULP)
    for wrapper in (pa.paged_attention_quantized, pa.paged_attention_dma_q8):
        _no_launch(wrapper, args, kw, got)


@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("case", ["sq8_mha_alibi", "page16_sq24_g2"])
def test_b8_window_q8_matches_pallas_interpret(case, d):
    """B8 (``_paged_multi_blocked_q8_kernel``) in interpret mode at bf16 q,
    one bf16 ulp; B8 takes the plain version on the CPU."""
    lengths, s_q, h, hkv, alibi, page, pps = WINDOW[case]
    q, kv, ks, vv, vs, lens, tables = _q8_inputs(65, lengths, h, hkv, d,
                                                 s_q=s_q, page=page, pps=pps)
    slopes = _slopes(h, alibi)
    with pltpu.force_tpu_interpret_mode():
        want = jpa.paged_attention_multi_blocked_q8(
            _j(q, jnp.bfloat16), _j(kv), _j(ks), _j(vv), _j(vs), _j(lens),
            _j(tables), alibi_slopes=None if slopes is None else _j(slopes))
    args = (_t(q, torch.bfloat16), _t(kv), _t(ks), _t(vv), _t(vs), _t(lens),
            _t(tables))
    kw = {"alibi_slopes": None if slopes is None else _t(slopes)}
    got = pa.paged_attention_multi_q8_plain(*args, **kw)
    _close(got.float().numpy(), _np(want), BF16_ULP)
    _no_launch(pa.paged_attention_multi_blocked_q8, args, kw, got)


@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("s_q", [0, 5])
def test_b7_q8_matches_jax_reference(s_q, d):
    """B7 (decode at s_q = 1 and windows) against the JAX decoder's CPU
    route: ``dequantize_pages`` to bf16, then the references (C8)."""
    q, kv, ks, vv, vs, lens, tables = _q8_inputs(66, [max(s_q, 1), 16, 30],
                                                 4, 2, d, s_q=s_q)
    slopes = _slopes(4, True)
    k16, v16 = (jpa.dequantize_pages(_j(x), _j(s), d)
                for x, s in ((kv, ks), (vv, vs)))
    ref = (jpa.paged_attention_multi_reference if s_q
           else jpa.paged_attention_reference)
    want = ref(_j(q), k16, v16, _j(lens), _j(tables),
               alibi_slopes=_j(slopes))
    args = (_t(q), _t(kv), _t(ks), _t(vv), _t(vs), _t(lens), _t(tables))
    kw = {"alibi_slopes": _t(slopes)}
    wrapper = (pa.paged_attention_dma_multi_q8 if s_q
               else pa.paged_attention_dma_q8)
    plain = (pa.paged_attention_multi_q8_plain if s_q
             else pa.paged_attention_q8_plain)
    got = plain(*args, **kw)
    _close(got.numpy(), _np(want), F32_TOL)
    _no_launch(wrapper, args, kw, got)


# ---------------------------------------------------------------------------
# the f32 kernels' rule at d = 256 and the splits they are planned
# ---------------------------------------------------------------------------

DT = {"bf16": (torch.bfloat16, jnp.bfloat16),
      "f32": (torch.float32, jnp.float32)}
PAIRS = (("f32", "bf16"), ("bf16", "f32"), ("f32", "f32"))


def _tol(q_name, p_name):
    if q_name == "bf16":
        return BF16_ULP
    return F32_TOL if p_name == "f32" else ROUNDED_TOL


@pytest.mark.parametrize("pair", PAIRS, ids=["-".join(p) for p in PAIRS])
@pytest.mark.parametrize("kind", ["decode", "window"])
def test_f32_rule_at_d256_matches_pallas_interpret(pair, kind):
    """The kernel-rule plain versions at d = 256 with a split holding
    every key, on the TPU kernels' blocks (the page), against B4 (decode,
    ALiBi) and B6 (windows) in interpret mode at the f32 route's (q, page)
    pairs."""
    (tq, jq), (tp, jp) = DT[pair[0]], DT[pair[1]]
    s_q = 16 if kind == "window" else 0
    q, kp, vp, lens, tables = _inputs(67, [s_q + 3, 64, 30], 4, 2, 256,
                                      s_q=s_q, page=16, pps=4)
    jargs = (_j(q, jq), _j(kp, jp), _j(vp, jp), _j(lens), _j(tables))
    targs = (_t(q, tq), _t(kp, tp), _t(vp, tp), _t(lens), _t(tables))
    with pltpu.force_tpu_interpret_mode():
        if kind == "decode":
            slopes = _slopes(4, True)
            want = jpa.paged_attention(*jargs, alibi_slopes=_j(slopes))
        else:
            want = jpa.paged_attention_multi_blocked(*jargs)
    if kind == "decode":
        got = pa.paged_attention_plain(*targs, alibi_slopes=_t(slopes),
                                       kernel_rounding=True, split_keys=BIG)
    else:
        got = pa.paged_attention_multi_plain(*targs, kernel_rounding=True,
                                             split_keys=[BIG] * 3)
    _close(got.float().numpy(), _np(want), _tol(*pair))


def test_f32_rule_at_d256_b8_matches_pallas_interpret():
    """B8 at f32 q, d = 256 (K/V dequantized to f32, p kept f32) against
    the int8 kernel-rule plain version, single walk and split in 16."""
    q, kv, ks, vv, vs, lens, tables = _q8_inputs(68, [9, 64, 30], 4, 2, 256,
                                                 s_q=8, page=16)
    with pltpu.force_tpu_interpret_mode():
        want = _np(jpa.paged_attention_multi_blocked_q8(
            _j(q), _j(kv), _j(ks), _j(vv), _j(vs), _j(lens), _j(tables)))
    targs = (_t(q), _t(kv), _t(ks), _t(vv), _t(vs), _t(lens), _t(tables))
    for split in (BIG, 16):
        got = pa.paged_attention_multi_q8_plain(
            *targs, kernel_rounding=True, block_keys=16, split_keys=split)
        _close(got.numpy(), want, F32_TOL)


@pytest.mark.parametrize("page_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kind", ["decode", "window"])
def test_f32_rule_walks_the_d256_plan_splits(kind, page_dtype):
    """At d = 256 the wrappers' splits (the few-rows kernel's pages a
    split, the window plan's per-sequence keys, with two column halves a
    row tile on the card's 132 SMs) cut the keys into more than one split,
    and the split walk stays within the single walk's tolerance: 1e-6 of
    max |want| at f32 pages (p kept f32), ``OUT_RTOL`` a row where p is
    rounded to bf16 (C48)."""
    d, page, pps = 256, 16, 40
    s_q = 128 if kind == "window" else 0
    lengths = [640, 300] if kind == "window" else [600, 257, 1]
    q, kp, vp, lens, tables = _inputs(69, lengths, 2, 2, d, s_q=s_q,
                                      page=page, pps=pps)
    args = (_t(q), _t(kp, page_dtype), _t(vp, page_dtype), _t(lens),
            _t(tables))
    if kind == "window":
        splits = pa.window_plan(len(lengths), s_q, 2, d, page, pps, 132,
                                f32=True)[0]
        split = pa.f32_window_split_keys(lengths, splits, page, pps)
        assert splits > 1 and min(split) < max(lengths)
        plain = pa.paged_attention_multi_plain
    else:
        split = pa.rows_split_keys(page)
        assert split < max(lengths)
        plain = pa.paged_attention_plain
    kw = dict(kernel_rounding=True, block_keys=pa.F32_TILE_KEYS)
    got = plain(*args, split_keys=split, **kw).numpy()
    one = plain(*args, **kw).numpy()
    if page_dtype == torch.float32:
        _close(got, one, SPLIT_F32_TOL)
    else:
        assert _row_err(got, one) <= OUT_RTOL


def _cu_constants(name):
    src = (_build.CSRC / name).read_text()
    return {m.group(1): int(m.group(2)) for m in re.finditer(
        r"constexpr int (\w+) = (\d+);", src)}


@pytest.mark.parametrize("f32", [False, True])
@pytest.mark.parametrize("b,rows,hkv", [(1, 128, 16), (4, 128, 16),
                                        (2, 512, 4), (1, 24, 2)])
def test_window_plan_at_d256_covers_both_column_halves(b, rows, hkv, f32):
    """At d > 128 the window kernels run two CTAs (column halves) for each
    (sequence, kv head, 64-row tile) and split: the plan's workspace holds
    each CTA's 128 threads' 64 accumulators and (m, l), and its counters
    cover every CTA of one split and the few-rows kernels' 16-row tiles."""
    bf16 = _cu_constants("paged_attention.cu")
    f32c = _cu_constants("paged_attention_f32.cu")
    assert f32c["kCols"] == 128 and f32c["kMaxDP"] == 256
    tile, per_sm, threads, acc, halves = pa._window_tiles(256, f32)
    assert (tile, threads, acc, halves) == (64, 128, 64, 2)
    assert tile == (f32c["kWindowRows"] if f32 else 64)
    assert pa._window_tiles(128, f32)[4] == 1
    for sms in (1, 16, 132):
        splits, ws, counters = pa.window_plan(b, rows, hkv, 256, 128, 16,
                                              sms, f32=f32)
        assert 1 <= splits <= bf16["kWindowMaxSplits"]
        if splits == 1:
            assert ws == counters == 0
            continue
        ctas = b * hkv * -(-rows // 64) * 2
        assert ws == ctas * splits * 128 * (64 + 4)
        assert counters >= ctas and counters >= b * hkv * -(-rows // 16)
        # the grid holds about the card's CTA slots (one CTA an SM)
        assert splits <= max(1, -(-sms // ctas))


def _bad_shape():
    """``bad_shape`` of ``csrc/paged_attention.cu`` evaluated in Python."""
    src = (_build.CSRC / "paged_attention.cu").read_text()
    m = re.search(r"bool bad_shape\(([^)]*)\) \{\s*return (.*?);\s*\}", src,
                  re.S)
    params = [p_.split()[-1] for p_ in m.group(1).split(",")]
    expr = " ".join(m.group(2).replace("||", " or ").replace("&&", " and ")
                    .split())
    return lambda *args: eval(expr, {}, dict(zip(params, args)))


@pytest.mark.parametrize("d,ok", [(136, True), (256, True), (248, True),
                                  (264, False), (252, False)])
def test_guards_take_d_up_to_256(d, ok):
    """``_check_paged`` and the C guards take multiples of 8 up to 256 and
    refuse the rest (a CPU tensor then fails only the device check)."""
    q = torch.zeros(2, 4, d)
    pages = torch.zeros(3, 8, 2 * d)
    lens = torch.ones(2, dtype=torch.int32)
    tables = torch.zeros(2, 3, dtype=torch.int32)
    with pytest.raises(ValueError) as err:
        pa._check_paged("t", q, pages, pages, lens, tables, None)
    assert ("head dim" in str(err.value)) == (not ok)
    assert ("CUDA device" in str(err.value)) == ok
    assert bool(_bad_shape()(4, 2, d, 0)) == (not ok)
    assert bool(_bad_shape()(4, 2, d, 128)) == (not ok)
    src = (_build.CSRC / "paged_attention_f32.cu").read_text()
    assert "d % 8 || d > kMaxDP" in src
    assert bool(d % 8 or d > _cu_constants("paged_attention_f32.cu")[
        "kMaxDP"]) == (not ok)


# ---------------------------------------------------------------------------
# the engine with a head_dim=256 decoder, against JAX's
# ---------------------------------------------------------------------------

EOS, PAD = 2, 0
BASE = dict(num_slots=2, max_len=64, eos_id=EOS, pad_id=PAD,
            prompt_bucket=16, page_size=8)
WIDE = dict(num_heads=2, head_dim=256, hidden_size=64, intermediate_size=96)


@pytest.fixture(scope="module")
def wide_models():
    """A tiny decoder with two heads of 256 dims (and its GQA twin, one kv
    head), the same random params in both packages."""
    out = {}
    for name, kw in (("mha", WIDE), ("gqa", dict(WIDE, num_kv_heads=1))):
        jmodel = JCausalLM(j_tiny(**kw))
        params = nn.unbox(jmodel.init(jax.random.key(0),
                                      jnp.ones((1, 4), jnp.int32))["params"])
        rng = np.random.default_rng(2)
        params = jax.tree.map(
            lambda x: np.asarray(x) + 0.05 * rng.normal(size=x.shape).astype(
                np.float32), params)
        tmodel = CausalLM(tiny(**kw)).eval()
        tmodel.load_state_dict(params_from_flax(params), strict=True)
        out[name] = (jmodel, params, tmodel)
    return out


def _serve(engine, prompts, max_new):
    calls = collections.Counter()
    for name in ("_prefill", "_prefill_window", "_preempt_youngest"):
        fn = getattr(engine, name, None)
        if fn is not None:
            setattr(engine, name, lambda *a, _f=fn, _n=name, **k: (
                calls.update([_n]), _f(*a, **k))[1])
    reqs = [engine.submit(p, max_new_tokens=max_new) for p in prompts]
    engine.run_until_idle()
    assert all(r.done and r.error is None for r in reqs)
    return [r.generated for r in reqs], dict(calls), engine.pool.free_pages


PROMPTS = [[5, 17, 33, 41], [7, 9, 11], list(range(3, 16)),
           list(range(40, 60))]
ENGINE_CASES = {
    "whole_prompt": ("mha", dict(chunk_steps=4)),
    "chunked_C8": ("mha", dict(prefill_chunk=8, chunk_steps=2)),
    "spec_k3": ("mha", dict(spec_draft=3, chunk_steps=2)),
    "gqa_chunked_spec": ("gqa", dict(prefill_chunk=8, spec_draft=2,
                                     chunk_steps=2)),
}
POOLS = {"bf16": (jnp.bfloat16, torch.bfloat16),
         "int8": (jnp.int8, torch.int8)}


@pytest.mark.parametrize("pool", sorted(POOLS))
@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_engine_head_dim_256_matches_jax(wide_models, case, pool):
    """The port's ServingEngine and JAX's on a head_dim=256 decoder at
    f32: every request's tokens, the admission routes' counts and the free
    pages equal, over bf16 and int8 pools."""
    which, kw = ENGINE_CASES[case]
    jmodel, params, tmodel = wide_models[which]
    jdt, tdt = POOLS[pool]
    cfg = dict(BASE, **kw)
    want = _serve(JServingEngine(jmodel, params, cache_dtype=jdt, **cfg),
                  PROMPTS, 6)
    got = _serve(ServingEngine(tmodel, cache_dtype=tdt, device="cpu", **cfg),
                 PROMPTS, 6)
    assert got == want
    if "prefill_chunk" in kw:
        assert got[1].get("_prefill_window", 0) > 0
