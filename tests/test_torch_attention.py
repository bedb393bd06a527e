"""The port's attention against the JAX package on the CPU.

  * ``onepass_attention_plain`` (B1's plain version) against the Pallas
    one-pass kernel run in TPU interpret mode;
  * ``flash_attention_plain`` (B2's plain version, out and LSE) against the
    Pallas flash forward kernel in interpret mode: causal, segment ids,
    ALiBi, GQA;
  * ``mha_reference`` against the JAX one, decode offsets included;
  * the fully masked row (trap C2).

Inputs come from numpy with a seed. f32 cases hold to 2e-5 (the two sides
differ in summation order and exp vs exp2 only); bf16 cases to 2e-2 (p and
the output are rounded to bf16, half an ulp of values of magnitude ~1).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from merlin_tpu.ops.attention import mha_reference as j_mha
from merlin_tpu.ops.flash_attention import _flash_fwd_pallas
from merlin_tpu.ops.onepass_attention import onepass_attention as j_onepass

from merlin_tpu_torch.ops.attention import attention, mha_reference
from merlin_tpu_torch.ops.flash_attention import (
    NEG_INF, flash_attention, flash_attention_plain)
from merlin_tpu_torch.ops.onepass_attention import (
    onepass_attention, onepass_attention_plain)

F32_TOL = 2e-5
BF16_TOL = 2e-2


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _qkv(seed, b, sq, skv, h, hkv, d):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, sq, h, d)).astype(np.float32)
    k = rng.normal(size=(b, skv, hkv, d)).astype(np.float32)
    v = rng.normal(size=(b, skv, hkv, d)).astype(np.float32)
    return q, k, v


def _layer_normed(x):
    """LayerNorm-bounded vectors, as the ViT tower feeds its attention."""
    x = x - x.mean(-1, keepdims=True)
    return x / np.sqrt((x * x).mean(-1, keepdims=True) + 1e-5)


def _t(x, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(x)).to(dtype)


def _j(x, dtype=jnp.float32):
    return jnp.asarray(x, dtype)


# d = 80 and 104: the metaclip ViT-H/14 and Qwen-VL bigG towers' widths
@pytest.mark.parametrize("b,s,h,d", [(1, 37, 2, 64), (2, 21, 4, 32),
                                     (1, 37, 2, 80), (1, 37, 2, 104)])
def test_onepass_plain_matches_pallas_interpret_f32(b, s, h, d):
    q, k, v = (_layer_normed(x) for x in _qkv(0, b, s, s, h, h, d))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(j_onepass(_j(q), _j(k), _j(v)))
    got = onepass_attention_plain(_t(q), _t(k), _t(v)).numpy()
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=F32_TOL)
    # the CPU wrapper takes the plain path and counts no launch
    before = onepass_attention.launches
    np.testing.assert_array_equal(
        onepass_attention(_t(q), _t(k), _t(v)).numpy(), got)
    assert onepass_attention.launches == before


def test_onepass_plain_matches_pallas_interpret_bf16():
    q, k, v = (_layer_normed(x) for x in _qkv(1, 1, 37, 37, 2, 2, 64))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(j_onepass(_j(q, jnp.bfloat16), _j(k, jnp.bfloat16),
                                    _j(v, jnp.bfloat16)).astype(jnp.float32))
    got = onepass_attention_plain(_t(q, torch.bfloat16), _t(k, torch.bfloat16),
                                  _t(v, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=BF16_TOL,
                               rtol=BF16_TOL)


def _flash_pallas(q, k, v, qseg, kseg, slopes, *, causal, block=128):
    b, sq, h, d = q.shape
    use_seg = qseg is not None
    use_alibi = slopes is not None
    qseg = qseg if use_seg else np.ones((b, sq), np.int32)
    kseg = kseg if use_seg else np.ones((b, k.shape[1]), np.int32)
    slopes = slopes if use_alibi else np.zeros((h,), np.float32)
    with pltpu.force_tpu_interpret_mode():
        out, lse = _flash_fwd_pallas(
            _j(q), _j(k), _j(v), jnp.asarray(qseg), jnp.asarray(kseg),
            jnp.asarray(slopes), causal=causal, scale=d ** -0.5,
            block_q=block, block_k=block, use_alibi=use_alibi,
            use_segments=use_seg)
    return np.asarray(out), np.asarray(lse)[:, :, 0, :]


FLASH_CASES = {
    "causal": dict(causal=True, seg=False, alibi=False, hkv=2),
    "bidir_segments": dict(causal=False, seg=True, alibi=False, hkv=2),
    "causal_alibi_segments": dict(causal=True, seg=True, alibi=True, hkv=2),
    "causal_gqa": dict(causal=True, seg=False, alibi=False, hkv=1),
    # widths past the 64/128 forms: phi-2's d = 80, and d = 256 (the
    # flash route's limit)
    "causal_segments_d80": dict(causal=True, seg=True, alibi=False, hkv=2,
                                d=80),
    "causal_segments_d256": dict(causal=True, seg=True, alibi=False, hkv=2,
                                 d=256),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_plain_matches_pallas_interpret(case):
    c = FLASH_CASES[case]
    b, s, h, d = 1, 256, 2, c.get("d", 64)
    q, k, v = _qkv(2, b, s, s, h, c["hkv"], d)
    seg = None
    if c["seg"]:
        seg = np.repeat(np.asarray([[1, 2, 3]], np.int32), [100, 60, 96],
                        axis=1)
    slopes = (np.asarray([0.25, 0.0625], np.float32) if c["alibi"]
              else None)
    want_out, want_lse = _flash_pallas(q, k, v, seg, seg, slopes,
                                       causal=c["causal"])
    t_seg = _t(seg, torch.int32) if seg is not None else None
    out, lse = flash_attention_plain(
        _t(q), _t(k), _t(v), segment_ids_q=t_seg, segment_ids_kv=t_seg,
        alibi_slopes=_t(slopes) if slopes is not None else None,
        causal=c["causal"])
    assert lse.shape == (b, h, s) and lse.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), want_out, atol=F32_TOL,
                               rtol=F32_TOL)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=F32_TOL,
                               rtol=F32_TOL)
    before = flash_attention.launches
    cpu_out, _ = flash_attention(
        _t(q), _t(k), _t(v), segment_ids_q=t_seg, segment_ids_kv=t_seg,
        alibi_slopes=_t(slopes) if slopes is not None else None,
        causal=c["causal"])
    np.testing.assert_array_equal(cpu_out.numpy(), out.numpy())
    assert flash_attention.launches == before


def test_fully_masked_row_gives_zero_not_nan():
    """Trap C2. A query whose segment id matches no key: the port's flash
    path gives output 0 and LSE = NEG_INF (l = 0 -> l_safe = 1, masked p
    zeroed), never NaN. The JAX flash kernel and both mha_references mask
    with the same finite NEG_INF but do not zero masked p, so that row is
    the uniform average of v there; every other row agrees."""
    b, s, h, d = 1, 128, 1, 64
    q, k, v = _qkv(3, b, s, s, h, h, d)
    qseg = np.ones((b, s), np.int32)
    qseg[0, 5] = 7
    kseg = np.ones((b, s), np.int32)
    want_out, want_lse = _flash_pallas(q, k, v, qseg, kseg, None,
                                       causal=False)
    out, lse = flash_attention_plain(
        _t(q), _t(k), _t(v), segment_ids_q=_t(qseg, torch.int32),
        segment_ids_kv=_t(kseg, torch.int32), causal=False)
    out, lse = out.numpy(), lse.numpy()
    assert np.isfinite(out).all()
    np.testing.assert_array_equal(out[0, 5], 0.0)
    assert lse[0, 0, 5] == np.float32(NEG_INF)
    np.testing.assert_allclose(want_out[0, 5, 0], v[0, :, 0].mean(0),
                               atol=F32_TOL)
    rows = np.arange(s) != 5
    np.testing.assert_allclose(out[:, rows], want_out[:, rows],
                               atol=F32_TOL, rtol=F32_TOL)
    np.testing.assert_allclose(lse[..., rows], want_lse[..., rows],
                               atol=F32_TOL, rtol=F32_TOL)
    ref = mha_reference(_t(q), _t(k), _t(v), causal=False,
                        segment_ids_q=_t(qseg, torch.int32),
                        segment_ids_kv=_t(kseg, torch.int32)).numpy()
    jref = np.asarray(j_mha(_j(q), _j(k), _j(v), causal=False,
                            segment_ids_q=jnp.asarray(qseg),
                            segment_ids_kv=jnp.asarray(kseg)))
    np.testing.assert_allclose(ref, jref, atol=F32_TOL, rtol=F32_TOL)


MHA_CASES = {
    "causal": dict(causal=True),
    "bidir": dict(causal=False),
    "segments": dict(causal=True, seg=True),
    "alibi_gqa": dict(causal=True, alibi=True, hkv=2),
    "decode_offsets": dict(causal=False, seg=True, alibi=True, decode=True),
    "prefill_offset": dict(causal=True, seg=True, offset=3),
}


@pytest.mark.parametrize("case", sorted(MHA_CASES))
def test_mha_reference_matches_jax(case):
    c = MHA_CASES[case]
    b, h, d = 2, 4, 16
    sq, skv = (1, 24) if c.get("decode") else (16, 24 if "offset" in c else 16)
    hkv = c.get("hkv", h)
    q, k, v = _qkv(4, b, sq, skv, h, hkv, d)
    rng = np.random.default_rng(5)
    kw_t, kw_j = {}, {}
    if c.get("seg"):
        sq_ids = rng.integers(0, 3, size=(b, sq)).astype(np.int32)
        sk_ids = rng.integers(0, 3, size=(b, skv)).astype(np.int32)
        kw_t.update(segment_ids_q=_t(sq_ids, torch.int32),
                    segment_ids_kv=_t(sk_ids, torch.int32))
        kw_j.update(segment_ids_q=jnp.asarray(sq_ids),
                    segment_ids_kv=jnp.asarray(sk_ids))
    if c.get("alibi"):
        slopes = np.asarray([2.0 ** -(i + 1) for i in range(h)], np.float32)
        kw_t["alibi_slopes"] = _t(slopes)
        kw_j["alibi_slopes"] = jnp.asarray(slopes)
    if c.get("decode"):
        pos = np.asarray([[20], [13]], np.int32)
        kpos = np.tile(np.arange(skv, dtype=np.int32), (b, 1)) - 2
        kw_t.update(q_offset=_t(pos, torch.int32),
                    k_positions=_t(kpos, torch.int32))
        kw_j.update(q_offset=jnp.asarray(pos), k_positions=jnp.asarray(kpos))
    if "offset" in c:
        kw_t["q_offset"] = kw_j["q_offset"] = c["offset"]
    got = mha_reference(_t(q), _t(k), _t(v), causal=c["causal"], **kw_t)
    want = j_mha(_j(q), _j(k), _j(v), causal=c["causal"], **kw_j)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=F32_TOL,
                               rtol=F32_TOL)


def test_dispatcher_on_cpu_uses_reference():
    q, k, v = _qkv(6, 1, 160, 160, 2, 2, 64)
    for causal in (True, False):
        got = attention(_t(q), _t(k), _t(v), causal=causal)
        want = mha_reference(_t(q), _t(k), _t(v), causal=causal)
        np.testing.assert_array_equal(got.numpy(), want.numpy())


def test_bf16_reference_softmax_in_f32():
    q, k, v = _qkv(7, 1, 16, 16, 1, 1, 8)
    out = mha_reference(_t(q, torch.bfloat16), _t(k, torch.bfloat16),
                        _t(v, torch.bfloat16))
    assert out.dtype == torch.bfloat16
    want = j_mha(_j(q, jnp.bfloat16), _j(k, jnp.bfloat16),
                 _j(v, jnp.bfloat16))
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=BF16_TOL, rtol=BF16_TOL)
    assert math.isfinite(float(out.float().abs().max()))
