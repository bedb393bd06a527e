"""On-card smoke run of the PyTorch/CUDA port (``merlin_tpu_torch``).

Drives the port's paths once on one NVIDIA GPU, through the entry points
a user calls, at the full width of CLIP ViT-L/14-448 + Vicuna-7B (all 32
decoder layers, random bf16 weights from a seed, and the same weights with
the LM quantized to int8) and of Baichuan-13B:

  1. setup      - card name and power limit; build the CUDA kernels from
                  ``merlin_tpu_torch/csrc`` (nvcc, sm_90a);
  2. kernels    - each kernel (B1-B9) against its plain PyTorch version on
                  the card at its path's shapes (and edge cases: GQA, ALiBi,
                  ragged lengths over permuted page tables, hkv = 40), with
                  times, the bound from the shapes, and one PyTorch library
                  call as a yardstick where one exists; a planted fault (the
                  last key tile dropped; a live page redirected to the trash
                  page; int8 scales read at lane hk instead of hk * stride)
                  must fail the same check;
  3. reference  - a narrow model on the card (through the kernels) against
                  the same weights on the CPU (plain path), both in bf16;
  4. forward    - uint8 640x480 frames -> preprocess -> tower -> projector
                  -> splice -> decoder logits at b=1, s=512, with the kernel
                  launch counts read around the call;
  5. generation - greedy ``Generator`` answers a ragged batch of 3 requests
                  (one with two image blocks) and one streamed request; the
                  logits each row's tokens were picked from, at the prefill
                  and at the last step, are held against one no-cache
                  forward of that row alone;
  6. serving    - the paged continuous-batching ``ServingEngine`` serves 6
                  ragged text requests (32 tokens each) in five setups:
                  E1 Vicuna-7B whole-prompt admission + decode (B2, B3);
                  E2 Vicuna-7B chunked prefill + speculative windows (B6,
                  B5); E4 Vicuna-7B with int8 weights and int8 pages,
                  hybrid admission (B2, B8, B7 at s_q = 1); E3 Baichuan-13B
                  cut to 4 layers, ALiBi, hybrid admission (B2, B6, B4); E5
                  the same Baichuan on int8 pages, chunked prefill +
                  speculative windows (B8, B7). Each kernel's launches must
                  equal the layers times the model calls of its kind and no
                  other kernel may launch; every emitted token must hold
                  against a no-cache forward of its request through the same
                  model, and a request's tokens read after another
                  request's prompt must fail that check. Prints tokens/s,
                  per-request TTFT and the KV pool's bytes.

Prints the serving readings and the kernel table as JSON lines before the
last, and as the last
line ``{"ok": true, "device": {...}}``. Any failure exits non-zero before
that line. Needs a CUDA card; exits 2 without one.

    python3 chip_smoke.py
"""

from __future__ import annotations

import collections
import dataclasses
import gc
import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

PEAK_BF16_FLOPS = 989e12     # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_BYTES = 3.35e12         # H100 SXM HBM3
OUT_RTOL = 2.0 ** -5         # per query row: max |kernel - plain| over d, of
                             # the row's max |plain|: 4 bf16 ulps there (one
                             # ulp, 2^-7, is what the kernels show); a
                             # dropped key tile gives 0.7-1.0
LSE_TOL = 2e-3               # f32 LSE ~ 5-10, summation order only
LOGIT_RTOL = 3e-2            # narrow model, card vs CPU, both bf16 compute:
                             # of max |logit|, for bf16 roundings taken in
                             # other orders through 3 layers (1.3% seen)
GEN_RTOL = 5e-2              # generation logits against a no-cache forward
                             # of the row alone, of max |logit| (< 1% seen;
                             # the cache's padding left visible gives 66%)
Q8_GEN_RTOL = 1e-1           # the same over int8 pages: a key's int8 step
                             # is up to absmax/254, a few bf16 ulps, so a
                             # near tie flips more readily. Seen: 0 with
                             # this serving phase run on the CPU on a
                             # narrow Vicuna-shaped model (6.5e-3 over its
                             # bf16 pages); <= 4.7e-3 in E4/E5 on an H100
                             # 80GB HBM3 at 700 W; a swapped prompt gives
                             # 0.53-1.32

B1_SOURCE = "merlin_tpu_torch/csrc/onepass_attention.cu"
B2_SOURCE = "merlin_tpu_torch/csrc/flash_attention.cu"
B1_REPLACES = "merlin_tpu/ops/onepass_attention.py:254"
B2_REPLACES = "merlin_tpu/ops/flash_attention.py:161"
PAGED_SOURCE = "merlin_tpu_torch/csrc/paged_attention.cu"
PAGED_REPLACES = {"B3": "merlin_tpu/ops/paged_attention.py:365",
                  "B4": "merlin_tpu/ops/paged_attention.py:143",
                  "B5": "merlin_tpu/ops/paged_attention.py:631",
                  "B6": "merlin_tpu/ops/paged_attention.py:772",
                  # B7 is one pallas_call; the port serves its s_q = 1 case
                  # (paged_attention_dma_q8, "B7") with the decode kernel
                  # and its windows ("B7w") with the window kernel
                  "B7": "merlin_tpu/ops/paged_attention.py:1172",
                  "B7w": "merlin_tpu/ops/paged_attention.py:1172",
                  "B8": "merlin_tpu/ops/paged_attention.py:916",
                  "B9": "merlin_tpu/ops/paged_attention.py:1353"}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call, by CUDA events over ``iters`` calls."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(flops: float, nbytes: float):
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def layer_normed(shape, gen):
    x = torch.randn(shape, generator=gen, device="cuda")
    x = (x - x.mean(-1, keepdim=True)) / x.std(-1, keepdim=True)
    return x.to(torch.bfloat16)


def out_err(got, want):
    """(max abs error, largest error of a query row over d as a share of
    that row's largest plain output). The share is read per row because
    attention outputs shrink with the number of keys a row averages: one
    absolute bound is loose for long rows and tight for short ones."""
    diff = (got.float() - want.float()).abs()
    rel = diff.amax(-1) / want.float().abs().amax(-1).clamp_min(1e-30)
    return diff.max().item(), rel.max().item()


def planted_fault(tag, rel):
    """A kernel run that leaves out work must fail the check it is held to."""
    log(f"{tag} planted fault (last key tile dropped): row error {rel:.3e}, "
        f"must exceed {OUT_RTOL:.3e}")
    if not rel > OUT_RTOL:
        raise AssertionError(f"{tag}: the check cannot see a dropped key tile")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_b1(gen):
    from merlin_tpu_torch.ops.onepass_attention import (
        onepass_attention, onepass_attention_plain)

    rows = []
    for shape in [(2, 1025, 16, 64), (3, 257, 16, 64), (1, 77, 4, 128)]:
        q, k, v = (layer_normed(shape, gen) for _ in range(3))
        got = onepass_attention(q, k, v)
        want = onepass_attention_plain(q, k, v)
        torch.cuda.synchronize()
        err, rel = out_err(got, want)
        log(f"B1 {shape}: max_abs_err {err:.3e}, row error {rel:.3e} "
            f"(tol {OUT_RTOL:.3e})")
        if not rel <= OUT_RTOL:
            raise AssertionError(f"B1 {shape} disagrees: {err} {rel}")
        rows.append((err, q, k, v, got, want))
    # the KV tile is 64 keys: at s=1025 the last tile holds key 1024 alone
    _, q, k, v, out, want = rows[0]
    s = q.shape[1]
    planted_fault("B1", out_err(onepass_attention(
        q, k[:, :s - 1], v[:, :s - 1]), want)[1])
    # time at the tower's shape, per image batch of 1 (one layer's call)
    q1, k1, v1, out1 = q[:1], k[:1], v[:1], out[:1]
    b, s, h, d = q1.shape
    ms = time_ms(lambda: onepass_attention(q1, k1, v1))
    plain = time_ms(lambda: onepass_attention_plain(q1, k1, v1), iters=5)
    qt, kt, vt = (t.transpose(1, 2) for t in (q1, k1, v1))
    lib = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt))
    bms, by = bound_ms(4.0 * b * h * s * s * d, nbytes(q1, k1, v1, out1))
    log(f"B1 (1, {s}, {h}, {d}) bf16: kernel {ms:.4f} ms, plain {plain:.4f} "
        f"ms, sdpa {lib:.4f} ms, bound {bms:.4f} ms ({by})")
    return dict(name="B1 onepass_attention", route="cuda", source=B1_SOURCE,
                replaces=B1_REPLACES, max_abs_err=max(r[0] for r in rows),
                ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                library_ms=lib, shape=[b, s, h, d])


def check_b2(gen):
    from merlin_tpu_torch.ops.flash_attention import (
        NEG_INF, flash_attention, flash_attention_plain)

    errs = []

    def compare(tag, q, k, v, **kw):
        out, lse = flash_attention(q, k, v, **kw)
        want, want_lse = flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        err, rel = out_err(out, want)
        lerr = (lse - want_lse).abs().max().item()
        log(f"B2 {tag}: max_abs_err {err:.3e}, row error {rel:.3e} (tol "
            f"{OUT_RTOL:.3e}), lse {lerr:.3e} (tol {LSE_TOL})")
        if not (rel <= OUT_RTOL and lerr <= LSE_TOL
                and torch.isfinite(out.float()).all()):
            raise AssertionError(f"B2 {tag} disagrees: {err} {rel} {lerr}")
        errs.append(err)
        return out, lse, want

    # the decoder's shape: Vicuna-7B prompt, causal
    shape = (1, 512, 32, 128)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(
        torch.bfloat16) for _ in range(3))
    out, lse, want = compare("(1, 512, 32, 128) causal", q, k, v,
                             causal=True)
    # keys 448..511 left out: rows 448 on lose keys they see
    planted_fault("B2", out_err(flash_attention(
        q, k[:, :448], v[:, :448], causal=True)[0], want)[1])

    # small case: GQA (h=8, hkv=2), ALiBi, packed segments with a fully
    # masked row, a ragged length, and k/v read as strided views of one
    # packed tensor
    b, s, h, hkv, d = 2, 200, 8, 2, 64
    qs = torch.randn((b, s, h, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    kv = torch.randn((b, s, 2, hkv, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    ks, vs = kv[:, :, 0], kv[:, :, 1]
    seg = torch.ones((b, s), dtype=torch.int32, device="cuda")
    seg[:, 120:] = 2
    qseg = seg.clone()
    qseg[1, 7] = 9                     # no key carries segment 9
    slopes = torch.tensor([2.0 ** -(i + 1) for i in range(h)],
                          device="cuda")
    for causal in (True, False):
        o_s, l_s, _ = compare(f"small gqa/alibi/segments causal={causal}",
                              qs, ks, vs, causal=causal, segment_ids_q=qseg,
                              segment_ids_kv=seg, alibi_slopes=slopes)
        if not (o_s[1, 7].float().abs().max().item() == 0.0
                and l_s[1, :, 7].eq(NEG_INF).all().item()):
            raise AssertionError("B2 fully masked row is not 0 / NEG_INF")

    bq, sq, hq, dq = shape
    ms = time_ms(lambda: flash_attention(q, k, v, causal=True))
    plain = time_ms(lambda: flash_attention_plain(q, k, v, causal=True),
                    iters=5)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True))
    pairs = sq * (sq + 1) / 2          # visible (q, k) pairs, causal
    bms, by = bound_ms(4.0 * bq * hq * pairs * dq, nbytes(q, k, v, out, lse))
    log(f"B2 {shape} causal bf16: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
        f"sdpa {lib:.4f} ms, bound {bms:.4f} ms ({by})")
    return dict(name="B2 flash_attention_fwd", route="cuda",
                source=B2_SOURCE, replaces=B2_REPLACES,
                max_abs_err=max(errs), ms=ms, plain_ms=plain, bound_ms=bms,
                bound_by=by, library_ms=lib, shape=list(shape))


def paged_inputs(gen, b, h, hkv, d, lengths, s_q=0, page=128, pps=16):
    """q, a pool of b * pps + 1 random pages (page 0 is the trash page),
    and tables whose live entries are a random permutation of pages 1..
    (not contiguous), unused entries on page 0."""
    total = b * pps + 1
    pool = [torch.randn((total, page, hkv * d), generator=gen,
                        device="cuda").to(torch.bfloat16) for _ in range(2)]
    perm = (torch.randperm(total - 1, generator=gen, device="cuda") + 1).to(
        torch.int32).reshape(b, pps)
    tables = torch.zeros((b, pps), dtype=torch.int32, device="cuda")
    for i, n in enumerate(lengths):
        used = -(-n // page)
        tables[i, :used] = perm[i, :used]
    qshape = (b, s_q, h, d) if s_q else (b, h, d)
    q = torch.randn(qshape, generator=gen, device="cuda").to(torch.bfloat16)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return q, pool[0], pool[1], lens, tables


def redirect_page(tables, lengths, page=128):
    """The planted fault: one live page of the first sequence with two or
    more pages, pointed at the trash page 0."""
    bad = tables.clone()
    i = next(i for i, n in enumerate(lengths) if n > page)
    bad[i, 1] = 0
    return bad


def window_flops(q, lens):
    """4 h d FLOP for each (query row, visible key) pair of a window whose
    lengths include it: row t of s_q sees keys <= length - s_q + t."""
    b, s_q, h, d = q.shape
    seen = sum(max(0, n - s_q + t + 1) for n in lens.tolist()
               for t in range(s_q))
    return 4.0 * h * d * seen


def check_paged(gen):
    """B3/B4 (paged decode) and B5/B6 (paged window) against their plain
    versions at the serving path's widths, ragged lengths (1, page
    multiples, >= 1900) over permuted tables; a redirected live page must
    fail the check. Returns the four kernel rows."""
    from merlin_tpu_torch.models.layers import alibi_slopes
    from merlin_tpu_torch.ops import paged_attention as pa

    errs = {k: [] for k in ("B3", "B4", "B5", "B6")}
    fns = {"B3": pa.paged_attention_dma, "B4": pa.paged_attention,
           "B5": pa.paged_attention_dma_multi,
           "B6": pa.paged_attention_multi_blocked}

    def compare(tag, name, inputs, slopes=None, tables=None):
        q, kp, vp, lens, tabs = inputs
        kw = {} if name == "B3" else {"alibi_slopes": slopes}
        plain = (pa.paged_attention_plain if q.dim() == 3
                 else pa.paged_attention_multi_plain)
        got = fns[name](q, kp, vp, lens, tabs if tables is None else tables,
                        **kw)
        want = plain(q, kp, vp, lens, tabs, **kw)
        torch.cuda.synchronize()
        err, rel = out_err(got, want)
        if tables is not None:
            log(f"{name} planted fault ({tag}: a live page redirected to "
                f"the trash page): row error {rel:.3e}, must exceed "
                f"{OUT_RTOL:.3e}")
            if not rel > OUT_RTOL:
                raise AssertionError(f"{name}: the check cannot see a "
                                     "redirected page")
            return
        log(f"{name} {tag}: max_abs_err {err:.3e}, row error {rel:.3e} "
            f"(tol {OUT_RTOL:.3e})")
        if not (rel <= OUT_RTOL and torch.isfinite(got.float()).all()):
            raise AssertionError(f"{name} {tag} disagrees: {err} {rel}")
        errs[name].append(err)

    vicuna = [1, 256, 1937, 700]            # E1's 4 slots at 32/32 heads
    baichuan = [1, 384, 1999, 901]
    gqa = [1, 1024, 1900]
    s40 = alibi_slopes(40, device="cuda")
    s8 = alibi_slopes(8, device="cuda")
    dec_mha = paged_inputs(gen, 4, 32, 32, 128, vicuna)
    dec_gqa = paged_inputs(gen, 3, 8, 2, 128, gqa)
    dec_bc = paged_inputs(gen, 4, 40, 40, 128, baichuan)
    compare("decode vicuna (4 slots, 32/32 heads)", "B3", dec_mha)
    compare("decode gqa (8/2 heads)", "B3", dec_gqa)
    compare("decode baichuan-13b alibi (40 heads)", "B4", dec_bc, s40)
    compare("decode gqa alibi (8/2 heads)", "B4", dec_gqa, s8)
    compare("decode vicuna", "B3", dec_mha,
            tables=redirect_page(dec_mha[4], vicuna))

    win5 = paged_inputs(gen, 4, 32, 32, 128, [5, 256, 1937, 700], s_q=5)
    win128 = paged_inputs(gen, 4, 32, 32, 128, [128, 256, 1990, 700],
                          s_q=128)
    win_gqa5 = paged_inputs(gen, 3, 8, 2, 128, [5, 1024, 1900], s_q=5)
    win_gqa128 = paged_inputs(gen, 3, 8, 2, 128, [130, 1024, 1900],
                              s_q=128)
    compare("window s_q=5 vicuna", "B5", win5)
    compare("window s_q=5 gqa alibi", "B5", win_gqa5, s8)
    compare("window s_q=5 gqa alibi", "B6", win_gqa5, s8)
    compare("window s_q=128 vicuna", "B6", win128)
    compare("window s_q=128 gqa alibi", "B6", win_gqa128, s8)
    compare("window s_q=128 vicuna", "B6", win128,
            tables=redirect_page(win128[4], [128, 256, 1990, 700]))

    def row(name, fn_name, inputs, slopes, plain, flops):
        q, kp, vp, lens, tabs = inputs
        fn = fns[name]
        kw = {} if name == "B3" else {"alibi_slopes": slopes}
        ms = time_ms(lambda: fn(q, kp, vp, lens, tabs, **kw))
        plain_ms = time_ms(lambda: plain(q, kp, vp, lens, tabs, **kw),
                           iters=5)
        hkv_d = kp.shape[2]
        kv_bytes = int(lens.sum()) * hkv_d * 2 * 2     # each live K/V once
        bms, by = bound_ms(flops, kv_bytes + 2 * nbytes(q))
        log(f"{name} {tuple(q.shape)} lengths {lens.tolist()} bf16: kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bms:.4f} ms "
            f"({by}), library none")
        return dict(name=f"{name} {fn_name}", route="cuda",
                    source=PAGED_SOURCE, replaces=PAGED_REPLACES[name],
                    max_abs_err=max(errs[name]), ms=ms, plain_ms=plain_ms,
                    bound_ms=bms, bound_by=by, library_ms=None,
                    shape=list(q.shape))

    # the route's reason: B6's 64-row tiles on the verify window's shape
    q, kp, vp, lens, tabs = win5
    b6_ms = time_ms(lambda: pa.paged_attention_multi_blocked(
        q, kp, vp, lens, tabs))
    log(f"B6 on B5's shape {tuple(q.shape)}: {b6_ms:.4f} ms")
    return {
        "B3": row("B3", "paged_attention_dma", dec_mha, None,
                  pa.paged_attention_plain,
                  4.0 * 32 * 128 * int(dec_mha[3].sum())),
        "B4": row("B4", "paged_attention", dec_bc, s40,
                  pa.paged_attention_plain,
                  4.0 * 40 * 128 * int(dec_bc[3].sum())),
        "B5": row("B5", "paged_attention_dma_multi", win5, None,
                  pa.paged_attention_multi_plain,
                  window_flops(win5[0], win5[3])),
        "B6": row("B6", "paged_attention_multi_blocked", win128, None,
                  pa.paged_attention_multi_plain,
                  window_flops(win128[0], win128[3])),
    }


def paged_q8_inputs(gen, b, h, hkv, d, lengths, s_q=0):
    """``paged_inputs`` with both pools quantized by the port's
    ``quantize_pages``: q, k values, k scales, v values, v scales, lengths,
    tables."""
    from merlin_tpu_torch.ops.paged_attention import quantize_pages

    q, kp, vp, lens, tables = paged_inputs(gen, b, h, hkv, d, lengths, s_q)
    kv, ks = quantize_pages(kp, d)
    vv, vs = quantize_pages(vp, d)
    return q, kv, ks, vv, vs, lens, tables


def head_lane_scales(scales, hkv):
    """The planted layout fault: each head's scale at lane hk (head ==
    lane) where the kernel reads lane hk * (128 // hkv)."""
    stride = max(scales.shape[-1] // hkv, 1)
    bad = torch.zeros_like(scales)
    bad[..., :hkv] = scales[..., 0:hkv * stride:stride]
    return bad


def check_paged_q8(gen):
    """B7 (decode at s_q = 1, and windows), B8 and B9 over int8 pages
    against their plain versions at the int8 serving paths' widths: ragged
    lengths (1, page multiples, >= 1900) over permuted tables, GQA, ALiBi
    and hkv = 40 (scale stride 3). Two planted faults must fail the check:
    a live page redirected to the trash page, and scales laid out head ==
    lane. Returns the four kernel rows."""
    from merlin_tpu_torch.models.layers import alibi_slopes
    from merlin_tpu_torch.ops import paged_attention as pa

    names = ("B7", "B7w", "B8", "B9")
    errs = {k: [] for k in names}
    fns = {"B7": pa.paged_attention_dma_q8,
           "B7w": pa.paged_attention_dma_multi_q8,
           "B8": pa.paged_attention_multi_blocked_q8,
           "B9": pa.paged_attention_quantized}

    def plain(q):
        return (pa.paged_attention_q8_plain if q.dim() == 3
                else pa.paged_attention_multi_q8_plain)

    def compare(tag, name, inputs, slopes=None, fault=None):
        q, kv, ks, vv, vs, lens, tabs = inputs
        got_in = list(inputs)
        if fault == "page":
            lengths = lens.tolist()
            got_in[6] = redirect_page(tabs, lengths)
            what = "a live page redirected to the trash page"
        elif fault == "lanes":
            hkv = kv.shape[2] // q.shape[-1]
            got_in[2] = head_lane_scales(ks, hkv)
            got_in[4] = head_lane_scales(vs, hkv)
            what = f"scales at lane hk, not hk * {128 // hkv}"
        got = fns[name](*got_in, alibi_slopes=slopes)
        want = plain(q)(*inputs, alibi_slopes=slopes)
        torch.cuda.synchronize()
        err, rel = out_err(got, want)
        if fault is not None:
            log(f"{name} planted fault ({tag}: {what}): row error "
                f"{rel:.3e}, must exceed {OUT_RTOL:.3e}")
            if not rel > OUT_RTOL:
                raise AssertionError(f"{name}: the check cannot see {what}")
            return
        log(f"{name} {tag}: max_abs_err {err:.3e}, row error {rel:.3e} "
            f"(tol {OUT_RTOL:.3e})")
        if not (rel <= OUT_RTOL and torch.isfinite(got.float()).all()):
            raise AssertionError(f"{name} {tag} disagrees: {err} {rel}")
        errs[name].append(err)

    vicuna = [1, 256, 1937, 700]
    baichuan = [1, 384, 1999, 901]
    gqa = [1, 1024, 1900]
    s40 = alibi_slopes(40, device="cuda")
    s8 = alibi_slopes(8, device="cuda")
    dec_mha = paged_q8_inputs(gen, 4, 32, 32, 128, vicuna)
    dec_gqa = paged_q8_inputs(gen, 3, 8, 2, 128, gqa)
    dec_bc = paged_q8_inputs(gen, 4, 40, 40, 128, baichuan)
    for name in ("B7", "B9"):
        compare("decode vicuna (4 slots, 32/32 heads)", name, dec_mha)
        compare("decode gqa alibi (8/2 heads)", name, dec_gqa, s8)
        compare("decode baichuan-13b alibi (40 heads)", name, dec_bc, s40)
    compare("decode gqa (8/2 heads)", "B7", dec_gqa)
    compare("decode vicuna", "B7", dec_mha, fault="page")
    compare("decode vicuna", "B7", dec_mha, fault="lanes")
    compare("decode baichuan-13b", "B7", dec_bc, s40, fault="lanes")

    win5 = paged_q8_inputs(gen, 4, 32, 32, 128, [5, 256, 1937, 700], s_q=5)
    win5_bc = paged_q8_inputs(gen, 4, 40, 40, 128, [5, 384, 1999, 901],
                              s_q=5)
    win128 = paged_q8_inputs(gen, 4, 32, 32, 128, [128, 256, 1990, 700],
                             s_q=128)
    win128_bc = paged_q8_inputs(gen, 4, 40, 40, 128, [130, 384, 1999, 901],
                                s_q=128)
    win_gqa5 = paged_q8_inputs(gen, 3, 8, 2, 128, [5, 1024, 1900], s_q=5)
    win_gqa128 = paged_q8_inputs(gen, 3, 8, 2, 128, [130, 1024, 1900],
                                 s_q=128)
    compare("window s_q=5 vicuna", "B7w", win5)
    compare("window s_q=5 baichuan-13b alibi", "B7w", win5_bc, s40)
    compare("window s_q=5 gqa alibi", "B7w", win_gqa5, s8)
    compare("window s_q=5 gqa alibi", "B8", win_gqa5, s8)
    compare("window s_q=128 vicuna", "B8", win128)
    compare("window s_q=128 baichuan-13b alibi", "B8", win128_bc, s40)
    compare("window s_q=128 gqa alibi", "B8", win_gqa128, s8)
    compare("window s_q=5 baichuan-13b", "B7w", win5_bc, s40, fault="lanes")
    compare("window s_q=128 vicuna", "B8", win128, fault="page")
    compare("window s_q=128 vicuna", "B8", win128, fault="lanes")

    def row(name, fn_name, inputs, slopes, flops):
        q, kv, ks, vv, vs, lens, tabs = inputs
        fn = fns[name]
        ms = time_ms(lambda: fn(q, kv, ks, vv, vs, lens, tabs,
                                alibi_slopes=slopes))
        plain_ms = time_ms(lambda: plain(q)(q, kv, ks, vv, vs, lens, tabs,
                                            alibi_slopes=slopes), iters=5)
        hkv = kv.shape[2] // q.shape[-1]
        live = int(lens.sum())
        # each live int8 K/V row once, each live (token, head) scale of K
        # and V once (4 bytes), q in, out
        kv_bytes = live * kv.shape[2] * 2 + live * hkv * 4 * 2
        bms, by = bound_ms(flops, kv_bytes + 2 * nbytes(q))
        log(f"{name} {tuple(q.shape)} lengths {lens.tolist()} int8 pages: "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bms:.4f} "
            f"ms ({by}), library none")
        return dict(name=f"{name} {fn_name}", route="cuda",
                    source=PAGED_SOURCE, replaces=PAGED_REPLACES[name],
                    max_abs_err=max(errs[name]), ms=ms, plain_ms=plain_ms,
                    bound_ms=bms, bound_by=by, library_ms=None,
                    shape=list(q.shape))

    return {
        "B7": row("B7", "paged_attention_dma_q8", dec_mha, None,
                  4.0 * 32 * 128 * int(dec_mha[5].sum())),
        "B7w": row("B7w", "paged_attention_dma_multi_q8", win5_bc, s40,
                   window_flops(win5_bc[0], win5_bc[5])),
        "B8": row("B8", "paged_attention_multi_blocked_q8", win128, None,
                  window_flops(win128[0], win128[5])),
        "B9": row("B9", "paged_attention_quantized", dec_mha, None,
                  4.0 * 32 * 128 * int(dec_mha[5].sum())),
    }


# ---------------------------------------------------------------------------
# phases 3-5: the model
# ---------------------------------------------------------------------------

PATCH_ID, START_ID, END_ID = 32000, 32001, 32002


def mm_config(lm, vit):
    from merlin_tpu_torch.models.mmgpt import MMGPTConfig

    return MMGPTConfig(lm=lm, vit=vit, projector="conv", conv_stride=2,
                       image_patch_id=PATCH_ID, im_start_id=START_ID,
                       im_end_id=END_ID)


def prompt(rng, n_text: int, n_images: int, tok_len: int):
    """Merlin-style prompt: text, then per image <im_start> patches
    <im_end>, then text (the tracking template puts two image blocks in
    one prompt)."""
    ids = [1] + list(rng.integers(10, 31000, size=n_text // 2))
    for _ in range(n_images):
        ids += [START_ID] + [PATCH_ID] * tok_len + [END_ID]
        ids += list(rng.integers(10, 31000, size=8))
    ids += list(rng.integers(10, 31000, size=n_text - n_text // 2))
    return np.asarray(ids, np.int64)


def kernel_wrappers():
    """Every kernel wrapper of the port by its TPU kernel's number; each
    counts its launches in ``.launches``."""
    from merlin_tpu_torch.ops import paged_attention as pa
    from merlin_tpu_torch.ops.flash_attention import flash_attention
    from merlin_tpu_torch.ops.onepass_attention import onepass_attention

    return {"B1": onepass_attention, "B2": flash_attention,
            "B3": pa.paged_attention_dma, "B4": pa.paged_attention,
            "B5": pa.paged_attention_dma_multi,
            "B6": pa.paged_attention_multi_blocked,
            "B7": pa.paged_attention_dma_q8,
            "B7w": pa.paged_attention_dma_multi_q8,
            "B8": pa.paged_attention_multi_blocked_q8,
            "B9": pa.paged_attention_quantized}


def reset_counts():
    for fn in kernel_wrappers().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def launches(**nonzero):
    """A full launch-count dict: the given kernels, 0 for every other."""
    return {name: nonzero.get(name, 0) for name in kernel_wrappers()}


def check_reference(rng):
    """A narrow model through the kernels on the card against the same
    weights through the plain path on the CPU, both computing in bf16."""
    from merlin_tpu_torch.models.bridge import init_params
    from merlin_tpu_torch.models.families import tiny
    from merlin_tpu_torch.models.mmgpt import MMGPT
    from merlin_tpu_torch.models.vit import tiny_vit
    from merlin_tpu_torch.ops.image_ops import preprocess_images

    def build(dtype, device):
        lm = tiny(vocab_size=32128, hidden_size=256, intermediate_size=512,
                  num_layers=2, num_heads=2, dtype=dtype)
        vit = tiny_vit(hidden_size=128, num_heads=2, intermediate_size=256,
                       patch_size=14, image_size=448, dtype=dtype)
        cfg = mm_config(lm, vit)
        with torch.device("meta"):
            model = MMGPT(cfg)
        gen = torch.Generator(device=device).manual_seed(7)
        return init_params(model, gen, std=0.05, dtype=torch.float32,
                           device=device).eval(), cfg

    card, cfg = build(torch.bfloat16, "cuda")
    host, _ = build(torch.bfloat16, "cpu")
    with torch.no_grad():
        # unit norm scales keep activations and logits O(1), so the
        # tolerance below means something
        for name, p in card.named_parameters():
            if name.endswith("norm.scale") or name.endswith("norm1.scale") \
                    or name.endswith("norm2.scale"):
                p.fill_(1.0)
    host.load_state_dict({k: v.cpu() for k, v in card.state_dict().items()})
    frames = rng.integers(0, 256, size=(1, 480, 640, 3), dtype=np.uint8)
    ids = prompt(rng, 200, 1, cfg.image_token_len)[None]
    reset_counts()
    with torch.no_grad():
        got, _ = card(torch.from_numpy(ids).cuda(), images=preprocess_images(
            frames, device="cuda")[:, None])
        torch.cuda.synchronize()
        counts = read_counts()
        want, _ = host(torch.from_numpy(ids), images=preprocess_images(
            frames, device="cpu")[:, None])
    err = (got.float().cpu() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    log(f"reference: narrow model card (kernels) vs CPU (plain), bf16: "
        f"max_abs_err {err:.3e} of max |logit| {scale:.3e} (rtol "
        f"{LOGIT_RTOL}), launches {counts}")
    if not (err <= LOGIT_RTOL * scale and counts["B1"] == 1
            and counts["B2"] == 2):
        raise AssertionError(f"reference check failed: {err} {counts}")


def build_full_model():
    from merlin_tpu_torch.models.bridge import init_params
    from merlin_tpu_torch.models.families import vicuna_7b
    from merlin_tpu_torch.models.mmgpt import MMGPT
    from merlin_tpu_torch.models.vit import clip_vit_l14

    # vocab grown to hold the 3 multimodal tokens, padded to 128 (as entry())
    lm = dataclasses.replace(vicuna_7b(), vocab_size=32128)
    cfg = mm_config(lm, clip_vit_l14(448))
    t0 = time.perf_counter()
    with torch.device("meta"):
        model = MMGPT(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    init_params(model, gen, dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    n = sum(p.numel() for p in model.parameters())
    log(f"model: {n / 1e9:.3f} B params bf16 on the card in "
        f"{time.perf_counter() - t0:.1f} s")
    return model.eval(), cfg


def run_forward(model, cfg, rng):
    from merlin_tpu_torch.ops.image_ops import preprocess_images

    tok_len = cfg.image_token_len
    b, s = 1, 512
    ids = rng.integers(10, 31000, size=(b, s)).astype(np.int64)
    ids[:, 1] = START_ID
    ids[:, 2:2 + tok_len] = PATCH_ID
    ids[:, 2 + tok_len] = END_ID
    frames = rng.integers(0, 256, size=(b, 480, 640, 3), dtype=np.uint8)
    ids_t = torch.from_numpy(ids).cuda()

    def forward():
        images = preprocess_images(frames, image_size=448, device="cuda")
        with torch.no_grad():
            logits, _ = model(ids_t, images=images[:, None])
        torch.cuda.synchronize()
        return logits

    forward()                                           # warm-up
    reset_counts()
    t0 = time.perf_counter()
    logits = forward()
    wall = (time.perf_counter() - t0) * 1e3
    counts = read_counts()
    ok = (tuple(logits.shape) == (b, s, cfg.lm.vocab_size)
          and bool(torch.isfinite(logits.float()).all()))
    log(f"forward: logits {tuple(logits.shape)} {logits.dtype}, finite "
        f"{ok}, {wall:.1f} ms (host clock, warm), launches {counts}")
    if not ok or counts != launches(B1=23, B2=32):
        raise AssertionError(f"forward failed: ok={ok} counts={counts}")
    return counts, wall


def last_logits(model, prompt_ids, images, tail):
    """Logits after ``prompt_ids`` + ``tail`` from one no-cache forward of
    that sequence alone (no padding, the decoder through B2). The prompt's
    image tokens take the features of ``images`` (n, H, W, C); the tail's
    ids are embedded as they are, as the decode steps embed them (a
    generated id may equal the image-patch id)."""
    from merlin_tpu_torch.models.mmgpt import splice_image_embeds

    ids = torch.from_numpy(np.concatenate([prompt_ids, tail])).cuda()[None]
    patch = ids == PATCH_ID
    patch[:, len(prompt_ids):] = False
    with torch.no_grad():
        feats = model.encode_images(images).reshape(
            1, -1, model.cfg.lm.hidden_size)
        embeds = splice_image_embeds(model.lm.embed(ids), patch, feats)
        logits, _ = model.lm(inputs_embeds=embeds)
    return logits[0, -1].float()


def logit_err(got, want) -> float:
    """max |got - want| as a share of max |want|."""
    return ((got.float() - want).abs().max() / want.abs().max()).item()


def check_logits(tag, got, want):
    err = logit_err(got, want)
    same = int(got.argmax()) == int(want.argmax())
    log(f"generation check {tag}: logit error {err:.3e} of max |logit| "
        f"(tol {GEN_RTOL}), same greedy token {same}")
    if not err <= GEN_RTOL:
        raise AssertionError(f"generation {tag} disagrees with the "
                             f"no-cache forward: {err}")


def run_generation(model, cfg, rng):
    from merlin_tpu_torch.generate.decode import GenerateConfig, Generator
    from merlin_tpu_torch.ops.image_ops import preprocess_images

    tok_len = cfg.image_token_len
    max_new, bucket = 32, 128
    # eos -1: no early stop, so every request does the same fixed work
    gen = Generator(model, GenerateConfig(
        max_new_tokens=max_new, eos_id=-1, pad_id=0, prompt_bucket=bucket),
        device="cuda")
    prompts = [prompt(rng, 300 - tok_len - 10, 1, tok_len),
               prompt(rng, 420 - tok_len - 10, 1, tok_len),
               prompt(rng, 40, 2, tok_len)]
    n_images = [1, 1, 2]
    lens = [len(p) for p in prompts]
    batch = np.zeros((3, max(lens)), np.int64)
    for i, p in enumerate(prompts):
        batch[i, :len(p)] = p
    frames = rng.integers(0, 256, size=(6, 480, 640, 3), dtype=np.uint8)
    images = preprocess_images(frames, device="cuda").reshape(
        3, 2, 448, 448, 3)
    images[:2, 1] = 0                  # rows 0 and 1 hold one image

    gen(batch[:1, :lens[0]], images=images[:1, :1])     # warm-up
    torch.cuda.synchronize()
    # the logits of every model call: the prefill's (b, s, V), then each
    # step's (b, 1, V); call j's logits pick generated token j
    seen = []
    hook = model.register_forward_hook(lambda m, a, o: seen.append(o[0]))
    reset_counts()
    t0 = time.perf_counter()
    out = gen(batch, images=images, attention_mask=batch != 0)
    torch.cuda.synchronize()
    batch_s = time.perf_counter() - t0
    batch_counts = read_counts()
    if out.shape != (3, max_new) or not ((out >= 0) & (out < 32128)).all():
        raise AssertionError(f"batch generation output bad: {out}")
    log(f"generation: 3 requests (prompt lengths {lens}, bucket {bucket}), "
        f"{max_new} new tokens each in {batch_s:.3f} s -> "
        f"{3 * max_new / batch_s:.2f} tok/s batch; launches {batch_counts}")
    batch_seen, seen[:] = list(seen), []

    one = batch[2:3, :lens[2]]
    reset_counts()
    t0 = time.perf_counter()
    stamps, toks = [], []
    for tok in gen.stream(one, images=images[2:3]):
        stamps.append(time.perf_counter())
        toks.append(int(tok[0]))
    stream_counts = read_counts()
    hook.remove()
    ttft = (stamps[0] - t0) * 1e3
    decode_tps = (len(stamps) - 1) / (stamps[-1] - stamps[0])
    if len(toks) != max_new:
        raise AssertionError(f"stream gave {len(toks)} tokens")
    log(f"stream: 1 request ({lens[2]} prompt tokens, 2 images): TTFT "
        f"{ttft:.1f} ms, decode {decode_tps:.2f} tok/s; launches "
        f"{stream_counts}; tokens equal to batch row 2: "
        f"{toks == out[2].tolist()}")
    if batch_counts != launches(B1=23) or stream_counts != launches(B1=23):
        raise AssertionError(f"generation launches {batch_counts} "
                             f"{stream_counts}")

    # Each row's prefill and last-step logits against one no-cache forward
    # of that row alone: right padding, the shared cache cursor, per-row
    # positions and the cache mask all sit between the two. Greedy tokens
    # are not compared: bf16 sums in another order may flip a near tie.
    last = max_new - 1
    for r in range(3):
        imgs = images[r, :n_images[r]]
        check_logits(f"row {r} prefill", batch_seen[0][r, lens[r] - 1],
                     last_logits(model, prompts[r], imgs, out[r, :0]))
        check_logits(f"row {r} step {last}", batch_seen[last][r, 0],
                     last_logits(model, prompts[r], imgs, out[r, :last]))
    check_logits(f"stream step {last}", seen[last][0, 0],
                 last_logits(model, prompts[2], images[2], toks[:last]))
    # planted fault: row 0's last step as it would read with the cache's
    # padding slots visible and positions counted by slot
    padded = np.zeros(-(-batch.shape[1] // bucket) * bucket, np.int64)
    padded[:lens[0]] = prompts[0]
    err = logit_err(batch_seen[last][0, 0], last_logits(
        model, padded, images[0, :1], out[0, :last]))
    log(f"generation planted fault (row 0 padding visible): logit error "
        f"{err:.3e}, must exceed {GEN_RTOL}")
    if not err > GEN_RTOL:
        raise AssertionError("the generation check cannot see a cache "
                             "masking fault")
    return dict(batch_tok_s=3 * max_new / batch_s, ttft_ms=ttft,
                decode_tok_s=decode_tps, counts=batch_counts)


# ---------------------------------------------------------------------------
# phases 6-8: serving through the paged engine
# ---------------------------------------------------------------------------

def token_gap(model, prompt_ids, tokens) -> float:
    """Largest (max logit - the emitted token's logit) over the positions
    that emitted ``tokens`` after ``prompt_ids``, each as a share of that
    position's max |logit|, from one no-cache forward (B2: every prompt
    here has >= 128 tokens with its answer) of the prompt and the tokens
    before the last."""
    ids = np.concatenate([prompt_ids, tokens[:-1]]).astype(np.int64)
    with torch.no_grad():
        logits, _ = model(torch.from_numpy(ids).cuda()[None])
    rows = logits[0, len(prompt_ids) - 1:].float()
    picked = rows.gather(1, torch.tensor(tokens, device="cuda")[:, None])
    gap = (rows.amax(-1) - picked[:, 0]) / rows.abs().amax(-1)
    return gap.max().item()


def run_engine(tag, model, prompts, reached, **engine_kw):
    """Serve ``prompts`` (32 new tokens each, no early stop) through a
    ``ServingEngine`` on the card. Each kernel's launches must equal the
    layers times the model calls of its kind (counted by forward hooks),
    the kernels in ``reached`` must launch and no other kernel may, every
    emitted token must hold against a no-cache forward of its request, and
    a planted prompt swap must fail that check. An int8 pool
    (``cache_dtype=torch.int8``) routes decode to B7 at s_q = 1 and windows
    to B7/B8, and its tokens are held to ``Q8_GEN_RTOL``. Returns (launch
    counts, readings)."""
    from merlin_tpu_torch.ops.paged_attention import WINDOW_SMALL_ROWS
    from merlin_tpu_torch.serve.engine import ServingEngine

    max_new = 32
    q8 = engine_kw.get("cache_dtype") == torch.int8
    tol = Q8_GEN_RTOL if q8 else GEN_RTOL
    engine = ServingEngine(model, eos_id=-1, device="cuda", **engine_kw)
    cfg = engine.lm_cfg
    group = cfg.num_heads // cfg.kv_heads
    pool = nbytes(*(t for layer in engine.cache["layers"]
                    for t in layer.values()))
    # the same pool as bf16 pages: K and V, 2 bytes a value, no scales
    pool_bf16 = sum(2 * 2 * layer["k_pages"].numel()
                    for layer in engine.cache["layers"])
    calls = collections.Counter()

    def counter(window):
        def hook(module, args, kwargs, output):
            s = args[0].shape[1]
            if window:
                small = group * s <= WINDOW_SMALL_ROWS
                calls["window_small" if small else "window_large"] += 1
            else:
                calls["prefill" if s > 1 else "decode"] += 1
        return hook

    hooks = [engine.model.register_forward_hook(counter(False),
                                                with_kwargs=True)]
    if engine.multi_model is not None:
        hooks.append(engine.multi_model.register_forward_hook(
            counter(True), with_kwargs=True))
    first = {}
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    reqs = [engine.submit(p, max_new_tokens=max_new,
                          emit=lambda t, d, _i=i: first.setdefault(
                              _i, time.perf_counter()))
            for i, p in enumerate(prompts)]
    engine.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    for h in hooks:
        h.remove()
    engine.close()
    n = cfg.num_layers
    alibi = cfg.positional == "alibi"
    if q8:
        want = launches(B2=n * calls["prefill"], B7=n * calls["decode"],
                        B7w=n * calls["window_small"],
                        B8=n * calls["window_large"])
    else:
        want = launches(B2=n * calls["prefill"],
                        B3=0 if alibi else n * calls["decode"],
                        B4=n * calls["decode"] if alibi else 0,
                        B5=n * calls["window_small"],
                        B6=n * calls["window_large"])
    n_tok = sum(len(r.generated) for r in reqs)
    ttft = [round((first[i] - t0) * 1e3, 1) for i in range(len(prompts))]
    log(f"{tag}: {len(prompts)} requests, prompt lengths "
        f"{[len(p) for p in prompts]}, {n_tok} tokens in {wall:.3f} s -> "
        f"{n_tok / wall:.2f} tok/s aggregate; TTFT ms per request {ttft} "
        f"(host clock, from the emit callback); model calls {dict(calls)}; "
        f"KV pool {pool} bytes ({pool_bf16} as bf16 pages); "
        f"launches {counts}")
    if counts != want or any((n > 0) != (k in reached)
                             for k, n in counts.items()):
        raise AssertionError(f"{tag}: launches {counts}, expected {want} "
                             f"with {reached} reached")
    if any(r.error or len(r.generated) != max_new for r in reqs):
        raise AssertionError(f"{tag}: a request failed or ended early")

    gaps = [token_gap(model, p, r.generated) for p, r in zip(prompts, reqs)]
    log(f"{tag} tokens vs a no-cache forward of each request: largest gap "
        f"per request {[f'{g:.2e}' for g in gaps]} of max |logit| (tol "
        f"{tol})")
    if not max(gaps) <= tol:
        raise AssertionError(f"{tag}: emitted tokens disagree with the "
                             f"no-cache forward: {gaps}")
    # planted fault: request 0's tokens read after another request's
    # prompt, one whose first token differs (so the two contexts disagree)
    j = next((j for j, r in enumerate(reqs)
              if r.generated[0] != reqs[0].generated[0]), 1)
    swapped = token_gap(model, prompts[j], reqs[0].generated)
    log(f"{tag} planted fault (request 0's tokens after request {j}'s "
        f"prompt): gap {swapped:.3e}, must exceed {tol}")
    if not swapped > tol:
        raise AssertionError(f"{tag}: the token check cannot see a "
                             "swapped prompt")
    return counts, dict(tok_s=n_tok / wall, ttft_ms=ttft, calls=dict(calls),
                        wall_s=wall, max_gap=max(gaps), pool_bytes=pool,
                        pool_bytes_bf16=pool_bf16)


def serving_prompts(rng, lengths, vocab, period=0):
    """Random prompts of the given lengths; with ``period``, each repeats
    one random segment of that length, so prompt lookup finds n-grams."""
    out = []
    for n in lengths:
        if period:
            seg = rng.integers(10, vocab - 1000, size=period)
            out.append(np.resize(seg, n).astype(np.int32))
        else:
            out.append(rng.integers(10, vocab - 1000, size=n).astype(
                np.int32))
    return out


def build_baichuan():
    """Baichuan-13B at full width (5120 hidden, 40 heads, vocab 64000,
    ALiBi), depth cut to 4 of 40 layers; random bf16 weights, seed 1."""
    from merlin_tpu_torch.models.bridge import init_params
    from merlin_tpu_torch.models.decoder import CausalLM
    from merlin_tpu_torch.models.families import baichuan_13b

    with torch.device("meta"):
        model = CausalLM(dataclasses.replace(baichuan_13b(), num_layers=4))
    gen = torch.Generator(device="cuda").manual_seed(1)
    init_params(model, gen, dtype=torch.bfloat16, device="cuda")
    return model.eval()


SERVING = dict(num_slots=4, max_len=2048, page_size=128, prompt_bucket=128)
SERVING_LENGTHS = [100, 300, 700, 1100, 130, 1500]


def serve_vicuna(model, rng):
    """E1 and E2 on the full-width Vicuna-7B MMGPT, text-only requests as
    the worker's engine path serves them."""
    e1 = run_engine("E1 vicuna-7b (whole-prompt admission, decode)", model,
                    serving_prompts(rng, SERVING_LENGTHS, 32000),
                    ["B2", "B3"], chunk_steps=8, pipeline=1, **SERVING)
    e2 = run_engine("E2 vicuna-7b (chunked prefill C=128, spec k=4)", model,
                    serving_prompts(rng, SERVING_LENGTHS, 32000, period=48),
                    ["B5", "B6"], prefill_chunk=128,
                    prefill_windows_per_step=4, spec_draft=4, chunk_steps=1,
                    **SERVING)
    return {"E1": e1, "E2": e2}


def build_int8_vicuna(model, cfg):
    """The same MMGPT with its LM quantized to int8 weights on the card by
    the port's ``quantize_decoder_params_int8`` (the vision tower and the
    projector stay bf16, as the JAX worker's ``--int8-weights`` does). The
    tower's tensors are shared with ``model``."""
    from merlin_tpu_torch.models.convert import quantize_decoder_params_int8
    from merlin_tpu_torch.models.mmgpt import MMGPT

    t0 = time.perf_counter()
    qcfg = dataclasses.replace(cfg, lm=dataclasses.replace(
        cfg.lm, weight_dtype="int8"))
    with torch.device("meta"):
        qmodel = MMGPT(qcfg)
    qmodel.load_state_dict(quantize_decoder_params_int8(
        model.state_dict(), prefix="lm."), strict=True, assign=True)
    torch.cuda.synchronize()
    log(f"int8 LM: {nbytes(*qmodel.lm.parameters()) / 1e9:.3f} GB on the "
        f"card (bf16: {nbytes(*model.lm.parameters()) / 1e9:.3f} GB), "
        f"quantized in {time.perf_counter() - t0:.1f} s")
    return qmodel.eval()


def serve_vicuna_int8(model, rng):
    """E4 on the int8-weight Vicuna-7B MMGPT over int8 pages: short prompts
    whole (B2, quantized into the pages), long ones in 128-token windows
    (B8), decode through B7 at s_q = 1."""
    return run_engine(
        "E4 vicuna-7b int8 weights + int8 pages (hybrid C=128 min 256)",
        model, serving_prompts(rng, SERVING_LENGTHS, 32000),
        ["B2", "B7", "B8"], cache_dtype=torch.int8, prefill_chunk=128,
        prefill_chunk_min=256, chunk_steps=8, pipeline=1, **SERVING)


def serve_baichuan(rng):
    """E3: ALiBi decode, short prompts whole (<= 256 tokens), long ones in
    128-token windows (bf16 pages). E5: the same model on int8 pages,
    every prompt in 128-token windows (B8) and speculative verify windows
    of 5 rows per kv head (B7), at hkv = 40 (scale stride 3)."""
    model = build_baichuan()
    lengths = [100, 200, 700, 1300, 120, 900]
    e3 = run_engine(
        "E3 baichuan-13b 4 layers (alibi, hybrid C=128 min 256)", model,
        serving_prompts(rng, lengths, 64000), ["B2", "B4", "B6"],
        prefill_chunk=128, prefill_chunk_min=256, **SERVING)
    e5 = run_engine(
        "E5 baichuan-13b 4 layers int8 pages (alibi, chunked C=128, spec "
        "k=4)", model, serving_prompts(rng, lengths, 64000, period=48),
        ["B7w", "B8"], cache_dtype=torch.int8, prefill_chunk=128,
        prefill_windows_per_step=4, spec_draft=4, chunk_steps=1, **SERVING)
    return {"E3": e3, "E5": e5}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from merlin_tpu_torch.ops import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    _build.lib()
    log(f"setup: kernels built and loaded in {time.perf_counter() - t0:.1f} s")

    gen = torch.Generator(device="cuda").manual_seed(0)
    rng = np.random.default_rng(0)
    b1 = check_b1(gen)
    b2 = check_b2(gen)
    paged = check_paged(gen)
    paged.update(check_paged_q8(gen))
    check_reference(rng)
    model, cfg = build_full_model()
    fwd_counts, _ = run_forward(model, cfg, rng)
    g = run_generation(model, cfg, rng)
    served = serve_vicuna(model, rng)
    qmodel = build_int8_vicuna(model, cfg)
    del model                         # the int8 LM replaces the bf16 one
    gc.collect()
    torch.cuda.empty_cache()
    served["E4"] = serve_vicuna_int8(qmodel, rng)
    del qmodel                        # E3's model replaces the 7B one
    gc.collect()
    torch.cuda.empty_cache()
    served.update(serve_baichuan(rng))
    b1["launches"], b2["launches"] = fwd_counts["B1"], fwd_counts["B2"]
    b1["launches_generation"] = g["counts"]["B1"]
    b2["launches_generation"] = g["counts"]["B2"]
    # a paged kernel's launches come from the engine run of its path; B9
    # is on no path (the decoder's int8 token step calls B7 at s_q = 1,
    # the same CUDA kernel), so its count stays 0
    for name, run in (("B3", "E1"), ("B4", "E3"), ("B5", "E2"),
                      ("B6", "E2"), ("B7", "E4"), ("B7w", "E5"),
                      ("B8", "E4"), ("B9", "E4")):
        paged[name]["launches"] = served[run][0][name]
    rows = [b1, b2] + [paged[k] for k in ("B3", "B4", "B5", "B6", "B7",
                                          "B7w", "B8", "B9")]
    for row in rows:
        key = row["name"].split()[0]
        row["launches_serving"] = {e: served[e][0][key] for e in served}
    log(json.dumps({"serving": {e: served[e][1] for e in served}}))
    log(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
