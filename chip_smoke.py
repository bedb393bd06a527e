"""On-card smoke run of the PyTorch/CUDA port (``merlin_tpu_torch``).

Drives the port's paths once on one NVIDIA GPU, through the entry points
a user calls, at the full width of CLIP ViT-L/14-448 + Vicuna-7B (all 32
decoder layers, random bf16 weights from a seed, and the same weights with
the LM quantized to int8) and of Baichuan-13B:

  1. setup      - card name and power limit; build the CUDA kernels from
                  ``merlin_tpu_torch/csrc`` (nvcc, sm_90a) and print what
                  ptxas reported for the backward kernel (registers,
                  spills);
  2. kernels    - each kernel (B1-B9) against its plain PyTorch version on
                  the card at its path's shapes (and edge cases: GQA, ALiBi,
                  ragged lengths over permuted page tables, hkv = 40), with
                  times, the bound from the shapes, and one PyTorch library
                  call as a yardstick where one exists (SDPA pinned to its
                  flash backend and to the unpinned dispatcher's pick, each
                  timed in alternating pairs of runs with the kernel, the
                  faster backend the yardstick); a planted fault (the
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
  7. backward   - the training kernels against their plain versions on the
                  card, each fed its forward kernel's out and LSE as on the
                  path: B2 then the fused backward (B10 dq + B11 dk, dv in
                  one kernel) at the decoder's (1, 2048, 32, 128) causal
                  with a padded tail, GQA 8/2 + ALiBi, non-causal, and
                  causal with fewer queries than keys; B12 (one-pass
                  forward with its LSE) then B13 (the fused kernel,
                  non-causal) at the tower's (8, 1025, 16, 64); a second
                  run gives dk/dv bit-identical and dq within tolerance
                  (C17); the whole backward against SDPA's on the same
                  inputs (as above, 5 alternating pairs of runs per
                  backend), and its host time per call; a dropped last
                  key tile (dq) and last query tile (dk/dv) must fail;
                  the gap of trap C13 (the bf16 cotangent of DenseGeneral's
                  backward) at a Vicuna MLP projection;
  8. T0         - a narrow MMGPT takes one training forward and backward on
                  the card (B2, the fused B10 + B11, B12, B13) and on the
                  CPU (plain path), both bf16 from the same f32 weights:
                  loss, grad norm and every parameter's gradient must
                  agree;
  9. T1         - ``Trainer.train`` runs pretrain.sh's recipe (nothing
                  frozen, LLRD, remat, cosine 5e-5, AdamW b2 0.95, wd 0.05,
                  clip 1.0, ctx 2048) on CLIP ViT-L/14-448 + Vicuna-7B width
                  with the LM cut to 8 layers (f32 AdamW over 32 needs ~108
                  GB), accum 2, 4 steps: the first loss near ln(vocab), step
                  2 equal to step 1 (lr 0 at count 0), step 4 below step 2,
                  exact launch counts; then one more step timed alone and
                  one under ``torch.profiler`` for the card's time per
                  kernel family;
 10. T2         - the same at all 32 LM layers with the LM frozen but its
                  new-token embedding rows (2 steps): the LM stays
                  bit-identical but those rows, the tower and projector move.

Prints the serving and training readings and the kernel table as JSON
lines before the last, and as the last
line ``{"ok": true, "device": {...}}``. Any failure exits non-zero before
that line. Needs a CUDA card; exits 2 without one.

    python3 chip_smoke.py
"""

from __future__ import annotations

import collections
import copy
import dataclasses
import gc
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel

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
FLASH_BWD_SOURCE = "merlin_tpu_torch/csrc/flash_attention_bwd.cu"
B10_REPLACES = "merlin_tpu/ops/flash_attention.py:365"
B11_REPLACES = "merlin_tpu/ops/flash_attention.py:398"
B12_REPLACES = "merlin_tpu/ops/onepass_attention.py:254"
B13_REPLACES = "merlin_tpu/ops/onepass_attention.py:407"


def log(msg: str) -> None:
    print(msg, flush=True)


SLEEP_CYCLES = 100_000_000    # ~50 ms of the card's clock


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one call, by CUDA events over ``iters`` calls.
    The card first spins ``SLEEP_CYCLES`` while the host queues the calls
    behind it, so the calls run back to back and the reading is the card's
    time alone: a call whose host work outlasts its device time (SDPA's
    backward through autograd, on a loaded host) would otherwise read the
    host's pace. A host that queues for longer than the card slept is
    reported."""
    for _ in range(warmup):
        fn()
    slept = torch.cuda.Event(enable_timing=True)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    slept.record()
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    queued_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    torch.cuda.synchronize()
    if queued_ms > slept.elapsed_time(start):
        log(f"time_ms: the host took {queued_ms:.1f} ms to queue {iters} "
            f"calls, longer than the card slept "
            f"({slept.elapsed_time(start):.1f} ms): host-paced in part")
    return start.elapsed_time(end) / iters


def host_us(fn, calls: int = 50) -> float:
    """Host time of one call of ``fn``, in microseconds: ``calls`` calls
    issued back to back after a sync, timed on the host clock before the
    closing sync. It is the call's own host work (checks, allocations, the
    ctypes call, the launches) as long as the card takes longer per call,
    so that the host never waits on it."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


# SDPA's backends by a piece of the name of the backward node each builds
SDPA_NODES = (("Cudnn", SDPBackend.CUDNN_ATTENTION),
              ("Flash", SDPBackend.FLASH_ATTENTION),
              ("Efficient", SDPBackend.EFFICIENT_ATTENTION))


def sdpa_backends(q, k, v, **kw):
    """The backends SDPA is timed on for (b, h, s, d) inputs: PyTorch's
    flash kernels, and the unpinned dispatcher's pick where it is another
    (read from the backward node it builds). Returns them and that node's
    name."""
    qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
    node = type(F.scaled_dot_product_attention(
        qg, kg, vg, **kw).grad_fn).__name__
    pick = next((be for key, be in SDPA_NODES if key in node), None)
    flash = SDPBackend.FLASH_ATTENTION
    return [flash] + ([pick] if pick not in (None, flash) else []), node


def vs_sdpa(fn, lib_for, q, k, v, runs: int = 5, **kw):
    """``fn`` against SDPA on the same (b, h, s, d) inputs, like for like.
    For each backend of ``sdpa_backends``: ``runs`` pairs of ``time_ms``
    runs (20 calls each after 10 warm-up calls) of ``fn`` and of
    ``lib_for(backend)`` with that backend pinned, the two runs of a pair
    back to back and which goes first alternating, so both see the card in
    the same clock state. The yardstick is the backend with the lowest
    median. Returns its pairing (each median with its sorted runs, the
    median of the per-pair ratios fn / SDPA with the sorted ratios), its
    name, the unpinned node's name and every backend's median."""
    backends, node = sdpa_backends(q, k, v, **kw)
    readings = {}
    for be in backends:
        lib_fn = lib_for(be)

        def lib_run():
            with sdpa_kernel(be):
                return time_ms(lib_fn, iters=20, warmup=10)

        ours, lib = [], []
        for i in range(runs):
            pair = ((lambda: time_ms(fn, iters=20, warmup=10), ours),
                    (lib_run, lib))
            for run, times in (pair if i % 2 == 0 else pair[::-1]):
                times.append(run())
        ratios = sorted(a / b for a, b in zip(ours, lib))
        ours, lib = sorted(ours), sorted(lib)
        readings[be.name] = dict(ms=ours[runs // 2], runs=ours,
                                 lib_ms=lib[runs // 2], lib_runs=lib,
                                 ratio=ratios[runs // 2], ratios=ratios)
    best = min(readings, key=lambda n: readings[n]["lib_ms"])
    return dict(readings[best], backend=best, unpinned=node,
                by_backend={n: r["lib_ms"] for n, r in readings.items()})


def sdpa_fwd(q, k, v, **kw):
    """``lib_for`` of SDPA's forward on (b, s, h, d) inputs, and those
    inputs as SDPA takes them."""
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    return (lambda be: lambda: F.scaled_dot_product_attention(
        qt, kt, vt, **kw)), (qt, kt, vt)


def sdpa_bwd(q, k, v, do, **kw):
    """``lib_for`` of SDPA's backward on (b, s, h, d) inputs (dq, dk, dv of
    one forward built on the given backend, its graph kept), and those
    inputs as SDPA takes them."""
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    dot = do.transpose(1, 2)

    def lib_for(be):
        with sdpa_kernel(be):
            out = F.scaled_dot_product_attention(qt, kt, vt, **kw)
        return lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                           retain_graph=True)

    return lib_for, (qt, kt, vt)


def sdpa_text(p, what="kernel") -> str:
    """A ``vs_sdpa`` reading as one line."""
    return (f"{what} {p['ms']:.4f} ms (runs {runs_text(p['runs'])}) "
            f"against sdpa {p['lib_ms']:.4f} ms on {p['backend']} (runs "
            f"{runs_text(p['lib_runs'])}; medians by backend "
            + ", ".join(f"{n} {t:.4f}" for n, t in p["by_backend"].items())
            + f"; the unpinned dispatcher builds {p['unpinned']}), in "
            f"alternating pairs: ratio {p['ratio']:.3f} (pairs "
            f"{runs_text(p['ratios'])})")


def sdpa_fields(p, ms_key="ms") -> dict:
    return {ms_key: p["ms"], ms_key + "_runs": p["runs"],
            "library_ms": p["lib_ms"], "library_ms_runs": p["lib_runs"],
            "library_backend": p["backend"],
            "library_ms_by_backend": p["by_backend"],
            "unpinned_backend": p["unpinned"],
            "ratio_to_library": p["ratio"], "ratio_runs": p["ratios"]}


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


def grad_err(got, want):
    """``out_err`` for a gradient: each row's error as a share of its max
    |plain|, with that max floored at 2^-10 of the tensor's largest: a row
    whose gradient cancels to ~0 (query 0 sees only key 0, so ds = p (dp -
    di) is 0 up to the f32 summation order of dp and di) has no scale of
    its own."""
    diff = (got.float() - want.float()).abs()
    row = want.float().abs().amax(-1)
    floor = row.max().clamp_min(1e-30) * 2.0 ** -10
    rel = (diff.amax(-1) / row.clamp_min(floor)).max()
    return diff.max().item(), rel.item()


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
    lib_for, qkv = sdpa_fwd(q1, k1, v1)
    p = vs_sdpa(lambda: onepass_attention(q1, k1, v1), lib_for, *qkv)
    plain = time_ms(lambda: onepass_attention_plain(q1, k1, v1), iters=5)
    bms, by = bound_ms(4.0 * b * h * s * s * d, nbytes(q1, k1, v1, out1))
    log(f"B1 (1, {s}, {h}, {d}) bf16: " + sdpa_text(p) + f", plain "
        f"{plain:.4f} ms, bound {bms:.4f} ms ({by})")
    return dict(name="B1 onepass_attention", route="cuda", source=B1_SOURCE,
                replaces=B1_REPLACES, max_abs_err=max(r[0] for r in rows),
                plain_ms=plain, bound_ms=bms, bound_by=by, shape=[b, s, h, d],
                **sdpa_fields(p))


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
    lib_for, qkv = sdpa_fwd(q, k, v, is_causal=True)
    p = vs_sdpa(lambda: flash_attention(q, k, v, causal=True), lib_for,
                *qkv, is_causal=True)
    plain = time_ms(lambda: flash_attention_plain(q, k, v, causal=True),
                    iters=5)
    pairs = sq * (sq + 1) / 2          # visible (q, k) pairs, causal
    bms, by = bound_ms(4.0 * bq * hq * pairs * dq, nbytes(q, k, v, out, lse))
    log(f"B2 {shape} causal bf16: " + sdpa_text(p) + f", plain {plain:.4f} "
        f"ms, bound {bms:.4f} ms ({by})")
    return dict(name="B2 flash_attention_fwd", route="cuda",
                source=B2_SOURCE, replaces=B2_REPLACES,
                max_abs_err=max(errs), plain_ms=plain, bound_ms=bms,
                bound_by=by, shape=list(shape), **sdpa_fields(p))


def runs_text(times) -> str:
    return ", ".join(f"{t:.4f}" for t in times)


def visible_pairs(sq, skv, causal, seg_q=None, seg_kv=None) -> int:
    """(query, key) pairs the mask lets through, over one batch row."""
    qi = torch.arange(sq, device="cuda")[:, None]
    ki = torch.arange(skv, device="cuda")[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device="cuda")
    if causal:
        mask &= ki <= qi
    if seg_q is not None:
        mask &= seg_q[0][:, None] == seg_kv[0][None, :]
    return int(mask.sum())


def check_grads(tag, got, want, errs):
    """Each of (dq, dk, dv) held per row to ``OUT_RTOL`` against its plain
    version; the largest abs errors join ``errs`` under B10 (dq) and B11
    (dk, dv)."""
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        err, rel = grad_err(g, w)
        log(f"{tag} {name}: max_abs_err {err:.3e}, row error {rel:.3e} (tol "
            f"{OUT_RTOL:.3e})")
        if not (rel <= OUT_RTOL and torch.isfinite(g.float()).all()):
            raise AssertionError(f"{tag} {name} disagrees: {err} {rel}")
        errs["B10" if name == "dq" else "B11"].append(err)


def check_rerun(tag, fn, first):
    """A second run of the fused kernel on the same inputs: dk and dv are
    summed inside one CTA, so they must be bit-identical; dq is summed
    across CTAs by f32 atomics in an order that varies (trap C17), so it
    is held per row to ``OUT_RTOL`` against the first run. Returns dq's
    largest difference."""
    again = fn()
    torch.cuda.synchronize()
    diff, rel = grad_err(again[0], first[0])
    same = torch.equal(again[1], first[1]) and torch.equal(again[2], first[2])
    log(f"{tag} second run: dq max |difference| {diff:.3e}, row {rel:.3e} "
        f"(tol {OUT_RTOL:.3e}); dk and dv bit-identical: {same}")
    if not (rel <= OUT_RTOL and same):
        raise AssertionError(f"{tag}: second run differs: {diff} {same}")
    return diff


def check_flash_bwd(gen, b2_row):
    """The fused backward (B10 + B11 in one kernel) against its plain
    versions, fed the out and LSE of B2 run on the same inputs (B2 is held
    to its plain version there too; its largest error joins ``b2_row``):
    the decoder's training shape (1, 2048, 32, 128) causal with segment ids
    from an attention mask whose last 300 positions are padding, a GQA 8/2
    + ALiBi case with a ragged length, a non-causal case, and a causal case
    with fewer queries than keys (whose last key tiles see no query). Each
    case runs ``flash_attention_bwd`` (di from its pre-pass, as
    ``FlashAttentionFn`` runs it) and the B10 and B11 wrappers (di given),
    each held per row, as a share of the row's max |plain|, to
    ``OUT_RTOL``; a second run must give dk/dv bit-identical and dq within
    tolerance; a dropped last key tile (dq) and a dropped last query tile
    (dk/dv) must fail the check. Then times: the fused launch at the padded
    shape, its host time per call, and the whole backward against SDPA's on
    SDPA's own inputs (causal, no segments). Returns the B10 and B11
    rows."""
    from merlin_tpu_torch.ops import flash_attention as fa

    errs = {"B2": [], "B10": [], "B11": []}

    def inputs(b, s, h, hkv, d, skv=None):
        q = torch.randn((b, s, h, d), generator=gen, device="cuda")
        k, v = (torch.randn((b, skv or s, hkv, d), generator=gen,
                            device="cuda") for _ in range(2))
        do = torch.randn((b, s, h, d), generator=gen, device="cuda")
        return [t.to(torch.bfloat16) for t in (q, k, v, do)]

    def compare(tag, q, k, v, do, **kw):
        # B2 first, held to its plain version; its out and LSE then feed
        # the fused backward and its plain version, as in FlashAttentionFn
        out, lse = fa.flash_attention(q, k, v, **kw)
        want_out, want_lse = fa.flash_attention_plain(q, k, v, **kw)
        torch.cuda.synchronize()
        err, rel = out_err(out, want_out)
        lerr = (lse - want_lse).abs().max().item()
        log(f"B2 {tag}: max_abs_err {err:.3e}, row error {rel:.3e} (tol "
            f"{OUT_RTOL:.3e}), lse {lerr:.3e} (tol {LSE_TOL})")
        if not (rel <= OUT_RTOL and lerr <= LSE_TOL
                and torch.isfinite(out.float()).all()):
            raise AssertionError(f"B2 {tag} disagrees: {err} {rel} {lerr}")
        errs["B2"].append(err)
        got = fa.flash_attention_bwd(q, k, v, out, lse, do, **kw)
        want = fa.flash_attention_bwd_plain(q, k, v, out, lse, do, **kw)
        torch.cuda.synchronize()
        check_grads(f"B10/B11 fused {tag}", got, want, errs)
        di = fa.attention_di(out, do)
        split = (fa.flash_attention_bwd_dq(q, k, v, do, lse, di, **kw),
                 *fa.flash_attention_bwd_dkv(q, k, v, do, lse, di, **kw))
        torch.cuda.synchronize()
        check_grads(f"B10/B11 wrappers {tag}", split, want, errs)
        return out, lse, di, got, want

    b, s, h, d = 1, 2048, 32, 128
    q, k, v, do = inputs(b, s, h, h, d)
    seg = torch.ones((b, s), dtype=torch.int32, device="cuda")
    seg[:, s - 300:] = 0
    kw = dict(causal=True, segment_ids_q=seg, segment_ids_kv=seg)
    out, lse, di, got, want = compare(
        "(1, 2048, 32, 128) causal, last 300 padding", q, k, v, do, **kw)
    rerun = check_rerun(
        "B10/B11 fused (1, 2048, 32, 128)",
        lambda: fa.flash_attention_bwd(q, k, v, out, lse, do, **kw), got)
    # planted faults: keys 1984.. left out of dq; queries 1984.. left out
    # of dk/dv (the keys only they see lose everything)
    cut = s - 64
    dq_bad = fa.flash_attention_bwd_dq(
        q, k[:, :cut], v[:, :cut], do, lse, di, causal=True,
        segment_ids_q=seg, segment_ids_kv=seg[:, :cut].contiguous())
    dkv_bad = fa.flash_attention_bwd_dkv(
        q[:, :cut], k, v, do[:, :cut], lse[..., :cut].contiguous(),
        di[..., :cut].contiguous(), causal=True,
        segment_ids_q=seg[:, :cut].contiguous(), segment_ids_kv=seg)
    torch.cuda.synchronize()
    for name, got_bad, ref, what in (
            ("B10", dq_bad, want[0], "last key tile dropped from dq"),
            ("B11", dkv_bad[0], want[1], "last query tile dropped from dk"),
            ("B11", dkv_bad[1], want[2], "last query tile dropped from dv")):
        rel = grad_err(got_bad, ref)[1]
        log(f"{name} planted fault ({what}): row error {rel:.3e}, must "
            f"exceed {OUT_RTOL:.3e}")
        if not rel > OUT_RTOL:
            raise AssertionError(f"{name}: the check cannot see: {what}")

    qg, kg, vg, dog = inputs(2, 200, 8, 2, 128)
    slopes = torch.tensor([2.0 ** -(i + 1) for i in range(8)], device="cuda")
    seg_g = torch.ones((2, 200), dtype=torch.int32, device="cuda")
    seg_g[1, 150:] = 0
    for causal in (True, False):
        compare(f"(2, 200, 8/2 heads, 128) alibi, segments, causal={causal}",
                qg, kg, vg, dog, causal=causal, alibi_slopes=slopes,
                segment_ids_q=seg_g, segment_ids_kv=seg_g)
    qn, kn, vn, don = inputs(2, 300, 4, 4, 64)
    compare("(2, 300, 4, 64) non-causal", qn, kn, vn, don, causal=False)
    # 130 queries over 300 keys, causal: the key tiles from 192 on see no
    # query, run no step and must write zero dk, dv
    qs, ks, vs, dos = inputs(2, 130, 4, 2, 128, skv=300)
    compare("(2, 130 queries, 300 keys, 4/2 heads, 128) causal", qs, ks, vs,
            dos, causal=True)

    # the fused launch at the padded training shape, as the LM path runs it
    ms = time_ms(lambda: fa.flash_attention_bwd(q, k, v, out, lse, do, **kw))
    host = host_us(lambda: fa.flash_attention_bwd(q, k, v, out, lse, do,
                                                  **kw))
    plain = time_ms(lambda: fa.flash_attention_bwd_plain(
        q, k, v, out, lse, do, **kw), iters=3, warmup=1)
    di_ms = time_ms(lambda: fa.attention_di(out, do))
    pairs = visible_pairs(s, s, True, seg, seg)
    bms, by = bound_ms(5 * 2.0 * b * h * pairs * d,
                       nbytes(q, k, v, do, out, lse) + 3 * nbytes(q))
    # like for like: the whole backward on SDPA's inputs (causal, no
    # segments), in alternating pairs of runs with SDPA's backward
    out_c, lse_c = fa.flash_attention(q, k, v, causal=True)
    lib_for, qkv = sdpa_bwd(q, k, v, do, is_causal=True)
    p = vs_sdpa(lambda: fa.flash_attention_bwd(q, k, v, out_c, lse_c, do,
                                               causal=True), lib_for, *qkv,
                is_causal=True)
    del lib_for, qkv
    b2_row["max_abs_err"] = max([b2_row["max_abs_err"]] + errs["B2"])
    log(f"B10/B11 fused (1, 2048, 32, 128) causal + padding bf16: one launch "
        f"{ms:.4f} ms (pre-pass with di, kernel, post-pass; plain {plain:.4f} "
        f"ms, 5-product bound {bms:.4f} ms {by}; attention_di alone "
        f"{di_ms:.4f} ms; host time {host:.1f} us a call); on SDPA's inputs "
        f"(causal, no padding): " + sdpa_text(p, "whole backward"))
    row = dict(route="cuda", source=FLASH_BWD_SOURCE,
               kernel="flash_bwd_kernel", wrapper="flash_attention_bwd",
               counter="B10+B11", ms=ms, plain_ms=plain, bound_ms=bms,
               bound_by=by, attention_di_ms=di_ms, host_us_per_call=host,
               rerun_dq_max_diff=rerun, shape=[b, s, h, d],
               **sdpa_fields(p, "whole_backward_ms"))
    return {"B10": dict(row, name="B10 flash_attention_bwd_dq",
                        replaces=B10_REPLACES, max_abs_err=max(errs["B10"])),
            "B11": dict(row, name="B11 flash_attention_bwd_dkv",
                        replaces=B11_REPLACES, max_abs_err=max(errs["B11"]))}


def check_onepass_train(gen):
    """B12 (the tower's forward with its LSE) and B13 (its backward, one
    launch of the fused kernel) against their plain versions at the
    training path's (8, 1025, 16, 64): 8 image slots a sample. B13 runs
    from B12's out (di from its pre-pass, as ``OnepassAttentionFn`` runs
    it); a second run as in ``check_rerun``; B12 against SDPA's forward and
    B13 against SDPA's backward in alternating pairs of runs. Returns the
    B12 and B13 rows."""
    from merlin_tpu_torch.ops import onepass_attention as oa
    from merlin_tpu_torch.ops.flash_attention import attention_di

    shape = (8, 1025, 16, 64)
    q, k, v = (layer_normed(shape, gen) for _ in range(3))
    do = torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    out, lse = oa.onepass_attention_lse(q, k, v)
    want, want_lse = oa.onepass_attention_lse_plain(q, k, v)
    torch.cuda.synchronize()
    err12, rel = out_err(out, want)
    lerr = (lse - want_lse).abs().max().item()
    log(f"B12 {shape}: max_abs_err {err12:.3e}, row error {rel:.3e} (tol "
        f"{OUT_RTOL:.3e}), lse {lerr:.3e} (tol {LSE_TOL})")
    if not (rel <= OUT_RTOL and lerr <= LSE_TOL):
        raise AssertionError(f"B12 disagrees: {err12} {rel} {lerr}")
    # B13 and its plain version from B12's out and LSE, as OnepassAttentionFn
    di = attention_di(out, do)
    got = oa.onepass_attention_bwd(q, k, v, do, lse, out)
    ref = oa.onepass_attention_bwd_plain(q, k, v, do, lse, di)
    torch.cuda.synchronize()
    errs = {"B10": [], "B11": []}
    check_grads(f"B13 {shape}", got, ref, errs)
    err13 = max(errs["B10"] + errs["B11"])
    rerun = check_rerun(f"B13 {shape}", lambda: oa.onepass_attention_bwd(
        q, k, v, do, lse, out), got)

    b, s, h, d = shape
    lib_for, qkv = sdpa_fwd(q, k, v)
    p12 = vs_sdpa(lambda: oa.onepass_attention_lse(q, k, v), lib_for, *qkv)
    plain12 = time_ms(lambda: oa.onepass_attention_lse_plain(q, k, v),
                      iters=3, warmup=1)
    ms13 = time_ms(lambda: oa.onepass_attention_bwd(q, k, v, do, lse, out))
    host = host_us(lambda: oa.onepass_attention_bwd(q, k, v, do, lse, out))
    plain13 = time_ms(lambda: oa.onepass_attention_bwd_plain(
        q, k, v, do, lse, di), iters=3, warmup=1)
    lib_for, qkv = sdpa_bwd(q, k, v, do)
    p13 = vs_sdpa(lambda: oa.onepass_attention_bwd(q, k, v, do, lse, out),
                  lib_for, *qkv)
    del lib_for, qkv
    mm = 2.0 * b * h * s * s * d
    b12, by12 = bound_ms(2 * mm, nbytes(q, k, v, out, lse))
    b13, by13 = bound_ms(5 * mm, nbytes(q, k, v, do, out, lse) + 3 * nbytes(q))
    log(f"B12 {shape} bf16: " + sdpa_text(p12) + f", plain {plain12:.4f} "
        f"ms, bound {b12:.4f} ms ({by12}); B13: fused launch {ms13:.4f} ms, "
        f"plain {plain13:.4f} ms, bound {b13:.4f} ms ({by13}), host time "
        f"{host:.1f} us a call; B13 from out: "
        + sdpa_text(p13, "whole backward"))
    return {"B12": dict(name="B12 onepass_attention_lse", route="cuda",
                        source=B1_SOURCE, replaces=B12_REPLACES,
                        max_abs_err=err12, plain_ms=plain12, bound_ms=b12,
                        bound_by=by12, shape=list(shape), **sdpa_fields(p12)),
            "B13": dict(name="B13 onepass_attention_bwd", route="cuda",
                        source=FLASH_BWD_SOURCE, replaces=B13_REPLACES,
                        kernel="flash_bwd_kernel",
                        wrapper="onepass_attention_bwd",
                        max_abs_err=err13, ms=ms13, plain_ms=plain13,
                        bound_ms=b13, bound_by=by13, host_us_per_call=host,
                        rerun_dq_max_diff=rerun, shape=list(shape),
                        **sdpa_fields(p13, "whole_backward_ms"))}


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
    from merlin_tpu_torch.ops import flash_attention as fa
    from merlin_tpu_torch.ops import onepass_attention as oa
    from merlin_tpu_torch.ops import paged_attention as pa

    return {"B1": oa.onepass_attention, "B2": fa.flash_attention,
            "B3": pa.paged_attention_dma, "B4": pa.paged_attention,
            "B5": pa.paged_attention_dma_multi,
            "B6": pa.paged_attention_multi_blocked,
            "B7": pa.paged_attention_dma_q8,
            "B7w": pa.paged_attention_dma_multi_q8,
            "B8": pa.paged_attention_multi_blocked_q8,
            "B9": pa.paged_attention_quantized,
            "B10": fa.flash_attention_bwd_dq,
            "B11": fa.flash_attention_bwd_dkv,
            # the fused backward's entry on the LM path: dq, dk and dv
            # (B10 + B11) from one launch
            "B10+B11": fa.flash_attention_bwd,
            "B12": oa.onepass_attention_lse,
            "B13": oa.onepass_attention_bwd}


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


# ---------------------------------------------------------------------------
# phases 10-12: training
# ---------------------------------------------------------------------------

TRAIN_GRAD_RTOL = 1e-1       # T0, card vs CPU, both bf16: per parameter,
                             # max |grad difference| of max |CPU grad|
TRAIN_LOSS_RTOL = 1e-2       # T0 loss and grad_norm, card vs CPU
N_PAD = 300                  # padded positions at the end of a T1/T2 row


def train_batch(rng, tok_len, *, seq=2048, rows=2, slots=8, n_images=2,
                n_text=80, n_pad=N_PAD):
    """A host batch in the collator's format: ``rows`` samples (accum x
    micro), each ``<s>``, text, ``n_images`` ``<im_start><im_patch>x256
    <im_end>`` blocks with text after each (two: the tracking template) and
    the answer, then ``n_pad`` padding positions; labels -100 over the
    prompt and the padding; ``images`` uint8, ``n_images`` real frames and
    ``slots - n_images`` zero slots per sample."""
    valid = seq - n_pad
    ids = np.zeros((rows, seq), np.int32)
    labels = np.full((rows, seq), -100, np.int32)
    for r in range(rows):
        p = prompt(rng, n_text, n_images, tok_len)
        answer = rng.integers(10, 31000, size=valid - len(p))
        ids[r, :valid] = np.concatenate([p, answer])
        labels[r, len(p):valid] = answer
    mask = np.zeros((rows, seq), np.int32)
    mask[:, :valid] = 1
    images = np.zeros((rows, slots, 448, 448, 3), np.uint8)
    images[:, :n_images] = rng.integers(
        0, 256, size=(rows, n_images, 448, 448, 3), dtype=np.uint8)
    return dict(input_ids=ids, labels=labels, attention_mask=mask,
                segment_ids=mask.copy(), images=images)


def check_train_reference(rng):
    """T0: a narrow MMGPT (LM heads of d = 128, tower heads of d = 64, s =
    384 with 32 padding positions, one image) takes one training step's
    forward and backward on the card through the kernels (B2, B10, B11,
    B12, B13), and the same weights and batch on the CPU through the plain
    path, both computing in bf16 from f32 parameters. Loss, grad norm and
    every parameter's gradient must agree."""
    from merlin_tpu_torch.models.bridge import init_params
    from merlin_tpu_torch.models.families import tiny
    from merlin_tpu_torch.models.mmgpt import MMGPT
    from merlin_tpu_torch.models.vit import tiny_vit
    from merlin_tpu_torch.train.optimizer import global_norm
    from merlin_tpu_torch.train.step import make_loss_fn

    lm = tiny(vocab_size=32128, hidden_size=256, intermediate_size=512,
              num_layers=2, num_heads=2, remat=True, dtype=torch.bfloat16)
    vit = tiny_vit(hidden_size=128, num_heads=2, intermediate_size=256,
                   num_layers=3, patch_size=14, image_size=448,
                   dtype=torch.bfloat16)
    cfg = mm_config(lm, vit)
    with torch.device("meta"):
        card = MMGPT(cfg)
    init_params(card, torch.Generator(device="cuda").manual_seed(7),
                std=0.05, dtype=torch.float32, device="cuda",
                requires_grad=True)
    with torch.no_grad():
        # unit norm scales keep activations O(1), so the tolerances mean
        # something
        for name, p in card.named_parameters():
            if name.endswith("norm.scale") or name.endswith("norm1.scale") \
                    or name.endswith("norm2.scale"):
                p.fill_(1.0)
    models = {"card": (card, "cuda"),
              "host": (copy.deepcopy(card).cpu(), "cpu")}
    host = train_batch(rng, cfg.image_token_len, seq=384, rows=1, slots=1,
                       n_images=1, n_text=40, n_pad=32)
    grads, losses = {}, {}
    for where, (model, device) in models.items():
        batch = {k: torch.from_numpy(v).to(device) for k, v in host.items()}
        reset_counts()
        loss = make_loss_fn(model)(batch)
        loss.backward()
        if where == "card":
            torch.cuda.synchronize()
            counts = read_counts()
        losses[where] = loss.item()
        grads[where] = {n: p.grad.float().cpu()
                        for n, p in model.named_parameters()}
    norms = {d: global_norm(g.values()).item() for d, g in grads.items()}
    worst, worst_name, kbias = 0.0, "", 0.0
    for name, want in grads["host"].items():
        got = grads["card"][name]
        if name.endswith("k_proj.bias"):
            # zero in exact arithmetic (softmax ignores a per-query
            # constant): both sides hold rounding noise, held below
            # ``TRAIN_GRAD_RTOL`` of the key kernel's largest gradient
            kernel = grads["host"][name[:-len("bias")] + "kernel"]
            kbias = max(kbias, (got.abs().max() + want.abs().max()).item()
                        / kernel.abs().max().item())
            continue
        rel = ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)
               ).item()
        if rel > worst:
            worst, worst_name = rel, name
    loss_rel = abs(losses["card"] - losses["host"]) / abs(losses["host"])
    norm_rel = abs(norms["card"] - norms["host"]) / norms["host"]
    want_counts = launches(B2=4, B12=2, B13=2, **{"B10+B11": 2})
    log(f"T0 narrow train step, card (kernels) vs CPU (plain), bf16: loss "
        f"{losses['card']:.6f} vs {losses['host']:.6f} (rel {loss_rel:.3e}), "
        f"grad norm {norms['card']:.6f} vs {norms['host']:.6f} (rel "
        f"{norm_rel:.3e}), tol {TRAIN_LOSS_RTOL}; worst parameter gradient "
        f"{worst:.3e} of its max |CPU grad| ({worst_name}, tol "
        f"{TRAIN_GRAD_RTOL}); key biases (zero in exact arithmetic) "
        f"{kbias:.3e} of the key kernels' max gradient; launches {counts}")
    if not (loss_rel <= TRAIN_LOSS_RTOL and norm_rel <= TRAIN_LOSS_RTOL
            and worst <= TRAIN_GRAD_RTOL and kbias <= TRAIN_GRAD_RTOL
            and counts == want_counts):
        raise AssertionError(f"T0 failed: {loss_rel} {norm_rel} {worst} "
                             f"{counts}")
    return dict(loss_rel=loss_rel, grad_norm_rel=norm_rel,
                worst_grad_rel=worst, worst_grad=worst_name,
                key_bias_rel=kbias)


def build_train_model(n_layers):
    """CLIP ViT-L/14-448 (23 of 24 layers run) + conv projector + Vicuna-7B
    width cut to ``n_layers``, remat on, f32 trainable parameters N(0,
    1)*0.02 from seed 0, bf16 compute."""
    from merlin_tpu_torch.models.bridge import init_params
    from merlin_tpu_torch.models.families import vicuna_7b
    from merlin_tpu_torch.models.mmgpt import MMGPT
    from merlin_tpu_torch.models.vit import clip_vit_l14

    lm = dataclasses.replace(vicuna_7b(), vocab_size=32128,
                             num_layers=n_layers, remat=True)
    cfg = mm_config(lm, clip_vit_l14(448))
    t0 = time.perf_counter()
    with torch.device("meta"):
        model = MMGPT(cfg)
    init_params(model, torch.Generator(device="cuda").manual_seed(0),
                dtype=torch.float32, device="cuda", requires_grad=True)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in model.parameters())
    log(f"train model ({n_layers} LM layers): {n / 1e9:.3f} B f32 parameters "
        f"on the card in {time.perf_counter() - t0:.1f} s")
    return model


def train_args(**kw):
    """pretrain.sh's recipe: llrd, remat, bf16, ctx 2048, batch 1, cosine
    5e-5 with warmup_ratio 0.01, b2 0.95, wd 0.05, clip 1.0."""
    from merlin_tpu_torch.train.arguments import TrainingArguments

    base = dict(output_dir="output/chip_smoke_train",
                per_device_train_batch_size=1,
                learning_rate=5e-5, adam_beta2=0.95, weight_decay=0.05,
                max_grad_norm=1.0, warmup_ratio=0.01,
                lr_scheduler_type="cosine", model_max_length=2048,
                gradient_checkpointing=True, bf16=True, llrd=True,
                save_steps=0, logging_steps=1)
    base.update(kw)
    return TrainingArguments(**base)


def run_training(tag, model, model_args, targs, steps, rng):
    """Train ``steps`` steps through ``Trainer.train`` on one repeated batch
    with the launch counts set to 0 just before and read just after.
    Returns (per-step metrics, launch counts, peak bytes)."""
    from merlin_tpu_torch.models.builder import make_bundle
    from merlin_tpu_torch.train.trainer import Trainer

    bundle = make_bundle(model, model_args, orig_vocab_size=32000)
    trainer = Trainer(bundle, targs, device="cuda")
    trainer.init_state()
    batch = train_batch(rng, model.cfg.image_token_len,
                        rows=targs.gradient_accumulation_steps)
    seen = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    trainer.train(iter([batch] * steps), num_steps=steps,
                  log_fn=lambda step, m: seen.append(m))
    torch.cuda.synchronize()
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    for i, m in enumerate(seen):
        log(f"{tag} step {i + 1}: loss {m['loss']:.7f}, grad_norm "
            f"{m['grad_norm']:.4f}, update_norm {m['update_norm']:.4e}, lr "
            f"{m['lr']:.3e}, step {m['step_time_s']:.3f} s, "
            f"{m.get('tokens_per_sec', float('nan')):.1f} tok/s, mfu "
            f"{m.get('mfu', float('nan')):.4f} (host clock; 8ND estimate at "
            f"989 TFLOP/s)")
    log(f"{tag}: launches {counts}, peak memory {peak} bytes "
        f"(torch.cuda.max_memory_allocated)")
    return seen, counts, peak, profile_step(
        tag, trainer, batch, seen[-1]["step_time_s"] * 1e3)


# the ops whose FLOPs the profiler counts as matmul work
MATMUL_OPS = ("aten::mm", "aten::addmm", "aten::bmm", "aten::baddbmm")
# kernel families of a training step, by a piece of the kernel's name
FAMILIES = (("B10/B11/B13 attention backward",   # fused kernel, pre- and
             ("flash_bwd_",)),                   # post-pass
            ("B2 flash forward", ("flash_attention_fwd_kernel",)),
            ("B12 one-pass forward", ("onepass_attention_kernel",)),
            ("matmuls (cuBLAS)", ("gemm", "nvjet", "xmma", "cutlass")),
            ("optimizer (foreach)", ("multi_tensor_apply",)),
            # dtype casts: the f32 weights to bf16 at each use, the bf16
            # weight gradients back to f32
            ("casts", ("direct_copy_kernel", "bfloat16_copy_kernel")),
            ("copies", ("Memcpy", "Memset")))


def profile_step(tag, trainer, batch, plain_step_ms):
    """One more step through ``Trainer.train`` under ``torch.profiler``,
    after the checked run: the card's time per kernel family, and its idle
    share of the step (1 - the summed kernel time over the host-clock time
    of the step; one stream, so kernels do not overlap). The profiler's own
    host cost lengthens the traced step, so the busy time is also given as
    a share of ``plain_step_ms``, the last step of the checked run, and of
    one more unprofiled step taken just before the traced one. The device
    rows the trace holds are counted too: at a step's time, that count
    says how much host time each launch could take before the host, and
    not the card, set the step's pace."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.train(iter([batch]), num_steps=trainer.step + 1)
    torch.cuda.synchronize()
    again_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 with_flops=True) as prof:
        t0 = time.perf_counter()
        trainer.train(iter([batch]), num_steps=trainer.step + 1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    fams = {name: 0.0 for name, _ in FAMILIES}
    fams["other elementwise and reductions"] = 0.0
    others = []
    mm_flops = 0
    n_device = 0
    for ev in prof.key_averages():
        if ev.key in MATMUL_OPS:
            mm_flops += ev.flops
        # kernel and copy rows only: a CPU op's row repeats the device time
        # of the kernels it launched
        ms = ev.self_device_time_total / 1e3
        if ev.device_type != torch.autograd.DeviceType.CUDA or ms <= 0:
            continue
        n_device += ev.count
        fam = next((name for name, keys in FAMILIES
                    if any(k in ev.key for k in keys)), None)
        if fam is None:
            fam = "other elementwise and reductions"
            others.append((ms, ev.count, ev.key[:110]))
        fams[fam] += ms
    busy = sum(fams.values())
    if busy <= 0:
        raise AssertionError(f"{tag}: the trace holds no device time")
    log(f"{tag} profile (one more step under torch.profiler): step "
        f"{wall * 1e3:.1f} ms (host clock), card busy {busy:.1f} ms, idle "
        f"share {1 - busy / (wall * 1e3):.3f} (busy "
        f"{busy / plain_step_ms:.3f} of the unprofiled {plain_step_ms:.1f} ms "
        f"step, {busy / again_ms:.3f} of a repeat of it, {again_ms:.1f} ms); "
        f"{n_device} kernels and copies, {again_ms / n_device * 1e3:.2f} us "
        f"of the repeated step each; " + ", ".join(
            f"{k} {v:.1f} ms" for k, v in fams.items()) + f"; matmul work "
        f"{mm_flops / 1e12:.2f} TFLOP (the profiler's count), "
        f"{mm_flops / fams['matmuls (cuBLAS)'] / 1e9:.1f} TFLOP/s over the "
        f"matmul kernels")
    for ms, count, key in sorted(others, reverse=True)[:8]:
        log(f"  {ms:.1f} ms in {count} launches: {key}")
    return dict(step_ms=wall * 1e3, busy_ms=busy,
                idle_share=1 - busy / (wall * 1e3),
                busy_of_unprofiled_step=busy / plain_step_ms,
                repeated_step_ms=again_ms,
                busy_of_repeated_step=busy / again_ms,
                device_launches=n_device,
                families_ms=fams, matmul_tflop=mm_flops / 1e12)


def run_t1(rng):
    """T1: the pretraining recipe at full width, LM cut to 8 layers (f32
    AdamW over 7B needs ~108 GB), accum 2, 4 steps."""
    from merlin_tpu_torch.train.arguments import ModelArguments

    model = build_train_model(8)
    seen, counts, peak, prof = run_training(
        "T1 recipe (8 LM layers, nothing frozen)", model, ModelArguments(),
        train_args(gradient_accumulation_steps=2, max_steps=4), 4, rng)
    losses = [m["loss"] for m in seen]
    want = launches(B2=128, B12=184, B13=184, **{"B10+B11": 64})
    first_ok = abs(losses[0] - math.log(32128)) <= 0.5
    same = abs(losses[1] - losses[0]) <= 1e-6 * abs(losses[0])
    finite = all(math.isfinite(m["grad_norm"]) for m in seen)
    log(f"T1 checks: first loss {losses[0]:.6f} vs ln(32128) "
        f"{math.log(32128):.6f} (within 0.5: {first_ok}); step 2 equals "
        f"step 1 at lr 0: {same}; step 4 below step 2: "
        f"{losses[3] < losses[1]}; grad norms finite: {finite}")
    if not (first_ok and same and losses[3] < losses[1] and finite
            and counts == want):
        raise AssertionError(f"T1 failed: {losses} {counts}")
    return dict(losses=losses, counts=counts, peak_bytes=peak,
                step_time_s=seen[-1]["step_time_s"],
                tokens_per_sec=seen[-1]["tokens_per_sec"],
                mfu=seen[-1]["mfu"], profile=prof)


def run_t2(rng):
    """T2: the reference's frozen-LM mode at full depth (32 layers): only
    the tower, the projector and the new-token embedding rows train; the
    backward still crosses every LM layer. 2 steps at accum 2."""
    from merlin_tpu_torch.train.arguments import ModelArguments

    model = build_train_model(32)
    lm_before = {n: p.detach().to("cpu", copy=True)
                 for n, p in model.lm.named_parameters()}
    moved_before = {n: p.detach().clone() for n, p in model.named_parameters()
                    if not n.startswith("lm.")}
    seen, counts, peak, prof = run_training(
        "T2 frozen LM (32 layers)", model,
        ModelArguments(freeze_lm_model=True, tune_im_start_end=True),
        train_args(gradient_accumulation_steps=2, max_steps=2), 2, rng)
    new_rows = [START_ID, PATCH_ID, END_ID]
    lm_same = True
    for n, p in model.lm.named_parameters():
        now, was = p.detach().cpu(), lm_before[n]
        if n == "embed_tokens.embedding":
            keep = torch.ones(now.shape[0], dtype=torch.bool)
            keep[32000:] = False
            lm_same &= torch.equal(now[keep], was[keep])
            rows_moved = bool((now[new_rows] != was[new_rows]).any(-1).all())
        else:
            lm_same &= torch.equal(now, was)
    # a key bias has no gradient in exact arithmetic (softmax ignores a
    # per-query constant) and no decay, so it need not move
    still = [n for n, p in model.named_parameters() if n in moved_before
             and not n.endswith("k_proj.bias")
             and torch.equal(p, moved_before[n])]
    want = launches(B2=256, B12=92, B13=92, **{"B10+B11": 128})
    log(f"T2 checks: LM bit-identical but the new-token rows: {lm_same}; "
        f"rows {new_rows} moved: {rows_moved}; tower and projector "
        f"parameters that did not move: {still}")
    if not (lm_same and rows_moved and not still and counts == want):
        raise AssertionError(f"T2 failed: {lm_same} {rows_moved} {still} "
                             f"{counts}")
    return dict(losses=[m["loss"] for m in seen], counts=counts,
                peak_bytes=peak, step_time_s=seen[-1]["step_time_s"],
                tokens_per_sec=seen[-1]["tokens_per_sec"],
                mfu=seen[-1]["mfu"], profile=prof)


def measure_c13(gen):
    """Trap C13: on the card ``MatmulF32``'s backward rounds the f32
    cotangent to bf16 before its two products; JAX contracts the f32
    cotangent. The gap between the two orders at an MLP projection of T1
    (2048 tokens, 4096 -> 11008), as max |difference| of max |f32 order|."""
    x = torch.randn((2048, 4096), generator=gen, device="cuda").to(
        torch.bfloat16)
    w = (torch.randn((4096, 11008), generator=gen, device="cuda")
         * 0.02).to(torch.bfloat16)
    g = torch.randn((2048, 11008), generator=gen, device="cuda") * 1e-3
    gaps = {}
    for name, fast, exact in (
            ("dx", g.to(torch.bfloat16) @ w.T,
             (g @ w.float().T).to(torch.bfloat16)),
            ("dw", x.T @ g.to(torch.bfloat16),
             (x.float().T @ g).to(torch.bfloat16))):
        gaps[name] = ((fast.float() - exact.float()).abs().max()
                      / exact.float().abs().max()).item()
    log(f"C13 cotangent rounded to bf16 before the backward's products, "
        f"against the f32 order (2048 x 4096 -> 11008): dx {gaps['dx']:.3e}, "
        f"dW {gaps['dw']:.3e} of max |f32 order|")
    return gaps


def ptxas_report(piece: str = "flash_bwd"):
    """Registers and spill bytes that ptxas reported while building the
    library, for each kernel whose (mangled) name holds ``piece``."""
    import re

    from merlin_tpu_torch.ops import _build

    report, current = {}, None
    for line in _build.ptxas_log().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            current = m.group(1) if piece in m.group(1) else None
            if current:
                report[current] = {}
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            report[current]["spill_store_bytes"] = int(m.group(1))
            report[current]["spill_load_bytes"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            report[current]["registers"] = int(m.group(1))
    return report


def free_cuda():
    gc.collect()
    torch.cuda.empty_cache()


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
    bwd_ptxas = ptxas_report()
    for name, info in bwd_ptxas.items():
        log(f"ptxas {name}: {info}")

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
    free_cuda()                       # training starts from an empty card
    trained = check_flash_bwd(gen, b2)
    trained.update(check_onepass_train(gen))
    c13 = measure_c13(gen)
    free_cuda()
    t0_reading = check_train_reference(rng)
    free_cuda()
    t1 = run_t1(rng)
    free_cuda()
    t2 = run_t2(rng)
    free_cuda()
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
    # B10 and B11 run on the LM path as one launch of the fused kernel
    # through flash_attention_bwd, whose count is theirs ("counter")
    for name in ("B10", "B11", "B12", "B13"):
        row = trained[name]
        row["launches"] = t1["counts"][row.get("counter", name)]
        if name != "B12":
            row["ptxas"] = bwd_ptxas
    rows = [b1, b2] + [paged[k] for k in ("B3", "B4", "B5", "B6", "B7",
                                          "B7w", "B8", "B9")] + [
        trained[k] for k in ("B10", "B11", "B12", "B13")]
    for row in rows:
        key = row.get("counter", row["name"].split()[0])
        row["launches_serving"] = {e: served[e][0][key] for e in served}
        row["launches_training"] = t1["counts"][key]
        row["launches_training_frozen_lm"] = t2["counts"][key]
    log(json.dumps({"serving": {e: served[e][1] for e in served}}))
    log(json.dumps({"training": {
        "T0": t0_reading, "C13": c13,
        "T1": {k: v for k, v in t1.items() if k != "counts"},
        "T2": {k: v for k, v in t2.items() if k != "counts"}}}))
    log(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
