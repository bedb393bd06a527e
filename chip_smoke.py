"""On-card smoke run of the PyTorch/CUDA port (``merlin_tpu_torch``).

Drives the port's paths once on one NVIDIA GPU, through the entry points
a user calls, at the full width of CLIP ViT-L/14-448 + Vicuna-7B (all 32
decoder layers, random bf16 weights from a seed, and the same weights with
the LM quantized to int8) and of Baichuan-13B:

  1. setup      - card name and power limit; build the CUDA kernels from
                  ``merlin_tpu_torch/csrc`` (nvcc, sm_90a) and print what
                  ptxas reported for every wgmma kernel, the forward's and
                  the backward's instantiations, and for the paged
                  few-rows and window kernels' (registers, spills: any
                  spill fails);
  2. kernels    - each kernel (B1-B9) against its plain PyTorch version on
                  the card at its path's shapes (and edge cases: GQA, ALiBi,
                  ragged lengths over permuted page tables, hkv = 40; B1 at
                  d = 104, B2 at the training shape with its padding, the
                  paged kernels at d = 64 and at pages of 16 and 256 keys,
                  B6 at d = 80, B7/B8 at d = 72 (8-byte int8 copies) and
                  80;
                  the paged decode at query groups 16 and 32, a 15-row
                  window, and lengths 0, 1, a multiple of the key split,
                  one past it and the full table; B6/B8 at the engine's
                  one-sequence prefill windows, (1, 128, 32, 128) at 128,
                  640 and 1536 keys and (1, 128, 40, 128) with ALiBi, and
                  at window lengths [100, 128, 129, 640, 641, 2048], rows
                  that see no key reading 0), with
                  times, the bound from the shapes, and one PyTorch library
                  call as a yardstick where one exists (SDPA pinned to its
                  flash backend and to the unpinned dispatcher's pick, each
                  timed in alternating pairs of runs with the kernel, the
                  faster backend the yardstick), and each paged wrapper's
                  host time per call (B6/B8 both at the 4-sequence check
                  shape and at the prefill windows); a planted fault (the
                  last key tile dropped; a live page redirected to the
                  trash page, also one in the first and in the last key
                  split of a sequence; int8 scales read at lane hk instead
                  of hk * stride) must fail the same check; then every
                  f32 kernel: B1 (d = 64/80/104), B12, B13, B2 (512,
                  2048 with padding, GQA/ALiBi/segments, d = 80/256) and
                  the f32 backward (B10 + B11, a second run bit-identical)
                  to 1e-5 of max |plain|, and B3-B9 over the pairs (bf16
                  q, f32 pages), (f32, bf16), (f32, f32), (f32, int8)
                  against their plain versions with the TPU kernels'
                  rounding (C48) walked in the f32 kernels' key splits
                  (and logged against the single walk; second runs
                  bit-identical), with ALiBi, groups 16/32, lengths 0/1/
                  full and pages of 16; B7 at f32 q held to its bf16
                  operands (C49: B9's f32 rule planted must fail), a
                  dropped tile and a page redirected in a first and a last
                  key split planted, and for the
                  dense kernels (3xTF32) q, k, v rounded to tf32 (one TF32
                  pass) planted too; times against 3xTF32's 165 TFLOP/s
                  (the paged kernels: the TF32 passes their operands
                  take; FFMA's 67 beside it) or the bytes, and SDPA at
                  f32 (its
                  memory-efficient backend) as the yardstick, the 2048
                  training shape also unpadded;
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
  H. head dims past 128 - the paged kernels' DP = 256 forms (all four:
                  the bf16 few-rows and window kernels over bf16 and int8
                  pages, the f32 ones at the four (q, page) pairs) at d =
                  136 and 256 against their plain versions at the
                  unchanged tolerances (decode at 4 slots, windows s_q = 5
                  and 128 at L = 128/640/1536, ALiBi at 16 heads, groups
                  1/4/8, pages of 16 and 128), every case run twice
                  (bit-identical); planted: a page redirected in the last
                  key split, a dropped key tile, C11's lane fault at hkv =
                  2, the column halves swapped; times at d = 256 against
                  the d = 128 rows' bytes. After S3, the served model:
                  the llama block at Vicuna-7B width regrouped as 16 heads
                  of 256 (4 of 32 layers) through ``ServingEngine`` with
                  E1's, E2's and E4's (int8 pool) traffic and an f32 copy
                  over f32 pages (E2's traffic), every check of phase 6;
  F. float32    - the JAX package's f32 entry points on the card: F1 the
                  ``parse_args(["--bf16", "False"])`` bundle (CLIP
                  ViT-L/14-448 + conv + Vicuna-7B, 32 layers, f32 weights
                  from a seed) forward at b=1, s=512 and greedy
                  generation as phases 4-5 (B1 23, B2 32 on the f32
                  kernels, every bf16 kernel 0); F2 that model behind the
                  engine with E1's and E2's traffic over bf16 pages (C48's
                  pair) and over f32 pages, and E4's hybrid admission
                  over int8 pages (B2, B8, B7 with C49), every check of
                  phase 6; F3 (in phase W, after W1) W1's bf16 bundle
                  behind a worker with ``engine_cache_dtype="f32"``: one
                  text (bf16 q over the f32 pool) and one image request,
                  answers held as W1's; F4 (after T3) T1's recipe with
                  ``bf16=False`` (f32 compute, LM cut to 8 layers, accum 2,
                  2 steps): exact launches of the f32 B2, backward, B12 and
                  B13, peak memory and a profiled step;
  S. scan_layers - the same models built with ``scan_layers`` (the LM's
                  layers stacked by ``stack_layer_params``) behind the
                  engine at 8 slots x 2304 tokens, pages of 128: one
                  stacked pool that the decoder views flat, 4608 pages at
                  Vicuna-7B, the last three layers' pages past 2**31 values
                  (64-bit page offsets). S1 whole prompt + decode (B2, B3),
                  S2 chunked + spec k=4 (B6, B5), S4 int8 weights (the
                  stacked quantizer, equal leaf for leaf to the loop one's
                  stacked) + int8 pages, hybrid (B2, B8, B7), S3
                  Baichuan-13B 4 layers, ALiBi, hybrid (B2, B6, B4); each
                  also through the loop model at the same settings: every
                  check of the serving phase on both, each request's
                  tokens equal, the free pages back at their start; the
                  per-layer page offset dropped (every layer on layer 0's
                  pages) must change the tokens;
  W. front end  - the serving front end over HTTP on loopback: a Vicuna-7B
                  + CLIP ViT-L/14-448 bundle built by ``parse_args([])``,
                  ``build_model_tokenizer`` (the hub unreachable: the
                  TinyTokenizer, primed so that every id is a word) and
                  ``init_or_load_params`` (f32 weights, as the flax tree);
                  a controller (shortest queue) and two workers on it. W1:
                  4 concurrent text requests of 100-1100 words to the
                  engine worker (B2 whole prompts, B6 chunked, B3 decode),
                  a 2-image request there (``Generator.stream``: B1) and a
                  1-image request to the speculative worker (k = 4: B1),
                  every one through the controller's relay with the CLI's
                  client; then ``EvalModel`` with 5 beams on 1 image. W2:
                  the LM quantized to int8 (the tower untouched) behind an
                  engine worker on int8 pages (B2, B8, B7). No chunk may
                  carry an error and no worker may log a failure; each
                  request's chunks must be prefixes of one another, its
                  text must map back to ids, and each token must hold
                  against a no-cache forward of its request (images
                  included); the beam's score must equal the one a
                  no-cache forward gives its sequence, and a cache
                  gathered with the beam index rotated by one must fail
                  that; B1 = 23 x the tower's calls and the engine kernels
                  = 32 x the engine's calls of each kind, 0 elsewhere.
                  Prints TTFT and tok/s per request (host clock at the
                  client);
                  W3: the W1 bundle rebuilt by the worker's own command
                  line with ``--scan-decode`` (``parse_worker_args``), W1's
                  weights stacked into it; W1's first two text prompts to
                  an engine worker and its 1-frame prompt to a speculative
                  one (a stacked dense cache) must give W1's answers; one
                  chat with a frame through ``serve/web.py`` (held against
                  a no-cache forward), a vote, the conversation JSONL and
                  the image archived under its md5 in a temporary log
                  directory; ``serve/tools.test_message`` through the
                  controller. L: LoRA (``train/lora.py``, r 64, alpha 16,
                  the reference's 224 targets) over the W bundle with its
                  base cast to bf16 and the tower frozen, 3 steps of
                  ``torch.optim.Adam`` over the factors on a (1, 2048)
                  batch with one frame (B1, B2 twice a layer under remat,
                  the fused backward): the step-0 merge equal to the base
                  bit for bit, the loss falling, every base tensor's
                  fingerprint unchanged, every b non-zero, the launches
                  exact, the peak memory printed;
  V. evaluation - between W1 and W2, on the same bf16-computing bundle
                  (its tokenizer primed with every word the harness
                  prompts hold, C20), every harness of
                  ``merlin_tpu_torch.eval`` through its own ``run`` on
                  input files written from a seed into a temporary
                  directory: MMBench (a TSV of 3 questions x 2 circular
                  shifts, one row with a hint, one with numeric options and
                  D empty, 640x480 noise JPEGs in base64 cells over csv's
                  default field limit; 5 beams x 16 tokens, then greedy in
                  batches of 3; its JSON, xlsx and scores), MM-Vet (2
                  questions), DocVQA (2 at 1000x800, ANLS), tracking (2
                  LaSOT-layout videos of 4 frames at 640x360, 24 tokens,
                  serial and in 2 chunks merged: equal), single-image QA
                  (sampled twice: one answer, C32; then greedy), the demo
                  in Track mode (a 2-frame turn and a text turn) and the
                  box REPL, each with scripted input; then ``python -m
                  merlin_tpu_torch.engine.eval --merge-chunks`` in a
                  subprocess and ``main`` with ``--tiny --device cuda``.
                  Every greedy answer holds against a no-cache forward of
                  its prompt with its images, every beam score against the
                  one that forward gives its sequence, each tracking prompt
                  carries the box the previous answer left (or the last
                  good one); B1 = 23 x the tower's calls around each
                  harness and every other kernel 0; an MM-Vet answer held
                  with the other question's image must fail. Prints
                  seconds per answer and tok/s per harness;
  K. checkpoints - K1: a composite checkpoint at full width, made by HF
                  modules on the card (``LlamaForCausalLM`` at Vicuna-7B's
                  widths, all 32 layers; ``CLIPVisionModel`` ViT-L/14-448;
                  conv projector weights) and written as sharded bf16
                  safetensors with an index in a temporary directory, is
                  loaded as the worker loads ``--pretrain_model``
                  (``parse_args``, ``build_model_tokenizer``,
                  ``init_or_load_params``): every leaf must equal the f32
                  of HF's tensor under the relayout; the no-cache logits
                  (B2) must hold against HF's forward on 512 ids, and the
                  same with every o_proj loaded without its head relayout
                  must not; the tower's features (B1) against HF's
                  hidden_states[-2]; one text and one 1-image request
                  through an engine worker, each token held against a
                  no-cache forward. K2: the other towers at full width and
                  depth, random bf16 weights: MetaCLIP ViT-H/14-448 (B1 at
                  d = 80) against HF ``CLIPVisionModel``, Qwen-VL
                  ViT-bigG-448 (B1 at d = 104) against itself on
                  ``mha_reference`` and its resampler's (1, 256, 4096), SAM
                  ViT-B/16-1024 (no kernel) against HF
                  ``SamVisionEncoder``; one MMGPT forward per new tower kind
                  with its projector and a 2-layer Vicuna-7B; B1 timed at
                  d = 80 and 104 against SDPA, and each tower's encode;
  7. backward   - the training kernels against their plain versions on the
                  card, each fed its forward kernel's out and LSE as on the
                  path: B2 then the fused backward (B10 dq + B11 dk, dv in
                  one kernel) at the decoder's (1, 2048, 32, 128) causal
                  with a padded tail, GQA 8/2 + ALiBi, non-causal, and
                  causal with fewer queries than keys, and the widths the
                  card had not run: d = 80 and d = 256 (GQA 8/4, the
                  column-split backward) at (1, 1024) causal with a padded
                  tail; B12 (one-pass forward with its LSE) then B13 (the
                  fused kernel, non-causal) at the tower's (8, 1025, 16,
                  64), and at d = 80 and 104 (2, 1025, 16); a second
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
 11. T3         - ``Trainer.train`` over MetaCLIP ViT-H/14-448 (trainable,
                  31 layers run, d = 80, 1025 tokens) + conv + Vicuna-7B
                  width cut to 2 layers, 2 steps at accum 2 on (2, 2048)
                  batches with one frame a row: B12/B13 under autograd;
                  first one microbatch whose tower gradients must hold
                  against the same step with the plain attention swapped
                  in (here only), loss and tower gradient norm finite;
                  exact launches; then a step timed alone and one profiled.
  D. data       - the data pipeline and the training entry point: tar
                  shards (pair, tracking and detection frames) and a
                  conversation set with boxes, written from a seed and
                  registered under the recipe's names; the reference's
                  pretraining command line through
                  ``merlin_tpu_torch.engine.train.train`` at Vicuna-7B (32
                  layers, frozen) + CLIP ViT-L/14-448 width: D1 takes 3
                  steps (launches exactly T2's per step, the first loss an
                  untrained head's, the LM bit-identical but its trainable
                  rows), D1r resumes from checkpoint-3 with its data cursor
                  and takes one; every batch's shapes and image blocks, a
                  fresh pipeline's families and rate against the step rate,
                  checkpoint-3's cursor against an uninterrupted pipeline's
                  4th batch (the cursor with one sample dropped must fail),
                  and the native tar loader, built by the host compiler,
                  against the Python tar path.
  M. mesh       - the parallelism code on a one-rank NCCL group (FileStore
                  rendezvous in a temporary directory; the card machine has
                  one H100, so no multi-rank path runs here) with the (1, 1,
                  1, 1) mesh, the group torn down after each part. M2 after
                  E1/E2 and after E4: ``ServingEngine(mesh=,
                  param_shardings=)`` serves E1's, E2's (chunked + spec) and
                  E4's (int8 weights and pages) prompts and settings again;
                  tokens and launches must equal the meshless runs', every
                  page come back and ``close()`` restore the global mesh.
                  M1 after T1: T1's model, recipe and batch through the
                  Trainer over the mesh (FSDP2 over (data, fsdp), the rules'
                  tensor plan), 3 steps: losses against T1's and a meshless
                  rerun's, every leaf's update against the rerun's,
                  launches T1's per step, every trainable parameter a
                  DTensor with the rules' placements; the tower unit's
                  gradients left out of the update, and the LM head's
                  alone (planted), must each fail the leaf check;
                  ``host_allreduce_min`` and ``barrier`` over NCCL.

Prints the serving, front-end, evaluation, checkpoint, training, data and
mesh readings and the kernel table as JSON lines before the last, and as the last
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
import logging
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F
from torch.nn.attention import SDPBackend, sdpa_kernel

PEAK_BF16_FLOPS = 989e12     # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_F32_FLOPS = 67e12       # H100 SXM f32 outside the tensor cores (FFMA)
PEAK_TF32_FLOPS = 495e12     # H100 SXM dense TF32: one pass of a product
PEAK_TF32X3_FLOPS = PEAK_TF32_FLOPS / 3   # f32 products as 3 TF32 passes
                                          # on the tensor cores: the dense
                                          # f32 kernels' own bound
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

F32 = "_f32"                 # an f32 kernel's count: "B2" -> "B2_f32"
F32_RTOL = 1e-5              # an f32 kernel against its plain version where
                             # every operand is f32: max |error| of max
                             # |plain| over the tensor (summation order and
                             # exp2 against exp; <= 1.9e-6 seen on an H100
                             # 80GB HBM3 at 700 W); a dropped key tile or a
                             # redirected page gives >= 7e-2
C49_TOL = 2e-4               # B7 at f32 q against its bf16-operand plain
                             # version, as ||kernel - plain|| / ||plain||:
                             # p * v_scale's bf16 rounding flips at a few
                             # keys between the two f32 orders (<= 3.4e-6
                             # seen on the card; 2.3e-4 as max |err| of max
                             # |plain|), where computing in f32 (C49's
                             # planted fault) moves every row: 2.0e-3
F32_DENSE_SOURCE = "merlin_tpu_torch/csrc/attention_f32.cu"
F32_PAGED_SOURCE = "merlin_tpu_torch/csrc/paged_attention_f32.cu"
F32_BWD_SOURCE = "merlin_tpu_torch/csrc/flash_attention_bwd_f32.cu"

# B1, B2 and B12 run one forward kernel (two entry names, one body)
B1_SOURCE = "merlin_tpu_torch/csrc/attention_fwd.cu"
B2_SOURCE = "merlin_tpu_torch/csrc/attention_fwd.cu"
B1_REPLACES = "merlin_tpu/ops/onepass_attention.py:254"
B2_REPLACES = "merlin_tpu/ops/flash_attention.py:161"
PAGED_SOURCE = "merlin_tpu_torch/csrc/paged_attention.cu"
PAGED_REPLACES = {"B3": "merlin_tpu/ops/paged_attention.py:365",
                  "B4": "merlin_tpu/ops/paged_attention.py:143",
                  "B5": "merlin_tpu/ops/paged_attention.py:631",
                  "B6": "merlin_tpu/ops/paged_attention.py:772",
                  # B7 is one pallas_call; the port serves its s_q = 1 case
                  # (paged_attention_dma_q8, "B7") and its windows ("B7w",
                  # <= 16 rows per kv head) with the split-key few-rows
                  # kernel, as B3, B4, B5 and B9
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


def bound_ms(flops: float, nbytes: float, peak: float = PEAK_BF16_FLOPS):
    t_ops = flops / peak * 1e3
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
    # the tower's (ViT-L/14-448) shape, ragged ones, d = 128, and d = 104
    # (Qwen-VL's bigG tower; C18: a width the card had not run)
    for shape in [(2, 1025, 16, 64), (3, 257, 16, 64), (1, 77, 4, 128),
                  (1, 1025, 16, 104)]:
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
        # the KV tile is 128 keys: at s=1025 the last tile holds key 1024
        # alone
        if shape[1] == 1025:
            s = shape[1]
            planted_fault(f"B1 {shape}", out_err(onepass_attention(
                q, k[:, :s - 1], v[:, :s - 1]), want)[1])
    _, q, k, v, out, want = rows[0]
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

    # the training shape, as T1 runs B2: causal, the last 300 positions
    # padding (a segment of their own)
    tshape = (1, 2048, 32, 128)
    qt, kt, vt = (torch.randn(tshape, generator=gen, device="cuda").to(
        torch.bfloat16) for _ in range(3))
    seg_t = torch.ones(tshape[:2], dtype=torch.int32, device="cuda")
    seg_t[:, -N_PAD:] = 0
    pad = dict(causal=True, segment_ids_q=seg_t, segment_ids_kv=seg_t)
    out_t, lse_t, want_t = compare(
        f"{tshape} causal, last {N_PAD} padding", qt, kt, vt, **pad)
    cut = tshape[1] - 64
    planted_fault(f"B2 {tshape} padded", out_err(flash_attention(
        qt, kt[:, :cut], vt[:, :cut], causal=True, segment_ids_q=seg_t,
        segment_ids_kv=seg_t[:, :cut].contiguous())[0], want_t)[1])

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
    # at the training shape: the padded call as T1 makes it, and like for
    # like against SDPA (causal, no padding), in alternating pairs
    _, st, ht, dt = tshape
    ms_t = time_ms(lambda: flash_attention(qt, kt, vt, **pad))
    bms_t, by_t = bound_ms(4.0 * ht * visible_pairs(st, st, True, seg_t,
                                                    seg_t) * dt,
                           nbytes(qt, kt, vt, out_t, lse_t))
    lib_for, qkv = sdpa_fwd(qt, kt, vt, is_causal=True)
    p_t = vs_sdpa(lambda: flash_attention(qt, kt, vt, causal=True), lib_for,
                  *qkv, is_causal=True)
    del lib_for, qkv
    bms_c, by_c = bound_ms(4.0 * ht * st * (st + 1) / 2 * dt,
                           nbytes(qt, kt, vt, out_t, lse_t))
    log(f"B2 {tshape} causal, last {N_PAD} padding bf16: kernel {ms_t:.4f} "
        f"ms, bound {bms_t:.4f} ms ({by_t}); causal, no padding: "
        + sdpa_text(p_t) + f", bound {bms_c:.4f} ms ({by_c})")
    training = dict(shape=list(tshape), padded_ms=ms_t,
                    padded_bound_ms=bms_t, padded_bound_by=by_t,
                    bound_ms=bms_c, bound_by=by_c, **sdpa_fields(p_t))
    return dict(name="B2 flash_attention_fwd", route="cuda",
                source=B2_SOURCE, replaces=B2_REPLACES,
                max_abs_err=max(errs), plain_ms=plain, bound_ms=bms,
                bound_by=by, shape=list(shape), training_shape=training,
                **sdpa_fields(p))


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
        return out, lse, di, got, want, want_out

    def padded(b, s, h, hkv, d):
        """Inputs at (b, s, h/hkv, d) with segment ids whose last 300
        positions are padding, as the LM path's attention mask gives."""
        seg = torch.ones((b, s), dtype=torch.int32, device="cuda")
        seg[:, s - N_PAD:] = 0
        return inputs(b, s, h, hkv, d), dict(
            causal=True, segment_ids_q=seg, segment_ids_kv=seg)

    def faults(tag, q, k, v, do, kw, fwd, want, with_b2=False):
        """Planted faults on a padded causal case: keys from s - 64 left
        out of dq (and of B2's out); queries from s - 64 left out of dk/dv
        (the keys only they see lose everything)."""
        out, lse, di, want_out = fwd
        seg = kw["segment_ids_q"]
        cut = q.shape[1] - 64
        seg_cut = seg[:, :cut].contiguous()
        if with_b2:
            planted_fault(f"B2 {tag}", out_err(fa.flash_attention(
                q, k[:, :cut], v[:, :cut], causal=True, segment_ids_q=seg,
                segment_ids_kv=seg_cut)[0], want_out)[1])
        dq_bad = fa.flash_attention_bwd_dq(
            q, k[:, :cut], v[:, :cut], do, lse, di, causal=True,
            segment_ids_q=seg, segment_ids_kv=seg_cut)
        dkv_bad = fa.flash_attention_bwd_dkv(
            q[:, :cut], k, v, do[:, :cut], lse[..., :cut].contiguous(),
            di[..., :cut].contiguous(), causal=True, segment_ids_q=seg_cut,
            segment_ids_kv=seg)
        torch.cuda.synchronize()
        for name, got_bad, ref, what in (
                ("B10", dq_bad, want[0], "last key tile dropped from dq"),
                ("B11", dkv_bad[0], want[1],
                 "last query tile dropped from dk"),
                ("B11", dkv_bad[1], want[2],
                 "last query tile dropped from dv")):
            rel = grad_err(got_bad, ref)[1]
            log(f"{name} {tag} planted fault ({what}): row error "
                f"{rel:.3e}, must exceed {OUT_RTOL:.3e}")
            if not rel > OUT_RTOL:
                raise AssertionError(f"{name}: the check cannot see: {what}")

    b, s, h, d = 1, 2048, 32, 128
    (q, k, v, do), kw = padded(b, s, h, h, d)
    seg = kw["segment_ids_q"]
    out, lse, di, got, want, want_out = compare(
        "(1, 2048, 32, 128) causal, last 300 padding", q, k, v, do, **kw)
    rerun = check_rerun(
        "B10/B11 fused (1, 2048, 32, 128)",
        lambda: fa.flash_attention_bwd(q, k, v, out, lse, do, **kw), got)
    faults("(1, 2048, 32, 128)", q, k, v, do, kw, (out, lse, di, want_out),
           want)
    # C18/C19: head dims the card had not run, B2 then the backward: d = 80
    # (phi-2's width) and d = 256 with GQA 8/4 (the column-split form)
    wide = {}
    for shape in ((1, 1024, 32, 32, 80), (1, 1024, 8, 4, 256)):
        tag = f"({shape[0]}, {shape[1]}, {shape[2]}/{shape[3]} heads, " \
              f"{shape[4]}) causal, last {N_PAD} padding"
        (qw, kw_, vw, dow), kww = padded(*shape)
        o_w, l_w, di_w, got_w, want_w, wo_w = compare(tag, qw, kw_, vw, dow,
                                                      **kww)
        faults(tag, qw, kw_, vw, dow, kww, (o_w, l_w, di_w, wo_w), want_w,
               with_b2=True)
        wide[shape[4]] = (qw, kw_, vw, dow, kww, o_w, l_w)

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
    # the column-split form at d = 256: both halves contract S^T and dP^T,
    # so it does 7 products of 2 d flops per visible pair where the
    # function needs 5
    qw, kw_, vw, dow, kww, o_w, l_w = wide[256]
    ms256 = time_ms(lambda: fa.flash_attention_bwd(qw, kw_, vw, o_w, l_w, dow,
                                                   **kww))
    pairs256 = visible_pairs(qw.shape[1], qw.shape[1], True,
                             kww["segment_ids_q"], kww["segment_ids_kv"])
    io256 = nbytes(qw, kw_, vw, dow, o_w, l_w) + nbytes(qw, kw_, vw)
    b256, by256 = bound_ms(5 * 2.0 * qw.shape[2] * pairs256 * 256, io256)
    b256_7, _ = bound_ms(7 * 2.0 * qw.shape[2] * pairs256 * 256, io256)
    log(f"B10/B11 fused {tuple(qw.shape)} (hkv {kw_.shape[2]}) causal + "
        f"padding bf16: one launch {ms256:.4f} ms, bound {b256:.4f} ms "
        f"({by256}, 5 products), {b256_7:.4f} ms for the 7 products the "
        f"column split does")
    d256 = dict(shape=list(qw.shape), hkv=kw_.shape[2], ms=ms256,
                bound_ms=b256, bound_by=by256, bound_ms_7_products=b256_7)
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
               rerun_dq_max_diff=rerun, shape=[b, s, h, d], d256=d256,
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
    rerun = check_rerun(f"B13 {shape}", lambda: oa.onepass_attention_bwd(
        q, k, v, do, lse, out), got)
    # C18: the metaclip ViT-H/14 (d = 80) and Qwen-VL bigG (d = 104) towers'
    # widths, each with planted faults: the last key left out of B12's out
    # and of dq, the last query tile left out of dk/dv
    for wshape in ((2, 1025, 16, 80), (2, 1025, 16, 104)):
        qw, kw, vw = (layer_normed(wshape, gen) for _ in range(3))
        dow = torch.randn(wshape, generator=gen, device="cuda").to(
            torch.bfloat16)
        o_w, l_w = oa.onepass_attention_lse(qw, kw, vw)
        want_w, want_lw = oa.onepass_attention_lse_plain(qw, kw, vw)
        torch.cuda.synchronize()
        e_w, rel = out_err(o_w, want_w)
        lerr = (l_w - want_lw).abs().max().item()
        log(f"B12 {wshape}: max_abs_err {e_w:.3e}, row error {rel:.3e} (tol "
            f"{OUT_RTOL:.3e}), lse {lerr:.3e} (tol {LSE_TOL})")
        if not (rel <= OUT_RTOL and lerr <= LSE_TOL):
            raise AssertionError(f"B12 {wshape} disagrees: {e_w} {rel} {lerr}")
        err12 = max(err12, e_w)
        sw = wshape[1]
        planted_fault(f"B12 {wshape}", out_err(oa.onepass_attention_lse(
            qw, kw[:, :sw - 1], vw[:, :sw - 1])[0], want_w)[1])
        got_w = oa.onepass_attention_bwd(qw, kw, vw, dow, l_w, o_w)
        ref_w = oa.onepass_attention_bwd_plain(qw, kw, vw, dow, l_w,
                                               attention_di(o_w, dow))
        torch.cuda.synchronize()
        check_grads(f"B13 {wshape}", got_w, ref_w, errs)
        cut = sw - 64
        dq_bad = oa.onepass_attention_bwd(qw, kw[:, :cut], vw[:, :cut], dow,
                                          l_w, o_w)[0]
        dkv_bad = oa.onepass_attention_bwd(
            qw[:, :cut], kw, vw, dow[:, :cut], l_w[..., :cut].contiguous(),
            o_w[:, :cut])[1:]
        torch.cuda.synchronize()
        for got_bad, ref, what in (
                (dq_bad, ref_w[0], "last key tile dropped from dq"),
                (dkv_bad[0], ref_w[1], "last query tile dropped from dk"),
                (dkv_bad[1], ref_w[2], "last query tile dropped from dv")):
            rel = grad_err(got_bad, ref)[1]
            log(f"B13 {wshape} planted fault ({what}): row error {rel:.3e}, "
                f"must exceed {OUT_RTOL:.3e}")
            if not rel > OUT_RTOL:
                raise AssertionError(f"B13: the check cannot see: {what}")
    err13 = max(errs["B10"] + errs["B11"])

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


def paged_inputs(gen, b, h, hkv, d, lengths, s_q=0, page=128, pps=None,
                 dtype=torch.bfloat16):
    """q, a pool of b * pps + 1 random pages (page 0 is the trash page;
    pps by default holds 2048 keys), and tables whose live entries are a
    random permutation of pages 1.. (not contiguous), unused entries on
    page 0; q and the pages in ``dtype``."""
    pps = pps or 2048 // page
    total = b * pps + 1
    pool = [torch.randn((total, page, hkv * d), generator=gen,
                        device="cuda").to(dtype) for _ in range(2)]
    perm = (torch.randperm(total - 1, generator=gen, device="cuda") + 1).to(
        torch.int32).reshape(b, pps)
    tables = torch.zeros((b, pps), dtype=torch.int32, device="cuda")
    for i, n in enumerate(lengths):
        used = -(-n // page)
        tables[i, :used] = perm[i, :used]
    qshape = (b, s_q, h, d) if s_q else (b, h, d)
    q = torch.randn(qshape, generator=gen, device="cuda").to(dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return q, pool[0], pool[1], lens, tables


def redirect_page(tables, lengths, page=128, last_split=False,
                  window=False):
    """The planted fault: one live page of the first sequence with two or
    more pages, pointed at the trash page 0: its page 1, or (last_split)
    the first page of its last key split of the few-rows kernel, in the
    first sequence with more than one split, so that the fault reaches
    the splits' merge. For the window kernel, whose splits are sized from
    the lengths (``window``): the sequence's first page, in its first
    split, or (last_split) the page of its last key, in its last split."""
    from merlin_tpu_torch.ops.paged_attention import rows_split_keys

    bad = tables.clone()
    split = rows_split_keys(page)
    if window:
        i = next(i for i, n in enumerate(lengths) if n > page)
        bad[i, (lengths[i] - 1) // page if last_split else 0] = 0
    elif last_split:
        i = next(i for i, n in enumerate(lengths) if n > split)
        bad[i, (lengths[i] - 1) // split * split // page] = 0
    else:
        i = next(i for i, n in enumerate(lengths) if n > page)
        bad[i, 1] = 0
    return bad


def no_key_rows_zero(want, lens):
    """The kernels' answer for query rows that see no key (trap C2): 0,
    where the plain versions average V. A decode row sees none at length 0,
    a window row t of s_q at length - s_q + t < 0."""
    want = want.clone()
    if want.dim() == 3:
        want[lens == 0] = 0
    else:
        s_q = want.shape[1]
        pos = lens[:, None] - s_q + torch.arange(s_q, device=lens.device)
        want[pos < 0] = 0
    return want


def window_flops(q, lens):
    """4 h d FLOP for each (query row, visible key) pair of a window whose
    lengths include it: row t of s_q sees keys <= length - s_q + t."""
    b, s_q, h, d = q.shape
    seen = sum(max(0, n - s_q + t + 1) for n in lens.tolist()
               for t in range(s_q))
    return 4.0 * h * d * seen


# the engine's prefill windows (b = 1, s_q = 128) and window lengths at
# the edges: rows that see no key (100 < 128), a page's edges, the table
WINDOW_PATH_LENGTHS = (128, 640, 1536)
WINDOW_EDGES = [100, 128, 129, 640, 641, 2048]


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
        want = no_key_rows_zero(plain(q, kp, vp, lens, tabs, **kw), lens)
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
    compare("decode vicuna, last split", "B3", dec_mha,
            tables=redirect_page(dec_mha[4], vicuna, last_split=True))
    # any query group: 32 query heads over 2 kv heads (16) and over 1 (32)
    s32 = alibi_slopes(32, device="cuda")
    for hkv in (2, 1):
        inputs = paged_inputs(gen, 4, 32, hkv, 128, vicuna)
        compare(f"decode group {32 // hkv} (32/{hkv} heads)", "B3", inputs)
        compare(f"decode group {32 // hkv} alibi (32/{hkv} heads)", "B4",
                inputs, s32)
    # the key splits' edges: no key, one, a whole split, one key past it,
    # the full table (16 pages of 128)
    edges = [0, 1, 256, 257, 2048]
    dec_edges = paged_inputs(gen, 5, 32, 32, 128, edges)
    compare(f"decode lengths {edges}", "B3", dec_edges)
    compare(f"decode lengths {edges} alibi", "B4", dec_edges, s32)

    win5 = paged_inputs(gen, 4, 32, 32, 128, [5, 256, 1937, 700], s_q=5)
    win128 = paged_inputs(gen, 4, 32, 32, 128, [128, 256, 1990, 700],
                          s_q=128)
    win_gqa5 = paged_inputs(gen, 3, 8, 2, 128, [5, 1024, 1900], s_q=5)
    win_gqa128 = paged_inputs(gen, 3, 8, 2, 128, [130, 1024, 1900],
                              s_q=128)
    compare("window s_q=5 vicuna", "B5", win5)
    compare("window s_q=5 vicuna, last split", "B5", win5,
            tables=redirect_page(win5[4], [5, 256, 1937, 700],
                                 last_split=True))
    compare("window s_q=5 gqa alibi", "B5", win_gqa5, s8)
    # 15 rows per kv head (group 3 x s_q 5): one full 16-row tile
    s24 = alibi_slopes(24, device="cuda")
    win_g3 = paged_inputs(gen, 4, 24, 8, 128, [5, 256, 1937, 700], s_q=5)
    compare("window s_q=5 group 3 alibi (24/8 heads)", "B5", win_g3, s24)
    win_edges = paged_inputs(gen, 6, 32, 32, 128, [3, 5, 256, 257, 261,
                                                    2048], s_q=5)
    compare("window s_q=5 lengths [3, 5, 256, 257, 261, 2048]", "B5",
            win_edges)
    compare("window s_q=5 gqa alibi", "B6", win_gqa5, s8)
    compare("window s_q=128 vicuna", "B6", win128)
    compare("window s_q=128 gqa alibi", "B6", win_gqa128, s8)
    compare("window s_q=128 vicuna", "B6", win128,
            tables=redirect_page(win128[4], [128, 256, 1990, 700]))
    # the engine's prefill windows: one sequence, s_q = 128, its keys split
    # over CTAs; a page redirected in the first and in the last split
    path = {n: paged_inputs(gen, 1, 32, 32, 128, [n], s_q=128)
            for n in WINDOW_PATH_LENGTHS}
    for n, inputs in path.items():
        compare(f"window (1,128,32,128) L={n}", "B6", inputs)
    path_bc = paged_inputs(gen, 1, 40, 40, 128, [640], s_q=128)
    compare("window (1,128,40,128) L=640 baichuan-13b alibi", "B6", path_bc,
            s40)
    for last in (False, True):
        where = "last" if last else "first"
        compare(f"window L=1536, {where} split", "B6", path[1536],
                tables=redirect_page(path[1536][4], [1536], last_split=last,
                                     window=True))
    # rows that see no key (100 < 128: rows 0..27), a page's edges, the
    # full table
    win_edges128 = paged_inputs(gen, 6, 32, 32, 128, WINDOW_EDGES, s_q=128)
    compare(f"window s_q=128 lengths {WINDOW_EDGES}", "B6", win_edges128)
    compare(f"window s_q=128 lengths {WINDOW_EDGES} alibi", "B6",
            win_edges128, s32)
    # page sizes 16 (a key tile spans pages) and 256 (a page spans tiles),
    # for both kernels, each with a redirected page in a last split
    for page in (16, 256):
        dec = paged_inputs(gen, 4, 32, 32, 128, vicuna, page=page)
        compare(f"decode page {page}", "B3", dec)
        compare(f"decode page {page} alibi", "B4", dec, s32)
        compare(f"decode page {page}, last split", "B3", dec,
                tables=redirect_page(dec[4], vicuna, page, last_split=True))
        w5 = paged_inputs(gen, 4, 32, 32, 128, [5, 256, 1937, 700], s_q=5,
                          page=page)
        compare(f"window s_q=5 page {page}", "B5", w5)
        w128 = paged_inputs(gen, 2, 32, 32, 128, [1536, 641], s_q=128,
                            page=page)
        compare(f"window s_q=128 page {page}", "B6", w128)
        compare(f"window s_q=128 page {page} alibi", "B6", w128, s32)
        compare(f"window s_q=128 page {page}, last split", "B6", w128,
                tables=redirect_page(w128[4], [1536, 641], page,
                                     last_split=True, window=True))
    # d = 80: the columns past d of the window kernel's 128-column tiles
    # zero-filled
    d80 = paged_inputs(gen, 2, 32, 32, 80, [1536, 641], s_q=128)
    compare("window s_q=128 d=80", "B6", d80)
    compare("window s_q=128 d=80, last split", "B6", d80,
            tables=redirect_page(d80[4], [1536, 641], last_split=True,
                                 window=True))
    # C18: d = 64, a width the paged checks had not run (16 heads), each
    # with a live page redirected to the trash page
    for tag, name, lens, s_q in (("decode d=64 (16 heads)", "B3", vicuna, 0),
                                 ("window s_q=5 d=64", "B5",
                                  [5, 256, 1937, 700], 5),
                                 ("window s_q=128 d=64", "B6",
                                  [128, 256, 1990, 700], 128)):
        inputs = paged_inputs(gen, 4, 16, 16, 64, lens, s_q=s_q)
        compare(tag, name, inputs)
        compare(tag, name, inputs, tables=redirect_page(inputs[4], lens))

    def timing(name, inputs, slopes, plain, flops):
        q, kp, vp, lens, tabs = inputs
        fn = fns[name]
        kw = {} if name == "B3" else {"alibi_slopes": slopes}
        ms = time_ms(lambda: fn(q, kp, vp, lens, tabs, **kw))
        plain_ms = time_ms(lambda: plain(q, kp, vp, lens, tabs, **kw),
                           iters=5)
        host = host_us(lambda: fn(q, kp, vp, lens, tabs, **kw))
        hkv_d = kp.shape[2]
        kv_bytes = int(lens.sum()) * hkv_d * 2 * 2     # each live K/V once
        bms, by = bound_ms(flops, kv_bytes + 2 * nbytes(q))
        log(f"{name} {tuple(q.shape)} lengths {lens.tolist()} bf16: kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bms:.4f} ms "
            f"({by}), library none; wrapper {host:.1f} us of host time a "
            f"call")
        return dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                    host_us_per_call=host, shape=list(q.shape),
                    lengths=lens.tolist())

    def row(name, fn_name, inputs, slopes, plain, flops):
        return dict(name=f"{name} {fn_name}", route="cuda",
                    source=PAGED_SOURCE, replaces=PAGED_REPLACES[name],
                    max_abs_err=max(errs[name]), library_ms=None,
                    **timing(name, inputs, slopes, plain, flops))

    # the route's reason: B6's 128-row tiles on the verify window's shape
    q, kp, vp, lens, tabs = win5
    b6_ms = time_ms(lambda: pa.paged_attention_multi_blocked(
        q, kp, vp, lens, tabs))
    log(f"B6 on B5's shape {tuple(q.shape)}: {b6_ms:.4f} ms")
    b6_path = [timing("B6", inputs, None, pa.paged_attention_multi_plain,
                      window_flops(inputs[0], inputs[3]))
               for inputs in path.values()]
    b6_path.append(timing("B6", path_bc, s40, pa.paged_attention_multi_plain,
                          window_flops(path_bc[0], path_bc[3])))
    rows = {
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
    rows["B6"]["path_shapes"] = b6_path
    return rows


def paged_q8_inputs(gen, b, h, hkv, d, lengths, s_q=0, page=128):
    """``paged_inputs`` with both pools quantized by the port's
    ``quantize_pages``: q, k values, k scales, v values, v scales, lengths,
    tables."""
    from merlin_tpu_torch.ops.paged_attention import quantize_pages

    q, kp, vp, lens, tables = paged_inputs(gen, b, h, hkv, d, lengths, s_q,
                                           page=page)
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
        if fault in ("page", "last split page", "first split page"):
            lengths = lens.tolist()
            page = kv.shape[1]
            got_in[6] = redirect_page(tabs, lengths, page,
                                      last_split=fault == "last split page",
                                      window=name == "B8"
                                      and fault != "page")
            what = ("a live page redirected to the trash page" + {
                "page": "", "last split page": ", in the last key split",
                "first split page": ", in the first key split"}[fault])
        elif fault == "lanes":
            hkv = kv.shape[2] // q.shape[-1]
            got_in[2] = head_lane_scales(ks, hkv)
            got_in[4] = head_lane_scales(vs, hkv)
            what = f"scales at lane hk, not hk * {128 // hkv}"
        got = fns[name](*got_in, alibi_slopes=slopes)
        want = no_key_rows_zero(plain(q)(*inputs, alibi_slopes=slopes), lens)
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
    compare("decode vicuna", "B7", dec_mha, fault="last split page")
    compare("decode vicuna", "B7", dec_mha, fault="lanes")
    compare("decode baichuan-13b", "B7", dec_bc, s40, fault="lanes")
    # any query group: 32 query heads over 2 kv heads (16; scale lane
    # stride 64) and over 1 (32)
    s32 = alibi_slopes(32, device="cuda")
    for hkv in (2, 1):
        inputs = paged_q8_inputs(gen, 4, 32, hkv, 128, vicuna)
        for name in ("B7", "B9"):
            compare(f"decode group {32 // hkv} alibi (32/{hkv} heads)", name,
                    inputs, s32)
        if hkv == 2:
            compare("decode group 16 alibi (32/2 heads)", "B7", inputs, s32,
                    fault="lanes")
    # the key splits' edges, as check_paged's
    edges = [0, 1, 256, 257, 2048]
    dec_edges = paged_q8_inputs(gen, 5, 32, 32, 128, edges)
    compare(f"decode lengths {edges}", "B7", dec_edges)
    compare(f"decode lengths {edges} alibi", "B9", dec_edges, s32)

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
    s24 = alibi_slopes(24, device="cuda")
    win_g3 = paged_q8_inputs(gen, 4, 24, 8, 128, [5, 256, 1937, 700],
                             s_q=5)
    compare("window s_q=5 group 3 alibi (24/8 heads)", "B7w", win_g3, s24)
    win_edges = paged_q8_inputs(gen, 6, 32, 32, 128, [3, 5, 256, 257, 261,
                                                       2048], s_q=5)
    compare("window s_q=5 lengths [3, 5, 256, 257, 261, 2048]", "B7w",
            win_edges)
    compare("window s_q=5 vicuna", "B7w", win5, fault="last split page")
    compare("window s_q=5 gqa alibi", "B8", win_gqa5, s8)
    compare("window s_q=128 vicuna", "B8", win128)
    compare("window s_q=128 baichuan-13b alibi", "B8", win128_bc, s40)
    compare("window s_q=128 gqa alibi", "B8", win_gqa128, s8)
    compare("window s_q=5 baichuan-13b", "B7w", win5_bc, s40, fault="lanes")
    compare("window s_q=128 vicuna", "B8", win128, fault="page")
    compare("window s_q=128 vicuna", "B8", win128, fault="lanes")
    # C18: d = 64 (16 heads, scale stride 8)
    dec64 = paged_q8_inputs(gen, 4, 16, 16, 64, vicuna)
    win64 = paged_q8_inputs(gen, 4, 16, 16, 64, [128, 256, 1990, 700],
                            s_q=128)
    compare("decode d=64 (16 heads)", "B7", dec64)
    compare("decode d=64 (16 heads)", "B7", dec64, fault="page")
    compare("decode d=64 (16 heads)", "B7", dec64, fault="lanes")
    compare("window s_q=128 d=64", "B8", win64)
    compare("window s_q=128 d=64", "B8", win64, fault="page")
    # the engine's prefill windows over int8 pages (B8): one sequence,
    # s_q = 128, keys split over CTAs; faults in the first and the last
    # split, and the C11 lane fault
    path = {n: paged_q8_inputs(gen, 1, 32, 32, 128, [n], s_q=128)
            for n in WINDOW_PATH_LENGTHS}
    for n, inputs in path.items():
        compare(f"window (1,128,32,128) L={n}", "B8", inputs)
    path_bc = paged_q8_inputs(gen, 1, 40, 40, 128, [640], s_q=128)
    compare("window (1,128,40,128) L=640 baichuan-13b alibi", "B8", path_bc,
            s40)
    compare("window L=1536", "B8", path[1536], fault="first split page")
    compare("window L=1536", "B8", path[1536], fault="last split page")
    compare("window L=640 baichuan-13b", "B8", path_bc, s40, fault="lanes")
    win_edges128 = paged_q8_inputs(gen, 6, 32, 32, 128, WINDOW_EDGES,
                                   s_q=128)
    compare(f"window s_q=128 lengths {WINDOW_EDGES} alibi", "B8",
            win_edges128, s32)
    # page sizes 16 and 256 for B8 and the few-rows kernel (B7 decode and
    # windows), each with a page redirected in a last split
    for page in (16, 256):
        dec = paged_q8_inputs(gen, 4, 32, 32, 128, vicuna, page=page)
        compare(f"decode page {page}", "B7", dec)
        compare(f"decode page {page}", "B7", dec, fault="last split page")
        w5 = paged_q8_inputs(gen, 4, 40, 40, 128, [5, 384, 1999, 901],
                             s_q=5, page=page)
        compare(f"window s_q=5 page {page} baichuan-13b alibi", "B7w", w5,
                s40)
        w128 = paged_q8_inputs(gen, 2, 32, 32, 128, [1536, 641], s_q=128,
                               page=page)
        compare(f"window s_q=128 page {page}", "B8", w128)
        compare(f"window s_q=128 page {page}", "B8", w128,
                fault="last split page")
    # d = 72 (a head's int8 slice only 8-byte aligned: 8-byte copies, in
    # both kernels) and d = 80 (16-byte copies, columns past d zero-filled)
    for d in (72, 80):
        w = paged_q8_inputs(gen, 2, 32, 32, d, [1536, 641], s_q=128)
        compare(f"window s_q=128 d={d}", "B8", w)
        compare(f"window s_q=128 d={d}", "B8", w, fault="last split page")
        dec = paged_q8_inputs(gen, 4, 32, 32, d, vicuna)
        compare(f"decode d={d}", "B7", dec)
        compare(f"decode d={d}", "B7", dec, fault="last split page")

    def timing(name, inputs, slopes, flops):
        q, kv, ks, vv, vs, lens, tabs = inputs
        fn = fns[name]
        ms = time_ms(lambda: fn(q, kv, ks, vv, vs, lens, tabs,
                                alibi_slopes=slopes))
        plain_ms = time_ms(lambda: plain(q)(q, kv, ks, vv, vs, lens, tabs,
                                            alibi_slopes=slopes), iters=5)
        host = host_us(lambda: fn(q, kv, ks, vv, vs, lens, tabs,
                                  alibi_slopes=slopes))
        hkv = kv.shape[2] // q.shape[-1]
        live = int(lens.sum())
        # each live int8 K/V row once, each live (token, head) scale of K
        # and V once (4 bytes), q in, out
        kv_bytes = live * kv.shape[2] * 2 + live * hkv * 4 * 2
        bms, by = bound_ms(flops, kv_bytes + 2 * nbytes(q))
        log(f"{name} {tuple(q.shape)} lengths {lens.tolist()} int8 pages: "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bms:.4f} "
            f"ms ({by}), library none; wrapper {host:.1f} us of host time a "
            f"call")
        return dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                    host_us_per_call=host, shape=list(q.shape),
                    lengths=lens.tolist())

    def row(name, fn_name, inputs, slopes, flops):
        return dict(name=f"{name} {fn_name}", route="cuda",
                    source=PAGED_SOURCE, replaces=PAGED_REPLACES[name],
                    max_abs_err=max(errs[name]), library_ms=None,
                    **timing(name, inputs, slopes, flops))

    b8_path = [timing("B8", inputs, None, window_flops(inputs[0], inputs[5]))
               for inputs in path.values()]
    b8_path.append(timing("B8", path_bc, s40,
                          window_flops(path_bc[0], path_bc[5])))
    rows = {
        "B7": row("B7", "paged_attention_dma_q8", dec_mha, None,
                  4.0 * 32 * 128 * int(dec_mha[5].sum())),
        "B7w": row("B7w", "paged_attention_dma_multi_q8", win5_bc, s40,
                   window_flops(win5_bc[0], win5_bc[5])),
        "B8": row("B8", "paged_attention_multi_blocked_q8", win128, None,
                  window_flops(win128[0], win128[5])),
        "B9": row("B9", "paged_attention_quantized", dec_mha, None,
                  4.0 * 32 * 128 * int(dec_mha[5].sum())),
    }
    rows["B8"]["path_shapes"] = b8_path
    return rows


# ---------------------------------------------------------------------------
# phases 3-5: the model
# ---------------------------------------------------------------------------

PATCH_ID, START_ID, END_ID = 32000, 32001, 32002


def mm_config(lm, vit):
    from merlin_tpu_torch.models.mmgpt import MMGPTConfig

    return MMGPTConfig(lm=lm, vit=vit, projector="conv", conv_stride=2,
                       image_patch_id=PATCH_ID, im_start_id=START_ID,
                       im_end_id=END_ID)


def prompt(rng, n_text: int, n_images: int, tok_len: int,
           ids_of=(PATCH_ID, START_ID, END_ID)):
    """Merlin-style prompt: text, then per image <im_start> patches
    <im_end>, then text (the tracking template puts two image blocks in
    one prompt); ``ids_of`` the (patch, start, end) ids."""
    patch, start, end = ids_of
    ids = [1] + list(rng.integers(10, 31000, size=n_text // 2))
    for _ in range(n_images):
        ids += [start] + [patch] * tok_len + [end]
        ids += list(rng.integers(10, 31000, size=8))
    ids += list(rng.integers(10, 31000, size=n_text - n_text // 2))
    return np.asarray(ids, np.int64)


def kernel_wrappers():
    """Every kernel wrapper of the port by its TPU kernel's number; each
    counts its bf16 kernel's launches in ``.launches`` and its f32 kernel's
    in ``.launches_f32``."""
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


def counters():
    """Every launch count by name: a wrapper's bf16 kernel under its TPU
    kernel's number ("B2"), its f32 kernel under the number and ``F32``
    ("B2_f32"); (wrapper, attribute) each."""
    out = {name: (fn, "launches") for name, fn in kernel_wrappers().items()}
    out.update({name + F32: (fn, "launches_f32")
                for name, fn in kernel_wrappers().items()})
    return out


def reset_counts():
    for fn, attr in counters().values():
        setattr(fn, attr, 0)


def read_counts():
    return {name: getattr(fn, attr)
            for name, (fn, attr) in counters().items()}


def launches(**nonzero):
    """A full launch-count dict: the given kernels, 0 for every other."""
    return {name: nonzero.get(name, 0) for name in counters()}


def suffixed(counts: dict, suffix: str) -> dict:
    """``counts`` with ``suffix`` on every name: an f32 model's launches
    land on the f32 kernels' counts."""
    return {name + suffix: n for name, n in counts.items()}


def mm_ids(cfg):
    """(image patch, <im_start>, <im_end>) ids of an MMGPT config."""
    return cfg.image_patch_id, cfg.im_start_id, cfg.im_end_id


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


def run_forward(model, cfg, rng, suffix=""):
    """One forward at b = 1, s = 512 with a frame; ``suffix`` F32 for an f32
    model, whose launches land on the f32 kernels."""
    from merlin_tpu_torch.ops.image_ops import preprocess_images

    tok_len = cfg.image_token_len
    b, s = 1, 512
    patch, start, end = mm_ids(cfg)
    ids = rng.integers(10, 31000, size=(b, s)).astype(np.int64)
    ids[:, 1] = start
    ids[:, 2:2 + tok_len] = patch
    ids[:, 2 + tok_len] = end
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
    if not ok or counts != launches(**suffixed(
            dict(B1=23, B2=cfg.lm.num_layers), suffix)):
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
    patch = ids == model.cfg.image_patch_id
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


def run_generation(model, cfg, rng, suffix=""):
    """Greedy generation, batch and stream, each row's logits held against
    a no-cache forward; ``suffix`` as in :func:`run_forward`."""
    from merlin_tpu_torch.generate.decode import GenerateConfig, Generator
    from merlin_tpu_torch.ops.image_ops import preprocess_images

    tok_len = cfg.image_token_len
    ids_of = mm_ids(cfg)
    max_new, bucket = 32, 128
    # eos -1: no early stop, so every request does the same fixed work
    gen = Generator(model, GenerateConfig(
        max_new_tokens=max_new, eos_id=-1, pad_id=0, prompt_bucket=bucket),
        device="cuda")
    prompts = [prompt(rng, 300 - tok_len - 10, 1, tok_len, ids_of),
               prompt(rng, 420 - tok_len - 10, 1, tok_len, ids_of),
               prompt(rng, 40, 2, tok_len, ids_of)]
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
    if out.shape != (3, max_new) or not (
            (out >= 0) & (out < cfg.lm.vocab_size)).all():
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
    want = launches(**suffixed(dict(B1=23), suffix))
    if batch_counts != want or stream_counts != want:
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


class ReplayCounter:
    """Counts the decode steps an engine replays from its captured step
    into ``calls["decode"]`` (a replay calls no module, so no forward hook
    sees it); ``remove()`` stops counting, as a hook's handle does."""

    def __init__(self, engine, calls):
        self.engine = engine
        replay = engine._replay_chunk

        def counted():
            chunk, last, replayed = replay()
            if replayed:
                calls["decode"] += engine.chunk_steps
            return chunk, last, replayed
        engine._replay_chunk = counted

    def remove(self):
        del self.engine._replay_chunk


def run_engine(tag, model, prompts, reached, suffix="", **engine_kw):
    """Serve ``prompts`` (32 new tokens each, no early stop) through a
    ``ServingEngine`` on the card. Each kernel's launches must equal the
    layers times the model calls of its kind (counted by forward hooks;
    a replay of the engine's captured decode step calls no module, so the
    decode calls add the replayed steps, and the capture's own call, which
    runs nothing, is not counted),
    the kernels in ``reached`` must launch and no other kernel may, every
    emitted token must hold against a no-cache forward of its request, and
    a planted prompt swap must fail that check. An int8 pool
    (``cache_dtype=torch.int8``) routes decode to B7 at s_q = 1 and windows
    to B7/B8, and its tokens are held to ``Q8_GEN_RTOL``. An f32 model
    (``suffix`` F32) runs the f32 kernels, whose counts take its launches
    (``reached`` names them). Returns (launch counts, readings)."""
    from merlin_tpu_torch.ops.paged_attention import WINDOW_SMALL_ROWS
    from merlin_tpu_torch.serve.engine import ServingEngine

    max_new = 32
    q8 = engine_kw.get("cache_dtype") == torch.int8
    tol = Q8_GEN_RTOL if q8 else GEN_RTOL
    engine = ServingEngine(model, eos_id=-1, device="cuda", **engine_kw)
    cfg = engine.lm_cfg
    group = cfg.num_heads // cfg.kv_heads
    layers = engine.cache["layers"]
    if engine._stacked:              # one (L, P, ...) tensor per key
        layers = [layers]
    pool = nbytes(*(t for layer in layers for t in layer.values()))
    # the same pool as bf16 pages: K and V, 2 bytes a value, no scales
    pool_bf16 = sum(2 * 2 * layer["k_pages"].numel() for layer in layers)
    free_start = engine.pool.free_pages
    calls = collections.Counter()

    def counter(window):
        def hook(module, args, kwargs, output):
            if torch.cuda.is_current_stream_capturing():
                return
            s = args[0].shape[1]
            if window:
                small = group * s <= WINDOW_SMALL_ROWS
                calls["window_small" if small else "window_large"] += 1
            else:
                calls["prefill" if s > 1 else "decode"] += 1
        return hook

    hooks = [engine.model.register_forward_hook(counter(False),
                                                with_kwargs=True),
             ReplayCounter(engine, calls)]
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
    free_end = engine.pool.free_pages
    stats = engine.stats()
    engine.close()
    if free_end != free_start:
        raise AssertionError(f"{tag}: {free_end} free pages after the run, "
                             f"{free_start} before")
    n = cfg.num_layers
    alibi = cfg.positional == "alibi"
    if q8:
        want = dict(B2=n * calls["prefill"], B7=n * calls["decode"],
                    B7w=n * calls["window_small"],
                    B8=n * calls["window_large"])
    else:
        want = dict(B2=n * calls["prefill"],
                    B3=0 if alibi else n * calls["decode"],
                    B4=n * calls["decode"] if alibi else 0,
                    B5=n * calls["window_small"],
                    B6=n * calls["window_large"])
    want = launches(**suffixed(want, suffix))
    n_tok = sum(len(r.generated) for r in reqs)
    ttft = [round((first[i] - t0) * 1e3, 1) for i in range(len(prompts))]
    log(f"{tag}: {len(prompts)} requests, prompt lengths "
        f"{[len(p) for p in prompts]}, {n_tok} tokens in {wall:.3f} s -> "
        f"{n_tok / wall:.2f} tok/s aggregate; TTFT ms per request {ttft} "
        f"(host clock, from the emit callback); model calls {dict(calls)}; "
        f"KV pool {pool} bytes ({pool_bf16} as bf16 pages); "
        f"decode chunks replayed {stats['graph_replays']}, eager "
        f"{stats['eager_chunks']}; launches {counts}")
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
                        graph_replays=stats["graph_replays"],
                        eager_chunks=stats["eager_chunks"],
                        wall_s=wall, max_gap=max(gaps), pool_bytes=pool,
                        pool_bytes_bf16=pool_bf16, free_pages=free_end,
                        tokens=[r.generated for r in reqs])


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


def check_graph_replay(rng):
    """Phase G: the full-width Baichuan2-7B (RoPE, NormHead; f32 leaves,
    bf16 compute, as the worker serves them) in a 32-slot engine, bf16
    pages, ``chunk_steps`` 1, ``pipeline`` 8: 32 requests of 32 greedy
    tokens. The engine that replays its captured decode step must emit the
    tokens of the same engine kept eager by its test hook, token for
    token; B3 and B2 must count 32 layers times the decode steps (replayed
    or not) and the prefills. Returns the readings of both engines."""
    from merlin_tpu_torch.models.bridge import init_params
    from merlin_tpu_torch.models.decoder import CausalLM
    from merlin_tpu_torch.models.families import baichuan2_7b
    from merlin_tpu_torch.serve.engine import ServingEngine

    t0 = time.perf_counter()
    with torch.device("meta"):
        model = CausalLM(baichuan2_7b())
    init_params(model, torch.Generator(device="cuda").manual_seed(21),
                dtype=torch.float32, device="cuda")
    model.eval()
    log(f"G: Baichuan2-7B, f32 leaves, built in "
        f"{time.perf_counter() - t0:.1f} s")
    n, slots, max_new = model.cfg.num_layers, 32, 32
    prompts = serving_prompts(rng, rng.integers(100, 700, slots),
                              model.cfg.vocab_size)
    out = {}
    for eager in (False, True):
        engine = ServingEngine(model, eos_id=-1, device="cuda",
                               num_slots=slots, max_len=2048, page_size=128,
                               prompt_bucket=128, chunk_steps=1, pipeline=8)
        engine._eager_only = eager
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        reqs = [engine.submit(p, max_new_tokens=max_new) for p in prompts]
        engine.run_until_idle()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts, stats = read_counts(), engine.stats()
        peak = torch.cuda.max_memory_allocated()
        engine.close()
        free_cuda()
        steps = stats["graph_replays"] + stats["eager_chunks"]
        tag = "eager" if eager else "replayed"
        want = launches(B2=n * stats["admitted"], B3=n * steps)
        log(f"G {tag}: {sum(len(r.generated) for r in reqs)} tokens in "
            f"{wall:.3f} s (capture included); decode chunks replayed "
            f"{stats['graph_replays']}, eager {stats['eager_chunks']}; "
            f"launches {counts}; peak {peak} bytes")
        if counts != want:
            raise AssertionError(f"G {tag}: launches {counts}, expected "
                                 f"{want}")
        if any(r.error or len(r.generated) != max_new for r in reqs):
            raise AssertionError(f"G {tag}: a request failed or ended early")
        out[tag] = dict(tokens=[r.generated for r in reqs], wall_s=wall,
                        graph_replays=stats["graph_replays"],
                        eager_chunks=stats["eager_chunks"], peak_bytes=peak)
    del model
    free_cuda()
    same = out["replayed"]["tokens"] == out["eager"]["tokens"]
    differ = [i for i, (a, b) in enumerate(zip(out["replayed"]["tokens"],
                                                out["eager"]["tokens"]))
              if a != b]
    log(f"G: replayed tokens equal the eager engine's: {same} (requests "
        f"that differ: {differ})")
    if not same or out["replayed"]["graph_replays"] == 0 \
            or out["eager"]["graph_replays"] != 0:
        raise AssertionError("G: the replayed engine's tokens or counts "
                             "disagree with the eager engine's")
    return {tag: {k: v for k, v in r.items() if k != "tokens"}
            for tag, r in out.items()}


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


def serve_vicuna(model, rng, prompts):
    """E1 and E2 on the full-width Vicuna-7B MMGPT, text-only requests as
    the worker's engine path serves them; their prompts go into
    ``prompts`` (phase M2 serves them again)."""
    prompts["E1"] = serving_prompts(rng, SERVING_LENGTHS, 32000)
    e1 = run_engine("E1 vicuna-7b (whole-prompt admission, decode)", model,
                    prompts["E1"], ["B2", "B3"], chunk_steps=8, pipeline=1,
                    **SERVING)
    prompts["E2"] = serving_prompts(rng, SERVING_LENGTHS, 32000, period=48)
    e2 = run_engine("E2 vicuna-7b (chunked prefill C=128, spec k=4)", model,
                    prompts["E2"], ["B5", "B6"], prefill_chunk=128,
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


def serve_vicuna_int8(model, rng, prompts):
    """E4 on the int8-weight Vicuna-7B MMGPT over int8 pages: short prompts
    whole (B2, quantized into the pages), long ones in 128-token windows
    (B8), decode through B7 at s_q = 1."""
    prompts["E4"] = serving_prompts(rng, SERVING_LENGTHS, 32000)
    return run_engine(
        "E4 vicuna-7b int8 weights + int8 pages (hybrid C=128 min 256)",
        model, prompts["E4"],
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
# phase S: the scan_layers layout served from one stacked paged pool
# ---------------------------------------------------------------------------

# 8 slots x 2304 tokens in pages of 128: 144 pages a layer, and a flat pool
# of 32 x 144 pages of 128 x 4096 values, so layers 29-31 start past 2**31
# values of the pool and their page offsets need 64 bits
S_SERVING = dict(num_slots=8, max_len=2304, page_size=128, prompt_bucket=128)
S_FAULT_NEW = 8              # tokens of the planted dropped-offset run


def scanned_copy(model):
    """The same ``MMGPT`` (or ``CausalLM``) built with ``scan_layers``: its
    LM layers stacked by ``stack_layer_params`` (new tensors), every other
    tensor shared with ``model``."""
    from merlin_tpu_torch.models.convert import stack_layer_params

    cfg = model.cfg
    mm = hasattr(cfg, "lm")
    lm = dataclasses.replace(cfg.lm if mm else cfg, scan_layers=True)
    scfg = dataclasses.replace(cfg, lm=lm) if mm else lm
    with torch.device("meta"):
        smodel = type(model)(scfg)
    smodel.load_state_dict(stack_layer_params(
        dict(model.state_dict()), lm.num_layers,
        prefix="lm." if mm else ""), strict=True, assign=True)
    return smodel.eval()


def flat_pool_reach(smodel):
    """(the element offset of the last layer's first page in the flat
    pool, its pages) for ``S_SERVING``: > 2**31 is the point."""
    lm = smodel.cfg.lm if hasattr(smodel.cfg, "lm") else smodel.cfg
    pages = S_SERVING["num_slots"] * (S_SERVING["max_len"]
                                      // S_SERVING["page_size"])
    per_page = S_SERVING["page_size"] * lm.kv_heads * lm.head_size
    return (lm.num_layers - 1) * pages * per_page, lm.num_layers * pages


def s_pair(tag, loop_model, scan_model, prompts, reached, **kw):
    """One traffic mix through the loop engine and the scanned engine, both
    at ``S_SERVING``: every check of ``run_engine`` on each, and each
    request's tokens equal. Returns the scanned run's (counts, readings)
    with the loop run's beside them."""
    loop = run_engine(f"{tag} loop", loop_model, prompts, reached, **kw,
                      **S_SERVING)
    scan = run_engine(f"{tag} scan_layers", scan_model, prompts, reached,
                      **kw, **S_SERVING)
    same = scan[1]["tokens"] == loop[1]["tokens"]
    log(f"{tag}: scanned tokens equal the loop engine's for every request: "
        f"{same}; launches loop {loop[0]} / scanned {scan[0]}")
    if not same or scan[0] != loop[0]:
        raise AssertionError(f"{tag}: the scanned engine differs from the "
                             "loop engine")
    scan[1]["loop"] = {k: v for k, v in loop[1].items() if k != "tokens"}
    return scan


def s_dropped_offset(smodel, prompts, want):
    """Planted fault: the flat pool's per-layer page offset dropped, so
    every layer reads and writes layer 0's pages in the decode steps. The
    tokens must then differ from the loop engine's."""
    from merlin_tpu_torch.models.decoder import ScannedLayers
    from merlin_tpu_torch.serve.engine import ServingEngine

    real = ScannedLayers._layer_caches

    def dropped(self, kv_cache, cache_aux):
        out = real(self, kv_cache, cache_aux)
        if kv_cache is not None and "page_tables" in kv_cache:
            out = [(c, dict(a, page_tables=kv_cache["page_tables"]))
                   for c, a in out]
        return out

    ScannedLayers._layer_caches = dropped
    try:
        engine = ServingEngine(smodel, eos_id=-1, device="cuda",
                               chunk_steps=8, **S_SERVING)
        reqs = [engine.submit(p, max_new_tokens=S_FAULT_NEW)
                for p in prompts[:2]]
        engine.run_until_idle()
        engine.close()
    finally:
        ScannedLayers._layer_caches = real
    got = [r.generated for r in reqs]
    differs = got != [w[:S_FAULT_NEW] for w in want[:2]]
    log(f"S planted fault (page offset dropped): tokens differ from the loop "
        f"engine's: {differs}")
    if not differs:
        raise AssertionError("S: a dropped layer offset went unseen")


def serve_scanned(model, rng):
    """S1 (whole prompt + decode: B2, B3) and S2 (chunked C=128 + spec k=4:
    B6, B5) on the full-width Vicuna-7B MMGPT, loop and scanned, at
    ``S_SERVING``; the planted dropped offset. Returns (readings, the
    scanned model)."""
    smodel = scanned_copy(model)
    reach, pages = flat_pool_reach(smodel)
    log(f"S: scanned copy of the Vicuna-7B MMGPT (layers stacked: "
        f"{tuple(smodel.lm.layers.block.attn.q_proj.kernel.shape)}); flat "
        f"pool of {pages} pages, the last layer's first page at element "
        f"{reach} (2**31 = {2 ** 31})")
    if reach <= 2 ** 31:
        raise AssertionError("S: the flat pool does not pass 2**31")
    prompts = serving_prompts(rng, SERVING_LENGTHS, 32000)
    out = {"S1": s_pair("S1 vicuna-7b (whole prompt, decode)", model, smodel,
                        prompts, ["B2", "B3"], chunk_steps=8, pipeline=1)}
    # the scanned tokens equal the loop engine's (s_pair checked)
    s_dropped_offset(smodel, prompts, out["S1"][1]["tokens"])
    out["S2"] = s_pair("S2 vicuna-7b (chunked C=128, spec k=4)", model,
                       smodel, serving_prompts(rng, SERVING_LENGTHS, 32000,
                                               period=48),
                       ["B5", "B6"], prefill_chunk=128,
                       prefill_windows_per_step=4, spec_draft=4,
                       chunk_steps=1)
    return out, smodel


def check_stacked_int8(qmodel, sqmodel):
    """The stacked quantizer's int8 LM equals the loop quantizer's layers
    stacked, leaf for leaf (one scale per layer and channel)."""
    from merlin_tpu_torch.models.convert import stack_layer_params

    want = stack_layer_params(dict(qmodel.state_dict()),
                              qmodel.cfg.lm.num_layers, prefix="lm.")
    got = sqmodel.state_dict()
    bad = [n for n in got if not torch.equal(got[n], want[n])]
    log(f"S4: stacked int8 LM ({len(got)} leaves) equals the loop int8 LM "
        f"stacked: {not bad and sorted(got) == sorted(want)}")
    if bad or sorted(got) != sorted(want):
        raise AssertionError(f"S4: stacked quantizer differs: {bad[:4]}")


def serve_scanned_int8(qmodel, sqmodel, rng):
    """S4: the int8-weight LM over int8 pages, hybrid (B2, B8, B7), loop
    and scanned at ``S_SERVING``."""
    return s_pair("S4 vicuna-7b int8 weights + int8 pages (hybrid C=128 "
                  "min 256)", qmodel, sqmodel,
                  serving_prompts(rng, SERVING_LENGTHS, 32000),
                  ["B2", "B7", "B8"], cache_dtype=torch.int8,
                  prefill_chunk=128, prefill_chunk_min=256, chunk_steps=8,
                  pipeline=1)


def serve_scanned_alibi(rng):
    """S3: Baichuan-13B cut to 4 layers (E3's model), ALiBi, hybrid, loop
    and scanned at ``S_SERVING``: B4 over a flat pool (B2, B6 too)."""
    model = build_baichuan()
    smodel = scanned_copy(model)
    out = s_pair("S3 baichuan-13b 4 layers (alibi, hybrid C=128 min 256)",
                 model, smodel,
                 serving_prompts(rng, [100, 200, 700, 1300, 120, 900],
                                 64000), ["B2", "B4", "B6"],
                 prefill_chunk=128, prefill_chunk_min=256)
    del model, smodel
    free_cuda()
    return out


# ---------------------------------------------------------------------------
# phase: the serving front end (controller -> model worker -> CLI over HTTP)
# ---------------------------------------------------------------------------

W_MAX_NEW = 32
W_BEAM_NEW = 16
W1_WORDS = (100, 300, 700, 1100)   # the first prompt <= 256 tokens: B2
W2_WORDS = (200, 1100)             # one whole prompt (B2), one chunked (B8)
W_REPEAT = 48                      # the segment one W1 prompt repeats
BEAM_SCORE_TOL = 2e-3              # the beam's normalized log-prob score,
                                   # search (cached, mha_reference) against
                                   # a no-cache forward (B2), both bf16.
                                   # Seen on an H100 80GB HBM3 at 700 W:
                                   # 2.0e-4; the cache gathered with the
                                   # beam index rotated by one 1.36e-2
W_ENGINE = dict(use_engine=True, engine_slots=4, engine_max_len=2048,
                engine_prefill_chunk=128, engine_prefill_chunk_min=256)
W_QUESTION = "describe what the frame shows and where each object is"


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def prime_tokenizer(tok, vocab: int, texts) -> list:
    """Encode distinct words until every id up to ``vocab`` is a word: the
    words of ``texts`` first (the template's, the questions'), then
    fillers. Then an answer's text maps back to its token ids exactly.
    Returns the fillers, from which the prompts are drawn."""
    needed = dict.fromkeys(w for t in texts for w in tok.tokenize(t))
    tok.encode(" ".join(w for w in needed
                        if tok.convert_tokens_to_ids(w) == tok.unk_token_id),
               add_special_tokens=False)
    fillers = []
    # ids are given in order: id vocab - 1 is the last one to fill
    while tok.decode([vocab - 1]) == tok.unk_token:
        fillers.append(f"w{len(fillers)}")
        tok.encode(fillers[-1], add_special_tokens=False)
    if tok.decode([vocab]) != tok.unk_token or not fillers:
        raise AssertionError(f"priming failed at {len(fillers)} fillers")
    return fillers


def w_prompts(rng, fillers, n_words, repeat_first=False):
    """Conversation prompts of ``n_words`` random primed words each (the
    v1 template, as ``cli.chat`` sends them); with ``repeat_first`` the
    last prompt repeats one ``W_REPEAT``-word segment."""
    from merlin_tpu_torch.utils.conversation import conv_templates

    out = []
    for i, n in enumerate(n_words):
        words = [fillers[j] for j in rng.integers(0, len(fillers), size=n)]
        if repeat_first and i == len(n_words) - 1:
            words = list(np.resize(words[:W_REPEAT], n))
        conv = conv_templates["v1"].copy()
        conv.append_message(conv.roles[0], " ".join(words))
        conv.append_message(conv.roles[1], None)
        out.append(conv.get_prompt())
    return out


def w_image_prompt(n_images: int) -> str:
    from merlin_tpu_torch.utils.conversation import conv_templates

    conv = conv_templates["v1"].copy()
    conv.append_message(conv.roles[0], "<image>\n" * n_images + W_QUESTION)
    conv.append_message(conv.roles[1], None)
    return conv.get_prompt()


def png_b64(frame) -> str:
    import base64
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(frame).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def w_request(address, payload):
    """One request through the controller's relay with the port's CLI
    client: (chunks, seconds to each chunk from the send)."""
    from merlin_tpu_torch.serve.cli import stream_request

    t0 = time.perf_counter()
    chunks, stamps = [], []
    for chunk in stream_request(address, payload):
        chunks.append(chunk)
        stamps.append(time.perf_counter() - t0)
    return chunks, stamps


def answer_logits(model, prompt_ids, images, tail):
    """(len(tail) + 1, V) f32 logits after ``prompt_ids`` + each prefix of
    ``tail`` from one no-cache forward (B1 for the images, B2 for the LM);
    image features splice into the prompt's patch tokens only, as the
    decode steps embed generated ids as they are."""
    from merlin_tpu_torch.models.mmgpt import splice_image_embeds

    ids = torch.tensor(list(prompt_ids) + list(tail), device="cuda")[None]
    with torch.no_grad():
        embeds = model.lm.embed(ids)
        if images is not None:
            patch = ids == model.cfg.image_patch_id
            patch[:, len(prompt_ids):] = False
            feats = model.encode_images(images.reshape(
                (-1,) + images.shape[2:])).reshape(
                1, -1, model.cfg.lm.hidden_size)
            embeds = splice_image_embeds(embeds, patch, feats)
        logits, _ = model.lm(inputs_embeds=embeds)
    return logits[0, len(prompt_ids) - 1:].float()


def hold_answer(tag, model, tok, prompt_ids, images, text, n_tokens, tol):
    """Map an answer's text back to ids and hold every token against one
    no-cache forward of its request (the ``token_gap`` rule: max logit
    minus the token's, of max |logit|, at most ``tol``). Ids that decode to
    no text (special tokens) are invisible in the text: where the forward's
    argmax is one of them and the text's token does not hold, it is taken
    as emitted there; with ``n_tokens`` (a stream: one chunk a token) the
    answer's tail is completed the same way, each such token an argmax
    among the special ids or EOS. Returns (largest gap, tokens)."""
    ids = tok.encode(text, add_special_tokens=False)
    if tok.decode(ids) != text:
        raise AssertionError(f"{tag}: the text does not map back to ids")
    hidden = {tok.convert_tokens_to_ids(t) for t in tok.special_tokens}
    seq = list(ids)
    while True:
        rows = answer_logits(model, prompt_ids, images, seq)
        picked = rows[torch.arange(len(seq), device="cuda"),
                      torch.tensor(seq, device="cuda").long()]
        gaps = ((rows[:len(seq)].amax(-1) - picked)
                / rows[:len(seq)].abs().amax(-1)).tolist()
        bad = next((j for j, g in enumerate(gaps) if g > tol), None)
        at = bad if bad is not None else len(seq)
        if bad is None and (n_tokens is None or len(seq) >= n_tokens):
            return max(gaps, default=0.0), seq
        top = int(rows[at].argmax())
        if top not in hidden or (n_tokens is not None
                                 and len(seq) >= n_tokens):
            raise AssertionError(f"{tag}: token {at} disagrees with the "
                                 f"no-cache forward (gaps {gaps})")
        seq.insert(at, top)


def beam_score_gap(model, tok, ids, images, seq, score) -> float:
    """|the beam's normalized score - the mean log-prob that a no-cache
    forward gives its sequence up to its stop token|."""
    seq = [int(t) for t in seq]
    n = seq.index(tok.eos_token_id) + 1 if tok.eos_token_id in seq \
        else len(seq)
    rows = torch.log_softmax(answer_logits(model, ids, images, seq[:n - 1]),
                             -1)
    lp = rows[torch.arange(n, device="cuda"),
              torch.tensor(seq[:n], device="cuda").long()].sum()
    return abs(lp.item() / n - float(score))


def beam_hold(tag, em, model, question, frame, text, seconds):
    """The beam check: the sequence ``em.ask`` returned (``text``), searched
    again, has the best score the search kept, as a no-cache forward of
    ``model`` recomputes it (within ``BEAM_SCORE_TOL``); a cache gathered
    with the beam index rotated by one must fail that. Returns (gap,
    planted gap)."""
    from merlin_tpu_torch.generate import beam as beam_mod

    tok = em.tokenizer
    ids = tok(em.build_prompt(question, num_images=1))["input_ids"][0]
    image = em.preprocess_images([frame])
    seqs, scores = em._engine.search(np.asarray([ids]), images=image)
    if em.decode_output(seqs[0]) != text:
        raise AssertionError(f"{tag} beam: search() and ask() disagree")
    image_t = torch.from_numpy(image).to("cuda")
    honest = beam_score_gap(model, tok, ids, image_t, seqs[0], scores[0])
    gather = beam_mod._gather_beams
    beam_mod._gather_beams = lambda cache, idx, b, k: gather(
        cache, idx.roll(1, dims=1), b, k)
    try:
        bad_seqs, bad_scores = em._engine.search(np.asarray([ids]),
                                                 images=image)
    finally:
        beam_mod._gather_beams = gather
    planted = beam_score_gap(model, tok, ids, image_t, bad_seqs[0],
                             bad_scores[0])
    log(f"{tag} beam ({em.cfg.num_beams} beams, {em.cfg.max_new_tokens} "
        f"tokens, 1 image) in {seconds:.3f} s: {text!r}; score "
        f"{float(scores[0]):.4f}, recomputed gap {honest:.3e} (tol "
        f"{BEAM_SCORE_TOL}); planted fault (beam index rotated in the cache "
        f"gather): gap {planted:.3e}, must exceed it")
    if not honest <= BEAM_SCORE_TOL < planted:
        raise AssertionError(f"{tag} beam score check: {honest} {planted}")
    return honest, planted


def w_worker_log():
    """Collect what the port's workers log, to find engine failures."""
    import logging

    records = []

    class Keep(logging.Handler):
        def emit(self, record):
            records.append(record.getMessage())

    handler = Keep()
    logging.getLogger("merlin_tpu_torch.worker").addHandler(handler)
    return records, handler


def start_stack(bundle, workers):
    """A controller (shortest queue) and one worker per (name, kwargs) in
    ``workers``, all on loopback, serving from daemon threads. Returns
    (controller address, {name: worker}, servers)."""
    import threading

    from merlin_tpu_torch.serve import controller as ctrl_mod
    from merlin_tpu_torch.serve import worker as worker_mod
    from merlin_tpu_torch.serve.protocol import http_json

    servers = []

    def run(server):
        threading.Thread(target=server.serve_forever, daemon=True).start()
        servers.append(server)

    run(ctrl_mod.serve(host="127.0.0.1", port=free_port(),
                       dispatch_method="shortest_queue"))
    ctrl = f"http://127.0.0.1:{servers[0].server_address[1]}"
    out = {}
    for name, kw in workers:
        server = worker_mod.serve(bundle, host="127.0.0.1", port=free_port(),
                                  controller_address=ctrl,
                                  model_names=[name], device="cuda", **kw)
        run(server)
        out[name] = server.worker
    models = http_json("POST", ctrl + "/list_models")["models"]
    if models != sorted(name for name, _ in workers):
        raise AssertionError(f"/list_models gave {models}")
    return ctrl, out, servers


def stop_stack(servers, workers):
    """Stop every server, worker (engine loop, heartbeats, the engine's
    pool) and the controller's expiry thread."""
    for server in servers:
        server.shutdown()
        server.server_close()
    for worker in workers.values():
        worker.stop()
    servers[0].controller.stop()


def engine_counter(worker, calls):
    """Forward hooks counting a worker's engine model calls by kind, as
    ``run_engine`` counts them (the engine's replayed decode steps too, and
    not the capture's call, which runs nothing); dense-cache calls (the
    per-request generators) are counted apart by their token count."""
    from merlin_tpu_torch.ops.paged_attention import WINDOW_SMALL_ROWS

    cfg = worker.bundle.config.lm
    group = cfg.num_heads // cfg.kv_heads

    def hook(window):
        def count(module, args, kwargs, output):
            if torch.cuda.is_current_stream_capturing():
                return
            s = args[0].shape[1]
            cache = kwargs.get("kv_cache")
            if cache is None:
                return
            if "page_tables" not in cache:
                calls[f"dense s={s}"] += 1
            elif window:
                small = group * s <= WINDOW_SMALL_ROWS
                calls["window_small" if small else "window_large"] += 1
            else:
                calls["prefill" if s > 1 else "decode"] += 1
        return count

    hooks = [worker.bundle.model.register_forward_hook(hook(False),
                                                       with_kwargs=True)]
    if worker.engine is not None:
        hooks.append(ReplayCounter(worker.engine, calls))
    if worker.engine is not None and worker.engine.multi_model is not None:
        hooks.append(worker.engine.multi_model.register_forward_hook(
            hook(True), with_kwargs=True))
    return hooks


def tower_counter(model, encoded):
    """Counts the tower's calls and the images they encode: a call runs
    all of a request's images as one batch, one B1 launch a layer."""
    def count(module, args, output):
        encoded[0] += 1
        encoded[1] += args[0].shape[0]
    return [model.vision_tower.register_forward_hook(count)]


def w_readings(tag, chunks, stamps, smi):
    texts = [c["text"] for c in chunks]
    if not chunks or any(c.get("error_code") for c in chunks):
        raise AssertionError(f"{tag}: an error chunk: {chunks[-1:]}")
    if any(not b.startswith(a) for a, b in zip(texts, texts[1:])):
        raise AssertionError(f"{tag}: a chunk is not a prefix of the next")
    n = len(chunks)
    read = dict(ttft_ms=round(stamps[0] * 1e3, 1),
                total_ms=round(stamps[-1] * 1e3, 1), chunks=n)
    if n > 1:
        read["decode_tok_s"] = round((n - 1) / (stamps[-1] - stamps[0]), 2)
    log(f"{tag}: TTFT {read['ttft_ms']} ms, answer in {read['total_ms']} "
        f"ms, {n} chunks" + (f", {read['decode_tok_s']} tok/s after the "
                             f"first" if n > 1 else "")
        + f" (host clock at the client; card {smi})")
    return read


def decoded_images(frames, size):
    """The images as the worker sees them: PNG-decoded, resized by
    ``preprocess_pil``, (1, n, size, size, 3) uint8 on the card."""
    from merlin_tpu_torch.data.images import preprocess_pil
    from PIL import Image

    arr = np.stack([preprocess_pil(Image.fromarray(f), size, "resize")
                    for f in frames])
    return torch.from_numpy(arr).to("cuda")[None]


def w_check_launches(tag, counts, calls, n_layers, tower_calls, q8,
                     reached=None):
    n = n_layers
    if q8:
        want = launches(B2=n * calls["prefill"], B7=n * calls["decode"],
                        B7w=n * calls["window_small"],
                        B8=n * calls["window_large"])
        reached = reached or {"B2", "B7", "B8"}
    else:
        want = launches(B1=23 * tower_calls, B2=n * calls["prefill"],
                        B3=n * calls["decode"],
                        B5=n * calls["window_small"],
                        B6=n * calls["window_large"])
        reached = reached or {"B1", "B2", "B3", "B6"}
    log(f"{tag} launches {counts}; model calls {dict(calls)}; tower "
        f"calls {tower_calls}")
    if counts != want or any((v > 0) != (k in reached)
                             for k, v in counts.items()):
        raise AssertionError(f"{tag}: launches {counts}, expected {want} "
                             f"with {sorted(reached)} reached")


def run_w1(bundle, rng, fillers, frames, smi):
    """W1: a controller and two workers on one bf16-computing bundle, all
    requests through the relay with the port's CLI client."""
    import threading

    from merlin_tpu_torch.eval.runner import EvalConfig, EvalModel
    from merlin_tpu_torch.utils import constants as C

    tok, model = bundle.tokenizer, bundle.model
    placeholder = C.image_placeholder(bundle.config.image_token_len)
    ctrl, workers, servers = start_stack(bundle, [
        ("merlin-engine", W_ENGINE), ("merlin-spec", dict(speculative=4))])
    records, handler = w_worker_log()
    calls = collections.Counter()
    encoded = [0, 0]                  # tower calls, images
    hooks = engine_counter(workers["merlin-engine"], calls) \
        + tower_counter(model, encoded)
    base = dict(temperature=0.0, max_new_tokens=W_MAX_NEW, stop="</s>")
    texts = w_prompts(rng, fillers, W1_WORDS, repeat_first=True)
    results = [None] * len(texts)

    def send(i):
        results[i] = w_request(ctrl, dict(base, model="merlin-engine",
                                          prompt=texts[i]))

    torch.cuda.synchronize()
    reset_counts()
    threads = [threading.Thread(target=send, args=(i,))
               for i in range(len(texts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    two = w_image_prompt(2)
    results.append(w_request(ctrl, dict(
        base, model="merlin-engine", prompt=two,
        images=[png_b64(f) for f in frames[:2]])))
    one = w_image_prompt(1)
    results.append(w_request(ctrl, dict(
        base, model="merlin-spec", prompt=one, images=[png_b64(frames[2])])))
    spec_windows = calls[f"dense s={workers['merlin-spec'].speculative + 1}"]

    from PIL import Image
    em = EvalModel(bundle, EvalConfig(num_beams=5,
                                      max_new_tokens=W_BEAM_NEW),
                   device="cuda")
    beam_frame = Image.fromarray(frames[3])
    t0 = time.perf_counter()
    beam_text = em.ask(W_QUESTION, images=[beam_frame])
    beam_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    counts = read_counts()
    for h in hooks:
        h.remove()
    stop_stack(servers, workers)
    import logging
    logging.getLogger("merlin_tpu_torch.worker").removeHandler(handler)
    if any("engine step failed" in r or "generate failed" in r
           for r in records):
        raise AssertionError(f"W1: a worker logged a failure: {records}")
    w_check_launches("W1", counts, calls, bundle.config.lm.num_layers,
                     encoded[0], q8=False)
    if encoded != [3, 4]:
        raise AssertionError(f"W1: {encoded[1]} images in {encoded[0]} "
                             "tower calls, not 4 in 3")

    readings = {}
    names = [f"text {n} words" for n in W1_WORDS] + [
        "2 images (Generator.stream)", "1 image (speculative k=4)"]
    gaps = []
    for i, (name, (chunks, stamps)) in enumerate(zip(names, results)):
        readings[name] = w_readings(f"W1 {name}", chunks, stamps, smi)
        if i < len(texts):
            prompt, images = texts[i], None
        else:
            n_img = 2 if i == len(texts) else 1
            prompt = (two if n_img == 2 else one).replace("<image>",
                                                          placeholder)
            images = decoded_images(frames[:2] if n_img == 2
                                    else frames[2:3],
                                    bundle.config.vit.image_size)
        ids = tok(prompt)["input_ids"][0]
        spec = i == len(results) - 1
        gap, seq = hold_answer(f"W1 {name}", model, tok, ids, images,
                               chunks[-1]["text"],
                               None if spec else len(chunks), GEN_RTOL)
        readings[name].update(prompt_tokens=len(ids), tokens=len(seq),
                              max_gap=gap)
        gaps.append(gap)
        if spec:
            readings[name]["windows"] = spec_windows
            log(f"W1 speculative: {len(seq)} tokens in {spec_windows} "
                f"windows ({len(seq) / max(spec_windows, 1):.2f} tokens a "
                f"window)")
    log(f"W1 tokens vs a no-cache forward of each request: largest gap per "
        f"request {[f'{g:.2e}' for g in gaps]} of max |logit| (tol "
        f"{GEN_RTOL})")

    honest, planted = beam_hold("W1", em, model, W_QUESTION, beam_frame,
                                beam_text, beam_s)
    readings["beam"] = dict(seconds=round(beam_s, 3), score_gap=honest,
                            planted_gap=planted)
    sent = dict(texts=texts, answers=[c[-1]["text"] for c, _ in results],
                one=one)
    return counts, readings, sent


def w3_bundle(bundle):
    """The W1 bundle rebuilt through the worker's own command line with
    ``--scan-decode`` (``parse_worker_args``, ``build_model_tokenizer``),
    W1's weights stacked into it and W1's primed tokenizer."""
    from merlin_tpu_torch.models.builder import build_model_tokenizer
    from merlin_tpu_torch.models.convert import stack_layer_params
    from merlin_tpu_torch.serve.worker import parse_worker_args

    t0 = time.perf_counter()
    args, margs, dargs, targs = parse_worker_args(["--scan-decode"])
    w3 = build_model_tokenizer(margs, dargs, targs)
    loop_cfg = dataclasses.replace(w3.config, lm=dataclasses.replace(
        w3.config.lm, scan_layers=False))
    if not (args.scan_decode and margs.scan_layers and w3.config.lm.scan_layers
            and loop_cfg == bundle.config):
        raise AssertionError("W3: --scan-decode did not build the scanned "
                             "twin of the W1 bundle")
    w3.model.load_state_dict(stack_layer_params(
        dict(bundle.model.state_dict()), w3.config.lm.num_layers,
        prefix="lm."), strict=True, assign=True)
    w3.model.eval()
    w3.params = w3.model.state_dict()
    w3.tokenizer, w3.special_ids = bundle.tokenizer, bundle.special_ids
    torch.cuda.synchronize()
    log(f"W3: --scan-decode bundle, LM stacked "
        f"{tuple(w3.params['lm.layers.block.attn.q_proj.kernel'].shape)} "
        f"in {time.perf_counter() - t0:.1f} s")
    return w3


def w3_web(ctrl, frame, log_dir):
    """One chat request with a frame through the port's web server, then a
    vote. The conversation record and the archived image must appear under
    ``log_dir``. Returns (chunks, seconds to each, the question, the
    conversation log's record types)."""
    import base64
    import glob
    import hashlib
    import threading
    import urllib.request

    from merlin_tpu_torch.serve import web as web_mod

    server = web_mod.serve(ctrl, host="127.0.0.1", port=free_port(),
                           model="merlin-engine", log_dir=log_dir)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{server.server_address[1]}"
    question = "<image>\n" + W_QUESTION
    png = png_b64(frame)
    chunks, stamps = [], []
    try:
        t0 = time.perf_counter()
        req = urllib.request.Request(url + "/chat", data=json.dumps({
            "history": [["USER", question]], "images": [png],
            "temperature": 0.0, "max_new_tokens": W_MAX_NEW}).encode())
        with urllib.request.urlopen(req, timeout=600) as resp:
            buf = b""
            while True:
                data = resp.read1(1024)
                if not data:
                    break
                buf += data
                while b"\0" in buf:
                    raw, buf = buf.split(b"\0", 1)
                    if raw:
                        chunks.append(json.loads(raw))
                        stamps.append(time.perf_counter() - t0)
        answer = chunks[-1]["text"] if chunks else ""
        vote = urllib.request.Request(url + "/vote", data=json.dumps({
            "type": "upvote", "history": [["USER", question],
                                          ["ASSISTANT", answer]]}).encode())
        with urllib.request.urlopen(vote, timeout=60) as resp:
            voted = json.loads(resp.read())
    finally:
        server.shutdown()
        server.server_close()
    logs = glob.glob(os.path.join(log_dir, "conv-*.jsonl"))
    records = [json.loads(line) for path in logs for line in open(path)]
    digest = hashlib.md5(base64.b64decode(png)).hexdigest()
    archived = glob.glob(os.path.join(log_dir, "serve_images", "*",
                                      digest + ".jpg"))
    types = [r["type"] for r in records]
    chat = [r for r in records if r["type"] == "chat"]
    ok = (voted == {"ok": True} and types == ["chat", "upvote"]
          and chat[0]["images"] == [digest]
          and chat[0]["state"] == [["USER", question]]
          and len(archived) == 1
          and open(archived[0], "rb").read() == base64.b64decode(png))
    log(f"W3 web: conversation log {types}, image {digest} archived: "
        f"{len(archived)}; checks {ok}")
    if not ok:
        raise AssertionError(f"W3 web: logs {records} archived {archived}")
    return chunks, stamps, question, types


def w3_hold_web(model, tok, frame, chunks, stamps, question, types, smi):
    """The web chat's answer held against a no-cache forward of the prompt
    the web server built (its template for the model name)."""
    from merlin_tpu_torch.serve import web as web_mod
    from merlin_tpu_torch.utils import constants as C
    from merlin_tpu_torch.utils.conversation import conv_templates

    read = w_readings("W3 web chat (1 frame, through serve/web.py)", chunks,
                      stamps, smi)
    conv = conv_templates[web_mod.template_for_model("merlin-engine")].copy()
    conv.append_message(conv.roles[0], question)
    conv.append_message(conv.roles[1], None)
    prompt = conv.get_prompt().replace(
        "<image>", C.image_placeholder(model.cfg.image_token_len))
    ids = tok(prompt)["input_ids"][0]
    images = decoded_images([frame], model.cfg.vit.image_size)
    gap, seq = hold_answer("W3 web chat", model, tok, ids, images,
                           chunks[-1]["text"], len(chunks), GEN_RTOL)
    read.update(prompt_tokens=len(ids), tokens=len(seq), max_gap=gap,
                log_records=types)
    return read


def run_w3(bundle, sent, frames, smi):
    """W3: ``--scan-decode`` behind the front end. W1's bundle rebuilt
    scanned through the worker's argument path; W1's first two text prompts
    to an engine worker (B2 whole, B6 chunked, B3 decode) and its 1-frame
    prompt to a speculative worker (a stacked dense cache; B1): each
    answer must equal W1's. Then one chat through ``serve/web.py`` with a
    frame (B1), a vote, the log and the archived image, and
    ``serve/tools.test_message`` through the controller."""
    import tempfile
    import threading

    from merlin_tpu_torch.serve import tools as tools_mod

    w3 = w3_bundle(bundle)
    tok, model = w3.tokenizer, w3.model
    ctrl, workers, servers = start_stack(w3, [
        ("merlin-engine", W_ENGINE), ("merlin-spec", dict(speculative=4))])
    records, handler = w_worker_log()
    calls = collections.Counter()
    encoded = [0, 0]
    hooks = engine_counter(workers["merlin-engine"], calls) \
        + tower_counter(model, encoded)
    base = dict(temperature=0.0, max_new_tokens=W_MAX_NEW, stop="</s>")
    results = [None, None]

    def send(i):
        results[i] = w_request(ctrl, dict(base, model="merlin-engine",
                                          prompt=sent["texts"][i]))

    log_dir = tempfile.mkdtemp(prefix="chip_smoke_w3_")
    torch.cuda.synchronize()
    reset_counts()
    threads = [threading.Thread(target=send, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    results.append(w_request(ctrl, dict(
        base, model="merlin-spec", prompt=sent["one"],
        images=[png_b64(frames[2])])))
    web = w3_web(ctrl, frames[3], log_dir)
    said = []
    message = tools_mod.test_message(ctrl, model="merlin-engine",
                                     message=W_QUESTION, max_new_tokens=8,
                                     print_fn=said.append)
    torch.cuda.synchronize()
    counts = read_counts()
    for h in hooks:
        h.remove()
    stop_stack(servers, workers)
    import logging
    import shutil
    logging.getLogger("merlin_tpu_torch.worker").removeHandler(handler)
    shutil.rmtree(log_dir, ignore_errors=True)
    if any("engine step failed" in r or "generate failed" in r
           for r in records):
        raise AssertionError(f"W3: a worker logged a failure: {records}")
    w_check_launches("W3", counts, calls, w3.config.lm.num_layers,
                     encoded[0], q8=False)
    if encoded != [2, 2]:
        raise AssertionError(f"W3: {encoded[1]} images in {encoded[0]} "
                             "tower calls, not 2 in 2")
    names = ["text 100 words", "text 300 words", "1 image (speculative k=4)"]
    want = [sent["answers"][0], sent["answers"][1], sent["answers"][-1]]
    readings = {}
    for name, (chunks, stamps), w in zip(names, results, want):
        readings[name] = w_readings(f"W3 {name}", chunks, stamps, smi)
        readings[name]["equals_w1"] = chunks[-1]["text"] == w
    same = all(r["equals_w1"] for r in readings.values())
    log(f"W3 answers equal W1's for the same prompts: {same}; "
        f"tools.test_message answered {len(message.split())} words, "
        f"printed {said[:2]}")
    if not same:
        raise AssertionError("W3: a scanned answer differs from W1's")
    if not isinstance(message, str) or said[:2] != [
            "models: ['merlin-engine', 'merlin-spec']",
            f"worker: {workers['merlin-engine'].worker_address}"]:
        raise AssertionError(f"W3: test_message printed {said}")
    # test_message sends the question in the v1 template, text only
    from merlin_tpu_torch.utils.conversation import conv_templates

    conv = conv_templates["v1"].copy()
    conv.append_message(conv.roles[0], W_QUESTION)
    conv.append_message(conv.roles[1], None)
    gap, seq = hold_answer("W3 tools.test_message", model, tok,
                           tok(conv.get_prompt())["input_ids"][0], None,
                           message, None, GEN_RTOL)
    readings["web"] = w3_hold_web(model, tok, frames[3], *web, smi)
    readings["test_message"] = dict(tokens=len(seq), max_gap=gap)
    del w3, model
    return counts, readings


def run_w2(qbundle, rng, fillers, smi):
    """W2: one worker on the int8-weight LM over int8 pages, hybrid."""
    import threading

    tok, model = qbundle.tokenizer, qbundle.model
    ctrl, workers, servers = start_stack(qbundle, [
        ("merlin-int8", dict(W_ENGINE, engine_cache_dtype="int8"))])
    records, handler = w_worker_log()
    calls = collections.Counter()
    hooks = engine_counter(workers["merlin-int8"], calls)
    texts = w_prompts(rng, fillers, W2_WORDS)
    results = [None] * len(texts)

    def send(i):
        results[i] = w_request(ctrl, dict(
            model="merlin-int8", prompt=texts[i], temperature=0.0,
            max_new_tokens=W_MAX_NEW, stop="</s>"))

    torch.cuda.synchronize()
    reset_counts()
    threads = [threading.Thread(target=send, args=(i,))
               for i in range(len(texts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    torch.cuda.synchronize()
    counts = read_counts()
    for h in hooks:
        h.remove()
    stop_stack(servers, workers)
    import logging
    logging.getLogger("merlin_tpu_torch.worker").removeHandler(handler)
    if any("failed" in r for r in records):
        raise AssertionError(f"W2: a worker logged a failure: {records}")
    w_check_launches("W2", counts, calls, qbundle.config.lm.num_layers, 0,
                     q8=True)
    readings, gaps = {}, []
    for n, text, (chunks, stamps) in zip(W2_WORDS, texts, results):
        name = f"text {n} words"
        readings[name] = w_readings(f"W2 {name}", chunks, stamps, smi)
        ids = tok(text)["input_ids"][0]
        gap, seq = hold_answer(f"W2 {name}", model, tok, ids, None,
                               chunks[-1]["text"], len(chunks), Q8_GEN_RTOL)
        readings[name].update(prompt_tokens=len(ids), tokens=len(seq),
                              max_gap=gap)
        gaps.append(gap)
    log(f"W2 tokens vs a no-cache forward of each request: largest gap per "
        f"request {[f'{g:.2e}' for g in gaps]} of max |logit| (tol "
        f"{Q8_GEN_RTOL})")
    return counts, readings


# ---------------------------------------------------------------------------
# phase V: evaluation (the harnesses, their evaluators and engine/eval)
# ---------------------------------------------------------------------------

V_NEW = 16                         # new tokens a greedy or beam answer
V_TRACK_NEW = 24                   # ... a tracking answer
V_BEAMS = 5
V_BEAM_SCORE_TOL = 5e-2            # a beam's normalized log-prob score
                                   # (cached, bf16 cache) against a
                                   # no-cache forward (B2) at V's MMBench
                                   # prompts: ~1.1% of their mean max
                                   # |logit| (4.4), where the greedy holds
                                   # allow 5%. Seen on an H100 80GB HBM3
                                   # at 700 W: up to 1.85e-2. W1's prompt
                                   # reads 2.0e-4: BEAM_SCORE_TOL is its own
V_MMB = [("which shape is drawn in the frame",
          ("circle", "square", "triangle", "star"), "look at the centre"),
         ("what colour is the sky", ("red", "blue", "green", "grey"), None),
         ("how many dots are there", ("1", "2", "4", None), None)]
V_OPEN = ["what is shown here", "describe the picture in detail",
          "what is the total amount due", "which date is printed on it",
          "track the object"]
V_FRAME_WH = (640, 360)
V_TRACK_GT = {"car-1": [(100, 80, 160, 90), (110, 84, 160, 90),
                        (124, 90, 158, 92), (140, 95, 156, 92)],
              "dog-2": [(400, 200, 120, 100), (396, 204, 122, 100),
                        (390, 206, 124, 98), (384, 210, 124, 98)]}


def v_texts():
    """Every word a V prompt can hold, to prime the tokenizer with before
    the W phase fills the rest of its ids (C20): the MMBench instruction,
    option letters and rows, the questions, and the tracking prompt with
    every box it can carry (0-1000 in each place)."""
    from merlin_tpu_torch.eval import mmbench, tracking

    out = [mmbench.PROMPT_EN, "A. B. C. D.", *V_OPEN,
           tracking.TRACK_PROMPT.replace("<image>", " ")]
    for q, opts, hint in V_MMB:
        out += [q, " ".join(o for o in opts if o), hint or ""]
    out += [f"image0:<Id1>[{n:03d}, {n:03d}, {n:03d}]</Id1>"
            for n in range(1001)]
    return out


def read_json(path):
    with open(path) as f:
        return json.load(f)


def v_jpeg(path_or_buf, frame, quality=95):
    from PIL import Image

    Image.fromarray(frame).save(path_or_buf, format="JPEG", quality=quality)


def v_inputs(root, rng):
    """The harnesses' input files under ``root``, drawn from ``rng``:
    an MMBench TSV (3 questions x 2 circular shifts, 640x480 noise JPEGs in
    base64 cells over csv's 131072-character default limit), MM-Vet (a
    noise image and a black one), DocVQA (1000x800, with answers), two
    LaSOT-layout videos of 4 frames at 640x360, and two loose frames."""
    import base64
    import csv
    import io

    def noise(w, h):
        return rng.integers(0, 256, size=(h, w, 3), dtype=np.uint8)

    rows = []
    for q, (question, opts, hint) in enumerate(V_MMB):
        n = sum(1 for o in opts if o)
        for shift in (0, 1):
            rot = [opts[(j + shift) % n] for j in range(n)] + list(opts[n:])
            buf = io.BytesIO()
            v_jpeg(buf, noise(640, 480))
            cell = base64.b64encode(buf.getvalue()).decode()
            if len(cell) <= 131072:
                raise AssertionError("V: the JPEG cell is under csv's limit")
            rows.append([q + 1 + shift * 10 ** 6, question, hint or "",
                         *(o or "" for o in rot), "ABCD"[(q - shift) % n],
                         f"c{q % 2}", "perception", cell])
    with open(os.path.join(root, "mmbench_dev_en.tsv"), "w", newline="") as f:
        w = csv.writer(f, delimiter="\t", lineterminator="\n")
        w.writerow(["index", "question", "hint", "A", "B", "C", "D", "answer",
                    "category", "l2-category", "image"])
        w.writerows(rows)
    img = os.path.join(root, "images")
    os.makedirs(img)
    v_jpeg(os.path.join(img, "noise.jpg"), noise(640, 480))
    v_jpeg(os.path.join(img, "black.jpg"), np.zeros((480, 640, 3), np.uint8))
    for i in range(2):
        v_jpeg(os.path.join(img, f"doc{i}.jpg"), noise(1000, 800))
        v_jpeg(os.path.join(img, f"frame{i}.jpg"), noise(*V_FRAME_WH))
    with open(os.path.join(root, "mmvet.json"), "w") as f:
        json.dump({"v1_0": {"imagename": "noise.jpg", "question": V_OPEN[0]},
                   "v1_1": {"imagename": "black.jpg",
                            "question": V_OPEN[1]}}, f)
    with open(os.path.join(root, "docvqa.json"), "w") as f:
        json.dump({"data": [
            {"questionId": 1, "question": V_OPEN[2], "image": "doc0.jpg",
             "answers": ["$42", "42 dollars"]},
            {"questionId": 2, "question": V_OPEN[3], "image": "doc1.jpg",
             "answers": ["10 may"]}]}, f)
    for name, boxes in V_TRACK_GT.items():
        os.makedirs(os.path.join(root, "videos", name, "img"))
        for i in range(len(boxes)):
            v_jpeg(os.path.join(root, "videos", name, "img",
                                f"{i + 1:08d}.jpg"), noise(*V_FRAME_WH))
        with open(os.path.join(root, "videos", name, "groundtruth.txt"),
                  "w") as f:
            f.write("".join(",".join(map(str, b)) + "\n" for b in boxes))


class VRecorder:
    """Records every decode ``EvalModel`` runs (its ids, mask, images and
    tokens, and a beam search's sequences and scores), while installed."""

    def __init__(self):
        from merlin_tpu_torch.eval.runner import EvalModel
        from merlin_tpu_torch.generate.beam import BeamSearch

        self.calls, self.scores = [], []
        self._run, self._search = EvalModel._run, BeamSearch.search
        run, search = self._run, self._search

        def record_run(em, ids, images, generator, **kw):
            out = run(em, ids, images, generator, **kw)
            beam = self.scores.pop() if em.cfg.num_beams > 1 else None
            self.calls.append(dict(em=em, ids=np.asarray(ids),
                                   mask=kw.get("attention_mask"),
                                   images=images, out=np.asarray(out),
                                   beam=beam))
            return out

        def record_search(beam, *a, **kw):
            seqs, scores = search(beam, *a, **kw)
            self.scores.append((seqs, scores))
            return seqs, scores

        EvalModel._run, BeamSearch.search = record_run, record_search

    def close(self):
        from merlin_tpu_torch.eval.runner import EvalModel
        from merlin_tpu_torch.generate.beam import BeamSearch

        EvalModel._run, BeamSearch.search = self._run, self._search


def v_rows(call):
    """One decode's rows: (prompt ids, images as (1, n, S, S, 3) on the
    card or None, tokens)."""
    ids, mask, images, out = call["ids"], call["mask"], call["images"], \
        call["out"]
    for i in range(ids.shape[0]):
        n = int(np.asarray(mask[i]).sum()) if mask is not None \
            else ids.shape[1]
        img = None if images is None else \
            torch.from_numpy(np.asarray(images[i:i + 1])).to("cuda")
        yield ids[i, :n].tolist(), img, out[i]


def answer_tokens(tokens, eos: int, pad: int) -> int:
    """Tokens an answer took: up to its stop token, or the non-pad ones."""
    toks = [int(t) for t in tokens]
    return toks.index(eos) + 1 if eos in toks else sum(t != pad for t in toks)


def v_harness(tag, fn, rec, encoded, readings, total):
    """One harness call with the launches counted around it (added to
    ``total``): B1 must equal 23 x the tower's calls, at least one, and
    every other kernel 0. Puts its readings in ``readings[tag]``; returns
    (its result, its decodes)."""
    start = len(rec.calls)
    encoded[:] = [0, 0]
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    result = fn()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    calls = rec.calls[start:]
    if counts != launches(B1=23 * encoded[0]) or not encoded[0]:
        raise AssertionError(f"V {tag}: launches {counts} for {encoded[0]} "
                             "tower calls")
    tokens = answers = 0
    for call in calls:
        tk = call["em"].tokenizer
        for _, _, out in v_rows(call):
            answers += 1
            tokens += answer_tokens(out, tk.eos_token_id, tk.pad_token_id)
    read = dict(seconds=round(seconds, 3), answers=answers,
                s_per_answer=round(seconds / max(answers, 1), 3),
                tokens=tokens, tok_s=round(tokens / seconds, 2),
                tower_calls=encoded[0], images=encoded[1], B1=counts["B1"])
    log(f"V {tag}: {answers} answers, {tokens} tokens in {seconds:.3f} s "
        f"({read['s_per_answer']} s an answer, {read['tok_s']} tok/s); "
        f"{encoded[0]} tower calls ({encoded[1]} images), B1 {counts['B1']}")
    total.update(counts)
    readings[tag] = read
    return result, calls


def v_hold(tag, model, tok, calls):
    """Every greedy answer held against a no-cache forward of its prompt
    with its images (``hold_answer``), every beam answer's score against
    the one that forward gives its sequence. Returns the largest greedy
    gap, every beam's score gap and the beams' mean max |logit|."""
    gaps, beam_gaps, texts, scale = [], [], [], []
    for call in calls:
        em = call["em"]
        if em.cfg.do_sample:
            continue
        for j, (ids, images, out) in enumerate(v_rows(call)):
            if em.cfg.num_beams > 1:
                seqs, scores = call["beam"]
                if not np.array_equal(seqs[j], out):
                    raise AssertionError(f"V {tag}: search() and the answer "
                                         "disagree")
                beam_gaps.append(beam_score_gap(model, tok, ids, images,
                                                out, scores[j]))
                scale.append(answer_logits(model, ids, images, out[:-1])
                             .abs().amax(-1).mean().item())
                if beam_gaps[-1] > V_BEAM_SCORE_TOL:
                    raise AssertionError(f"V {tag}: beam score gap "
                                         f"{beam_gaps[-1]}")
            texts.append(em.decode_output(out))
            if em.cfg.num_beams == 1:
                gap, _ = hold_answer(f"V {tag}", model, tok, ids, images,
                                     texts[-1], None, GEN_RTOL)
                gaps.append(gap)
    if not any(texts):
        raise AssertionError(f"V {tag}: every answer is empty (C20)")
    return max(gaps, default=0.0), beam_gaps, np.mean(scale or [0.0])


def v_track_prompts(tag, tok, calls, videos_dir, n_frames):
    """Each tracking prompt carries the box the previous answer left (a
    parsed box), or the last good one: the loop's prompts rebuilt from the
    answers, video by video, equal the prompts decoded."""
    from PIL import Image

    from merlin_tpu_torch.eval import tracking

    it = iter(calls)
    parsed = 0
    for name in sorted(V_TRACK_GT):
        frames, gt = tracking.load_lasot_video(
            os.path.join(videos_dir, name))
        w, h = Image.open(frames[0]).size
        last = gt[0]
        for _ in range(1, n_frames):
            call = next(it)
            em = call["em"]
            q = tracking.TRACK_PROMPT.format(
                *tracking.serialize_norm_box(last, w, h))
            want = tok(em.build_prompt(q, 2))["input_ids"][0]
            if call["ids"][0].tolist() != list(want):
                raise AssertionError(f"V {tag}: {name}'s prompt does not "
                                     f"carry the box {last}")
            box = tracking.parse_predicted_box(em.decode_output(call["out"][0]))
            if box is not None:
                parsed += 1
                last = tracking.de_norm_box_xyxy([c / 1000 for c in box],
                                                 w=w, h=h)
    if next(it, None) is not None:
        raise AssertionError(f"V {tag}: more decodes than frame pairs")
    return parsed


def run_v(bundle, smi):
    """V: every harness of ``merlin_tpu_torch.eval`` through its own ``run``
    on the W bundle (bf16 compute), its input files written from a seed
    into a temporary directory, then the CLI. Prints its readings; returns
    the launches summed over its harness calls."""
    import pickle
    import tempfile

    from merlin_tpu_torch.eval import (
        box_eval, demo, docvqa, mmbench, mmvet, single, tracking)
    from merlin_tpu_torch.eval.runner import EvalConfig
    from merlin_tpu_torch.utils.xlsx import read_xlsx

    tok, model = bundle.tokenizer, bundle.model
    rec = VRecorder()
    encoded = [0, 0]
    hooks = tower_counter(model, encoded)
    readings, total = {}, collections.Counter()
    greedy = EvalConfig(max_new_tokens=V_NEW)
    try:
        with tempfile.TemporaryDirectory() as root:
            v_inputs(root, np.random.default_rng(11))
            out = os.path.join(root, "out")

            def harness(tag, fn):
                return v_harness(tag, fn, rec, encoded, readings, total)

            tsv = os.path.join(root, "mmbench_dev_en.tsv")
            res, calls = harness("mmbench beam5", lambda: mmbench.run(
                bundle, tsv, os.path.join(out, "mmb_beam.json"),
                EvalConfig(num_beams=V_BEAMS, max_new_tokens=V_NEW),
                device="cuda"))
            _, gaps, scale = v_hold("mmbench beam5", model, tok, calls)
            readings["mmbench beam5"].update(beam_score_gaps=gaps,
                                             mean_max_logit=scale)
            res2, calls = harness("mmbench greedy batch 3", lambda: mmbench.run(
                bundle, tsv, os.path.join(out, "mmb.json"), greedy,
                batch_size=3, device="cuda"))
            readings["mmbench greedy batch 3"]["max_gap"] = v_hold(
                "mmbench greedy", model, tok, calls)[0]
            for name, result in (("mmb_beam", res), ("mmb", res2)):
                preds = read_json(os.path.join(out, f"{name}.json"))
                back = read_xlsx(os.path.join(out, f"{name}.xlsx"))
                scores = read_json(os.path.join(out, f"{name}_scores.json"))
                if len(preds) != 6 or len(back) != 6 or any(
                        b.get(k) != v for p, b in zip(preds, back)
                        for k, v in p.items()) or \
                        set(scores) != {"overall", "l2", "leaf"} or \
                        scores["overall"] != result["overall"] or \
                        "D" in preds[4] or preds[4]["C"] != "4":
                    raise AssertionError(f"V mmbench {name}: the files")
            readings["mmbench greedy batch 3"]["overall"] = res2["overall"]

            img_dir = os.path.join(root, "images")
            answers, calls = harness("mmvet", lambda: mmvet.run(
                bundle, os.path.join(root, "mmvet.json"), img_dir,
                os.path.join(out, "mmvet.json"), greedy, device="cuda"))
            readings["mmvet"]["max_gap"] = v_hold("mmvet", model, tok,
                                                  calls)[0]
            # planted fault: the first answer held against its prompt with
            # the other question's image (black, where it saw noise)
            (ids0, _, out0), = v_rows(calls[0])
            (_, img1, _), = v_rows(calls[1])
            try:
                hold_answer("V mmvet planted", model, tok, ids0, img1,
                            calls[0]["em"].decode_output(out0), None,
                            GEN_RTOL)
            except AssertionError as e:
                log(f"V mmvet planted fault (the other question's image) "
                    f"fails as it must: {str(e)[:160]}")
            else:
                raise AssertionError("V mmvet: the answer held with the "
                                     "other question's image")

            scores, calls = harness("docvqa", lambda: docvqa.run(
                bundle, os.path.join(root, "docvqa.json"), img_dir,
                os.path.join(out, "docvqa.json"), greedy, device="cuda"))
            readings["docvqa"]["max_gap"] = v_hold("docvqa", model, tok,
                                                   calls)[0]
            if scores["n"] != 2 or read_json(os.path.join(
                    out, "docvqa_scores.json"))["n"] != 2:
                raise AssertionError(f"V docvqa: scores {scores}")
            readings["docvqa"]["anls"] = scores["overall"]

            videos = os.path.join(root, "videos")
            track_cfg = EvalConfig(max_new_tokens=V_TRACK_NEW)
            serial, calls = harness("tracking", lambda: tracking.run(
                bundle, videos, os.path.join(out, "serial"), track_cfg,
                device="cuda"))
            readings["tracking"]["max_gap"] = v_hold("tracking", model, tok,
                                                     calls)[0]
            readings["tracking"]["boxes_parsed"] = v_track_prompts(
                "tracking", tok, calls, videos, 4)
            chunks = os.path.join(out, "chunks")

            def chunked():
                for idx in range(2):
                    tracking.run(bundle, videos, chunks, track_cfg,
                                 num_chunks=2, chunk_idx=idx, device="cuda")
                return tracking.merge_chunks(chunks)

            merged, ccalls = harness("tracking 2 chunks", chunked)
            pk = {}
            for d in ("serial", "chunks"):
                for name in sorted(os.listdir(os.path.join(out, d))):
                    with open(os.path.join(out, d, name), "rb") as f:
                        pk.setdefault(d, {})[name] = pickle.load(f)
            if merged != serial or serial["videos"] != 2 or \
                    pk["serial"] != pk["chunks"] or len(ccalls) != len(calls) \
                    or any(not np.array_equal(a["out"], b["out"])
                           for a, b in zip(calls, ccalls)):
                raise AssertionError(f"V tracking: chunks merged {merged} "
                                     f"!= serial {serial}")
            readings["tracking"]["summary"] = serial

            frame = os.path.join(img_dir, "frame0.jpg")
            sampled = EvalConfig(do_sample=True, temperature=1.0,
                                 max_new_tokens=V_NEW)
            twice, _ = harness("single sampled x2", lambda: [
                single.run(bundle, frame, V_OPEN[0], sampled, device="cuda")
                for _ in range(2)])
            if twice[0] != twice[1] or not twice[0]:
                raise AssertionError(f"V single: sampled answers {twice}")
            one, calls = harness("single greedy", lambda: single.run(
                bundle, frame, V_OPEN[0], greedy, device="cuda"))
            readings["single greedy"]["max_gap"] = v_hold(
                "single", model, tok, calls)[0]

            def scripted(lines):
                it = iter(lines)

                def read(prompt):
                    line = next(it, None)
                    if line is None:
                        raise EOFError
                    return line
                return read

            shown = []
            f1 = os.path.join(img_dir, "frame1.jpg")
            _, calls = harness("demo Track", lambda: demo.run_demo(
                bundle, task_mode="Track", eval_cfg=greedy,
                input_fn=scripted([f"{frame},{f1} ; {V_OPEN[4]}",
                                   V_OPEN[0]]),
                print_fn=shown.append, max_turns=2, device="cuda"))
            readings["demo Track"]["max_gap"] = v_hold("demo", model, tok,
                                                       calls)[0]
            if len(calls) != 2 or calls[1]["images"].shape[1] != 2 or \
                    not all(s.startswith("ASSISTANT: ") for s in shown
                            if not s.startswith("[boxes")):
                raise AssertionError(f"V demo: {len(calls)} turns, {shown}")
            _, calls = harness("box repl", lambda: box_eval.run_repl(
                bundle, greedy, scripted([f"{frame} ; {V_OPEN[0]}"]),
                shown.append, device="cuda"))
            readings["box repl"]["max_gap"] = v_hold("box", model, tok,
                                                     calls)[0]
            readings["cli"] = v_cli(root, chunks, merged)
    finally:
        rec.close()
        for h in hooks:
            h.remove()
    log(json.dumps({"V": readings, "card": smi}))
    return dict(total)


def v_cli(root, chunks, merged):
    """The eval CLI: ``python -m merlin_tpu_torch.engine.eval --benchmark
    tracking --merge-chunks`` in a subprocess must print the merge V made,
    and ``main`` with ``--tiny --device cuda`` runs DocVQA on the card with
    no kernel (the tiny model's attention is too short for one)."""
    from merlin_tpu_torch.engine import eval as eval_cli

    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "merlin_tpu_torch.engine.eval", "--benchmark",
         "tracking", "--merge-chunks", "--eval_output", chunks],
        capture_output=True, text=True, timeout=300,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    merge_s = time.perf_counter() - t0
    if proc.returncode or f"tracking merged: {merged}" not in proc.stderr:
        raise AssertionError(f"V cli --merge-chunks: {proc.stderr[-800:]}")
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    scores = eval_cli.main([
        "--benchmark", "docvqa", "--tiny", "--device", "cuda", "--limit", "1",
        "--eval_file", os.path.join(root, "docvqa.json"),
        "--eval_image_dir", os.path.join(root, "images"),
        "--eval_output", os.path.join(root, "out", "tiny_docvqa.json")])
    torch.cuda.synchronize()
    tiny_s = time.perf_counter() - t0
    if scores["n"] != 1 or read_counts() != launches():
        raise AssertionError(f"V cli --tiny: {scores}, {read_counts()}")
    log(f"V cli: --merge-chunks in a subprocess {merge_s:.2f} s; --tiny "
        f"--device cuda DocVQA (1 item, sampled) {tiny_s:.2f} s, no kernel")
    return dict(merge_subprocess_s=round(merge_s, 2),
                tiny_docvqa_s=round(tiny_s, 2))


def serve_front(rng, smi):
    """The W phase: the port's serving front end on a Vicuna-7B MMGPT built
    by the user's entry points (``parse_args([])``, ``build_model_tokenizer``,
    ``init_or_load_params``), bf16 compute (W1), the same bundle behind a
    worker with f32 pages (F3), the eval harnesses on it (V), its LM
    quantized to int8 (W2), the bundle rebuilt with ``--scan-decode`` (W3),
    then LoRA over it (L). Returns ({"W1", "W2", "W3", "F3": counts},
    readings, V's launches, L's counts and readings)."""
    from merlin_tpu_torch.models.builder import (
        build_model_tokenizer, init_or_load_params, quantize_bundle_lm_int8)
    from merlin_tpu_torch.train.arguments import parse_args
    from merlin_tpu_torch.utils.conversation import conv_templates

    t0 = time.perf_counter()
    margs, dargs, targs = parse_args([])
    bundle = build_model_tokenizer(margs, dargs, targs)
    init_or_load_params(
        bundle, generator=torch.Generator(device="cuda").manual_seed(0),
        device="cuda")
    torch.cuda.synchronize()
    bundle.model.eval()
    vocab = bundle.config.lm.vocab_size
    n_params = sum(p.numel() for p in bundle.model.parameters())
    log(f"W: {margs.model_name_or_path} + {margs.vision_tower} "
        f"({dargs.image_size}, {margs.projector}): vocab {vocab}, "
        f"{n_params / 1e9:.3f} B parameters "
        f"({nbytes(*bundle.model.parameters()) / 1e9:.2f} GB, as the flax "
        f"tree holds them) on the card in {time.perf_counter() - t0:.1f} s; "
        f"tokenizer {type(bundle.tokenizer).__name__}")
    if vocab != 32003 or type(bundle.tokenizer).__name__ != "TinyTokenizer":
        raise AssertionError("W: not the name-built Vicuna with the "
                             "fallback tokenizer")
    conv = conv_templates["v1"].copy()
    conv.append_message(conv.roles[0], W_QUESTION)
    conv.append_message(conv.roles[1], None)
    fillers = prime_tokenizer(bundle.tokenizer, vocab,
                              [conv.get_prompt()] + v_texts())
    frames = rng.integers(0, 256, size=(4, 480, 640, 3), dtype=np.uint8)

    w1_counts, w1, sent = run_w1(bundle, rng, fillers, frames, smi)
    free_cuda()
    f3_counts, f3 = run_f3(bundle, np.random.default_rng(19), fillers,
                           frames, smi)
    free_cuda()
    v_counts = run_v(bundle, smi)
    free_cuda()
    fc1 = "vision_tower.vit.layers_0.mlp.fc1.kernel"
    tower = bundle.params[fc1]
    qbundle = quantize_bundle_lm_int8(bundle)
    free_cuda()
    q = qbundle.params
    if not (q[fc1] is tower or q[fc1].data_ptr() == tower.data_ptr()) or \
            q[fc1].dtype != tower.dtype or \
            q["lm.layers_0.attn.q_proj.kernel_q8"].dtype != torch.int8 or \
            q["lm.layers_31.mlp.down_proj.kernel_q8"].dtype != torch.int8:
        raise AssertionError("W2: the quantizer touched the tower or left "
                             "an LM projection unquantized (C12)")
    lm_gb = nbytes(*qbundle.model.lm.parameters()) / 1e9
    log(f"W2: LM quantized to int8 ({lm_gb:.2f} GB); tower fc1 untouched "
        f"({tower.dtype})")
    w2_counts, w2 = run_w2(qbundle, rng, fillers, smi)
    del qbundle, q, tower
    free_cuda()
    w3_counts, w3 = run_w3(bundle, sent, frames, smi)
    free_cuda()
    lora_counts, lora = run_l(bundle, np.random.default_rng(14), smi)
    del bundle
    free_cuda()
    return ({"W1": w1_counts, "W2": w2_counts, "W3": w3_counts,
             "F3": f3_counts},
            {"W1": w1, "W2": w2, "W3": w3, "F3": f3}, v_counts,
            {"counts": lora_counts, **lora})


# ---------------------------------------------------------------------------
# phase K: checkpoints and the other towers
# ---------------------------------------------------------------------------

K_SHARD_BYTES = 4 << 30      # safetensors shards of at most 4 GiB, as HF
K_TEXT_IDS = 512
K_VS_F32 = 1.5               # the port (bf16) against HF's forward in f32
                             # on the same weights: its error, of the f32
                             # output's max |value|, at most 1.5 times HF's
                             # own bf16 forward's from the same f32 one ...
K_MIN_TOL = 1e-2             # ... and never held tighter than 1%. A random
                             # 32-layer Llama at HF's init (std 0.02) is
                             # that sensitive to roundings: HF bf16 sat
                             # 7.17e-2 from HF f32, the port 6.41e-2 (H100
                             # 80GB HBM3, 700 W); every o_proj loaded
                             # without its relayout 1.34
K_TOWER_RTOL = 5e-2          # Qwen-bigG's features through B1 against the
                             # same tower on mha_reference, both bf16, of
                             # max |feature|
K_WORDS = 120                # the K1 text request: a whole-prompt prefill


def hf_to_official_sam(sd):
    """HF ``SamVisionEncoder`` names -> SAM's official image-encoder names,
    which ``sam_params_from_torch`` reads (as the JAX package's SAM test
    maps them)."""
    out = {}
    for k, v in sd.items():
        k = k.replace("neck.conv1", "neck.0").replace("neck.layer_norm1",
                                                      "neck.1")
        k = k.replace("neck.conv2", "neck.2").replace("neck.layer_norm2",
                                                      "neck.3")
        k = k.replace("layers.", "blocks.")
        k = k.replace("patch_embed.projection", "patch_embed.proj")
        k = k.replace("layer_norm1", "norm1").replace("layer_norm2", "norm2")
        out[k] = v
    return out


def hf_on_card(build, seed):
    """An HF model built from its config on the card with random weights
    from ``seed``, in bf16, for inference. It is built with bf16 as the
    default dtype, as ``from_pretrained(torch_dtype=torch.bfloat16)``
    builds it: a ``.to(torch.bfloat16)`` afterwards would also round
    Llama's rotary ``inv_freq`` buffer to bf16 and turn the angles of late
    positions by up to a radian (seen: 62% of max |logit| at 512 ids)."""
    torch.manual_seed(seed)
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.bfloat16)
    try:
        with torch.device("cuda"):
            model = build()
    finally:
        torch.set_default_dtype(prev)
    low = [n for n, b in model.named_buffers() if "inv_freq" in n
           and b.dtype != torch.float32]
    if low:
        raise AssertionError(f"HF rotary buffers not in f32: {low}")
    return model.eval()


def write_composite(path, tensors):
    """``tensors`` (name -> tensor on the card) as sharded bf16 safetensors
    with a ``model.safetensors.index.json``, one shard in host memory at a
    time. Returns (bytes written, seconds)."""
    from safetensors.torch import save_file

    t0 = time.perf_counter()
    shards, size = [[]], 0
    for name in tensors:
        n = tensors[name].numel() * 2
        if shards[-1] and size + n > K_SHARD_BYTES:
            shards.append([])
            size = 0
        shards[-1].append(name)
        size += n
    weight_map, total = {}, 0
    for i, names in enumerate(shards):
        file = f"model-{i + 1:05d}-of-{len(shards):05d}.safetensors"
        chunk = {k: tensors[k].to(torch.bfloat16).contiguous().cpu()
                 for k in names}
        save_file(chunk, os.path.join(path, file),
                  metadata={"format": "pt"})
        total += sum(t.numel() * 2 for t in chunk.values())
        weight_map.update(dict.fromkeys(names, file))
        del chunk
    with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": total},
                   "weight_map": weight_map}, f)
    return total, time.perf_counter() - t0


def expected_leaves(hf_lm, hf_tower, proj, lm_cfg, n_tower_layers):
    """Every leaf the composite should load, name -> f32 tensor, written
    out again here from the HF modules (not by the port's converters): the
    decoder's (in, heads, d) / (heads, d, out) einsum layouts and (in, out)
    kernels, the tower's HWIO patch kernel, and the conv projector's."""
    h, d, e = lm_cfg.num_heads, lm_cfg.head_size, lm_cfg.hidden_size
    hf = {k: v for k, v in hf_lm.state_dict().items()}
    want = {"lm.embed_tokens.embedding": hf["model.embed_tokens.weight"],
            "lm.final_norm.scale": hf["model.norm.weight"],
            "lm.lm_head.kernel": hf["lm_head.weight"].T}
    for i in range(lm_cfg.num_layers):
        src, dst = f"model.layers.{i}.", f"lm.layers_{i}."
        for m in ("q_proj", "k_proj", "v_proj"):
            want[dst + f"attn.{m}.kernel"] = \
                hf[src + f"self_attn.{m}.weight"].T.reshape(e, h, d)
        want[dst + "attn.o_proj.kernel"] = \
            hf[src + "self_attn.o_proj.weight"].T.reshape(h, d, e)
        for m in ("gate_proj", "up_proj", "down_proj"):
            want[dst + f"mlp.{m}.kernel"] = hf[src + f"mlp.{m}.weight"].T
        want[dst + "input_norm.scale"] = hf[src + "input_layernorm.weight"]
        want[dst + "post_attn_norm.scale"] = \
            hf[src + "post_attention_layernorm.weight"]
    vm = hf_tower.vision_model
    tc = hf_tower.config
    th, td = tc.num_attention_heads, tc.hidden_size // tc.num_attention_heads
    want["vision_tower.vit.class_embedding"] = vm.embeddings.class_embedding
    want["vision_tower.vit.position_embedding"] = \
        vm.embeddings.position_embedding.weight
    want["vision_tower.vit.patch_embed.kernel"] = \
        vm.embeddings.patch_embedding.weight.permute(2, 3, 1, 0)
    want["vision_tower.vit.pre_norm.scale"] = vm.pre_layrnorm.weight
    want["vision_tower.vit.pre_norm.bias"] = vm.pre_layrnorm.bias
    for i in range(n_tower_layers):
        layer, dst = vm.encoder.layers[i], f"vision_tower.vit.layers_{i}."
        at = layer.self_attn
        for m in ("q_proj", "k_proj", "v_proj"):
            lin = getattr(at, m)
            want[dst + f"{m}.kernel"] = lin.weight.T.reshape(
                tc.hidden_size, th, td)
            want[dst + f"{m}.bias"] = lin.bias.reshape(th, td)
        want[dst + "o_proj.kernel"] = at.out_proj.weight.T.reshape(
            th, td, tc.hidden_size)
        want[dst + "o_proj.bias"] = at.out_proj.bias
        for m in ("fc1", "fc2"):
            want[dst + f"mlp.{m}.kernel"] = getattr(layer.mlp, m).weight.T
            want[dst + f"mlp.{m}.bias"] = getattr(layer.mlp, m).bias
        for m, src in (("norm1", layer.layer_norm1),
                       ("norm2", layer.layer_norm2)):
            want[dst + f"{m}.scale"] = src.weight
            want[dst + f"{m}.bias"] = src.bias
    want["projector.conv.kernel"] = proj["conv.weight"].permute(2, 3, 1, 0)
    want["projector.conv.bias"] = proj["conv.bias"]
    return want


def against_hf(tag, ours, hf_bf16, hf_f32, planted=None):
    """The port's output against HF's f32 forward on the same weights, its
    error held to ``K_VS_F32`` times HF's own bf16 forward's (at least
    ``K_MIN_TOL``), each of the f32 output's max |value|; a planted fault's
    output must exceed that bound."""
    scale = hf_f32.float().abs().max()

    def gap(x):
        return ((x.float() - hf_f32.float()).abs().max() / scale).item()

    read = dict(err=gap(ours), hf_bf16_err=gap(hf_bf16),
                vs_hf_bf16=((ours.float() - hf_bf16.float()).abs().max()
                            / scale).item(), max_abs=scale.item())
    read["tol"] = max(K_VS_F32 * read["hf_bf16_err"], K_MIN_TOL)
    text = (f"{tag}: error {read['err']:.3e} of max |value| "
            f"{read['max_abs']:.3e} from HF's f32 forward (HF's bf16 "
            f"{read['hf_bf16_err']:.3e}; tol {read['tol']:.3e}); "
            f"{read['vs_hf_bf16']:.3e} from HF's bf16")
    if planted is not None:
        read["planted"] = gap(planted)
        text += (f"; planted fault (every o_proj without its head relayout)"
                 f" {read['planted']:.3e}, must exceed the tol")
    log(text)
    return read


def hf_features(hf, pixels, layer=-2, drop_cls=True):
    """An HF CLIP tower's hidden_states[layer] (CLS dropped) in bf16 and
    then in f32 (the tower is left in f32)."""
    out = []
    for dtype in (torch.bfloat16, torch.float32):
        hf.to(dtype)
        hs = hf(pixels.permute(0, 3, 1, 2).to(dtype),
                output_hidden_states=True).hidden_states[layer]
        out.append((hs[:, 1:] if drop_cls else hs).float())
        del hs
    return out


def k_text_ids(rng, vocab):
    ids = rng.integers(10, min(vocab, 32000), size=(1, K_TEXT_IDS))
    ids[0, 0] = 1
    return torch.from_numpy(ids).cuda()


def k1_composite(rng, smi):
    """K1: a Vicuna-7B (all 32 layers) + CLIP ViT-L/14-448 + conv projector
    composite, made by HF modules on the card and saved as sharded bf16
    safetensors, loaded as the worker loads ``--pretrain_model``; every leaf
    exact, logits and tower features against HF, a planted relayout fault,
    and one text and one image request through an engine worker."""
    import shutil
    import tempfile

    from transformers import (CLIPVisionConfig, CLIPVisionModel,
                              LlamaConfig, LlamaForCausalLM)

    from merlin_tpu_torch.models.builder import (
        build_model_tokenizer, init_or_load_params)
    from merlin_tpu_torch.ops.image_ops import preprocess_images
    from merlin_tpu_torch.train.arguments import parse_args
    from merlin_tpu_torch.utils.conversation import conv_templates

    out = {}
    tmp = tempfile.mkdtemp(prefix="merlin_k1_")
    try:
        # the bundle the worker builds; its config sets the HF widths
        margs, dargs, targs = parse_args(["--pretrain_model", tmp])
        bundle = build_model_tokenizer(margs, dargs, targs)
        lm_cfg, vit_cfg = bundle.config.lm, bundle.config.vit
        if (lm_cfg.rope_theta, lm_cfg.rope_linear_scale) != (10000.0, 1.0):
            raise AssertionError("K1: not HF Llama's default RoPE")
        t0 = time.perf_counter()
        hf_lm = hf_on_card(lambda: LlamaForCausalLM(LlamaConfig(
            vocab_size=lm_cfg.vocab_size, hidden_size=lm_cfg.hidden_size,
            intermediate_size=lm_cfg.intermediate_size,
            num_hidden_layers=lm_cfg.num_layers,
            num_attention_heads=lm_cfg.num_heads,
            num_key_value_heads=lm_cfg.kv_heads,
            max_position_embeddings=lm_cfg.max_position_embeddings,
            rms_norm_eps=lm_cfg.norm_eps, tie_word_embeddings=False)),
            seed=11)
        hf_tower = hf_on_card(lambda: CLIPVisionModel(CLIPVisionConfig(
            image_size=448, patch_size=14, hidden_size=1024,
            intermediate_size=4096, num_hidden_layers=24,
            num_attention_heads=16, hidden_act="quick_gelu")), seed=12)
        gen = torch.Generator(device="cuda").manual_seed(13)
        proj = {"conv.weight": torch.randn(
                    lm_cfg.hidden_size, vit_cfg.hidden_size, 3, 3,
                    generator=gen, device="cuda").mul_(0.02).bfloat16(),
                "conv.bias": torch.randn(lm_cfg.hidden_size, generator=gen,
                                         device="cuda").mul_(0.02).bfloat16()}
        tensors = {k: v for k, v in hf_lm.state_dict().items()
                   if v.is_floating_point()}
        tensors.update({"model.vision_tower." + k.replace("vision_model.", "",
                                                          1): v
                        for k, v in hf_tower.state_dict().items()
                        if v.is_floating_point()})
        tensors.update({"model.projector." + k: v for k, v in proj.items()})
        torch.cuda.synchronize()
        out["hf_build_s"] = round(time.perf_counter() - t0, 2)
        size, write_s = write_composite(tmp, tensors)
        del tensors
        out.update(checkpoint_gb=round(size / 1e9, 3),
                   write_s=round(write_s, 2))
        log(f"K1: composite of {len(os.listdir(tmp)) - 1} bf16 safetensors "
            f"shards, {size / 1e9:.3f} GB, written in {write_s:.1f} s "
            f"(HF modules built on the card in {out['hf_build_s']} s)")

        free_cuda()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        init_or_load_params(bundle, composite_checkpoint=margs.pretrain_model,
                            device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        model = bundle.model.eval()
        model_bytes = nbytes(*model.parameters())
        over = torch.cuda.max_memory_allocated() - base - model_bytes
        out.update(load_s=round(load_s, 2),
                   model_gb=round(model_bytes / 1e9, 3),
                   load_peak_over_model_gb=round(over / 1e9, 3))
        log(f"K1: parse_args(--pretrain_model) -> build_model_tokenizer -> "
            f"init_or_load_params: {model_bytes / 1e9:.2f} GB of f32 leaves "
            f"on the card in {load_s:.1f} s (card {smi}); the load's peak "
            f"over the model {over / 1e9:.3f} GB")

        # every leaf, exactly
        want = expected_leaves(hf_lm, hf_tower, proj, lm_cfg,
                               model.vision_tower.vit.n_layers)
        got = bundle.params
        exact = [n for n in got if n in want and torch.equal(
            got[n], want[n].float())]
        if sorted(want) != sorted(got) or len(exact) != len(got):
            bad = sorted(set(got) - set(exact))[:6]
            raise AssertionError(f"K1: {len(exact)} of {len(got)} leaves "
                                 f"exact (first others {bad})")
        out["leaves_exact"] = len(exact)
        log(f"K1: all {len(exact)} leaves equal the f32 of HF's tensors "
            f"under the relayout, none left at its random init")
        del want, got, exact

        # logits against HF (bf16, and f32 as the reference), and a
        # planted relayout fault
        ids = k_text_ids(rng, lm_cfg.vocab_size)
        with torch.no_grad():
            theirs = hf_lm(ids).logits.float()
            reset_counts()
            ours, _ = model.lm(ids)
            torch.cuda.synchronize()
            counts = read_counts()
            hf_lm.float()
            exact = hf_lm(ids).logits.float()
        if counts != launches(B2=lm_cfg.num_layers):
            raise AssertionError(f"K1 logits: launches {counts}")
        h, d, e = lm_cfg.num_heads, lm_cfg.head_size, lm_cfg.hidden_size
        loaded = [getattr(model.lm, f"layers_{i}").attn.o_proj.kernel.data
                  for i in range(lm_cfg.num_layers)]
        for i in range(lm_cfg.num_layers):
            w = hf_lm.model.layers[i].self_attn.o_proj.weight
            # the relayout skipped: HF's (out, in) read as (in, out)
            getattr(model.lm, f"layers_{i}").attn.o_proj.kernel.data = \
                w.float().reshape(h, d, e)
        with torch.no_grad():
            bad, _ = model.lm(ids)
        for i, k in enumerate(loaded):
            getattr(model.lm, f"layers_{i}").attn.o_proj.kernel.data = k
        del loaded
        read = against_hf(f"K1 logits, port no-cache (B2) vs HF "
                          f"LlamaForCausalLM, {K_TEXT_IDS} ids", ours,
                          theirs, exact, planted=bad)
        out["logits"] = read
        if not read["err"] <= read["tol"] < read["planted"]:
            raise AssertionError(f"K1 logits: {read}")
        del theirs, ours, bad, exact

        # the tower's features against HF's hidden_states[-2], CLS dropped
        frames = rng.integers(0, 256, size=(2, 480, 640, 3), dtype=np.uint8)
        pixels = preprocess_images(frames, image_size=448, device="cuda")
        with torch.no_grad():
            reset_counts()
            feats = model.vision_tower(pixels)
            torch.cuda.synchronize()
            counts = read_counts()
            theirs, exact = hf_features(hf_tower, pixels)
        read = against_hf("K1 tower (B1, d = 64) vs HF CLIPVisionModel "
                          "hidden_states[-2][:, 1:], 2 frames", feats,
                          theirs, exact)
        out["tower"] = read
        log(f"K1 tower launches {counts}")
        if not read["err"] <= read["tol"] or counts != launches(B1=23):
            raise AssertionError(f"K1 tower: {read} {counts}")
        del hf_lm, hf_tower, feats, theirs, exact
        free_cuda()

        # one text and one 1-image request through an engine worker
        conv = conv_templates["v1"].copy()
        conv.append_message(conv.roles[0], W_QUESTION)
        conv.append_message(conv.roles[1], None)
        fillers = prime_tokenizer(bundle.tokenizer, lm_cfg.vocab_size,
                                  [conv.get_prompt()])
        out["requests"], out["counts"] = k1_requests(bundle, rng, fillers,
                                                     frames, smi)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def k1_requests(bundle, rng, fillers, frames, smi):
    from merlin_tpu_torch.utils import constants as C

    tok, model = bundle.tokenizer, bundle.model
    ctrl, workers, servers = start_stack(bundle, [("merlin-ckpt", W_ENGINE)])
    records, handler = w_worker_log()
    calls = collections.Counter()
    encoded = [0, 0]
    hooks = engine_counter(workers["merlin-ckpt"], calls) \
        + tower_counter(model, encoded)
    base = dict(model="merlin-ckpt", temperature=0.0,
                max_new_tokens=W_MAX_NEW, stop="</s>")
    text = w_prompts(rng, fillers, (K_WORDS,))[0]
    one = w_image_prompt(1)
    torch.cuda.synchronize()
    reset_counts()
    results = [w_request(ctrl, dict(base, prompt=text)),
               w_request(ctrl, dict(base, prompt=one,
                                    images=[png_b64(frames[0])]))]
    torch.cuda.synchronize()
    counts = read_counts()
    for hk in hooks:
        hk.remove()
    stop_stack(servers, workers)
    import logging
    logging.getLogger("merlin_tpu_torch.worker").removeHandler(handler)
    if any("failed" in r for r in records):
        raise AssertionError(f"K1: a worker logged a failure: {records}")
    w_check_launches("K1", counts, calls, bundle.config.lm.num_layers,
                     encoded[0], q8=False, reached={"B1", "B2", "B3"})
    if encoded != [1, 1]:
        raise AssertionError(f"K1: tower calls {encoded}")
    readings = {}
    placeholder = C.image_placeholder(bundle.config.image_token_len)
    for name, prompt, images, (chunks, stamps) in (
            ("text", text, None, results[0]),
            ("1 image", one.replace("<image>", placeholder),
             decoded_images(frames[:1], bundle.config.vit.image_size),
             results[1])):
        readings[name] = w_readings(f"K1 {name}", chunks, stamps, smi)
        ids = tok(prompt)["input_ids"][0]
        gap, seq = hold_answer(f"K1 {name}", model, tok, ids, images,
                               chunks[-1]["text"], len(chunks), GEN_RTOL)
        readings[name].update(prompt_tokens=len(ids), tokens=len(seq),
                              max_gap=gap)
    gaps = ", ".join(f"{r['max_gap']:.2e}" for r in readings.values())
    log(f"K1 answers vs a no-cache forward: largest gaps {gaps} of max "
        f"|logit| (tol {GEN_RTOL})")
    return readings, counts


def load_tree(module, tree):
    """Assign a converter's tree to ``module`` (built on ``meta``): every
    parameter must come from it; layers the tower does not build may be
    left over."""
    from merlin_tpu_torch.models.convert import flat_state_dict

    import re

    flat = flat_state_dict(tree)
    result = module.load_state_dict(flat, strict=False, assign=True)
    extra = [k for k in result.unexpected_keys
             if not re.match(r"(.*\.)?layers_\d+\.", k)]
    if result.missing_keys or extra:
        raise AssertionError(f"load_tree: missing {result.missing_keys[:4]}"
                             f", unexpected {extra[:4]}")
    return module.eval()


def tower_time(tag, fn, smi):
    """One warm call of ``fn`` (a tower's encode): the card's busy time, its
    kernels' and copies' time summed under ``torch.profiler`` (one stream,
    so they do not overlap), and the host-clock time of an unprofiled
    call. A tower issues tens of small ops a layer, so the host may set the
    wall time; the idle share says how far."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # the device's rows also mirror the program's spans (``annotate``):
    # not operations
    rows = [ev for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA
            and ev.self_device_time_total > 0
            and not getattr(ev, "is_user_annotation", False)]
    busy = sum(ev.self_device_time_total for ev in rows) / 1e3
    n = sum(ev.count for ev in rows)
    if busy <= 0:
        raise AssertionError(f"{tag}: the trace holds no device time")
    log(f"K2 {tag}: card busy {busy:.3f} ms in {n} kernels and copies, "
        f"wall {wall:.3f} ms (host clock), idle share {1 - busy / wall:.3f}"
        f" (card {smi})")
    return dict(busy_ms=busy, wall_ms=wall, device_launches=n,
                idle_share=1 - busy / wall)


def feature_err(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


def b1_at(gen, shape):
    """B1's time at a tower's shape, against SDPA (as ``check_b1``), with
    its bound and the plain version's time."""
    from merlin_tpu_torch.ops.onepass_attention import (
        onepass_attention, onepass_attention_plain)

    q, k, v = (layer_normed(shape, gen) for _ in range(3))
    out = onepass_attention(q, k, v)
    b, s, h, d = shape
    lib_for, qkv = sdpa_fwd(q, k, v)
    p = vs_sdpa(lambda: onepass_attention(q, k, v), lib_for, *qkv)
    plain = time_ms(lambda: onepass_attention_plain(q, k, v), iters=5)
    bms, by = bound_ms(4.0 * b * h * s * s * d, nbytes(q, k, v, out))
    log(f"B1 {shape} bf16: " + sdpa_text(p) + f", plain {plain:.4f} ms, "
        f"bound {bms:.4f} ms ({by})")
    return dict(shape=list(shape), plain_ms=plain, bound_ms=bms,
                bound_by=by, **sdpa_fields(p))


def k2_towers(rng, gen, smi):
    """K2: MetaCLIP ViT-H/14-448 and SAM ViT-B/16-1024 against HF, Qwen-VL
    ViT-bigG-448 through B1 at d = 104 against its own plain attention,
    the resampler's shape, one MMGPT forward per new tower kind with a
    2-layer Vicuna-7B, and B1 timed at d = 80 and 104."""
    from transformers import (CLIPVisionConfig, CLIPVisionModel,
                              SamVisionConfig)
    from transformers.models.sam.modeling_sam import SamVisionEncoder

    from merlin_tpu_torch.models import vit as vit_mod
    from merlin_tpu_torch.models.projectors import (
        Resampler, default_resampler_heads, resampler_params_from_torch)
    from merlin_tpu_torch.models.sam_vit import (
        SAMViTConfig, sam_params_from_torch)
    from merlin_tpu_torch.models.vision_builder import build_vision_tower
    from merlin_tpu_torch.ops.attention import mha_reference
    from merlin_tpu_torch.ops.image_ops import preprocess_images

    out = {"encode": {}, "launches": {}}
    frames = rng.integers(0, 256, size=(1, 480, 640, 3), dtype=np.uint8)
    px448 = preprocess_images(frames, image_size=448, device="cuda")

    # MetaCLIP ViT-H/14-448 against HF's CLIPVisionModel (B1, d = 80)
    mcfg = vit_mod.metaclip_vit_h14(448)
    hf = hf_on_card(lambda: CLIPVisionModel(CLIPVisionConfig(
        image_size=448, patch_size=14, hidden_size=1280,
        intermediate_size=5120, num_hidden_layers=32,
        num_attention_heads=16, hidden_act="gelu")), seed=21)
    with torch.device("meta"):
        tower = build_vision_tower("metaclip", mcfg)
    load_tree(tower.vit, vit_mod.vit_params_from_hf(hf.state_dict(), mcfg))
    with torch.no_grad():
        reset_counts()
        ours = tower(px448)
        torch.cuda.synchronize()
        counts = read_counts()
        out["encode"]["metaclip_h14_448"] = tower_time(
            "MetaCLIP ViT-H/14-448 encode, 1 frame", lambda: tower(px448),
            smi)
        theirs, exact = hf_features(hf, px448)
    read = out["metaclip"] = against_hf(
        "K2 MetaCLIP ViT-H/14-448 (B1, d = 80) vs HF CLIPVisionModel "
        "hidden_states[-2][:, 1:]", ours, theirs, exact)
    out["launches"]["metaclip"] = counts["B1"]
    log(f"K2 MetaCLIP launches {counts}")
    if not read["err"] <= read["tol"] or counts != launches(B1=31):
        raise AssertionError(f"K2 MetaCLIP: {read} {counts}")
    del hf, tower, ours, theirs, exact
    free_cuda()

    # Qwen-VL ViT-bigG-448 + the qwen_sampler resampler, from a state dict
    # in the reference's layout (no HF class holds this tower)
    qcfg = vit_mod.qwen_vit_bigG(448, pos_embed="learned")
    w, nl, inter = qcfg.hidden_size, qcfg.num_layers, qcfg.intermediate_size

    def r(*shape, std=0.02):
        return torch.randn(shape, generator=gen, device="cuda").mul_(
            std).bfloat16()

    sd = {"conv1.weight": r(w, 3, 14, 14), "positional_embedding": r(256, w),
          "ln_pre.weight": 1 + r(w), "ln_pre.bias": r(w)}
    for i in range(nl):
        lb = f"transformer.resblocks.{i}."
        sd.update({lb + "ln_1.weight": 1 + r(w), lb + "ln_1.bias": r(w),
                   lb + "ln_2.weight": 1 + r(w), lb + "ln_2.bias": r(w),
                   # interleaved per head: rows [q_n | k_n | v_n]
                   lb + "attn.in_proj.weight": r(3 * w, w),
                   lb + "attn.in_proj.bias": r(3 * w),
                   lb + "attn.out_proj.weight": r(w, w),
                   lb + "attn.out_proj.bias": r(w),
                   lb + "mlp.c_fc.weight": r(inter, w),
                   lb + "mlp.c_fc.bias": r(inter),
                   lb + "mlp.c_proj.weight": r(w, inter),
                   lb + "mlp.c_proj.bias": r(w)})
    lm_width = 4096
    pool = {"attn_pool.query": r(256, w), "attn_pool.pos_embed": r(256, w),
            "attn_pool.kv_proj.weight": r(w, w),
            "attn_pool.ln_q.weight": 1 + r(w), "attn_pool.ln_q.bias": r(w),
            "attn_pool.ln_kv.weight": 1 + r(w), "attn_pool.ln_kv.bias": r(w),
            "attn_pool.attn.in_proj_weight": r(3 * w, w),
            "attn_pool.attn.in_proj_bias": r(3 * w),
            "attn_pool.attn.out_proj.weight": r(w, w),
            "attn_pool.attn.out_proj.bias": r(w),
            "ln_post.weight": 1 + r(w), "ln_post.bias": r(w),
            "proj": r(w, lm_width)}
    with torch.device("meta"):
        tower = build_vision_tower("qwen", qcfg)
    load_tree(tower.vit, vit_mod.qwen_vit_params_from_torch(sd, qcfg))
    del sd
    heads = default_resampler_heads(w)
    with torch.device("meta"):
        resampler = Resampler(w, lm_width, embed_dim=w, num_heads=heads)
    load_tree(resampler, resampler_params_from_torch(pool, dim=w,
                                                     num_heads=heads))
    with torch.no_grad():
        reset_counts()
        ours = tower(px448)
        torch.cuda.synchronize()
        counts = read_counts()
        tokens = resampler(ours)
        shared = vit_mod.shared_attention
        vit_mod.shared_attention = lambda q, k, v, causal: mha_reference(
            q, k, v, causal=causal)
        try:
            plain = tower(px448)
        finally:
            vit_mod.shared_attention = shared
        err = feature_err(ours, plain)
        out["encode"]["qwen_bigG_448"] = tower_time(
            "Qwen-VL ViT-bigG-448 encode, 1 frame", lambda: tower(px448),
            smi)
        out["encode"]["qwen_sampler"] = tower_time(
            "qwen_sampler resampler, 1 frame", lambda: resampler(ours), smi)
    out["qwen_err"] = err
    out["launches"]["qwen"] = counts["B1"]
    shape_ok = tuple(tokens.shape) == (1, 256, lm_width) and bool(
        torch.isfinite(tokens.float()).all())
    log(f"K2 Qwen-VL ViT-bigG-448 (B1, d = 104, s = 1024) vs the same tower "
        f"on mha_reference: error {err:.3e} of max |feature| (tol "
        f"{K_TOWER_RTOL}), launches {counts}; qwen_sampler ({heads} heads) "
        f"-> {tuple(tokens.shape)}, finite {shape_ok}")
    if not err <= K_TOWER_RTOL or counts != launches(B1=nl) or not shape_ok:
        raise AssertionError(f"K2 Qwen: {err} {counts} {tokens.shape}")
    del tower, resampler, ours, plain, tokens, pool
    free_cuda()

    # SAM ViT-B/16-1024 against HF's SamVisionEncoder (no kernel)
    hf = hf_on_card(lambda: SamVisionEncoder(SamVisionConfig()), seed=31)
    with torch.no_grad():
        # every weight drawn here from the seed, whatever HF's init gives
        # (transformers 5.5.0's left the output at ~1e-12): N(0, 0.02),
        # norm scales 1 + N(0, 0.02); the position table too, which HF
        # starts at 0. The relative tables stay 0: where they are not,
        # JAX's W bias, which the port keeps, departs from SAM's (C28)
        for name, p in hf.named_parameters():
            if "rel_pos" in name:
                p.zero_()
            else:
                p.copy_(torch.randn(p.shape, generator=gen, device="cuda")
                        * 0.02 + ("layer_norm" in name
                                  and name.endswith("weight")))
    scfg = SAMViTConfig()
    with torch.device("meta"):
        tower = build_vision_tower("sam", scfg)
    load_tree(tower, sam_params_from_torch(
        hf_to_official_sam(hf.state_dict()), scfg))
    px1024 = preprocess_images(frames, image_size=1024, device="cuda")
    with torch.no_grad():
        reset_counts()
        ours = tower(px1024)
        torch.cuda.synchronize()
        counts = read_counts()
        out["encode"]["sam_b16_1024"] = tower_time(
            "SAM ViT-B/16-1024 encode, 1 frame", lambda: tower(px1024), smi)
        hf_out = []
        for dtype in (torch.bfloat16, torch.float32):
            hf.to(dtype)
            last = hf(px1024.permute(0, 3, 1, 2).to(dtype)).last_hidden_state
            hf_out.append(last.permute(0, 2, 3, 1).reshape(
                1, -1, scfg.out_chans).float())
    read = out["sam"] = against_hf(
        "K2 SAM ViT-B/16-1024 (no kernel) vs HF SamVisionEncoder "
        "last_hidden_state", ours, *hf_out)
    log(f"K2 SAM launches {counts}")
    if not read["err"] <= read["tol"] or counts != launches():
        raise AssertionError(f"K2 SAM: {read} {counts}")
    del hf, tower, ours, hf_out
    free_cuda()

    out["mmgpt"] = k2_mmgpt(rng, mcfg, scfg, smi)
    free_cuda()
    out["b1"] = {"d80": b1_at(gen, (1, 1025, 16, 80)),
                 "d104": b1_at(gen, (1, 1024, 16, 104))}
    return out


def k2_mmgpt(rng, mcfg, scfg, smi):
    """One MMGPT forward per new tower kind with its projector and Vicuna-7B
    cut to 2 layers, random bf16 weights: B1 = the layers the tower runs,
    B2 = 2 (one no-cache LM call)."""
    from merlin_tpu_torch.models.bridge import init_params
    from merlin_tpu_torch.models.families import vicuna_7b
    from merlin_tpu_torch.models.mmgpt import MMGPT, MMGPTConfig
    from merlin_tpu_torch.models.vit import qwen_vit_bigG
    from merlin_tpu_torch.ops.image_ops import preprocess_images

    lm = dataclasses.replace(vicuna_7b(), vocab_size=32128, num_layers=2)
    out = {}
    for kind, vit, proj, b1 in (("metaclip", mcfg, "conv", 31),
                                ("qwen", qwen_vit_bigG(448), "qwen_sampler",
                                 48),
                                ("sam", scfg, "sam", 0)):
        cfg = MMGPTConfig(lm=lm, vit=vit, projector=proj, vision_kind=kind,
                          image_patch_id=PATCH_ID, im_start_id=START_ID,
                          im_end_id=END_ID)
        with torch.device("meta"):
            model = MMGPT(cfg)
        init_params(model, torch.Generator(device="cuda").manual_seed(41),
                    dtype=torch.bfloat16, device="cuda")
        model.eval()
        size = getattr(vit, "image_size", None) or vit.img_size
        frames = rng.integers(0, 256, size=(1, 480, 640, 3), dtype=np.uint8)
        images = preprocess_images(frames, image_size=size, device="cuda")
        ids = torch.from_numpy(prompt(rng, 200, 1, cfg.image_token_len)
                               ).cuda()[None]
        with torch.no_grad():
            reset_counts()
            logits, _ = model(ids, images=images[:, None])
            torch.cuda.synchronize()
            counts = read_counts()
        ok = (tuple(logits.shape) == (1, ids.shape[1], lm.vocab_size)
              and bool(torch.isfinite(logits.float()).all()))
        log(f"K2 MMGPT {kind} + {proj} + Vicuna-7B (2 layers): logits "
            f"{tuple(logits.shape)}, {cfg.image_token_len} image tokens, "
            f"finite {ok}, launches {counts}")
        if not ok or counts != launches(B1=b1, B2=2):
            raise AssertionError(f"K2 MMGPT {kind}: {ok} {counts}")
        out[kind] = dict(launches=counts, image_tokens=cfg.image_token_len)
        del model, logits
        free_cuda()
    return out


def checkpoints_and_towers(rng, gen, smi):
    """Phase K: K1 then K2, the card freed between them."""
    k1 = k1_composite(rng, smi)
    free_cuda()
    k2 = k2_towers(rng, gen, smi)
    free_cuda()
    return k1, k2


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


def build_train_model(n_layers, dtype=torch.bfloat16):
    """CLIP ViT-L/14-448 (23 of 24 layers run) + conv projector + Vicuna-7B
    width cut to ``n_layers``, remat on, f32 trainable parameters N(0,
    1)*0.02 from seed 0, computing in ``dtype`` (bf16; f32 as
    ``--bf16 False`` builds it)."""
    from merlin_tpu_torch.models.bridge import init_params
    from merlin_tpu_torch.models.families import vicuna_7b
    from merlin_tpu_torch.models.mmgpt import MMGPT
    from merlin_tpu_torch.models.vit import clip_vit_l14

    lm = dataclasses.replace(vicuna_7b(), vocab_size=32128,
                             num_layers=n_layers, remat=True, dtype=dtype)
    cfg = mm_config(lm, clip_vit_l14(448, dtype=dtype))
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


def run_training(tag, model, model_args, targs, steps, rng, **batch_kw):
    """Train ``steps`` steps through ``Trainer.train`` on one repeated batch
    (``train_batch`` with ``batch_kw``) with the launch counts set to 0
    just before and read just after. Returns (per-step metrics, launch
    counts, peak bytes, the profile); the batch is kept as
    ``run_training.batch``."""
    from merlin_tpu_torch.models.builder import make_bundle
    from merlin_tpu_torch.train.trainer import Trainer

    bundle = make_bundle(model, model_args, orig_vocab_size=32000)
    trainer = Trainer(bundle, targs, device="cuda")
    trainer.init_state()
    batch = train_batch(rng, model.cfg.image_token_len,
                        rows=targs.gradient_accumulation_steps, **batch_kw)
    run_training.batch = batch
    seen = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t_train = time.perf_counter()
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
             ("flash_bwd_",)),                   # post-pass; the f32 ones
            ("B2 flash forward", ("flash_attention_fwd_kernel",)),
            ("B2/B12 f32 forward", ("attention_f32_kernel",)),
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
        # of the kernels it launched, and a span's device row (``annotate``)
        # the time of those inside it
        ms = ev.self_device_time_total / 1e3
        if ev.device_type != torch.autograd.DeviceType.CUDA or ms <= 0 \
                or getattr(ev, "is_user_annotation", False):
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
                mfu=seen[-1]["mfu"], profile=prof,
                batch=run_training.batch)


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


# --- phase T3: a MetaCLIP-H/14 tower trained through the Trainer ----------

T3_TOWER_LAYERS = 31         # MetaCLIP-H/14 runs 31 of its 32 layers
T3_BATCH = dict(n_images=1, slots=1)
T3_NOISE_FACTOR = 4.0        # a gradient's error against the f32 step may
                             # reach 4x the plain versions' own (C40)
T3_FAULT_KEYS = 256          # the planted fault: B13's dv of the last 256
                             # keys (two of its 128-key tiles) zeroed
T3_F32_QK_RTOL = 3e-2        # C40 at f32: the tower's q_proj/k_proj
                             # gradients through the f32 kernels (B12/B13,
                             # 3xTF32) against autograd of mha_reference
                             # in f32, max |difference| over max |f32 step|
                             # (a key bias, exactly 0 (C14): max |kernels'|
                             # over its kernel's). Both f32; the kernels'
                             # ~3e-6 a product is amplified where dq and dk
                             # are differences of near-equal terms (near-
                             # uniform attention at random weights), and
                             # the key bias is what di from the forward's
                             # out leaves against the backward's P V. Seen
                             # on an H100 80GB HBM3 at 700 W: q 7.2e-3, k
                             # 2.4e-3, key bias 1.45e-2 (the reference's
                             # own 9.1e-5); B13's dropped keys 0.13-0.17


def build_t3_model():
    """MetaCLIP ViT-H/14-448 (d = 80, 1025 tokens) + conv projector +
    Vicuna-7B width cut to 2 layers (as K2), remat on, f32 trainable
    parameters N(0, 1)*0.02 from seed 0, bf16 compute."""
    from merlin_tpu_torch.models.bridge import init_params
    from merlin_tpu_torch.models.families import vicuna_7b
    from merlin_tpu_torch.models.mmgpt import MMGPT, MMGPTConfig
    from merlin_tpu_torch.models.vit import metaclip_vit_h14

    lm = dataclasses.replace(vicuna_7b(), vocab_size=32128, num_layers=2,
                             remat=True)
    cfg = MMGPTConfig(lm=lm, vit=metaclip_vit_h14(448), projector="conv",
                      vision_kind="metaclip", image_patch_id=PATCH_ID,
                      im_start_id=START_ID, im_end_id=END_ID)
    with torch.device("meta"):
        model = MMGPT(cfg)
    init_params(model, torch.Generator(device="cuda").manual_seed(0),
                dtype=torch.float32, device="cuda", requires_grad=True)
    return model


def t3_grads(model, batch, route: str):
    """(loss, every gradient) of one microbatch of ``batch``. ``route``
    "kernels": the path as it runs. "plain": each training kernel's plain
    version swapped in for its wrapper, here only, as the reference: B12/
    B13 (the tower) and B2/B10+B11 (the LM) run the same arithmetic (bf16
    P and dS, di from the bf16 out) in plain PyTorch on the card.
    "autograd": ``mha_reference`` in the tower's and the decoder's
    dispatcher, differentiated by autograd (f32 P, di from it); run on
    :func:`t3_f32_twin` it is the f32 reference. "fault": the kernels with
    B13's dv of the last ``T3_FAULT_KEYS`` keys zeroed (dropped key
    tiles)."""
    from merlin_tpu_torch.models import decoder as dec_mod
    from merlin_tpu_torch.models import vit as vit_mod
    from merlin_tpu_torch.ops import flash_attention as fa
    from merlin_tpu_torch.ops import onepass_attention as oa
    from merlin_tpu_torch.ops.attention import mha_reference
    from merlin_tpu_torch.train.step import make_loss_fn

    def onepass_bwd_plain(q, k, v, do, lse, out, *, scale=None):
        return oa.onepass_attention_bwd_plain(
            q, k, v, do, lse, fa.attention_di(out, do), scale=scale)

    def onepass_launch_fault(*args):
        dq, dk, dv = launch(*args)
        dv[:, -T3_FAULT_KEYS:] = 0
        return dq, dk, dv

    launch = oa._launch_bwd          # B13's launch (B10+B11 keep fa's)
    swaps = {"kernels": [],
             "fault": [(oa, "_launch_bwd", onepass_launch_fault)],
             "plain": [(oa, "onepass_attention_lse",
                        oa.onepass_attention_lse_plain),
                       (oa, "onepass_attention_bwd", onepass_bwd_plain),
                       (fa, "flash_attention", fa.flash_attention_plain),
                       (fa, "flash_attention_bwd",
                        fa.flash_attention_bwd_plain)],
             "autograd": [(vit_mod, "shared_attention", mha_reference),
                          (dec_mod, "dispatch_attention", mha_reference)]
             }[route]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in swaps]
    micro = {k: torch.as_tensor(v[:1]).to("cuda") for k, v in batch.items()}
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        model.zero_grad(set_to_none=True)
        loss = make_loss_fn(model)(micro)
        loss.backward()
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    grads = {n: p.grad.detach().float().clone()
             for n, p in model.named_parameters() if p.grad is not None}
    model.zero_grad(set_to_none=True)
    return float(loss.detach()), grads


def t3_f32_twin(model):
    """The same MMGPT computing in f32, sharing ``model``'s parameters:
    through ``mha_reference`` (route "autograd") the f32 reference step;
    through the kernels (route "kernels") the f32 kernels' step (B12/B13
    and B2/B10+B11 at f32, C40)."""
    from merlin_tpu_torch.models.mmgpt import MMGPT

    cfg = model.cfg
    f32 = dataclasses.replace(
        cfg, lm=dataclasses.replace(cfg.lm, dtype=torch.float32),
        vit=dataclasses.replace(cfg.vit, dtype=torch.float32))
    with torch.device("meta"):
        twin = MMGPT(f32)
    twin.load_state_dict(model.state_dict(), strict=True, assign=True)
    return twin


def rel_err(got, want) -> float:
    """max |got - want| over max |want|."""
    return ((got - want).abs().max() / want.abs().max().clamp_min(1e-30)
            ).item()


def t3_hold(got, plain, exact, names):
    """Each gradient's error against the f32 step, over the plain
    versions' own: at most max(``TRAIN_GRAD_RTOL``, ``T3_NOISE_FACTOR`` x
    the plain error). With random weights the tower's attention is near
    uniform, so dq and dk (hence the q and k projections' gradients) are
    differences of near-equal terms that every bf16 route rounds to noise
    (C40): the plain versions are as far from the f32 step there. A key
    bias's exact gradient is 0 (C14), so each route holds noise: its
    largest value may reach max(``TRAIN_GRAD_RTOL`` x the f32 key
    kernel's largest, ``T3_NOISE_FACTOR`` x the plain versions' largest).
    Returns (worst ratio to the allowance, its name)."""
    worst, worst_name = 0.0, ""
    for name in names:
        if name.endswith("k_proj.bias"):
            kernel = exact[name[:-len("bias")] + "kernel"].abs().max()
            allowed = max(TRAIN_GRAD_RTOL * kernel,
                          T3_NOISE_FACTOR * plain[name].abs().max())
            ratio = (got[name].abs().max() / allowed).item()
        else:
            allowed = max(TRAIN_GRAD_RTOL,
                          T3_NOISE_FACTOR * rel_err(plain[name], exact[name]))
            ratio = rel_err(got[name], exact[name]) / allowed
        if ratio > worst:
            worst, worst_name = ratio, name
    return worst, worst_name


def t3_f32_qk(got, exact, names):
    """The worst of the tower's q/k projection gradients at f32, by kind
    (q_proj.kernel, q_proj.bias, k_proj.kernel, k_proj.bias): each one's
    max |got - exact| over max |exact|; a key bias, whose exact gradient
    is 0 (C14), max |got| over its kernel's max |exact|, beside the f32
    reference's own (its noise). Returns {kind: (error, name)} and the
    reference's largest key-bias noise."""
    worst, ref_noise = {}, 0.0
    for name in names:
        kind = ".".join(name.split(".")[-2:])
        if kind == "k_proj.bias":
            kernel = exact[name[:-len("bias")] + "kernel"].abs().max()
            err = (got[name].abs().max() / kernel).item()
            ref_noise = max(ref_noise,
                            (exact[name].abs().max() / kernel).item())
        else:
            err = rel_err(got[name], exact[name])
        if err > worst.get(kind, (0.0, ""))[0]:
            worst[kind] = (err, name)
    return worst, ref_noise


def run_t3(rng):
    """T3: the Trainer over a MetaCLIP-H/14-448 bundle with the tower
    trainable (B12/B13 at d = 80, 1025 tokens, under autograd), 2 steps at
    accum 2 on (2, 2048) batches with one image each; first, one
    microbatch's tower gradients against the same step on the plain
    attention."""
    from merlin_tpu_torch.train.arguments import ModelArguments

    model = build_t3_model()
    n = sum(p.numel() for p in model.parameters())
    batch = train_batch(np.random.default_rng(15), model.cfg.image_token_len,
                        rows=2, **T3_BATCH)
    reset_counts()
    loss_k, got = t3_grads(model, batch, "kernels")
    torch.cuda.synchronize()
    one = read_counts()
    loss_p, plain = t3_grads(model, batch, "plain")
    _, fault = t3_grads(model, batch, "fault")
    twin = t3_f32_twin(model)
    loss_x, exact = t3_grads(twin, batch, "autograd")
    # C40: the same f32 step through the f32 kernels, and with B13's
    # dropped key tiles planted
    qk = sorted(n for n in exact if n.startswith("vision_tower.")
                and (".q_proj." in n or ".k_proj." in n))
    reset_counts()
    _, got32 = t3_grads(twin, batch, "kernels")
    torch.cuda.synchronize()
    one32 = read_counts()
    got32 = {n: got32[n] for n in qk}
    _, fault32 = t3_grads(twin, batch, "fault")
    fault32 = {n: fault32[n] for n in qk}
    del twin
    qk_worst, ref_noise = t3_f32_qk(got32, exact, qk)
    qk_fault_worst, _ = t3_f32_qk(fault32, exact, qk)
    qk_err, qk_name = max(qk_worst.values())
    qk_fault, qk_fault_name = max(qk_fault_worst.values())
    log(f"T3 f32 (C40): the tower's {len(qk)} q/k projection gradients "
        f"through the f32 kernels against autograd of mha_reference, worst "
        f"by kind {qk_worst} (the reference's own key-bias noise "
        f"{ref_noise:.3e}); tol {T3_F32_QK_RTOL}; planted fault (B13's dv "
        f"of the last {T3_FAULT_KEYS} keys zeroed): {qk_fault_worst}, must "
        f"exceed it; launches {one32}")
    if not (qk_err <= T3_F32_QK_RTOL < qk_fault and one32 == launches(
            **suffixed(dict(B2=4, B12=T3_TOWER_LAYERS, B13=T3_TOWER_LAYERS,
                            **{"B10+B11": 2}), F32))):
        raise AssertionError(f"T3 f32 q/k gradient check failed: {qk_err} "
                             f"{qk_fault} {one32}")
    del got32, fault32
    tower = sorted(n for n in exact if n.startswith("vision_tower."))
    rest = sorted(n for n in exact if n not in tower)
    norm = math.sqrt(sum(float(got[n].square().sum()) for n in tower))
    norm_x = math.sqrt(sum(float(exact[n].square().sum()) for n in tower))
    worst, worst_name = t3_hold(got, plain, exact, tower)
    rest_worst, rest_name = t3_hold(got, plain, exact, rest)
    planted, planted_name = t3_hold(fault, plain, exact, tower)
    raw = {n: (rel_err(got[n], exact[n]), rel_err(plain[n], exact[n]))
           for n in tower if not n.endswith("k_proj.bias")}
    well = [n for n, (_, p) in raw.items() if p <= TRAIN_GRAD_RTOL]
    loss_rel = abs(loss_k - loss_x) / abs(loss_x)
    log(f"T3 one microbatch ({n / 1e9:.3f} B f32 parameters): loss "
        f"{loss_k:.6f} (plain versions {loss_p:.6f}, f32 step {loss_x:.6f}, "
        f"rel {loss_rel:.3e}); tower gradient norm {norm:.6e} (f32 step "
        f"{norm_x:.6e}); against the f32 step, the kernels' error over its "
        f"allowance max(tol {TRAIN_GRAD_RTOL}, {T3_NOISE_FACTOR} x the plain "
        f"versions'): tower worst {worst:.3f} ({worst_name}: kernels "
        f"{raw.get(worst_name, (0, 0))[0]:.3e}, plain "
        f"{raw.get(worst_name, (0, 0))[1]:.3e}), projector and LM worst "
        f"{rest_worst:.3f} ({rest_name}); {len(well)} of "
        f"{len(raw)} tower gradients within {TRAIN_GRAD_RTOL} on both "
        f"routes, kernels' worst among them "
        f"{max(raw[n][0] for n in well):.3e}; planted fault (B13's dv of the "
        f"last {T3_FAULT_KEYS} keys zeroed): {planted:.3f} ({planted_name}), "
        f"must exceed 1; launches {one}")
    if not (math.isfinite(norm) and norm > 0 and sorted(got) == sorted(exact)
            and worst <= 1 and rest_worst <= 1 and planted > 1
            and loss_rel <= TRAIN_LOSS_RTOL
            and one == launches(B2=4, B12=T3_TOWER_LAYERS,
                                B13=T3_TOWER_LAYERS, **{"B10+B11": 2})):
        raise AssertionError(f"T3 gradient check failed: {worst} {rest_worst} "
                             f"{planted} {loss_rel} {one}")
    del got, plain, fault, exact
    seen, counts, peak, prof = run_training(
        "T3 MetaCLIP-H/14 tower trained (2 LM layers)", model,
        ModelArguments(freeze_vision_tower=False),
        train_args(gradient_accumulation_steps=2, max_steps=2), 2, rng,
        **T3_BATCH)
    losses = [m["loss"] for m in seen]
    micro = 2 * 2
    want_counts = launches(B2=2 * 2 * micro, B12=T3_TOWER_LAYERS * micro,
                           B13=T3_TOWER_LAYERS * micro,
                           **{"B10+B11": 2 * micro})
    finite = all(math.isfinite(x) for x in losses) and all(
        math.isfinite(m["grad_norm"]) for m in seen)
    log(f"T3 checks: losses {losses} finite {finite}; launches exact "
        f"{counts == want_counts}")
    if not (finite and counts == want_counts):
        raise AssertionError(f"T3 failed: {losses} {counts}")
    return dict(losses=losses, counts=counts, peak_bytes=peak,
                step_time_s=seen[-1]["step_time_s"],
                tokens_per_sec=seen[-1]["tokens_per_sec"],
                mfu=seen[-1]["mfu"], profile=prof, tower_grad_norm=norm,
                worst_grad_ratio=worst, worst_grad=worst_name,
                loss_rel=loss_rel,
                one_micro_counts=one, lm_projector_worst_ratio=rest_worst,
                planted_ratio=planted, tower_grad_norm_f32=norm_x,
                f32_qk_worst=qk_err, f32_qk_worst_name=qk_name,
                f32_qk_planted=qk_fault, one_micro_counts_f32=one32)


# --- phase L: LoRA factors trained over a frozen bf16 base ----------------

L_STEPS = 3
L_LR = 1e-2


def l_batch(rng, cfg, seq=2048, n_pad=N_PAD):
    """One (1, ``seq``) row with one image block and an answer, then
    ``n_pad`` padding positions, with the bundle's special ids; a uint8
    448x448 frame."""
    special = {cfg.image_patch_id, cfg.im_start_id, cfg.im_end_id}

    def text(n):
        out = rng.integers(10, min(31000, cfg.lm.vocab_size - 10), size=n)
        return [int(t) for t in out if int(t) not in special]

    head = [1] + text(40) + [cfg.im_start_id] + \
        [cfg.image_patch_id] * cfg.image_token_len + [cfg.im_end_id] + text(40)
    valid = seq - n_pad
    answer = text(valid - len(head))
    answer += [11] * (valid - len(head) - len(answer))
    ids = np.zeros((1, seq), np.int64)
    labels = np.full((1, seq), -100, np.int64)
    ids[0, :valid] = head + answer
    labels[0, len(head):valid] = answer
    mask = np.zeros((1, seq), np.int32)
    mask[:, :valid] = 1
    images = rng.integers(0, 256, size=(1, 1, 448, 448, 3), dtype=np.uint8)
    return {k: torch.from_numpy(v).to("cuda") for k, v in dict(
        input_ids=ids, labels=labels, attention_mask=mask,
        segment_ids=mask.copy(), images=images).items()}


def run_l(bundle, rng, smi):
    """L: LoRA over the W bundle with its base held in bf16 (the tower
    frozen), ``lora_r``/``lora_alpha`` defaults and the reference's
    targets, ``L_STEPS`` steps of ``torch.optim.Adam`` over the factors on
    one (1, 2048) batch with one image. B1 = 23 a forward, B2 = 32 a
    forward (twice under remat), B10 + B11 = 32 a backward."""
    from merlin_tpu_torch.train.arguments import TrainingArguments
    from merlin_tpu_torch.train.checkpoint import fingerprint
    from merlin_tpu_torch.train.lora import (
        init_lora_params, make_lora_loss_fn, merge_lora)

    model = bundle.model
    bundle.params = None              # the f32 tensors go with the cast
    model.to(torch.bfloat16)
    free_cuda()
    base = model.state_dict()
    before = {n: fingerprint(t) for n, t in base.items()}
    targs = TrainingArguments()
    rank, alpha = targs.lora_r, float(targs.lora_alpha)
    lora = init_lora_params(
        base, rank=rank, generator=torch.Generator(device="cuda").manual_seed(
            14))
    merged = merge_lora(base, lora, rank=rank, alpha=alpha)
    identical = all(torch.equal(merged[n], base[n]) for n in lora)
    del merged
    n_factors = sum(t.numel() for e in lora.values() for t in e.values())
    batch = l_batch(rng, bundle.config)
    factors = [t.requires_grad_() for e in lora.values() for t in e.values()]
    opt = torch.optim.Adam(factors, lr=L_LR)
    loss_fn = make_lora_loss_fn(model, base, rank=rank, alpha=alpha)
    losses = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    for _ in range(L_STEPS):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(lora, batch)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
    with torch.no_grad():
        final = float(loss_fn(lora, batch))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    n = bundle.config.lm.num_layers
    want = launches(B1=23 * (L_STEPS + 1), B2=2 * n * L_STEPS + n,
                    **{"B10+B11": n * L_STEPS})
    same = all(fingerprint(t) == before[name]
               for name, t in model.state_dict().items())
    b_moved = all(bool(e["b"].detach().abs().max() > 0)
                  for e in lora.values())
    log(f"L LoRA r={rank} alpha={alpha:g} over {len(lora)} targets "
        f"({n_factors / 1e6:.1f} M factor values) on a bf16 base: merged == "
        f"base at step 0: {identical}; losses {losses}, after "
        f"{L_STEPS} steps {final:.6f} (falls: {final < losses[0]}); base "
        f"bit-identical: {same}; every b non-zero: {b_moved}; launches "
        f"{counts} (formula {want}); peak {peak} bytes; {wall:.2f} s for "
        f"{L_STEPS} steps and a forward (card {smi})")
    if not (identical and final < losses[0] and same and b_moved
            and counts == want):
        raise AssertionError(f"L failed: {identical} {losses} {final} "
                             f"{same} {b_moved} {counts}")
    return counts, dict(losses=losses + [final], peak_bytes=peak,
                        targets=len(lora), factor_values=n_factors,
                        seconds=wall)


# --- phase D: the data pipeline and the training entry point ---------------

D_STEPS = 3                  # D1's steps; D1r resumes to D_STEPS + 1
D_CKPT_BYTES = 6e9           # one checkpoint: the trainable tensors (0.46
                             # B, f32) and their AdamW moments; the frozen
                             # LM is kept as fingerprints
# (recipe name, family, shards, samples a shard, merge round); each spec's
# size is its shards' real sample count
D_SETS = (("laion2b_10m_6merge", "pair", 2, 24, 6),
          ("track_1m_v2_2merge", "interpair", 2, 8, 2),
          ("det_5m_v1_en_4merge", "interpair", 2, 16, 4))
D_CONV = "d_conversations"   # the conversation set's registry name
D_N_CONV = 8
# a word only that family's texts hold: which family a packed row came from
D_MARKERS = {"laion2b_10m_6merge": "laion", "track_1m_v2_2merge": "track",
             "det_5m_v1_en_4merge": "Detect", D_CONV: "where"}
D_PIPE_BATCHES = 8           # batches timed through batch_iterator alone
D_RAW_SAMPLES = 2000         # raw tar samples timed on each loader route


def d_jpeg(rng, w, h) -> bytes:
    import io

    buf = io.BytesIO()
    v_jpeg(buf, rng.integers(0, 256, (h, w, 3), dtype=np.uint8), quality=75)
    return buf.getvalue()


def d_box(rng, w, h):
    x1, y1 = int(rng.integers(0, w // 2)), int(rng.integers(0, h // 2))
    return [x1, y1, x1 + int(rng.integers(20, w // 2)),
            y1 + int(rng.integers(20, h // 2))]


def d_sample(rng, name, key, i, s):
    """One tar sample's members: a 640x480 noise JPEG and its caption
    (pair); ``frame0``/``frame1`` at 640x360 and the tracking template's
    JSON (track); one 640x480 frame and a detection prompt (det)."""
    if name.startswith("laion"):
        return {"jpg": d_jpeg(rng, 640, 480),
                "txt": f"a laion photo number {i} of shard {s}".encode()}
    if name.startswith("track"):
        a, b = d_box(rng, 640, 360), d_box(rng, 640, 360)
        return {"frame0.jpg": d_jpeg(rng, 640, 360),
                "frame1.jpg": d_jpeg(rng, 640, 360),
                "json": json.dumps({
                    "image_name_list": [f"{key}-frame0", f"{key}-frame1"],
                    "prompt": f"Given image0<image> and image1<image>, track "
                              f"image0:<Id1>{a}</Id1> in image1.",
                    "txt": f"<Id1>{b}</Id1>"}).encode()}
    boxes = [d_box(rng, 640, 480) for _ in range(2)]
    return {"frame0.jpg": d_jpeg(rng, 640, 480),
            "json": json.dumps({
                "image_name_list": [f"{key}-frame0"],
                "prompt": "<image>\nDetect all objects in the image.",
                "txt": " ".join(f"<Id{k + 1}>{b}</Id{k + 1}>"
                                for k, b in enumerate(boxes))}).encode()}


def d_write_data(root, rng):
    """D's tar shards and conversation set, written from ``rng`` under
    ``root`` and registered in the port's registry under the recipe's
    names (det_/track_ in both the pair and the interpair family, as the
    registry holds them). Returns {name: shard paths}."""
    import io
    import tarfile

    from merlin_tpu_torch.data import registry

    shards = {}
    for name, family, n_shards, n, merge in D_SETS:
        paths = []
        for s in range(n_shards):
            path = os.path.join(root, f"{name}-{s:02d}.tar")
            with tarfile.open(path, "w") as tf:
                for i in range(n):
                    key = f"{name.split('_')[0]}{s}{i:04d}"
                    for ext, data in d_sample(rng, name, key, i, s).items():
                        info = tarfile.TarInfo(f"{key}.{ext}")
                        info.size = len(data)
                        tf.addfile(info, io.BytesIO(data))
            paths.append(path)
        spec = registry.WebdataSpec(path=paths, size=n_shards * n,
                                    merge_round=merge)
        registry.register(family, name, spec)
        if family == "interpair":
            registry.register("pair", name, spec)
        shards[name] = paths
    images = os.path.join(root, "conversation_images")
    os.makedirs(images)
    ann = []
    for i in range(D_N_CONV):
        with open(os.path.join(images, f"conv{i}.jpg"), "wb") as f:
            f.write(d_jpeg(rng, 640, 480))
        ann.append({"image": f"conv{i}.jpg", "conversations": [
            {"from": "human",
             "value": "<image>\nwhere is the <box> in this frame ?"},
            {"from": "gpt", "value": f"object {i} is at <box> now"}],
            "boxes": [d_box(rng, 640, 480), d_box(rng, 640, 480)]})
    with open(os.path.join(root, "conversations.json"), "w") as f:
        json.dump(ann, f)
    registry.register("conversation", D_CONV, registry.ConversationSpec(
        annotations=os.path.join(root, "conversations.json"),
        images=images))
    return shards


def d_argv(out_dir, steps):
    """The reference's pretraining command line on D's data, the LM frozen
    (f32 AdamW over an unfrozen 7B does not fit one card); the rest is
    pretrain.sh's recipe, as ``train_args()``."""
    return ["--pair_datasets", "laion2b_10m_6merge",
            "--interpair_datasets", "track_1m_v2_2merge+det_5m_v1_en_4merge",
            "--conversation_datasets", D_CONV,
            "--freeze_lm_model", "True", "--tune_im_start_end", "True",
            "--group_by_modality_length", "True",
            "--per_device_train_batch_size", "1",
            "--gradient_accumulation_steps", "2",
            "--model_max_length", "2048", "--num_train_steps", str(steps),
            "--save_steps", "0", "--output_dir", out_dir,
            "--learning_rate", "5e-5", "--adam_beta2", "0.95",
            "--weight_decay", "0.05", "--max_grad_norm", "1.0",
            "--warmup_ratio", "0.01", "--lr_scheduler_type", "cosine",
            "--gradient_checkpointing", "True", "--bf16", "True",
            "--llrd", "True", "--logging_steps", "1"]


class DTap:
    """Around one ``train()`` call: the entry point's ``Trainer`` and
    ``batch_iterator`` wrapped to record the trainer, the batches it
    received, each step's metrics, and the checkpoint's load and save
    seconds; undone after, and the package logger restored
    (``setup_logger`` stops its propagation)."""

    def __enter__(self):
        from merlin_tpu_torch.engine import train as engine

        self.engine = engine
        self.saved = (engine.Trainer, engine.batch_iterator)
        pkg = logging.getLogger("merlin_tpu_torch")
        self.logger_state = (pkg.handlers[:], pkg.propagate, pkg.level)
        self.batches, self.steps, self.trainer = [], [], None
        self.resumed, self.load_s = 0, None
        tap, (base, iterate) = self, self.saved

        class Tapped(base):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                tap.trainer = self

            def maybe_resume(self):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                tap.resumed = super().maybe_resume()
                torch.cuda.synchronize()
                tap.load_s = time.perf_counter() - t0
                return tap.resumed

            def train(self, batches, **kw):
                return super().train(
                    batches, log_fn=lambda s, m: tap.steps.append(m), **kw)

            def save_final(self):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                tap.checkpoint = super().save_final()
                tap.save_s = time.perf_counter() - t0
                return tap.checkpoint

        def tapped(*a, **kw):
            for batch in iterate(*a, **kw):
                tap.batches.append(batch)
                yield batch

        engine.Trainer, engine.batch_iterator = Tapped, tapped
        return self

    def __exit__(self, *exc):
        self.engine.Trainer, self.engine.batch_iterator = self.saved
        pkg = logging.getLogger("merlin_tpu_torch")
        for h in pkg.handlers:
            if h not in self.logger_state[0]:
                h.close()
        pkg.handlers[:], pkg.propagate, pkg.level = self.logger_state


def d_train(tag, argv):
    """``merlin_tpu_torch.engine.train.train(argv)`` on the card, the launch
    counts set to 0 just before and read just after."""
    from merlin_tpu_torch.engine.train import train

    with DTap() as tap:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        tap.metrics = train(argv)
        torch.cuda.synchronize()
        tap.wall_s = time.perf_counter() - t0
        tap.counts = read_counts()
        tap.peak = torch.cuda.max_memory_allocated()
    for m in tap.steps:
        log(f"{tag} step: loss {m['loss']:.7f}, grad_norm "
            f"{m['grad_norm']:.4f}, lr {m['lr']:.3e}, step "
            f"{m['step_time_s']:.3f} s, "
            f"{m.get('tokens_per_sec', float('nan')):.1f} tok/s, mfu "
            f"{m.get('mfu', float('nan')):.4f} (host clock; 8ND at 989 "
            f"TFLOP/s)")
    log(f"{tag}: train() {tap.wall_s:.1f} s, launches {tap.counts}, peak "
        f"memory {tap.peak} bytes; {len(tap.batches)} batches drawn")
    return tap


def d_check_launches(tag, counts, steps):
    """T2's formula: per step 2 microbatches x 32 LM layers x 2 (remat) B2
    launches, 2 x 32 fused backward launches (B10 + B11), 2 x 23 tower
    layers of B12 and of B13; no other kernel."""
    want = launches(B2=128 * steps, B12=46 * steps, B13=46 * steps,
                    **{"B10+B11": 64 * steps})
    if counts != want:
        raise AssertionError(f"{tag}: launches {counts}, want {want}")


def d_init_loss(model):
    """The first loss a random, untrained head should give: ln V + s2 / 2,
    the cross entropy of Gaussian logits of variance s2 against a target
    they do not depend on. The final RMSNorm leaves a token's features at
    RMS 1 times its scales, so a logit's variance is sum_i scale_i^2 *
    mean_v W[i, v]^2 over the (frozen) head W: ~1 under the flax-like
    initializers (unit scales, LeCun-normal head)."""
    with torch.no_grad():
        scale = model.lm.final_norm.scale.float()
        head = model.lm.lm_head.kernel.float()
        s2 = float((scale ** 2 * (head ** 2).mean(dim=1)).sum())
    vocab = head.shape[1]
    return vocab, s2, math.log(vocab) + s2 / 2


def d_frozen_lm(bundle):
    """Replays ``init_or_load_params``'s draws (seed 0 on the card, in
    parameter order) and holds the trained model against them: every LM
    tensor bit-identical but the embedding rows its row mask trains, the
    special tokens' rows moved, and no tower or projector tensor left
    where it started (but the key biases: zero gradient in exact
    arithmetic)."""
    from merlin_tpu_torch.models.builder import _flax_like

    gen = torch.Generator(device="cuda").manual_seed(0)
    frozen_rows = torch.as_tensor(bundle.embed_row_trainable,
                                  device="cuda") == 0
    ids = bundle.special_ids
    special = [ids.im_start, ids.image_patch, ids.im_end]
    lm_same, rows_moved, still = True, False, []
    with torch.no_grad():
        for name, p in bundle.model.named_parameters():
            init = _flax_like(name, p.shape, torch.int8 if name.endswith(
                "kernel_q8") else torch.float32, gen, "cuda")
            if name == "lm.embed_tokens.embedding":
                lm_same &= torch.equal(p[frozen_rows], init[frozen_rows])
                rows_moved = bool((p[special] != init[special]).any(-1).all())
            elif name.startswith("lm."):
                lm_same &= torch.equal(p, init)
            elif not name.endswith("k_proj.bias") and torch.equal(p, init):
                still.append(name)
    return lm_same, rows_moved, still, special


def d_check_batch(tag, batch, ids, n_patches):
    """The collator's static shapes, and every image block whole and never
    supervised."""
    for k in ("input_ids", "labels", "segment_ids", "attention_mask"):
        if batch[k].shape != (2, 2048) or batch[k].dtype != np.int32:
            raise AssertionError(f"{tag}: {k} {batch[k].shape} "
                                 f"{batch[k].dtype}")
    if batch["images"].shape != (2, 8, 448, 448, 3) or \
            batch["images"].dtype != np.uint8:
        raise AssertionError(f"{tag}: images {batch['images'].shape}")
    blocks = 0
    for row, lab in zip(batch["input_ids"], batch["labels"]):
        for s in np.flatnonzero(row == ids.im_start):
            if not (np.all(row[s + 1: s + 1 + n_patches] == ids.image_patch)
                    and row[s + 1 + n_patches] == ids.im_end):
                raise AssertionError(f"{tag}: image block at {s} broken")
            blocks += 1
        part = np.isin(row, [ids.im_start, ids.image_patch, ids.im_end])
        if not np.all(lab[part] == -100):
            raise AssertionError(f"{tag}: image tokens supervised")
    return blocks


def d_families(tok, batch):
    """The family of each row, by its marker word."""
    out = []
    for row in batch["input_ids"]:
        words = set(tok.decode(row).split())
        out.append([name for name, w in D_MARKERS.items() if w in words])
    return out


def d_same(a, b):
    return all(np.array_equal(a[k], b[k]) for k in
               ("input_ids", "labels", "segment_ids", "attention_mask",
                "images"))


def d_pipeline(argv, ckpt3, step_s):
    """The host side on D's settings: a fresh pipeline (the tokenizer and
    dataloader ``train()`` builds) timed alone, its first 4 batches checked
    for shapes, image blocks and families; then a second fresh pipeline
    loaded with checkpoint-3's cursor must draw the first's 4th batch, and
    the same cursor with one sample dropped must not."""
    from merlin_tpu_torch.data.builder import (
        batch_iterator, build_dataloader, resume_data)
    from merlin_tpu_torch.models.builder import build_model_tokenizer
    from merlin_tpu_torch.train.arguments import parse_args

    model_args, data_args, training_args = parse_args(argv)
    bundle = build_model_tokenizer(model_args, data_args, training_args)
    tok, ids = bundle.tokenizer, bundle.special_ids
    del bundle

    def pipeline(state=None, plant=None):
        data = build_dataloader(tok, ids, data_args, training_args,
                                process_index=0, process_count=1)
        start = resume_data(data["train_dataset"], state)
        if plant is not None:
            start = plant(data["train_dataset"], start)
        return batch_iterator(data["train_dataset"], data["collator"],
                              batch_size=2, sampler=data["sampler"],
                              start=start)

    t0 = time.perf_counter()
    it = pipeline()
    batches = [next(it)]
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    batches += [next(it) for _ in range(D_PIPE_BATCHES)]
    feed_s = time.perf_counter() - t0
    it.close()
    blocks = sum(d_check_batch(f"D fresh batch {i + 1}", b, ids,
                               data_args.num_patches)
                 for i, b in enumerate(batches[:4]))
    fams = [d_families(tok, b) for b in batches[:4]]
    seen = {f for b in fams for row in b for f in row}
    if seen != set(D_MARKERS) or any(len(r) != 1 for b in fams for r in b):
        raise AssertionError(f"D: the first 4 batches' families {fams}")

    with open(os.path.join(ckpt3, "data_state.json")) as f:
        cursor = json.load(f)["datasets"]
    resumed = next(pipeline(state=cursor))
    cursor_ok = d_same(resumed, batches[3])

    # the planted fault: one sample dropped from the cursor, in the family
    # the 4th batch's first row came from
    family = fams[3][0][0]
    names = [D_CONV] + [name for name, *_ in D_SETS]

    def drop_one(dataset, start):
        if family == D_CONV:
            return start + 1          # a map-style set's cursor: the index
        child = dataset.datasets[names.index(family)]
        state = child.data_state()
        state["stream"]["buffer"].pop(0)
        child.load_data_state(state)
        return start

    planted = next(pipeline(state=cursor, plant=drop_one))
    caught = not d_same(planted, batches[3])
    rate = 2 * D_PIPE_BATCHES / feed_s
    log(f"D pipeline alone (batch_iterator, D's settings): first batch "
        f"{first_s:.2f} s (each stream fills its 1000-sample reservoir), "
        f"then {D_PIPE_BATCHES} batches in {feed_s:.2f} s: {rate:.2f} "
        f"samples/s, {D_PIPE_BATCHES / feed_s:.3f} batches/s against "
        f"{1 / step_s:.3f} steps/s (D1's last step, {step_s:.3f} s): the "
        f"feed runs {(D_PIPE_BATCHES / feed_s) * step_s:.2f}x the step rate "
        f"(host clock)")
    log(f"D host checks: 4 fresh batches of (2, 2048) int32 and (2, 8, 448, "
        f"448, 3) uint8, {blocks} image blocks whole and unsupervised; "
        f"families {fams}; checkpoint-3's cursor (indices "
        f"{cursor['indices']}) draws the 4th batch: {cursor_ok}; one sample "
        f"dropped ({family}) caught: {caught}")
    if not (cursor_ok and caught):
        raise AssertionError(f"D cursor: {cursor_ok}, planted {caught}")
    return dict(first_batch_s=first_s, samples_per_s=rate,
                batches_per_s=D_PIPE_BATCHES / feed_s,
                feed_over_step_rate=(D_PIPE_BATCHES / feed_s) * step_s,
                image_blocks=blocks, families=fams,
                cursor_indices=cursor["indices"], dropped_from=family)


def d_native(shards):
    """The port's copy of the tar loader, built here by the host compiler:
    one epoch through it holds the same multiset of samples as the Python
    tar path over D's shards; ``shard_sample_stream`` on each route (D's
    settings: buffer 1000, one process) draws every key, timed."""
    from merlin_tpu_torch.data import native_loader
    from merlin_tpu_torch.data import shards as sh

    t0 = time.perf_counter()
    native_loader.build(force=True)
    build_s = time.perf_counter() - t0
    if not native_loader.native_available():
        raise AssertionError("D: the native loader is not available")
    paths = sorted(p for ps in shards.values() for p in ps)
    py = collections.Counter(s["__key__"] for s in sh.tar_to_samples(
        iter(paths)))
    nat = collections.Counter(s["__key__"] for s in
                              native_loader.NativeTarStream(paths,
                                                            max_epochs=1))
    rates, keys, nbytes_ = {}, {}, {}
    for route, use in (("native", True), ("python", False)):
        stream = sh.shard_sample_stream(paths, use_native=use,
                                        process_index=0, process_count=1)
        next(stream)                  # the reservoir fills first
        t0 = time.perf_counter()
        got = [next(stream) for _ in range(D_RAW_SAMPLES)]
        rates[route] = D_RAW_SAMPLES / (time.perf_counter() - t0)
        keys[route] = {s["__key__"] for s in got}
        nbytes_[route] = sum(len(v) for s in got for k, v in s.items()
                             if k != "__key__")
    ok = py == nat and keys["native"] == keys["python"] == set(py)
    mb = nbytes_["native"] / D_RAW_SAMPLES / 1e6
    log(f"D native loader: built by the host compiler in {build_s:.1f} s; "
        f"one epoch ({sum(py.values())} samples, {len(paths)} shards) the "
        f"same multiset as the Python tar path: {py == nat}; "
        f"shard_sample_stream draws {D_RAW_SAMPLES} samples ({mb:.3f} MB "
        f"each): native {rates['native']:.1f} samples/s, python "
        f"{rates['python']:.1f} ({rates['native'] / rates['python']:.2f}x; "
        f"host clock), every key on both routes: "
        f"{keys['native'] == keys['python'] == set(py)}")
    if not ok:
        raise AssertionError("D: the native loader disagrees with Python")
    return dict(build_s=build_s, native_samples_per_s=rates["native"],
                python_samples_per_s=rates["python"],
                mb_per_sample=mb, epoch_samples=sum(py.values()))


def run_d(smi):
    """D: the reference's pretraining command line through
    ``merlin_tpu_torch.engine.train.train`` at ViT-L/14-448 + Vicuna-7B
    width and depth (the LM frozen), on tar shards and a conversation set
    written from a seed: D1 takes 3 steps and writes checkpoint-3, D1r
    resumes from it (parameters, optimizer, data cursor) and takes one;
    then the host side (pipeline rate, cursor, planted fault) and the
    native loader. Returns the readings and D1's launch counts."""
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="merlin_d_")
    try:
        free = shutil.disk_usage(root).free
        if free < 2 * D_CKPT_BYTES:
            raise AssertionError(
                f"D: {free / 1e9:.1f} GB free under {root}; its two "
                f"checkpoints need {2 * D_CKPT_BYTES / 1e9:.1f} GB")
        t0 = time.perf_counter()
        data_dir = os.path.join(root, "data")
        os.makedirs(data_dir)
        shards = d_write_data(data_dir, np.random.default_rng(12))
        log(f"D data written in {time.perf_counter() - t0:.1f} s; "
            f"{free / 1e9:.1f} GB free for the checkpoints")
        out = os.path.join(root, "out")

        d1 = d_train("D1", d_argv(out, D_STEPS))
        d_check_launches("D1", d1.counts, D_STEPS)
        bundle = d1.trainer.bundle
        vocab, s2, init_loss = d_init_loss(bundle.model)
        losses = [m["loss"] for m in d1.steps]
        first_ok = abs(losses[0] - init_loss) <= 0.5
        lm_same, rows_moved, still, special = d_frozen_lm(bundle)
        ckpt3 = d1.checkpoint
        ckpt_bytes = sum(os.path.getsize(os.path.join(ckpt3, f))
                         for f in os.listdir(ckpt3))
        step_s = d1.steps[-1]["step_time_s"]
        d1_batches = list(d1.batches)
        ids, n_patches = bundle.special_ids, bundle.config.image_token_len
        log(f"D1 checks: vocab {vocab}; first loss {losses[0]:.6f} vs "
            f"ln(V) + s2/2 = {math.log(vocab):.6f} + {s2:.4f}/2 = "
            f"{init_loss:.6f}, an untrained head's (within 0.5: "
            f"{first_ok}); losses "
            f"finite: {all(map(math.isfinite, losses))}; LM bit-identical "
            f"but the trainable embedding rows: {lm_same}; rows {special} "
            f"moved: {rows_moved}; tower and projector tensors that did not "
            f"move: {still}; checkpoint-3 {ckpt_bytes} bytes saved in "
            f"{d1.save_s:.1f} s")
        if not (vocab == bundle.config.lm.vocab_size == 32003 and first_ok
                and lm_same and rows_moved
                and not still and len(losses) == D_STEPS
                and all(map(math.isfinite, losses))
                and d1.trainer.step == D_STEPS
                and os.path.basename(ckpt3) == f"checkpoint-{D_STEPS}"):
            raise AssertionError(f"D1 failed: {losses} {lm_same} "
                                 f"{rows_moved} {still}")
        counts, peak = d1.counts, d1.peak
        metrics = list(d1.steps)
        save_s = d1.save_s
        del d1, bundle
        free_cuda()

        d1r = d_train("D1r", d_argv(out, D_STEPS + 1))
        d_check_launches("D1r", d1r.counts, 1)
        ok = (d1r.resumed == D_STEPS and len(d1r.steps) == 1
              and d1r.trainer.step == D_STEPS + 1
              and math.isfinite(d1r.steps[0]["loss"])
              and os.path.isdir(os.path.join(out, f"checkpoint-{D_STEPS}"))
              and os.path.basename(d1r.checkpoint)
              == f"checkpoint-{D_STEPS + 1}")
        log(f"D1r: resumed at step {d1r.resumed} from checkpoint-{D_STEPS} "
            f"(loaded in {d1r.load_s:.1f} s), {len(d1r.steps)} step to "
            f"{d1r.trainer.step}, loss {d1r.steps[0]['loss']:.6f}: {ok}")
        if not ok:
            raise AssertionError("D1r failed")
        load_s, d1r_batches = d1r.load_s, list(d1r.batches)
        resume_metrics = dict(d1r.steps[0])
        del d1r
        free_cuda()

        blocks = 0
        for tag, bs in (("D1", d1_batches), ("D1r", d1r_batches)):
            for i, b in enumerate(bs):
                blocks += d_check_batch(f"{tag} batch {i + 1}", b, ids,
                                        n_patches)
        log(f"D: every batch the two runs' Trainers received "
            f"({len(d1_batches)} + {len(d1r_batches)}) holds the collator's "
            f"shapes, {blocks} image blocks whole and unsupervised")
        host = d_pipeline(d_argv(out, D_STEPS), ckpt3, step_s)
        native = d_native(shards)
        return dict(steps=metrics, resumed_step=resume_metrics,
                    init_loss=init_loss, head_logit_var=s2, peak_bytes=peak,
                    checkpoint_bytes=ckpt_bytes,
                    checkpoint_save_s=save_s, checkpoint_load_s=load_s,
                    pipeline=host, native_loader=native), counts
    finally:
        shutil.rmtree(root, ignore_errors=True)


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


# the wgmma kernels, the paged kernels and the f32 kernels, by a piece of
# their (mangled) names: every instantiation must build with no spills (18
# dense wgmma ones; the paged few-rows and window kernels each at d = 64,
# 128 and 256, bf16 and int8 pages, ALiBi being a run-time branch of each;
# the f32 forward (3xTF32) at d <= 64/128/256, its dq and dk/dv kernels
# likewise; the f32 paged few-rows kernel at its 5 (q, page) modes and the
# f32 paged window kernel at its 4, each at d <= 128 and d <= 256)
SPILL_CHECKED = ("flash_attention_fwd_kernel", "onepass_attention_kernel",
                 "flash_bwd_", "paged_rows_kernel", "paged_window_kernel",
                 "attention_f32_kernel", "paged_rows_f32_kernel",
                 "paged_window_f32_kernel")
N_SPILL_CHECKED = 57


def ptxas_report(pieces=SPILL_CHECKED):
    """Registers and spill bytes that ptxas reported while building the
    library, for each kernel whose (mangled) name holds one of ``pieces``,
    with any "Potential Performance Loss" note ptxas gave it (a wgmma
    serialized)."""
    import re

    from merlin_tpu_torch.ops import _build

    report, current = {}, None
    for line in _build.ptxas_log().splitlines():
        m = re.search(r"Performance Loss: (.*) in the function '(\S+)'",
                      line)
        if m and any(p in m.group(2) for p in pieces):
            report.setdefault(m.group(2), {}).setdefault(
                "warnings", []).append(m.group(1))
            continue
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            current = m.group(1) if any(p in m.group(1) for p in pieces) \
                else None
            if current:
                report.setdefault(current, {})
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


# ---------------------------------------------------------------------------
# phase 2, float32: the f32 kernels against their plain versions
# ---------------------------------------------------------------------------

def f32_err(got, want) -> float:
    """max |got - want| as a share of max |want| over the whole tensor."""
    want = want.float()
    return ((got.float() - want).abs().max()
            / want.abs().max().clamp_min(1e-30)).item()


def hold_f32(tag, got, want, tol=F32_RTOL) -> float:
    err = f32_err(got, want)
    log(f"{tag}: error {err:.3e} of max |plain| (tol {tol:.0e})")
    if not (err <= tol and torch.isfinite(got.float()).all()):
        raise AssertionError(f"{tag} disagrees: {err}")
    return err


def planted_f32(tag, got, want, what, tol=F32_RTOL):
    """A planted fault must put the f32 check over its tolerance."""
    err = f32_err(got, want)
    log(f"{tag} planted fault ({what}): error {err:.3e}, must exceed "
        f"{tol:.0e}")
    if not err > tol:
        raise AssertionError(f"{tag}: the check cannot see {what}")


def f32_randn(shape, gen, normed=False):
    x = torch.randn(shape, generator=gen, device="cuda")
    if normed:                        # the tower's LayerNorm-bounded rows
        x = (x - x.mean(-1, keepdim=True)) / x.std(-1, keepdim=True)
    return x


def sdpa_f32_fwd(q, k, v, **kw):
    """SDPA's forward at f32 on (b, s, h, d) inputs, unpinned (flash and
    cuDNN take bf16/fp16 only, so the dispatcher picks the memory-efficient
    or the math backend): (device ms, the backward node it builds)."""
    lib_for, (qt, kt, vt) = sdpa_fwd(q, k, v, **kw)
    node = type(F.scaled_dot_product_attention(
        qt.detach().requires_grad_(), kt, vt, **kw).grad_fn).__name__
    return time_ms(lib_for(None), iters=10, warmup=3), node


def sdpa_f32_bwd(q, k, v, do, **kw):
    """SDPA's backward at f32, unpinned: (device ms, its node's name)."""
    qt, kt, vt = (t.transpose(1, 2).detach().requires_grad_()
                  for t in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt, **kw)
    dot = do.transpose(1, 2)
    ms = time_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                             retain_graph=True),
                 iters=10, warmup=3)
    return ms, type(out.grad_fn).__name__


def f32_row(name, fn_name, source, replaces, counter, errs, ms, plain_ms,
            flops, nbytes_, library_ms, shape, smi, **extra):
    """A dense f32 kernel's row: its bound at 3xTF32's rate (the kernel's
    own) and, beside it, at FFMA's."""
    bms, by = bound_ms(flops, nbytes_, PEAK_TF32X3_FLOPS)
    ffma, _ = bound_ms(flops, nbytes_, PEAK_F32_FLOPS)
    log(f"{name} f32 {shape}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {bms:.4f} ms ({by}; 3xTF32 at 165 TFLOP/s, bytes at 3.35 "
        f"TB/s; FFMA at 67 TFLOP/s: {ffma:.4f} ms), library "
        + (f"{library_ms:.4f} ms ({extra.get('library_backend')})"
           if library_ms is not None else "none") + f"; card {smi}")
    return dict(name=f"{name} f32 {fn_name}", route="cuda", source=source,
                replaces=replaces, counter=counter,
                max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                bound_ms=bms, bound_by=by, bound_ms_ffma=ffma,
                library_ms=library_ms, shape=list(shape), card=smi, **extra)


def tf32_chop(x):
    """x (f32) with its low 13 mantissa bits cleared: the tf32 value one
    pass of the tensor cores reads of an f32 operand."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def check_f32_dense(gen, smi):
    """B1, B2, B12 and the backward (B10 + B11, B13) at f32 against their
    plain versions, each planted fault failing the same check; times at
    the path's shapes against SDPA at f32. Returns the rows."""
    from merlin_tpu_torch.ops import flash_attention as fa
    from merlin_tpu_torch.ops import onepass_attention as oa

    errs = collections.defaultdict(list)
    # B1 at the towers' widths: CLIP-L (64), MetaCLIP-H (80), bigG (104)
    for shape in [(1, 1025, 16, 64), (2, 1025, 16, 80), (1, 1025, 16, 104)]:
        q, k, v = (f32_randn(shape, gen, normed=True) for _ in range(3))
        want = oa.onepass_attention_plain(q, k, v)
        errs["B1"].append(hold_f32(f"B1 f32 {shape}",
                                   oa.onepass_attention(q, k, v), want))
        planted_f32(f"B1 f32 {shape}", oa.onepass_attention(
            q, k[:, :-1], v[:, :-1]), want, "the last key tile dropped")
        planted_f32(f"B1 f32 {shape}", oa.onepass_attention_plain(
            *map(tf32_chop, (q, k, v))), want,
            "q, k, v rounded to tf32: one TF32 pass")
    q1, k1, v1 = (f32_randn((1, 1025, 16, 64), gen, normed=True)
                  for _ in range(3))
    out1 = oa.onepass_attention(q1, k1, v1)
    lib1, node1 = sdpa_f32_fwd(q1, k1, v1)
    rows = {"B1": f32_row(
        "B1", "onepass_attention", F32_DENSE_SOURCE, B1_REPLACES, "B1" + F32,
        errs["B1"], time_ms(lambda: oa.onepass_attention(q1, k1, v1)),
        time_ms(lambda: oa.onepass_attention_plain(q1, k1, v1), iters=3),
        4.0 * 16 * 1025 * 1025 * 64, nbytes(q1, k1, v1, out1), lib1,
        (1, 1025, 16, 64), smi, library_backend=node1)}

    # B12 then B13 at the tower's training call, fed B12's out and LSE
    shape = (8, 1025, 16, 64)
    q, k, v, do = (f32_randn(shape, gen, normed=True) for _ in range(4))
    out, lse = oa.onepass_attention_lse(q, k, v)
    want, want_lse = oa.onepass_attention_lse_plain(q, k, v)
    errs["B12"].append(hold_f32(f"B12 f32 {shape}", out, want))
    lerr = (lse - want_lse).abs().max().item()
    log(f"B12 f32 {shape} lse: {lerr:.3e} (tol {LSE_TOL})")
    if not lerr <= LSE_TOL:
        raise AssertionError(f"B12 f32 lse disagrees: {lerr}")
    grads = oa.onepass_attention_bwd(q, k, v, do, lse, out)
    plain = oa.onepass_attention_bwd_plain(q, k, v, do, lse,
                                           fa.attention_di(out, do))
    for n, g, w in zip(("dq", "dk", "dv"), grads, plain):
        errs["B13"].append(hold_f32(f"B13 f32 {shape} {n}", g, w))
    planted_f32(f"B13 f32 {shape} dq", oa.onepass_attention_bwd(
        q, k[:, :-1], v[:, :-1], do, lse, out)[0], plain[0],
        "the last key tile dropped")
    for n, g, w in zip(("dk", "dv"), oa.onepass_attention_bwd(
            q[:, :-1], k, v, do[:, :-1], lse[:, :, :-1].contiguous(),
            out[:, :-1])[1:], plain[1:]):
        planted_f32(f"B13 f32 {shape} {n}", g, w,
                    "the last query tile dropped")
    again = oa.onepass_attention_bwd(q, k, v, do, lse, out)
    if not all(torch.equal(a, b) for a, b in zip(again, grads)):
        raise AssertionError("B13 f32: a second run differs (no atomics)")
    lib12, node12 = sdpa_f32_fwd(q, k, v)
    rows["B12"] = f32_row(
        "B12", "onepass_attention_lse", F32_DENSE_SOURCE, B12_REPLACES,
        "B12" + F32, errs["B12"],
        time_ms(lambda: oa.onepass_attention_lse(q, k, v)),
        time_ms(lambda: oa.onepass_attention_lse_plain(q, k, v), iters=3),
        4.0 * 8 * 16 * 1025 * 1025 * 64, nbytes(q, k, v, out, lse), lib12,
        shape, smi, library_backend=node12)
    lib13, node13 = sdpa_f32_bwd(q, k, v, do)
    rows["B13"] = f32_row(
        "B13", "onepass_attention_bwd", F32_BWD_SOURCE, B13_REPLACES,
        "B13" + F32, errs["B13"],
        time_ms(lambda: oa.onepass_attention_bwd(q, k, v, do, lse, out)),
        time_ms(lambda: oa.onepass_attention_bwd_plain(
            q, k, v, do, lse, fa.attention_di(out, do)), iters=3),
        10.0 * 8 * 16 * 1025 * 1025 * 64,
        nbytes(q, k, v, out, lse, do, *grads), lib13, shape, smi,
        library_backend=node13)
    del q, k, v, do, out, lse, grads, plain, again, want

    # B2 at the decoder's prompt, a masked small case, and the training
    # shape with its padding, then the backward on B2's out and LSE
    def flash_case(tag, q, k, v, **kw):
        out, lse = fa.flash_attention(q, k, v, **kw)
        want, want_lse = fa.flash_attention_plain(q, k, v, **kw)
        errs["B2"].append(hold_f32(f"B2 f32 {tag}", out, want))
        live = want_lse > -1e29
        lerr = ((lse - want_lse).abs() * live).max().item()
        if not (lerr <= LSE_TOL and torch.equal(lse > -1e29, live)):
            raise AssertionError(f"B2 f32 {tag} lse disagrees: {lerr}")
        return out, lse, want

    shape = (1, 512, 32, 128)
    q5, k5, v5 = (f32_randn(shape, gen) for _ in range(3))
    out5, lse5, want5 = flash_case(f"{shape} causal", q5, k5, v5,
                                   causal=True)
    planted_f32(f"B2 f32 {shape}", fa.flash_attention(
        q5, k5[:, :448], v5[:, :448], causal=True)[0], want5,
        "the last key tile dropped")
    planted_f32(f"B2 f32 {shape}", fa.flash_attention_plain(
        *map(tf32_chop, (q5, k5, v5)), causal=True)[0], want5,
        "q, k, v rounded to tf32: one TF32 pass")
    b, s, h, hkv, d = 2, 200, 8, 2, 64
    qs = f32_randn((b, s, h, d), gen)
    kvs = f32_randn((b, s, 2, hkv, d), gen)
    seg = torch.ones((b, s), dtype=torch.int32, device="cuda")
    seg[:, 120:] = 2
    qseg = seg.clone()
    qseg[1, 7] = 9                     # no key carries segment 9: a row of 0
    slopes = torch.tensor([2.0 ** -(i + 1) for i in range(h)],
                          device="cuda")
    mkw = dict(segment_ids_q=qseg, segment_ids_kv=seg, alibi_slopes=slopes)
    for causal in (True, False):
        o, l_, _ = flash_case(f"small gqa/alibi/segments causal={causal}",
                              qs, kvs[:, :, 0], kvs[:, :, 1], causal=causal,
                              **mkw)
        if not (o[1, 7].abs().max().item() == 0.0
                and l_[1, :, 7].eq(fa.NEG_INF).all().item()):
            raise AssertionError("B2 f32 fully masked row is not 0")
        do = f32_randn(qs.shape, gen)
        g = fa.flash_attention_bwd(qs, kvs[:, :, 0], kvs[:, :, 1], o, l_,
                                   do, causal=causal, **mkw)
        w = fa.flash_attention_bwd_plain(qs, kvs[:, :, 0], kvs[:, :, 1], o,
                                         l_, do, causal=causal, **mkw)
        for n, gg, ww in zip(("dq", "dk", "dv"), g, w):
            errs["B10+B11"].append(hold_f32(
                f"B10+B11 f32 small causal={causal} {n}", gg, ww))
    # widths past 128: d = 80 and the d = 256 form, causal, padded
    for shape_w in [(1, 1024, 32, 80), (1, 1024, 8, 256)]:
        hkv_w = 4 if shape_w[3] == 256 else shape_w[2]
        qw = f32_randn(shape_w, gen)
        kw_, vw = (f32_randn(shape_w[:2] + (hkv_w, shape_w[3]), gen)
                   for _ in range(2))
        segw = torch.ones(shape_w[:2], dtype=torch.int32, device="cuda")
        segw[:, -N_PAD:] = 0
        pkw = dict(causal=True, segment_ids_q=segw, segment_ids_kv=segw)
        ow, lw, _ = flash_case(f"{shape_w} hkv {hkv_w} padded", qw, kw_, vw,
                               **pkw)
        dow = f32_randn(shape_w, gen)
        for n, gg, ww in zip(("dq", "dk", "dv"), fa.flash_attention_bwd(
                qw, kw_, vw, ow, lw, dow, **pkw),
                fa.flash_attention_bwd_plain(qw, kw_, vw, ow, lw, dow,
                                             **pkw)):
            errs["B10+B11"].append(hold_f32(
                f"B10+B11 f32 {shape_w} {n}", gg, ww))
    tshape = (1, 2048, 32, 128)
    qt, kt, vt, dot = (f32_randn(tshape, gen) for _ in range(4))
    seg_t = torch.ones(tshape[:2], dtype=torch.int32, device="cuda")
    seg_t[:, -N_PAD:] = 0
    pad = dict(causal=True, segment_ids_q=seg_t, segment_ids_kv=seg_t)
    out_t, lse_t, _ = flash_case(f"{tshape} causal, last {N_PAD} padding",
                                 qt, kt, vt, **pad)
    grads = fa.flash_attention_bwd(qt, kt, vt, out_t, lse_t, dot, **pad)
    plain = fa.flash_attention_bwd_plain(qt, kt, vt, out_t, lse_t, dot, **pad)
    for n, g, w in zip(("dq", "dk", "dv"), grads, plain):
        errs["B10+B11"].append(hold_f32(f"B10+B11 f32 {tshape} {n}", g, w))
    di = fa.attention_di(out_t, dot)
    errs["B10"].append(hold_f32(f"B10 f32 {tshape} dq (di given)",
                                fa.flash_attention_bwd_dq(
                                    qt, kt, vt, dot, lse_t, di, **pad),
                                plain[0]))
    for n, g, w in zip(("dk", "dv"), fa.flash_attention_bwd_dkv(
            qt, kt, vt, dot, lse_t, di, **pad), plain[1:]):
        errs["B11"].append(hold_f32(f"B11 f32 {tshape} {n} (di given)", g, w))
    cut = tshape[1] - 64
    planted_f32(f"B10 f32 {tshape} dq", fa.flash_attention_bwd(
        qt, kt[:, :cut], vt[:, :cut], out_t, lse_t, dot, causal=True,
        segment_ids_q=seg_t, segment_ids_kv=seg_t[:, :cut].contiguous())[0],
        plain[0], "the last key tile dropped")
    for n, g, w in zip(("dk", "dv"), fa.flash_attention_bwd(
            qt[:, :cut], kt, vt, out_t[:, :cut],
            lse_t[:, :, :cut].contiguous(), dot[:, :cut], causal=True,
            segment_ids_q=seg_t[:, :cut].contiguous(),
            segment_ids_kv=seg_t)[1:], plain[1:]):
        planted_f32(f"B11 f32 {tshape} {n}", g, w,
                    "the last query tile dropped")
    for n, g, w in zip(("dq", "dk", "dv"), fa.flash_attention_bwd_plain(
            *map(tf32_chop, (qt, kt, vt, out_t)), lse_t, tf32_chop(dot),
            **pad), plain):
        planted_f32(f"B10+B11 f32 {tshape} {n}", g, w,
                    "q, k, v, out, do rounded to tf32: one TF32 pass")
    again = fa.flash_attention_bwd(qt, kt, vt, out_t, lse_t, dot, **pad)
    if not all(torch.equal(a, b) for a, b in zip(again, grads)):
        raise AssertionError("B10+B11 f32: a second run differs")
    log("B10+B11 f32: a second run is bit-identical (dq summed in a fixed "
        "order, no atomics)")

    lib2, node2 = sdpa_f32_fwd(q5, k5, v5, is_causal=True)
    pairs5 = 512 * 513 / 2
    rows["B2"] = f32_row(
        "B2", "flash_attention_fwd", F32_DENSE_SOURCE, B2_REPLACES,
        "B2" + F32, errs["B2"],
        time_ms(lambda: fa.flash_attention(q5, k5, v5, causal=True)),
        time_ms(lambda: fa.flash_attention_plain(q5, k5, v5, causal=True),
                iters=3),
        4.0 * 32 * pairs5 * 128, nbytes(q5, k5, v5, out5, lse5), lib2,
        shape, smi, library_backend=node2)
    # the training shape padded (as F4 runs it) and unpadded (SDPA's work)
    seen = 32 * visible_pairs(2048, 2048, True, seg_t, seg_t)
    seen_u = 32 * visible_pairs(2048, 2048, True)
    lib2t, _ = sdpa_f32_fwd(qt, kt, vt, is_causal=True)
    out_u, lse_u = fa.flash_attention(qt, kt, vt, causal=True)
    fwd_bytes = nbytes(qt, kt, vt, out_t, lse_t)
    bms_t, by_t = bound_ms(4.0 * seen * 128, fwd_bytes, PEAK_TF32X3_FLOPS)
    bms_u, _ = bound_ms(4.0 * seen_u * 128, fwd_bytes, PEAK_TF32X3_FLOPS)
    rows["B2"]["training_shape"] = dict(
        shape=list(tshape), padded_ms=time_ms(
            lambda: fa.flash_attention(qt, kt, vt, **pad)),
        bound_ms=bms_t, bound_by=by_t,
        bound_ms_ffma=bound_ms(4.0 * seen * 128, fwd_bytes,
                               PEAK_F32_FLOPS)[0],
        unpadded_ms=time_ms(lambda: fa.flash_attention(qt, kt, vt,
                                                       causal=True)),
        bound_ms_unpadded=bms_u, library_ms_unpadded=lib2t)
    lib_b, node_b = sdpa_f32_bwd(qt, kt, vt, dot, is_causal=True)
    bwd_ms = time_ms(lambda: fa.flash_attention_bwd(qt, kt, vt, out_t, lse_t,
                                                    dot, **pad), iters=5)
    bwd_unpadded = time_ms(lambda: fa.flash_attention_bwd(
        qt, kt, vt, out_u, lse_u, dot, causal=True), iters=5)
    bwd_bytes = nbytes(qt, kt, vt, out_t, lse_t, dot, *grads)
    bwd_plain = time_ms(lambda: fa.flash_attention_bwd_plain(
        qt, kt, vt, out_t, lse_t, dot, **pad), iters=2, warmup=1)
    for name, fn_name in (("B10", "flash_attention_bwd_dq"),
                          ("B11", "flash_attention_bwd_dkv")):
        rows[name] = f32_row(
            name, fn_name + " (one launch of the backward with B10/B11)",
            F32_BWD_SOURCE, B10_REPLACES if name == "B10" else B11_REPLACES,
            "B10+B11" + F32, errs["B10+B11"] + errs[name], bwd_ms, bwd_plain,
            10.0 * seen * 128, bwd_bytes, lib_b, tshape, smi,
            library_backend=node_b, unpadded_ms=bwd_unpadded,
            bound_ms_unpadded=bound_ms(10.0 * seen_u * 128, bwd_bytes,
                                       PEAK_TF32X3_FLOPS)[0],
            host_us_per_call=host_us(lambda: fa.flash_attention_bwd(
                qt, kt, vt, out_t, lse_t, dot, **pad), calls=5))
        log(f"{name} f32 {tshape} causal unpadded (SDPA's work): kernel "
            f"{bwd_unpadded:.4f} ms, library {lib_b:.4f} ms")
    log(f"B2 f32 {tshape} causal unpadded (SDPA's work): kernel "
        f"{rows['B2']['training_shape']['unpadded_ms']:.4f} ms, library "
        f"{lib2t:.4f} ms")
    return rows


def paged_f32_inputs(gen, b, h, hkv, d, lengths, q_dtype, page_dtype,
                     s_q=0, page=128):
    """``paged_inputs`` drawn in f32 and cast: q to ``q_dtype``, the pools
    to ``page_dtype`` (int8: quantized by ``quantize_pages``, with their
    scale pages). Returns (q, pages, lengths, tables) with pages (k, v) or
    (k, k scales, v, v scales)."""
    from merlin_tpu_torch.ops.paged_attention import quantize_pages

    q, kp, vp, lens, tables = paged_inputs(gen, b, h, hkv, d, lengths,
                                           s_q=s_q, page=page,
                                           dtype=torch.float32)
    if page_dtype == torch.int8:
        (kq, ks), (vq, vs) = (quantize_pages(x, d) for x in (kp, vp))
        pages = (kq, ks, vq, vs)
    else:
        pages = (kp.to(page_dtype), vp.to(page_dtype))
    return q.to(q_dtype), pages, lens, tables


F32_PAIRS = ((torch.bfloat16, torch.float32), (torch.float32, torch.bfloat16),
             (torch.float32, torch.float32), (torch.float32, torch.int8))


def f32_paged_passes(name, q_dtype, page_dtype):
    """The TF32 passes (q.k, P V) of the f32 paged kernels' products
    (``Rule`` in paged_attention_f32.cu): one a product, and one more for
    each operand with more bits than a tf32 term holds, which is split in
    two: an f32 q, f32 K and V (int8 pages dequantized to f32 for B8 and
    B9), and p unless it is rounded to bf16 (over bf16 pages, C48). B7's
    operands are bf16 and int8 (C49): one pass each."""
    if name in ("B7", "B7w"):
        return 1, 1
    split_q = q_dtype == torch.float32
    split_kv = page_dtype != torch.bfloat16
    return 1 + split_q + split_kv, 1 + 2 * split_kv


def pair_name(pair) -> str:
    """"f32/bf16" for (torch.float32, torch.bfloat16)."""
    return "/".join(str(t).replace("torch.", "").replace("float", "f")
                    for t in pair)


PAGED_FN_NAMES = {"B3": "paged_attention_dma", "B4": "paged_attention",
                  "B5": "paged_attention_dma_multi",
                  "B6": "paged_attention_multi_blocked",
                  "B7": "paged_attention_dma_q8",
                  "B7w": "paged_attention_dma_multi_q8",
                  "B8": "paged_attention_multi_blocked_q8",
                  "B9": "paged_attention_quantized"}
PAGED_WINDOW_KERNEL = ("B6", "B8")     # the rest run the few-rows kernel


def paged_run(name, q, pages, lens, tabs, slopes):
    """The paged wrapper of B3-B9 ``name`` on (q, pages, lengths, tables);
    pages (k, v) or (k, k scales, v, v scales)."""
    from merlin_tpu_torch.ops import paged_attention as pa

    kw = {} if name == "B3" else {"alibi_slopes": slopes}
    return getattr(pa, PAGED_FN_NAMES[name])(q, *pages, lens, tabs, **kw)


def f32_split_keys(name, q, pages, lens, tabs):
    """The key splits the f32 route's wrapper gives its kernel: the
    few-rows kernel's pages a split, the window kernel's plan for this
    card cut per sequence."""
    from merlin_tpu_torch.ops import paged_attention as pa

    page, pps = pages[0].shape[1], tabs.shape[1]
    if name not in PAGED_WINDOW_KERNEL:
        return pa.rows_split_keys(page)
    b, s_q, h, d = q.shape
    hkv = pages[0].shape[2] // d
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    splits = pa.window_plan(b, h // hkv * s_q, hkv, d, page, pps, sms,
                            f32=True)[0]
    return pa.f32_window_split_keys(lens.tolist(), splits, page, pps)


def f32_plain(name, q, pages, lens, tabs, slopes, split=None):
    """The plain version of an f32 paged kernel: the TPU kernel's rounding
    on the kernels' 64-key tiles, walked in ``split`` (None: the TPU
    kernel's single walk)."""
    from merlin_tpu_torch.ops import paged_attention as pa

    kw = dict(alibi_slopes=slopes, kernel_rounding=True,
              block_keys=pa.F32_TILE_KEYS, split_keys=split)
    if len(pages) == 4:
        fn = (pa.paged_attention_q8_plain if q.dim() == 3
              else pa.paged_attention_multi_q8_plain)
        return fn(q, *pages, lens, tabs,
                  bf16_operands=name in ("B7", "B7w"), **kw)
    fn = (pa.paged_attention_plain if q.dim() == 3
          else pa.paged_attention_multi_plain)
    return fn(q, *pages, lens, tabs, **kw)


def f32_tol(name, q, pages):
    """An f32 paged kernel's tolerance against its split-aware plain
    version, and how it is measured."""
    if name in ("B7", "B7w"):
        return C49_TOL, "C49, relative L2"
    if q.dtype == torch.bfloat16 or pages[0].dtype == torch.bfloat16:
        return OUT_RTOL, "bf16 rows"
    return F32_RTOL, "f32"


def f32_measure(got, want, how) -> float:
    if how == "bf16 rows":
        return out_err(got, want)[1]
    if how.startswith("C49"):
        return ((got.float() - want.float()).norm()
                / want.float().norm()).item()
    return f32_err(got, want)


def paged_plain(name, q, pages, lens, tabs, slopes):
    """The plain version a paged kernel is held to: on the f32 route
    (``_f32_kernel``) the TPU kernel's rounding walked in the wrapper's key
    splits (``f32_plain``); on the bf16 route (bf16 q over bf16 or int8
    pages) JAX's reference, rows with no key 0 (C2)."""
    from merlin_tpu_torch.ops import paged_attention as pa

    if pa._f32_kernel(q, pages[0]):
        return f32_plain(name, q, pages, lens, tabs, slopes,
                         f32_split_keys(name, q, pages, lens, tabs))
    kw = {} if name == "B3" else {"alibi_slopes": slopes}
    if len(pages) == 4:
        fn = (pa.paged_attention_q8_plain if q.dim() == 3
              else pa.paged_attention_multi_q8_plain)
    else:
        fn = (pa.paged_attention_plain if q.dim() == 3
              else pa.paged_attention_multi_plain)
    return no_key_rows_zero(fn(q, *pages, lens, tabs, **kw), lens)


def paged_timing(name, x, slopes, flops, smi, tag=""):
    """A paged kernel's time on x = (q, pages, lengths, tables), its plain
    version's (``paged_plain``) and its bound. The bound is the function's:
    each page byte read once, q read and out written once, at 3.35 TB/s; its
    ``flops`` (q.k and P V once each) at 989 TFLOP/s bf16, or on the f32
    route at the TF32 passes its operands take (``f32_paged_passes``). The
    window kernel at d > 128 runs q.k once a column half, 3 products where
    the function needs 2: that bound stands beside it as
    ``bound_ms_products_run``. ``tag`` heads the log line."""
    from merlin_tpu_torch.ops import paged_attention as pa

    q, pages, lens, tabs = x
    f32 = pa._f32_kernel(q, pages[0])
    ms = time_ms(lambda: paged_run(name, q, pages, lens, tabs, slopes))
    plain_ms = time_ms(lambda: paged_plain(name, q, pages, lens, tabs,
                                           slopes), iters=3)
    host = host_us(lambda: paged_run(name, q, pages, lens, tabs, slopes))
    hkv_d = pages[0].shape[2]
    per_key = 2 * hkv_d * pages[0].element_size()
    if len(pages) == 4:                # one f32 scale a (key, kv head)
        per_key += 2 * 4 * hkv_d // q.shape[-1]
    io = int(lens.sum()) * per_key + 2 * nbytes(q)
    # half the FLOP are q.k, half P V, each at its passes' rate
    qk, pv = (f32_paged_passes(name, q.dtype, pages[0].dtype) if f32
              else (1, 1))
    peak = (2 * PEAK_TF32_FLOPS if f32 else 2 * PEAK_BF16_FLOPS) / (qk + pv)
    bms, by = bound_ms(flops, io, peak)
    pair = pair_name((q.dtype, pages[0].dtype))
    out = dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
               host_us_per_call=host, shape=list(q.shape),
               lengths=lens.tolist(), pair=pair)
    how = (f"{qk} + {pv} TF32 passes (q.k + P V) at 495 TFLOP/s a pass"
           if f32 else "989 TFLOP/s bf16")
    if f32:
        out["bound_ms_ffma"], _ = bound_ms(flops, io, PEAK_F32_FLOPS)
        out["tf32_passes"] = [qk, pv]
        how += f"; FFMA at 67 TFLOP/s: {out['bound_ms_ffma']:.4f} ms"
    if name in PAGED_WINDOW_KERNEL and q.shape[-1] > 128:
        run_ms, run_by = bound_ms(flops * (2 * qk + pv) / (qk + pv), io,
                                  peak)
        out.update(products_run=3, bound_ms_products_run=run_ms,
                   bound_by_products_run=run_by)
        how += f"; for the 3 products it runs: {run_ms:.4f} ms ({run_by})"
    log(f"{tag}{name}{' f32' if f32 else ''} {tuple(q.shape)} lengths "
        f"{lens.tolist()} ({pair}): kernel {ms:.4f} ms, plain {plain_ms:.4f} "
        f"ms, bound {bms:.4f} ms ({by}; {how}; bytes at 3.35 TB/s), library "
        f"none; wrapper {host:.1f} us of host time a call; card {smi}")
    return out


def check_f32_paged(gen, smi):
    """B3-B9 on the f32 kernels (the few-rows kernel: B3, B4, B5, B7 decode
    and windows, B9; the window kernel: B6, B8) at every (q, page) pair but
    (bf16, bf16 | int8), against their plain versions with the TPU kernels'
    rounding (``kernel_rounding``, on the kernels' 64-key tiles) walked in
    the key splits the wrapper used (``split_keys``): bf16/f32 tolerance by
    the operands, C49's for B7 at f32 q. Each is also logged and held
    against the TPU kernel's single walk (rows at ``OUT_RTOL`` where p is
    rounded or out is bf16, else ``F32_RTOL``), and run a second time, which
    must be bit-identical (the splits merge in split order). ALiBi, groups
    4, 16 and 32 (group 4 at s_q = 72: window row tiles that span query
    heads), d = 64, 72 and 128, lengths 0, 1 and the full table, permuted
    tables, pages of 16 for both kernels; a page redirected in the first
    and in the last key split and, for B7, the f32 computation (B9's rule)
    must fail. Times at the serving path's shapes, bounds by the TF32
    passes each pair's products take (``f32_paged_passes``). Returns the
    rows."""
    from merlin_tpu_torch.models.layers import alibi_slopes

    errs = collections.defaultdict(list)
    single_errs = collections.defaultdict(list)

    def compare(tag, name, inputs, slopes=None, tables=None, fault=None):
        q, pages, lens, tabs = inputs
        split = f32_split_keys(name, q, pages, lens, tabs)
        want = f32_plain(name, q, pages, lens, tabs, slopes, split)
        got = (fault or paged_run)(name, q, pages, lens,
                             tabs if tables is None else tables, slopes)
        torch.cuda.synchronize()
        tol, how = f32_tol(name, q, pages)
        err = f32_measure(got, want, how)
        what = ("a live page redirected" if tables is not None
                else "computed in f32 (B9's rule)" if fault else None)
        full = f"{name} f32 {tag} ({pair_name((q.dtype, pages[0].dtype))})"
        if what:
            log(f"{full} planted fault ({what}): error {err:.3e}, must "
                f"exceed {tol:.0e} ({how})")
            if not err > tol:
                raise AssertionError(f"{full}: the check cannot see {what}")
            return
        # the TPU kernel's single walk: p rounded against one running max
        one = f32_plain(name, q, pages, lens, tabs, slopes)
        s_tol, s_how = ((OUT_RTOL, "bf16 rows")
                        if how != "f32" else (F32_RTOL, "f32"))
        s_err = f32_measure(got, one, s_how)
        again = paged_run(name, q, pages, lens, tabs, slopes)
        torch.cuda.synchronize()
        same = torch.equal(again, got)
        log(f"{full}: error {err:.3e} (tol {tol:.0e}, {how}), max_abs_err "
            f"{out_err(got, want)[0]:.3e} against the split walk ("
            f"{split if isinstance(split, int) else sorted(set(split))} "
            f"keys a split); {s_err:.3e} from the single walk (tol "
            f"{s_tol:.1e}, {s_how}); second run bit-identical: {same}")
        if not (err <= tol and s_err <= s_tol and same
                and torch.isfinite(got.float()).all()):
            raise AssertionError(f"{full} disagrees: {err} {s_err} {same}")
        errs[name].append(out_err(got, want)[0])
        single_errs[name].append(s_err)

    vicuna = [1, 256, 1937, 700]
    baichuan = [1, 384, 1999, 901]
    edges = [0, 1, 257, 2048]
    s40 = alibi_slopes(40, device="cuda")
    s32 = alibi_slopes(32, device="cuda")
    for pair in F32_PAIRS:
        qd, pd = pair
        q8 = pd == torch.int8
        dec, dec_w = ("B7", "B7w") if q8 else ("B3", "B5")
        dec_alibi, win = ("B7", "B8") if q8 else ("B4", "B6")
        inp = paged_f32_inputs(gen, 4, 32, 32, 128, vicuna, qd, pd)
        compare("decode vicuna (4 slots, 32/32 heads)", dec, inp)
        compare("decode vicuna", dec, inp,
                tables=redirect_page(inp[3], vicuna))
        compare("decode vicuna, last split", dec, inp,
                tables=redirect_page(inp[3], vicuna, last_split=True))
        if q8:
            compare("decode vicuna", "B9", inp)
            compare("decode vicuna, at f32 q", "B7", inp,
                    fault=lambda n, *a: paged_run("B9", *a))
        compare(f"decode lengths {edges}", dec_alibi,
                paged_f32_inputs(gen, 4, 32, 32, 128, edges, qd, pd), s32)
        compare("decode baichuan-13b alibi (40 heads)", dec_alibi,
                paged_f32_inputs(gen, 4, 40, 40, 128, baichuan, qd, pd), s40)
        for hkv in (2, 1):
            compare(f"decode group {32 // hkv} alibi (32/{hkv} heads)",
                    dec_alibi, paged_f32_inputs(gen, 4, 32, hkv, 128, vicuna,
                                                qd, pd), s32)
        p16 = paged_f32_inputs(gen, 4, 32, 32, 128, vicuna, qd, pd, page=16)
        compare("decode page 16", dec_alibi, p16, s32)
        compare("decode page 16, last split", dec, p16,
                tables=redirect_page(p16[3], vicuna, 16, last_split=True))
        w5 = paged_f32_inputs(gen, 4, 32, 32, 128, [5, 256, 1937, 700], qd,
                              pd, s_q=5)
        compare("window s_q=5 vicuna", dec_w, w5)
        compare("window s_q=5 vicuna, last split", dec_w, w5,
                tables=redirect_page(w5[3], [5, 256, 1937, 700],
                                     last_split=True))
        compare("window s_q=5 lengths [3, 5, 257, 2048] alibi", dec_w,
                paged_f32_inputs(gen, 4, 32, 32, 128, [3, 5, 257, 2048], qd,
                                 pd, s_q=5), s32)
        for n in (640, 1536):
            w128 = paged_f32_inputs(gen, 1, 32, 32, 128, [n], qd, pd,
                                    s_q=128)
            compare(f"window (1,128,32,128) L={n}", win, w128)
        for last in (False, True):
            compare(f"window L=1536, {'last' if last else 'first'} split",
                    win, w128, tables=redirect_page(w128[3], [1536],
                                                    last_split=last,
                                                    window=True))
        compare("window (1,128,40,128) L=640 alibi", win,
                paged_f32_inputs(gen, 1, 40, 40, 128, [640], qd, pd,
                                 s_q=128), s40)
        compare("window s_q=128 lengths [100, 129, 641, 2048] d=64", win,
                paged_f32_inputs(gen, 4, 16, 16, 64, [100, 129, 641, 2048],
                                 qd, pd, s_q=128))
        # row tiles that span query heads (group 4 at s_q = 72: t_max's
        # wrap), d = 72 (int8 rows, d % 16 = 8, copied 8 bytes at a time),
        # pages of 16; each with a page redirected in its last key split
        gqa_lens = [300, 1100]
        gqa = paged_f32_inputs(gen, 2, 32, 8, 72, gqa_lens, qd, pd, s_q=72)
        w16 = paged_f32_inputs(gen, 1, 32, 32, 128, [1536], qd, pd,
                               s_q=128, page=16)
        for tag, inputs, lens, page in (
                ("window (2,72,32/8 heads,72) lengths [300, 1100]", gqa,
                 gqa_lens, 128),
                ("window (1,128,32,128) L=1536 page 16", w16, [1536], 16)):
            compare(tag, win, inputs)
            compare(f"{tag}, last split", win, inputs,
                    tables=redirect_page(inputs[3], lens, page,
                                         last_split=True, window=True))

    rows = {}
    path = {}
    path_shapes = collections.defaultdict(list)
    for pair in F32_PAIRS:
        qd, pd = pair
        tag = pair_name(pair)
        dec = paged_f32_inputs(gen, 4, 32, 32, 128, vicuna, qd, pd)
        bc = paged_f32_inputs(gen, 4, 40, 40, 128, baichuan, qd, pd)
        w5 = paged_f32_inputs(gen, 4, 32, 32, 128, [5, 256, 1937, 700], qd,
                              pd, s_q=5)
        w128 = paged_f32_inputs(gen, 1, 32, 32, 128, [640], qd, pd, s_q=128)
        dec_flops = 4.0 * 32 * 128 * int(dec[2].sum())
        if pd == torch.int8:
            kinds = (("B7", dec, None, dec_flops),
                     ("B9", dec, None, dec_flops),
                     ("B7w", w5, None, window_flops(w5[0], w5[2])),
                     ("B8", w128, None, window_flops(w128[0], w128[2])))
        else:
            kinds = (("B3", dec, None, dec_flops),
                     ("B4", bc, s40, 4.0 * 40 * 128 * int(bc[2].sum())),
                     ("B5", w5, None, window_flops(w5[0], w5[2])),
                     ("B6", w128, None, window_flops(w128[0], w128[2])))
        for name, inputs, slopes, flops in kinds:
            path.setdefault(name, {})[tag] = paged_timing(
                name, inputs, slopes, flops, smi)
        # the engine's other prefill windows, at the F2 pairs
        if tag in ("f32/bf16", "f32/int8"):
            win = "B8" if pd == torch.int8 else "B6"
            for n in (128, 1536):
                w = paged_f32_inputs(gen, 1, 32, 32, 128, [n], qd, pd,
                                     s_q=128)
                path_shapes[win].append(paged_timing(
                    win, w, None, window_flops(w[0], w[2]), smi))
    names = PAGED_FN_NAMES
    main_pair = {n: ("f32/int8" if n in ("B7", "B7w", "B8", "B9")
                     else "f32/bf16") for n in names}
    for name, fn_name in names.items():
        t = path[name][main_pair[name]]
        rows[name] = dict(
            name=f"{name} f32 {fn_name}", route="cuda",
            source=F32_PAGED_SOURCE, replaces=PAGED_REPLACES[name],
            kernel=("paged_window_f32_kernel" if name in PAGED_WINDOW_KERNEL
                    else "paged_rows_f32_kernel"),
            counter=name + F32, max_abs_err=max(errs[name] or [0.0]),
            single_walk_err=max(single_errs[name] or [0.0]),
            library_ms=None, by_pair=path[name], card=smi, **t)
        if name in path_shapes:
            rows[name]["path_shapes"] = path_shapes[name]
    return rows


# ---------------------------------------------------------------------------
# phase H: head dims past 128 (the paged kernels' DP = 256 forms)
# ---------------------------------------------------------------------------

H_DIMS = (136, 256)          # a d zero-padded to the wide form, and its full
H_DECODE = [1, 256, 1937, 700]
H_WINDOW = [5, 256, 1937, 700]
H_BAICHUAN = [1, 384, 1999, 901]
H_PATH_LENGTHS = (128, 640, 1536)
H_SEED = 21                  # the served model's weights


def swap_halves(out):
    """The planted column-half fault: each 128-column half of O written at
    the other half's offset (d = 256)."""
    return torch.cat([out[..., 128:], out[..., :128]], -1)


def check_paged_wide(gen, smi):
    """Phase H's kernel checks: all four paged kernels at their DP = 256
    form, at d = 136 and 256, against their plain versions at the
    unchanged tolerances: the bf16 few-rows and window kernels over bf16
    and int8 pages (decode at 4 slots, windows s_q = 5 and 128 at L =
    128/640/1536, ALiBi at 16 heads, groups 1/4/8, pages of 16 and 128),
    the f32 ones at the four (q, page) pairs of the f32 route (B7 with its
    bf16 operands, C49) against the split-aware kernel rule. Every case
    runs twice (bit-identical). Planted: a page redirected in the last key
    split, a dropped key tile (the run's lengths one 64-key tile short),
    C11's lane fault at hkv = 2, and at d = 256 the output's column halves
    swapped. Times at d = 256 at the d = 128 rows' bytes (16 x 256 heads
    for 32 x 128). Returns the rows of the kernels line."""
    from merlin_tpu_torch.models.layers import alibi_slopes
    from merlin_tpu_torch.ops import paged_attention as pa

    errs = collections.defaultdict(list)
    n_checked = collections.Counter()

    def compare(tag, name, inputs, slopes=None, tables=None, lens_run=None,
                pages_run=None, post=None, what=None):
        q, pages, lens, tabs = inputs
        f32 = pa._f32_kernel(q, pages[0])
        want = paged_plain(name, q, pages, lens, tabs, slopes)
        tol, how = f32_tol(name, q, pages) if f32 else (OUT_RTOL, "bf16 rows")

        def run():
            out = paged_run(name, q, pages if pages_run is None else pages_run,
                            lens if lens_run is None else lens_run,
                            tabs if tables is None else tables, slopes)
            return out if post is None else post(out)

        got = run()
        torch.cuda.synchronize()
        err = f32_measure(got, want, how)
        key = name + (F32 if f32 else "")
        full = (f"H {key} {tag} ({pair_name((q.dtype, pages[0].dtype))}, "
                f"d = {q.shape[-1]})")
        if what is not None:
            log(f"{full} planted fault ({what}): error {err:.3e}, must "
                f"exceed {tol:.0e} ({how})")
            if not err > tol:
                raise AssertionError(f"{full}: the check cannot see {what}")
            return
        again = run()
        torch.cuda.synchronize()
        same = torch.equal(again, got)
        log(f"{full}: error {err:.3e} (tol {tol:.0e}, {how}), max_abs_err "
            f"{out_err(got, want)[0]:.3e}; second run bit-identical: {same}")
        if not (err <= tol and same and torch.isfinite(got.float()).all()):
            raise AssertionError(f"{full} disagrees: {err} {same}")
        errs[key].append(out_err(got, want)[0])
        n_checked[key] += 1

    def inputs(b, h, hkv, d, lengths, pair, s_q=0, page=128):
        return paged_f32_inputs(gen, b, h, hkv, d, lengths, *pair, s_q=s_q,
                                page=page)

    def dropped_tile(lens):
        return (lens - 64).clamp_min(0)

    s16 = alibi_slopes(16, device="cuda")
    bf16_pairs = ((torch.bfloat16, torch.bfloat16),
                  (torch.bfloat16, torch.int8))
    for d in H_DIMS:
        for pair in bf16_pairs + F32_PAIRS:
            q8 = pair[1] == torch.int8
            f32 = pair not in bf16_pairs
            dec, dec_alibi, win_s, win = (("B7", "B7", "B7w", "B8") if q8
                                          else ("B3", "B4", "B5", "B6"))
            # decode at 4 slots, groups 1, 4 and 8, ALiBi, pages of 16
            x = inputs(4, 16, 16, d, H_DECODE, pair)
            compare("decode (4 slots, 16/16 heads)", dec, x)
            if q8:
                compare("decode (4 slots, 16/16 heads)", "B9", x)
            compare("decode, last split", dec, x, tables=redirect_page(
                x[3], H_DECODE, last_split=True),
                what="a page redirected in the last key split")
            compare("decode", dec, x, lens_run=dropped_tile(x[2]),
                    what="the last 64-key tile dropped")
            for hkv in (4, 2):
                g = inputs(4, 16, hkv, d, H_DECODE, pair)
                compare(f"decode group {16 // hkv} alibi (16/{hkv} heads)",
                        dec_alibi, g, s16)
                if q8 and hkv == 2:
                    lanes = (g[1][0], head_lane_scales(g[1][1], 2),
                             g[1][2], head_lane_scales(g[1][3], 2))
                    compare("decode group 8 alibi (16/2 heads)", dec_alibi,
                            g, s16, pages_run=lanes,
                            what="scales at lane hk, not hk * 64")
            p16 = inputs(4, 16, 16, d, H_DECODE, pair, page=16)
            compare("decode page 16 alibi", dec_alibi, p16, s16)
            # windows of 5 rows (the few-rows kernel) and of 128 (the
            # window kernel, bf16 route's B5/B7 windows at s_q = 5)
            w5 = inputs(4, 16, 16, d, H_WINDOW, pair, s_q=5)
            compare("window s_q=5", win_s, w5, s16 if q8 else None)
            compare("window s_q=5, last split", win_s, w5,
                    tables=redirect_page(w5[3], H_WINDOW, last_split=True),
                    what="a page redirected in the last key split")
            for n in (H_PATH_LENGTHS if not f32 else (640,)):
                w = inputs(1, 16, 16, d, [n], pair, s_q=128)
                compare(f"window (1,128,16,{d}) L={n}", win, w)
            compare("window L=640 alibi", win,
                    inputs(1, 16, 16, d, [640], pair, s_q=128), s16)
            compare("window L=640 group 4 (16/4 heads)", win,
                    inputs(1, 16, 4, d, [640], pair, s_q=128))
            w16 = inputs(1, 16, 16, d, [1536], pair, s_q=128, page=16)
            compare("window L=1536 page 16", win, w16)
            compare("window L=1536 page 16, last split", win, w16,
                    tables=redirect_page(w16[3], [1536], 16,
                                         last_split=True, window=True),
                    what="a page redirected in the last key split")
            if d == 256:
                compare("window L=1536 page 16", win, w16, post=swap_halves,
                        what="the column halves' outputs swapped")

    rows = {}
    d = 256
    for pair in bf16_pairs + ((torch.float32, torch.bfloat16),
                              (torch.float32, torch.int8)):
        q8 = pair[1] == torch.int8
        f32 = pair not in bf16_pairs
        dec = inputs(4, 16, 16, d, H_DECODE, pair)
        bc = inputs(4, 20, 20, d, H_BAICHUAN, pair)
        w5 = inputs(4, 16, 16, d, H_WINDOW, pair, s_q=5)
        w5_bc = inputs(4, 20, 20, d, [5, 384, 1999, 901], pair, s_q=5)
        path = {n: inputs(1, 16, 16, d, [n], pair, s_q=128)
                for n in H_PATH_LENGTHS}
        dec_flops = 4.0 * 16 * d * int(dec[2].sum())
        s20 = alibi_slopes(20, device="cuda")
        if q8:
            kinds = (("B7", dec, None, dec_flops),
                     ("B9", dec, None, dec_flops),
                     ("B7w", w5_bc, s20, window_flops(w5_bc[0], w5_bc[2])))
            win = "B8"
        else:
            kinds = (("B3", dec, None, dec_flops),
                     ("B4", bc, s20, 4.0 * 20 * d * int(bc[2].sum())),
                     ("B5", w5, None, window_flops(w5[0], w5[2])))
            win = "B6"
        for name, x, slopes, flops in kinds:
            rows[name + (F32 if f32 else "")] = paged_timing(
                name, x, slopes, flops, smi, "H ")
        shapes = [paged_timing(win, x, None, window_flops(x[0], x[2]), smi,
                               "H ") for x in path.values()]
        rows[win + (F32 if f32 else "")] = dict(shapes[1],
                                                path_shapes=shapes)
    out = {}
    for key, t in rows.items():
        name = key.split("_")[0]
        f32 = key.endswith(F32)
        out[key] = dict(
            name=f"{name}{' f32' if f32 else ''} {PAGED_FN_NAMES[name]} "
                 f"(d = {d})",
            route="cuda", source=F32_PAGED_SOURCE if f32 else PAGED_SOURCE,
            replaces=PAGED_REPLACES[name],
            kernel=(("paged_window_f32_kernel" if f32 else
                     "paged_window_kernel") if name in PAGED_WINDOW_KERNEL
                    else ("paged_rows_f32_kernel" if f32 else
                          "paged_rows_kernel")),
            counter=key, max_abs_err=max(errs[key] or [0.0]),
            cases_checked=n_checked[key], library_ms=None, card=smi, **t)
    return out


def build_h_model(dtype=torch.bfloat16):
    """Phase H's served model: the llama block at Vicuna-7B width (hidden
    4096, intermediate 11008, vocabulary 32000, RoPE, RMSNorm) regrouped
    as 16 heads of 256 dims (the parameter count of Vicuna-7B's), depth
    cut to 4 of 32 layers; random weights from ``H_SEED`` in ``dtype``."""
    from merlin_tpu_torch.models.bridge import init_params
    from merlin_tpu_torch.models.decoder import CausalLM
    from merlin_tpu_torch.models.families import vicuna_7b

    cfg = dataclasses.replace(vicuna_7b(), num_heads=16, head_dim=256,
                              num_layers=4, dtype=dtype)
    with torch.device("meta"):
        model = CausalLM(cfg)
    gen = torch.Generator(device="cuda").manual_seed(H_SEED)
    init_params(model, gen, dtype=dtype, device="cuda")
    return model.eval()


def serve_wide(rng):
    """Phase H's served runs: the 16 x 256 model through ``ServingEngine``
    with E1's traffic (whole prompts + decode: B2, B3), E2's (chunked C =
    128 + speculative k = 4: B6, B5) and E4's over an int8 pool (hybrid:
    B2, B8, B7), then an f32 copy of the model over f32 pages with E2's
    traffic (the f32 few-rows and window kernels, B5 and B6). Every check
    of ``run_engine``. Returns {run: (counts, readings)}."""
    model = build_h_model()
    served = {}
    served["H E1"] = run_engine(
        "H E1 16x256 4 layers (whole-prompt admission, decode)", model,
        serving_prompts(rng, SERVING_LENGTHS, 32000), ["B2", "B3"],
        chunk_steps=8, pipeline=1, **SERVING)
    e2 = serving_prompts(rng, SERVING_LENGTHS, 32000, period=48)
    served["H E2"] = run_engine(
        "H E2 16x256 4 layers (chunked prefill C=128, spec k=4)", model, e2,
        ["B5", "B6"], prefill_chunk=128, prefill_windows_per_step=4,
        spec_draft=4, chunk_steps=1, **SERVING)
    served["H E4"] = run_engine(
        "H E4 16x256 4 layers int8 pages (hybrid C=128 min 256)", model,
        serving_prompts(rng, SERVING_LENGTHS, 32000), ["B2", "B7", "B8"],
        cache_dtype=torch.int8, prefill_chunk=128, prefill_chunk_min=256,
        chunk_steps=8, pipeline=1, **SERVING)
    del model
    free_cuda()
    model = build_h_model(torch.float32)
    served["H F32"] = run_engine(
        "H F32 16x256 4 layers f32 over f32 pages (chunked prefill C=128, "
        "spec k=4)", model, e2, ["B5" + F32, "B6" + F32], suffix=F32,
        cache_dtype=torch.float32, prefill_chunk=128,
        prefill_windows_per_step=4, spec_draft=4, chunk_steps=1, **SERVING)
    del model
    return served


# ---------------------------------------------------------------------------
# phase F: float32 models through every kernel
# ---------------------------------------------------------------------------

def build_f32_bundle():
    """F1's model as a user gets it: ``parse_args(["--bf16", "False"])``,
    ``build_model_tokenizer`` (the hub offline: the TinyTokenizer) and
    ``init_or_load_params`` (f32 weights from a seed, as the flax tree):
    CLIP ViT-L/14-448 + conv + Vicuna-7B computing in f32."""
    from merlin_tpu_torch.models.builder import (
        build_model_tokenizer, init_or_load_params)
    from merlin_tpu_torch.train.arguments import parse_args

    t0 = time.perf_counter()
    margs, dargs, targs = parse_args(["--bf16", "False"])
    bundle = build_model_tokenizer(margs, dargs, targs)
    init_or_load_params(
        bundle, generator=torch.Generator(device="cuda").manual_seed(15),
        device="cuda")
    torch.cuda.synchronize()
    bundle.model.eval()
    cfg = bundle.config
    log(f"F: --bf16 False bundle, lm {cfg.lm.dtype} x {cfg.lm.num_layers} "
        f"layers, tower {cfg.vit.dtype}: "
        f"{nbytes(*bundle.model.parameters()) / 1e9:.2f} GB of f32 weights "
        f"on the card in {time.perf_counter() - t0:.1f} s")
    if not (targs.bf16 is False and cfg.lm.dtype == torch.float32
            and cfg.vit.dtype == torch.float32):
        raise AssertionError("F: --bf16 False did not give an f32 model")
    return bundle


def run_f_beam(bundle, rng):
    """C50: ``EvalModel`` with V's beams on the f32 bundle, one of V's
    MMBench prompts (its first question, options and hint) with a 640x480
    noise image, held by ``beam_hold`` at ``BEAM_SCORE_TOL``: at f32 the
    no-cache forward that recomputes each score runs B2 at f32, so no bf16
    rounding hides a beam fault. Returns (the search's launches,
    readings with the check's launches)."""
    from PIL import Image

    from merlin_tpu_torch.eval import mmbench
    from merlin_tpu_torch.eval.runner import EvalConfig, EvalModel

    question, options, hint = V_MMB[0]
    question = mmbench.build_question(dict(
        question=question, hint=hint, **dict(zip("ABCD", options))))
    frame = Image.fromarray(rng.integers(0, 256, size=(480, 640, 3),
                                         dtype=np.uint8))
    em = EvalModel(bundle, EvalConfig(num_beams=V_BEAMS,
                                      max_new_tokens=V_NEW), device="cuda")
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    text = em.ask(question, images=[frame])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    if counts != launches(**{"B1" + F32: 23}):
        raise AssertionError(f"F beam: the search launched {counts}, not one "
                             "tower call (B1 f32 23; the prefill and the "
                             "steps attend over the dense cache)")
    reset_counts()
    honest, planted = beam_hold("F beam (f32)", em, bundle.model, question,
                                frame, text, seconds)
    torch.cuda.synchronize()
    check = read_counts()
    # the two searches again (B1) and a no-cache forward for each score
    # (B1, and B2 at f32 in every layer)
    n_layers = bundle.config.lm.num_layers
    if check != launches(**{"B1" + F32: 4 * 23, "B2" + F32: 2 * n_layers}):
        raise AssertionError(f"F beam: the check launched {check}")
    return counts, dict(seconds=round(seconds, 3), score_gap=honest,
                        planted_gap=planted, text=text,
                        check_launches={k: v for k, v in check.items() if v})


def run_f(rng):
    """F1 (forward and greedy generation), F2 (the engine over bf16,
    f32 and int8 pages) and the beam check (C50) on the f32 bundle.
    Returns (F1's forward counts, its generation readings, {run: (counts,
    readings)}, the beam run's (counts, readings))."""
    bundle = build_f32_bundle()
    model, cfg = bundle.model, bundle.config
    fwd_counts, wall = run_forward(model, cfg, rng, suffix=F32)
    gen = run_generation(model, cfg, rng, suffix=F32)
    gen["forward_ms"] = wall
    served = {}
    e1 = serving_prompts(rng, SERVING_LENGTHS, 32000)
    e2 = serving_prompts(rng, SERVING_LENGTHS, 32000, period=48)
    for tag, dtype in (("bf16 pages", torch.bfloat16),
                       ("f32 pages", torch.float32)):
        served[f"F2 E1 {tag}"] = run_engine(
            f"F2 E1 f32 vicuna-7b over {tag} (whole-prompt admission, "
            f"decode)", model, e1, ["B2" + F32, "B3" + F32], suffix=F32,
            cache_dtype=dtype, chunk_steps=8, pipeline=1, **SERVING)
        served[f"F2 E2 {tag}"] = run_engine(
            f"F2 E2 f32 vicuna-7b over {tag} (chunked prefill C=128, spec "
            f"k=4)", model, e2, ["B5" + F32, "B6" + F32], suffix=F32,
            cache_dtype=dtype, prefill_chunk=128, prefill_windows_per_step=4,
            spec_draft=4, chunk_steps=1, **SERVING)
    served["F2 E4 int8 pages"] = run_engine(
        "F2 E4 f32 vicuna-7b over int8 pages (hybrid C=128 min 256)", model,
        serving_prompts(rng, SERVING_LENGTHS, 32000),
        ["B2" + F32, "B7" + F32, "B8" + F32], suffix=F32,
        cache_dtype=torch.int8, prefill_chunk=128, prefill_chunk_min=256,
        chunk_steps=8, pipeline=1, **SERVING)
    beam = run_f_beam(bundle, rng)
    del bundle, model
    return fwd_counts, gen, served, beam


F3_WORDS = 400               # F3's text request: a chunked prefill


def run_f3(bundle, rng, fillers, frames, smi):
    """F3: the default bf16 bundle (W1's) behind an engine worker started
    with ``engine_cache_dtype="f32"`` (``--engine-cache-dtype f32``): an
    f32 pool on the card, bf16 q over it through the f32 paged kernels. One
    text request (chunked windows, then decode) and one image request
    (``Generator.stream``, B1), each answer held as W1's."""
    from merlin_tpu_torch.utils import constants as C

    tok, model = bundle.tokenizer, bundle.model
    ctrl, workers, servers = start_stack(bundle, [
        ("merlin-f32-pages", dict(W_ENGINE, engine_cache_dtype="f32"))])
    worker = workers["merlin-f32-pages"]
    pool = worker.engine.cache["layers"][0]["k_pages"]
    calls = collections.Counter()
    encoded = [0, 0]
    hooks = engine_counter(worker, calls) + tower_counter(model, encoded)
    base = dict(temperature=0.0, max_new_tokens=W_MAX_NEW, stop="</s>",
                model="merlin-f32-pages")
    text = w_prompts(rng, fillers, [F3_WORDS])[0]
    one = w_image_prompt(1)
    torch.cuda.synchronize()
    reset_counts()
    results = [w_request(ctrl, dict(base, prompt=text)),
               w_request(ctrl, dict(base, prompt=one,
                                    images=[png_b64(frames[0])]))]
    torch.cuda.synchronize()
    counts = read_counts()
    for h in hooks:
        h.remove()
    stop_stack(servers, workers)
    n = bundle.config.lm.num_layers
    want = launches(**{"B1": 23 * encoded[0], "B2": n * calls["prefill"],
                       "B3" + F32: n * calls["decode"],
                       "B5" + F32: n * calls["window_small"],
                       "B6" + F32: n * calls["window_large"]})
    log(f"F3 worker with f32 pages ({pool.dtype}, "
        f"{nbytes(pool) * 2 * n / 1e9:.2f} GB of K/V pages): launches "
        f"{counts}; model calls {dict(calls)}; tower calls {encoded[0]}")
    if pool.dtype != torch.float32 or counts != want or not (
            counts["B1"] and counts["B3" + F32] and counts["B6" + F32]):
        raise AssertionError(f"F3: pool {pool.dtype}, launches {counts}, "
                             f"expected {want}")
    readings = {}
    placeholder = C.image_placeholder(bundle.config.image_token_len)
    for name, (chunks, stamps), prompt_text, images in (
            (f"text {F3_WORDS} words", results[0], text, None),
            ("1 image (Generator.stream)", results[1],
             one.replace("<image>", placeholder),
             decoded_images(frames[:1], bundle.config.vit.image_size))):
        readings[name] = w_readings(f"F3 {name}", chunks, stamps, smi)
        ids = tok(prompt_text)["input_ids"][0]
        gap, seq = hold_answer(f"F3 {name}", model, tok, ids, images,
                               chunks[-1]["text"], len(chunks), GEN_RTOL)
        readings[name].update(prompt_tokens=len(ids), tokens=len(seq),
                              max_gap=gap)
        log(f"F3 {name}: {len(seq)} tokens held against a no-cache forward, "
            f"largest gap {gap:.3e} of max |logit| (tol {GEN_RTOL})")
        if not gap <= GEN_RTOL:
            raise AssertionError(f"F3 {name}: gap {gap}")
    return counts, readings


def run_f4(rng):
    """F4: T1's recipe with ``bf16=False`` through the Trainer: CLIP
    ViT-L/14-448 + conv + Vicuna-7B width, LM cut to 8 layers, f32
    compute, accum 2, 2 steps; B2, the backward (B10 + B11), B12 and B13
    all on their f32 kernels."""
    from merlin_tpu_torch.train.arguments import ModelArguments

    model = build_train_model(8, dtype=torch.float32)
    seen, counts, peak, prof = run_training(
        "F4 recipe at f32 (bf16=False, 8 LM layers, nothing frozen)", model,
        ModelArguments(), train_args(bf16=False, gradient_accumulation_steps=2,
                                     max_steps=2), 2, rng)
    losses = [m["loss"] for m in seen]
    want = launches(**suffixed({"B2": 64, "B12": 46 * 2, "B13": 46 * 2,
                                "B10+B11": 32}, F32))
    first_ok = abs(losses[0] - math.log(32128)) <= 0.5
    same = abs(losses[1] - losses[0]) <= 1e-6 * abs(losses[0])
    finite = all(math.isfinite(m["grad_norm"]) for m in seen)
    log(f"F4 checks: first loss {losses[0]:.6f} vs ln(32128) "
        f"{math.log(32128):.6f} (within 0.5: {first_ok}); step 2 equals "
        f"step 1 at lr 0: {same}; grad norms finite: {finite}; peak "
        f"{peak / 1e9:.2f} GB")
    if not (first_ok and same and finite and counts == want):
        raise AssertionError(f"F4 failed: {losses} {counts}")
    del model
    return dict(losses=losses, counts=counts, peak_bytes=peak,
                step_time_s=seen[-1]["step_time_s"],
                tokens_per_sec=seen[-1]["tokens_per_sec"], profile=prof)


# ---------------------------------------------------------------------------
# Phase M: the mesh path on a one-rank NCCL group
# ---------------------------------------------------------------------------

M_STEPS = 3                  # M1's steps: T1's first three
M_LOSS_RTOL = 1e-5           # M1's losses against T1's and the rerun's. Not
                             # bit for bit: dq's f32 atomics add in a
                             # varying order (C17), so even T1 and its
                             # meshless rerun part at step 3 (by 4.6e-7 on
                             # an H100), and Adam turns the gradients of
                             # elements near its eps into steps of ~lr
M_LEAF_LIMIT = 0.5           # every leaf's 3-step update (parameters after
                             # minus before) against the meshless rerun's:
                             # |difference|_2 / |rerun's update|_2. Sound
                             # runs read at most 0.16 on an H100, a key
                             # bias; a leaf whose gradient is left out
                             # moves by its decay alone and reads ~1. The
                             # key biases are left out (their exact
                             # gradient is 0: Adam steps on rounding noise
                             # in both runs, C14), as in the CPU tests


class MeshGroup:
    """A one-rank NCCL process group (FileStore rendezvous in a temporary
    directory) with the (1, 1, 1, 1) mesh over it, for the duration of a
    ``with``; no fallback: a group that does not come up fails the phase.
    The group is torn down after, so the phases without a mesh run as
    before."""

    def __enter__(self):
        import tempfile

        import torch.distributed as dist
        from merlin_tpu_torch.core.mesh import MeshConfig, create_mesh

        self.dir = tempfile.mkdtemp(prefix="chip_smoke_m_")
        dist.init_process_group("nccl", init_method=f"file://{self.dir}/rdzv",
                                rank=0, world_size=1)
        if dist.get_backend() != "nccl":
            raise AssertionError(f"M: backend {dist.get_backend()}")
        self.mesh = create_mesh(MeshConfig(data=1, fsdp=1, seq=1, tensor=1))
        return self.mesh

    def __exit__(self, *exc):
        import shutil

        import torch.distributed as dist
        from merlin_tpu_torch.core.mesh import set_global_mesh

        set_global_mesh(None)
        dist.destroy_process_group()
        shutil.rmtree(self.dir, ignore_errors=True)
        return False


def m_serve(tag, model, prompts, ref, mesh, **engine_kw):
    """One M2 run: ``ServingEngine(mesh=, param_shardings=)`` on ``model``
    with ``engine_kw`` serves ``prompts`` (32 new tokens each, as
    ``run_engine``); its tokens and launches must equal the meshless run
    ``ref`` (run_engine's (counts, readings)), every page must come back
    and ``close()`` must restore the global mesh."""
    from merlin_tpu_torch.core.mesh import get_global_mesh
    from merlin_tpu_torch.core.partitioning import (
        logical_axes, sharding_for_tree)
    from merlin_tpu_torch.serve.engine import ServingEngine

    shardings = sharding_for_tree(logical_axes(model), mesh, strict=False)
    engine = ServingEngine(model, eos_id=-1, device="cuda", mesh=mesh,
                           param_shardings=shardings, **engine_kw)
    set_while_running = get_global_mesh() is mesh
    free_start = engine.pool.free_pages
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    reqs = [engine.submit(p, max_new_tokens=32) for p in prompts]
    engine.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    free_end = engine.pool.free_pages
    engine.close()
    restored = get_global_mesh() is None
    tokens = [r.generated for r in reqs]
    n_tok = sum(len(t) for t in tokens)
    same = tokens == ref[1]["tokens"]
    log(f"M2 {tag}: {len(prompts)} requests on the (1, 1, 1, 1) NCCL mesh, "
        f"{n_tok} tokens in {wall:.3f} s -> {n_tok / wall:.2f} tok/s; "
        f"tokens equal the meshless run's: {same}; launches {counts} "
        f"(meshless {ref[0]}); free pages {free_end} of {free_start}; "
        f"global mesh set while serving {set_while_running}, restored by "
        f"close() {restored}")
    if not (same and counts == ref[0] and free_end == free_start
            and set_while_running and restored):
        raise AssertionError(f"M2 {tag} failed")
    return counts, dict(tok_s=n_tok / wall, wall_s=wall, tokens_equal=same)


def run_m2_bf16(model, prompts, served):
    """M2 on E1's Vicuna-7B: E1's traffic and settings (bf16 pool, whole
    prompts, B2/B3) and E2's (chunked prefill + spec k=4, B6/B5)."""
    with MeshGroup() as mesh:
        return {"M2 bf16 pool (E1)": m_serve(
                    "bf16 pool (E1)", model, prompts["E1"], served["E1"],
                    mesh, chunk_steps=8, pipeline=1, **SERVING),
                "M2 chunked + spec (E2)": m_serve(
                    "chunked + spec (E2)", model, prompts["E2"],
                    served["E2"], mesh, prefill_chunk=128,
                    prefill_windows_per_step=4, spec_draft=4, chunk_steps=1,
                    **SERVING)}


def run_m2_int8(qmodel, prompts, served):
    """M2 on E4's int8-weight Vicuna-7B over E4's int8 pool (B2/B8/B7)."""
    with MeshGroup() as mesh:
        return {"M2 int8 pool (E4)": m_serve(
            "int8 pool (E4)", qmodel, prompts["E4"], served["E4"], mesh,
            cache_dtype=torch.int8, prefill_chunk=128, prefill_chunk_min=256,
            chunk_steps=8, pipeline=1, **SERVING)}


def m_train(tag, batch, mesh=None, plant=None, keep_init=False):
    """T1's model and recipe (8 LM layers, seed 0) trained M_STEPS steps on
    T1's batch, on ``mesh`` when given (FSDP2 over (data, fsdp), the rules'
    tensor plan). ``plant``: a predicate on parameter names whose
    gradients are left out of the update (zeroed before the optimizer
    step). Returns the
    metrics, the launches, the peak bytes, the trainable parameters after
    the steps (on the host; with ``keep_init`` also before them) and the
    placement problems found."""
    from merlin_tpu_torch.core.parallel import check_placements, local
    from merlin_tpu_torch.models.builder import make_bundle
    from merlin_tpu_torch.train.arguments import ModelArguments
    from merlin_tpu_torch.train.trainer import Trainer

    free_cuda()         # the run before's model, held in reference cycles
    t_build = time.perf_counter()
    model = build_train_model(8)
    bundle = make_bundle(model, ModelArguments(), orig_vocab_size=32000)
    trainer = Trainer(bundle, train_args(gradient_accumulation_steps=2,
                                         max_steps=4),
                      mesh=mesh, device="cuda")
    trainer.init_state()
    bad = check_placements(model, trainer.parallel) if mesh else []
    init = ({n: local(p).detach().to("cpu", copy=True)
             for n, p in model.named_parameters() if p.requires_grad}
            if keep_init else None)
    if plant:
        step = trainer.optimizer.step

        def left_out(grads):
            for n, g in grads.items():
                if plant(n):
                    g.zero_()
            return step(grads)
        trainer.optimizer.step = left_out
    seen = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t_train = time.perf_counter()
    trainer.train(iter([batch] * M_STEPS), num_steps=M_STEPS,
                  log_fn=lambda i, m: seen.append(m))
    torch.cuda.synchronize()
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    params = {n: local(p).detach().to("cpu", copy=True)
              for n, p in model.named_parameters() if p.requires_grad}
    if plant:
        del trainer.optimizer.step      # the cycle through left_out
    trainer.close()
    log(f"M1 {tag}: {time.perf_counter() - t_build:.1f} s in all, "
        f"{t_train - t_build:.1f} s to build, "
        f"{time.perf_counter() - t_train:.1f} s to train and copy out")
    for m in seen:
        log(f"M1 {tag} step: loss {m['loss']:.7f}, grad_norm "
            f"{m['grad_norm']:.4f}, update_norm {m['update_norm']:.4e}, "
            f"step {m['step_time_s']:.3f} s, "
            f"{m.get('tokens_per_sec', float('nan')):.1f} tok/s")
    del trainer, bundle, model
    free_cuda()
    if keep_init:
        params = (params, init)
    return seen, counts, peak, params, bad


def m_update_gap(params, ref, updates):
    """Per leaf, |params - ref|_2 / |ref - init|_2 (``updates``: the
    reference's update norms): how far a run's update lies from the
    reference run's, as a share of it. Returns the leaves the check holds
    to M_LEAF_LIMIT that exceed it, the worst of those leaves with its
    share, and the median share of each FSDP unit's leaves (the tower, the
    projector, the root: the LM), which is information."""
    shares = {n: (params[n] - want).norm().item() / updates[n]
              for n, want in ref.items() if updates[n] > 0}
    units = collections.defaultdict(list)
    for n, share in shares.items():
        units[n.split(".")[0]].append(share)
    held = {n: v for n, v in shares.items() if not n.endswith("k_proj.bias")}
    worst = max(held, key=held.get)
    over = sorted(n for n, v in held.items() if v > M_LEAF_LIMIT)
    return (over, (worst, held[worst]),
            {u: float(np.median(v)) for u, v in units.items()})


def run_m1(t1, smi):
    """M1: the Trainer on the (1, 1, 1, 1) NCCL mesh in T1's configuration
    and batch, 3 steps: the losses against T1's first three and a meshless
    rerun's, each leaf's update against the rerun's, launches per step
    equal to T1's, every trainable parameter a DTensor on the mesh
    with the rules' placements; two planted faults must fail the
    parameter check: the tower's FSDP unit's gradients left out of the
    update, and one leaf's (the LM head's); ``host_allreduce_min`` and
    ``barrier`` over NCCL."""
    from merlin_tpu_torch.utils.dist import barrier, host_allreduce_min

    batch = t1["batch"]
    plain, _, _, (ref, init), _ = m_train("meshless rerun", batch,
                                          keep_init=True)
    updates = {n: (want - init[n]).norm().item() for n, want in ref.items()}
    del init
    planted = {"the tower unit's gradients left out":
               lambda n: n.startswith("vision_tower."),
               "the LM head's gradient left out":
               lambda n: n == "lm.lm_head.kernel"}
    with MeshGroup() as mesh:
        agreed = host_allreduce_min(7)
        barrier("M1")
        seen, counts, peak, params, bad = m_train("(1, 1, 1, 1) mesh", batch,
                                                  mesh)
        over, worst, medians = m_update_gap(params, ref, updates)
        del params
        caught = {}
        for tag, plant in planted.items():
            _, _, _, params, _ = m_train(f"planted: {tag}", batch, mesh,
                                         plant=plant)
            p_over, p_worst, p_medians = m_update_gap(params, ref, updates)
            del params
            caught[tag] = dict(leaves_over=len(p_over),
                               planted_over=sum(map(plant, p_over)),
                               worst_leaf=p_worst, unit_medians=p_medians)
    del ref
    losses = [m["loss"] for m in seen]
    loss_gap = max(abs(a - b) / abs(b) for a, b in
                   zip(losses, t1["losses"][:M_STEPS]))
    rerun_gap = max(abs(m["loss"] - r["loss"]) / abs(r["loss"])
                    for m, r in zip(seen, plain))
    want = {k: v * M_STEPS // 4 for k, v in t1["counts"].items()}
    log(f"M1 checks: losses {losses} vs T1's {t1['losses'][:M_STEPS]} (rel "
        f"{loss_gap:.3e}), vs the meshless rerun's "
        f"{[r['loss'] for r in plain]} (rel {rerun_gap:.3e}), tol "
        f"{M_LOSS_RTOL}; each leaf's update vs the rerun's: worst leaf "
        f"{worst[0]} {worst[1]:.3e}, leaves over {M_LEAF_LIMIT}: {over[:4]}; "
        f"the median of each FSDP unit {medians}; planted faults {caught}, "
        f"each must put its own leaves over; launches {counts} (T1 x 3/4: "
        f"{want}); placement problems {bad[:4]}; host_allreduce_min(7) = "
        f"{agreed}; peak {peak} bytes; card {smi}")
    if not (loss_gap <= M_LOSS_RTOL and rerun_gap <= M_LOSS_RTOL
            and not over
            and all(c["planted_over"] > 0 for c in caught.values())
            and counts == want and not bad and agreed == 7):
        raise AssertionError(f"M1 failed: {losses} {worst} {over[:4]} "
                             f"{caught} {counts} {bad[:4]}")
    return dict(losses=losses, counts=counts, peak_bytes=peak,
                step_time_s=[m["step_time_s"] for m in seen],
                tokens_per_sec=seen[-1].get("tokens_per_sec"),
                meshless_step_time_s=[m["step_time_s"] for m in plain],
                loss_rel_t1=loss_gap, loss_rel_rerun=rerun_gap,
                update_share_worst_leaf=worst, update_share_limit=M_LEAF_LIMIT,
                update_share_median=medians, planted=caught)


def free_cuda():
    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # nothing is fetched: the W phase's tokenizer load fails at once and
    # falls back to the TinyTokenizer
    os.environ["HF_HUB_OFFLINE"] = "1"
    os.environ["TRANSFORMERS_OFFLINE"] = "1"
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
    ptxas = ptxas_report()
    for name, info in ptxas.items():
        log(f"ptxas {name}: {info}")
    spilled = [n for n, i in ptxas.items() if i.get("spill_store_bytes", 1)
               or i.get("spill_load_bytes", 1)]
    if spilled or len(ptxas) < N_SPILL_CHECKED:
        raise AssertionError(f"ptxas: spills in {spilled}, or a checked "
                             f"kernel missing from {sorted(ptxas)}")
    f32_ptxas = {n: i for n, i in ptxas.items() if "f32" in n}
    bf16_ptxas = {n: i for n, i in ptxas.items() if n not in f32_ptxas}
    paged_ptxas = {n: i for n, i in bf16_ptxas.items() if "paged_" in n}
    fwd_ptxas = {n: i for n, i in bf16_ptxas.items() if "fwd" in n
                 or "onepass" in n}
    bwd_ptxas = {n: i for n, i in bf16_ptxas.items()
                 if n not in fwd_ptxas and n not in paged_ptxas}

    gen = torch.Generator(device="cuda").manual_seed(0)
    rng = np.random.default_rng(0)
    b1 = check_b1(gen)
    b2 = check_b2(gen)
    paged = check_paged(gen)
    paged.update(check_paged_q8(gen))
    # the f32 kernels, on a generator of their own: the bf16 checks and
    # every phase after them draw what they drew before
    gen32 = torch.Generator(device="cuda").manual_seed(15)
    f32_rows = check_f32_dense(gen32, smi)
    f32_rows.update(check_f32_paged(gen32, smi))
    # phase H's kernel checks, on a generator of their own
    t_h = time.perf_counter()
    wide_rows = check_paged_wide(
        torch.Generator(device="cuda").manual_seed(H_SEED), smi)
    h_seconds = {"kernel checks": time.perf_counter() - t_h}
    check_reference(rng)
    model, cfg = build_full_model()
    fwd_counts, _ = run_forward(model, cfg, rng)
    g = run_generation(model, cfg, rng)
    e_prompts = {}
    served = serve_vicuna(model, rng, e_prompts)
    m_seconds = {}
    t0 = time.perf_counter()
    mesh_served = run_m2_bf16(model, e_prompts, served)
    m_seconds["M2 (E1, E2)"] = time.perf_counter() - t0
    scanned, smodel = serve_scanned(model, np.random.default_rng(13))
    qmodel = build_int8_vicuna(model, cfg)
    sqmodel = build_int8_vicuna(smodel, smodel.cfg)
    check_stacked_int8(qmodel, sqmodel)
    del model, smodel                 # the int8 LM replaces the bf16 one
    gc.collect()
    torch.cuda.empty_cache()
    served["E4"] = serve_vicuna_int8(qmodel, rng, e_prompts)
    t0 = time.perf_counter()
    mesh_served.update(run_m2_int8(qmodel, e_prompts, served))
    m_seconds["M2 (E4)"] = time.perf_counter() - t0
    scanned["S4"] = serve_scanned_int8(qmodel, sqmodel,
                                       np.random.default_rng(16))
    del qmodel, sqmodel               # E3's model replaces the 7B one
    gc.collect()
    torch.cuda.empty_cache()
    served.update(serve_baichuan(rng))
    scanned["S3"] = serve_scanned_alibi(np.random.default_rng(17))
    free_cuda()                       # phase G builds its own model
    graph_replay = check_graph_replay(np.random.default_rng(21))
    free_cuda()                       # phase H builds its own models
    t_h = time.perf_counter()
    wide_served = serve_wide(np.random.default_rng(H_SEED))
    h_seconds["served"] = time.perf_counter() - t_h
    free_cuda()                       # phase F builds its own f32 model
    t_f = time.perf_counter()
    f1_counts, f1_gen, f_served, f_beam = run_f(np.random.default_rng(15))
    f_seconds = {"F1 + F2": time.perf_counter() - t_f}
    free_cuda()                       # the W phase builds its own model
    worker_counts, front, v_counts, lora = serve_front(
        np.random.default_rng(9), smi)
    free_cuda()
    k1, k2 = checkpoints_and_towers(np.random.default_rng(10), gen, smi)
    free_cuda()                       # training starts from an empty card
    trained = check_flash_bwd(gen, b2)
    trained.update(check_onepass_train(gen))
    c13 = measure_c13(gen)
    free_cuda()
    t0_reading = check_train_reference(rng)
    free_cuda()
    t1 = run_t1(rng)
    free_cuda()
    t0 = time.perf_counter()
    m1 = run_m1(t1, smi)
    m_seconds["M1"] = time.perf_counter() - t0
    del t1["batch"]
    free_cuda()
    t2 = run_t2(rng)
    free_cuda()
    t3 = run_t3(np.random.default_rng(18))
    free_cuda()
    t_f = time.perf_counter()
    f4 = run_f4(np.random.default_rng(20))
    f_seconds["F4"] = time.perf_counter() - t_f
    free_cuda()                       # D builds its bundle inside train()
    data_train, d_counts = run_d(smi)
    free_cuda()
    b1["launches"], b2["launches"] = fwd_counts["B1"], fwd_counts["B2"]
    b1["launches_generation"] = g["counts"]["B1"]
    # B1 inside the new towers (phase K2): launches of one encode, and its
    # times at their shapes
    b1["towers"] = {
        "metaclip_h14_448 (d = 80)": dict(launches=k2["launches"]["metaclip"],
                                          **k2["b1"]["d80"]),
        "qwen_bigG_448 (d = 104)": dict(launches=k2["launches"]["qwen"],
                                        **k2["b1"]["d104"])}
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
        row["ptxas"] = fwd_ptxas if name == "B12" else bwd_ptxas
    b1["ptxas"] = b2["ptxas"] = fwd_ptxas
    for name in ("B3", "B4", "B5", "B6", "B7", "B7w", "B8", "B9"):
        paged[name]["ptxas"] = {
            n: i for n, i in paged_ptxas.items()
            if ("window" in n) == (name in ("B6", "B8"))}
    # the f32 kernels' launches on phase F's paths: F1's forward (B1, B2),
    # F2's engine runs (B3, B5/B6 over bf16 pages; B7, B8 over int8), F4's
    # training (B10 + B11, B12, B13); B4 (ALiBi), B7 windows and B9 are on
    # no F path (held in phase 2)
    f_runs = {"F1 forward": f1_counts, "F1 generation": f1_gen["counts"],
              **{k: v[0] for k, v in f_served.items()},
              "F beam": f_beam[0],
              "F beam check": launches(**f_beam[1]["check_launches"]),
              "F3": worker_counts["F3"],
              "T3 f32": t3["one_micro_counts_f32"], "F4": f4["counts"]}
    f_path = {"B1": "F1 forward", "B2": "F1 forward",
              "B3": "F2 E1 bf16 pages", "B5": "F2 E2 bf16 pages",
              "B6": "F2 E2 bf16 pages", "B7": "F2 E4 int8 pages",
              "B8": "F2 E4 int8 pages", "B10": "F4", "B11": "F4",
              "B12": "F4", "B13": "F4"}
    for name, row in f32_rows.items():
        run = f_path.get(name)
        row["launches"] = f_runs[run][row["counter"]] if run else 0
        row["launches_run"] = run
        src = row["source"].rsplit("/", 1)[-1]
        row["ptxas"] = {n: i for n, i in f32_ptxas.items()
                        if ("paged" in n) == ("paged" in src)
                        and ("bwd" in n) == ("bwd" in src)}
    # the d = 256 rows' launches on phase H's served runs (B4, B7w and B9
    # are on none of them: the model has no ALiBi, and no int8 run takes
    # speculative windows)
    h_path = {"B3": "H E1", "B5": "H E2", "B6": "H E2", "B7": "H E4",
              "B8": "H E4", "B5" + F32: "H F32", "B6" + F32: "H F32"}
    for key, row in wide_rows.items():
        run = h_path.get(key)
        row["launches"] = wide_served[run][0][key] if run else 0
        row["launches_run"] = run
        row["ptxas"] = {n: i for n, i in ptxas.items()
                        if row["kernel"] in n and "Li256E" in n}
    rows = [b1, b2] + [paged[k] for k in ("B3", "B4", "B5", "B6", "B7",
                                          "B7w", "B8", "B9")] + [
        trained[k] for k in ("B10", "B11", "B12", "B13")] + [
        f32_rows[k] for k in ("B1", "B2", "B3", "B4", "B5", "B6", "B7",
                              "B7w", "B8", "B9", "B10", "B11", "B12",
                              "B13")]
    for row in rows:
        key = row.get("counter", row["name"].split()[0])
        row["launches_serving"] = {e: served[e][0][key] for e in served}
        row["launches_training"] = t1["counts"][key]
        row["launches_training_frozen_lm"] = t2["counts"][key]
        row["launches_worker"] = {w: worker_counts[w][key]
                                  for w in worker_counts}
        row["launches_eval"] = v_counts.get(key, 0)
        row["launches_checkpoint"] = k1["counts"][key]
        row["launches_data_train"] = d_counts[key]
        row["launches_scanned_serving"] = {e: scanned[e][0][key]
                                           for e in sorted(scanned)}
        row["launches_lora"] = lora["counts"][key]
        row["launches_tower_training"] = t3["counts"][key]
        row["launches_mesh_training"] = m1["counts"][key]
        row["launches_mesh_serving"] = {e: mesh_served[e][0][key]
                                        for e in mesh_served}
        row["launches_f32_phase"] = {r: c[key] for r, c in f_runs.items()}
    # a wrapper counts its launches at every d: a d = 256 row's launches
    # are phase H's (the only runs at d > 128), and the rows above count
    # none of phase H's
    for key, row in wide_rows.items():
        row["launches_head_dim_256"] = {r: c[0][key]
                                        for r, c in wide_served.items()}
    rows += list(wide_rows.values())
    log(json.dumps({"serving": {
        e: {k: v for k, v in served[e][1].items() if k != "tokens"}
        for e in served}}))
    log(json.dumps({"graph_replay": graph_replay, "card": smi}))
    log(json.dumps({"front_end": front, "card": smi}))
    log(json.dumps({"checkpoint": {k: v for k, v in k1.items()
                                   if k != "counts"},
                    "towers": {k: v for k, v in k2.items() if k != "b1"},
                    "card": smi}))
    log(json.dumps({"training": {
        "T0": t0_reading, "C13": c13,
        "T1": {k: v for k, v in t1.items() if k != "counts"},
        "T2": {k: v for k, v in t2.items() if k != "counts"}}}))
    log(json.dumps({"data_train": data_train, "card": smi}))
    log(json.dumps({"scanned_serving": {
        e: {k: v for k, v in scanned[e][1].items() if k != "tokens"}
        for e in sorted(scanned)}, "lora": {
            k: v for k, v in lora.items() if k != "counts"},
        "tower_training": {k: v for k, v in t3.items() if k != "counts"},
        "card": smi}))
    log(json.dumps({"mesh": {
        "M1": {k: v for k, v in m1.items() if k != "counts"},
        "M2": {e: r[1] for e, r in mesh_served.items()},
        "seconds": m_seconds,
        "note": "one rank (NCCL, world 1): no multi-rank number",
        "card": smi}}))
    log(json.dumps({"f32": {
        "F1": f1_gen, "F2": {e: {k: v for k, v in r[1].items()
                                 if k != "tokens"}
                             for e, r in f_served.items()},
        "F beam": f_beam[1], "F3": front["F3"],
        "F4": {k: v for k, v in f4.items() if k != "counts"},
        "seconds": f_seconds, "card": smi}}))
    log(json.dumps({"head_dim_256": {
        e: dict({k: v for k, v in r[1].items() if k != "tokens"},
                launches={k: n for k, n in r[0].items() if n})
        for e, r in wide_served.items()}, "seconds": h_seconds,
        "card": smi}))
    log(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
