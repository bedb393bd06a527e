"""Ablations of the paged kernels (``csrc/paged_attention.cu``).

Builds variants of the kernel source, each with one textual change, next
to the unchanged build, and times them in turns on the same inputs:

  * the few-rows kernel (one part of the work removed, another ring
    depth, a register cap for three CTAs an SM, or int8 pages in 8-byte
    copies), each at key splits of 1, 2 and 4 pages of 128 keys, at the
    shapes ``chip_smoke.py`` times B3, B4, B5, B7 (decode) and B7 windows
    at;
  * the window kernel (B6, B8) at the engine's prefill windows, (1, 128,
    32, 128) at 256, 640 and 1536 keys and (1, 128, 40, 128) with ALiBi
    at 640, and at ``chip_smoke.py``'s 4-sequence check shape, over bf16
    and int8 pages: the unchanged build at the wrapper's grid and with no
    split, fixed splits of 256, 512 and 1024 keys, no merge, the copies
    alone, (int8) the copies and the dequantize alone, and the launch and
    grid alone; beside them, at the one-sequence bf16 windows, the dense
    forward (B2, non-causal) on the same keys in contiguous K/V.

The variants' outputs are not checked (a variant that drops work is wrong
by design); ``chip_smoke.py`` holds the real kernels to their plain
versions. Prints the card, ptxas's registers and spill bytes per variant,
one line per shape, and the readings as one JSON line. ``--window`` builds
and times the window kernel's variants only.

With ``--wrappers-only`` it times only the public wrappers of those rows
(device ms a call, and the host's µs a call) through whichever
``merlin_tpu_torch`` is first on the path, so that two checkouts can be
compared in one run:

    python3 -m merlin_tpu_torch.utils.ablate_paged [--window]
    PYTHONPATH=<checkout> python3 merlin_tpu_torch/utils/ablate_paged.py \\
        --wrappers-only
"""

from __future__ import annotations

import ctypes
import json
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

from merlin_tpu_torch.models.layers import alibi_slopes
from merlin_tpu_torch.ops import _build
from merlin_tpu_torch.ops import paged_attention as pa
from merlin_tpu_torch.ops.flash_attention import flash_attention

SOURCE = _build.CSRC / "paged_attention.cu"
PAGE = 128
SPLIT_PAGES = (1, 2, 4)

# variant -> textual edits of paged_attention.cu (each anchor replaced
# wherever it stands)
VARIANTS = {
    "kernel": [],
    # ring depth: 3 stages of 64 keys
    "stages3": [("constexpr int kRowsStages = 2;",
                 "constexpr int kRowsStages = 3;")],
    # registers capped for 3 CTAs an SM
    "min3ctas": [("__launch_bounds__(kRowsThreads)\n",
                  "__launch_bounds__(kRowsThreads, 3)\n")],
    # int8 pages in 8-byte copies at every d
    "q8_8byte": [("if (!Q8 || a.d % 16 == 0) {", "if (!Q8) {")],
    # no workspace and no merge: every live split writes out directly
    "no_merge": [("const bool single = n_live == 1;",
                  "const bool single = true;")],
    # the ring's copies without the products and the softmax
    "loads_only": [("    const unsigned char* ks = ring + (j % kRowsStages) "
                    "* L::kStage;\n",
                    "    if (j >= 0) continue;\n"
                    "    const unsigned char* ks = ring + (j % kRowsStages) "
                    "* L::kStage;\n")],
    # a third ring stage (bf16 at d = 128: 225 KB of shared memory)
    "window stages3": ([("constexpr int kWindowStages = 2;",
                         "constexpr int kWindowStages = 3;")], None),
    # every CTA returns at once: the launch and the grid alone
    "empty": [("  const int group = a.h / a.hkv;\n"
               "  const int rows = group * a.s_q;",
               "  if (a.b >= 0) return;\n"
               "  const int group = a.h / a.hkv;\n"
               "  const int rows = group * a.s_q;")],
}

# the window kernel's variants: textual edits, and the most key splits a
# row tile its grid holds (None: the wrapper's)
_PER = "const int per = window_split_tiles(a, KEYS, n_rt, tiles, gridDim.z);"
_COMPUTE = ("    issue_s(j);\n    issue_pv(j - 1);\n    wgmma_wait<1>();  // S_j; "
            "P_{j-1} V_{j-1} may still run\n    pin(s);\n    softmax(j);\n"
            "    wgmma_wait<0>();\n    rescale_pack();\n")
_DEQUANT = ("      dequant(j, false);\n      dequant(j - 1, true);\n"
            "      sync_dequant();\n")
WINDOW_VARIANTS = {
    "window": ([], None),
    "window no split": ([], 1),
    # fixed splits of 2, 4 and 8 tiles of 128 keys
    "window split 256": ([(_PER, "const int per = 2;")], 16),
    "window split 512": ([(_PER, "const int per = 4;")], 16),
    "window split 1024": ([(_PER, "const int per = 8;")], 16),
    # every live split writes out directly: no workspace, no merge
    "window no merge": ([("const bool direct = n_live == 1;",
                          "const bool direct = true;")], None),
    # the ring's copies (and over int8 pages the dequantize) without the
    # products and the softmax of all tiles but the first and last
    "window copies+dequant": ([(_COMPUTE, "")], None),
    # the copies alone
    "window copies": ([(_COMPUTE, ""), (_DEQUANT, "")], None),
    # a third ring stage (bf16 at d = 128: 225 KB of shared memory)
    "window stages3": ([("constexpr int kWindowStages = 2;",
                         "constexpr int kWindowStages = 3;")], None),
    # every CTA returns at once: the launch and the grid alone
    "window empty": ([("  const int n_rt = (rows + ROWS - 1) / ROWS;\n",
                       "  const int n_rt = (rows + ROWS - 1) / ROWS;\n"
                       "  if (a.b >= 0) return;\n")], None),
}

ENTRIES = ("merlin_paged_decode_bf16", "merlin_paged_decode_q8",
           "merlin_paged_window_bf16", "merlin_paged_window_q8")

# row -> (b, s_q (0: decode), h, hkv, lengths, int8 pages, ALiBi)
ROWS = {
    "B3": (4, 0, 32, 32, [1, 256, 1937, 700], False, False),
    "B4": (4, 0, 40, 40, [1, 384, 1999, 901], False, True),
    "B5": (4, 5, 32, 32, [5, 256, 1937, 700], False, False),
    "B7": (4, 0, 32, 32, [1, 256, 1937, 700], True, False),
    "B7w": (4, 5, 40, 40, [5, 384, 1999, 901], True, True),
}
# the window kernel's rows: the engine's one-sequence prefill windows, and
# chip_smoke.py's 4-sequence check shape
WINDOW_ROWS = {
    f"{name} {tag}": (b, 128, h, h, lengths, name == "B8", alibi)
    for name in ("B6", "B8")
    for tag, b, h, lengths, alibi in (
        ("L=256", 1, 32, [256], False), ("L=640", 1, 32, [640], False),
        ("L=1536", 1, 32, [1536], False),
        ("baichuan L=640", 1, 40, [640], True),
        ("check", 4, 32, [128, 256, 1990, 700], False))}
D = 128
PPS = 16


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def inputs(gen, row):
    """q, K/V pools (b * PPS + 1 random pages; page 0 the trash page),
    their scales (int8) or None, lengths, tables of permuted pages, and
    the slopes or None, as ``chip_smoke.paged_inputs`` makes them."""
    b, s_q, h, hkv, lengths, q8, alibi = {**ROWS, **WINDOW_ROWS}[row]
    total = b * PPS + 1
    pools = [torch.randn((total, PAGE, hkv * D), generator=gen,
                         device="cuda").to(torch.bfloat16) for _ in range(2)]
    perm = (torch.randperm(total - 1, generator=gen, device="cuda") + 1).to(
        torch.int32).reshape(b, PPS)
    tables = torch.zeros((b, PPS), dtype=torch.int32, device="cuda")
    for i, n in enumerate(lengths):
        tables[i, :-(-n // PAGE)] = perm[i, :-(-n // PAGE)]
    q = torch.randn((b, s_q, h, D) if s_q else (b, h, D), generator=gen,
                    device="cuda").to(torch.bfloat16)
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    scales = None
    if q8:
        (kv, ks), (vv, vs) = (pa.quantize_pages(p_, D) for p_ in pools)
        pools, scales = [kv, vv], [ks, vs]
    slopes = alibi_slopes(h, device="cuda") if alibi else None
    return q, pools, scales, lens, tables, slopes


def wrapper(row, q, pools, scales, lens, tables, slopes):
    """One call of the row's public wrapper."""
    kw = {} if row == "B3" else {"alibi_slopes": slopes}
    fn = {"B3": pa.paged_attention_dma, "B4": pa.paged_attention,
          "B5": pa.paged_attention_dma_multi,
          "B6": pa.paged_attention_multi_blocked,
          "B7": pa.paged_attention_dma_q8,
          "B7w": pa.paged_attention_dma_multi_q8,
          "B8": pa.paged_attention_multi_blocked_q8}[row.split()[0]]
    if scales is None:
        return lambda: fn(q, pools[0], pools[1], lens, tables, **kw)
    return lambda: fn(q, pools[0], scales[0], pools[1], scales[1], lens,
                      tables, **kw)


def launcher(lib, split_pages, q, pools, scales, lens, tables, slopes,
             window_splits=None):
    """One launch of a variant's few-rows kernel at ``split_pages`` pages
    a split (or, given ``window_splits``, of its window kernel at that
    many key splits a row tile at most), with its own workspace and
    zeroed counters."""
    b, h = q.shape[0], q.shape[-2]
    s_q = q.shape[1] if q.dim() == 4 else 1
    hkv = pools[0].shape[2] // D
    rows = h // hkv * s_q
    n_splits = (window_splits if window_splits is not None
                else -(-PPS // split_pages))
    ws = torch.empty(b * hkv * n_splits * rows * (D + 2) if window_splits
                     is None else pa.window_workspace_floats(
                         b, rows, hkv, D, n_splits), device="cuda")
    counters = torch.zeros(b * hkv * -(-rows // 16), dtype=torch.int32,
                           device="cuda")
    out = torch.empty_like(q)
    stream = _build.stream_handle(q.device)
    common = (lens.data_ptr(), tables.data_ptr(),
              slopes.data_ptr() if slopes is not None else None,
              out.data_ptr(), ws.data_ptr(), counters.data_ptr(), b)
    shape = ((h, hkv, D, PAGE, PPS) if q.dim() == 3
             else (s_q, h, hkv, D, PAGE, PPS))
    scale = D ** -0.5

    def run():
        split = split_pages if window_splits is None else window_splits
        if scales is None:
            pages = (q.data_ptr(), pools[0].data_ptr(), pools[1].data_ptr())
            tail = (split, scale)
        else:
            pages = (q.data_ptr(), pools[0].data_ptr(),
                     scales[0].data_ptr(), pools[1].data_ptr(),
                     scales[1].data_ptr())
            tail = (scales[0].shape[2], split, scale)
        if q.dim() == 3:
            entry = ("merlin_paged_decode_bf16" if scales is None
                     else "merlin_paged_decode_q8")
            code = getattr(lib, entry)(*pages, *common, *shape, *tail,
                                       stream)
        else:
            entry = ("merlin_paged_window_bf16" if scales is None
                     else "merlin_paged_window_q8")
            code = getattr(lib, entry)(*pages, *common, *shape, *tail,
                                       int(window_splits is None), stream)
        if code:
            raise RuntimeError(f"{entry} failed: {code}")
    run.keep = (ws, counters, out)
    return run


def build(tmp: Path, variants):
    """One library per variant ({name: edits}), all compiled at once;
    returns {name: (CDLL, ptxas report of the paged kernels)}."""
    nvcc = _build._nvcc()
    procs = {}
    for name, edits in variants.items():
        src = SOURCE.read_text()
        for old, new in edits:
            if old not in src:
                raise RuntimeError(f"{name}: edit anchor not found")
            src = src.replace(old, new)
        d = tmp / name.replace(" ", "_").replace("+", "_")
        shutil.copytree(_build.CSRC, d, ignore=shutil.ignore_patterns(
            "build", "*.cu"))
        (d / SOURCE.name).write_text(src)
        procs[name] = subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-shared", str(d / SOURCE.name),
             "-o", str(d / "lib.so")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out, _ = proc.communicate()
        d = tmp / name.replace(" ", "_").replace("+", "_")
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{out}")
        report, fn = {}, None
        for line in out.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                fn = m.group(1) if "paged_" in m.group(1) else None
                if fn:
                    report[fn] = {}
            m = re.search(r"(\d+) bytes spill stores", line)
            if m and fn:
                report[fn]["spill_store_bytes"] = int(m.group(1))
            m = re.search(r"Used (\d+) registers", line)
            if m and fn:
                report[fn]["registers"] = int(m.group(1))
        lib = ctypes.CDLL(str(d / "lib.so"))
        for entry in ENTRIES:
            getattr(lib, entry).argtypes = _build.SIGNATURES[entry]
            getattr(lib, entry).restype = ctypes.c_int
        libs[name] = (lib, report)
    return libs


def time_ms(fn, iters=20, warmup=5):
    """Device time of one call: CUDA events over ``iters`` calls queued
    while the card spins ~50 ms, so the host's pace is not read."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, calls=50):
    """Host time of one call, issued back to back after a sync."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def wrappers_only(rounds: int = 3) -> dict:
    """Each row's public wrapper: median device ms and host µs a call."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    readings = {}
    for row in [*ROWS, *WINDOW_ROWS]:
        fn = wrapper(row, *inputs(gen, row))
        ms = sorted(time_ms(fn) for _ in range(rounds))[rounds // 2]
        us = sorted(host_us(fn) for _ in range(rounds))[rounds // 2]
        readings[row] = {"ms": ms, "host_us": us}
        print(f"{row} wrapper: {ms:.4f} ms, {us:.1f} us of host time a "
              f"call", flush=True)
    return readings


def timed_in_turns(runs, rounds):
    """Median ms of each of ``runs`` ({name: fn}), timed in turns, the
    order reversed each round."""
    times = {n: [] for n in runs}
    for i in range(rounds):
        for n in (list(runs) if i % 2 == 0 else list(runs)[::-1]):
            times[n].append(time_ms(runs[n]))
    return {n: sorted(t)[len(t) // 2] for n, t in times.items()}


def variants(rounds: int = 3, window_only: bool = False) -> dict:
    builds = {n: e for n, (e, _) in WINDOW_VARIANTS.items()}
    if not window_only:
        builds.update(VARIANTS)
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        t0 = time.perf_counter()
        libs = build(Path(tmp), builds)
        print(f"built {len(libs)} variants in {time.perf_counter() - t0:.1f} "
              f"s", flush=True)
        for name, (_, report) in libs.items():
            print(f"ptxas {name}: {report}", flush=True)
        gen = torch.Generator(device="cuda").manual_seed(0)
        readings = {}
        for row in ([] if window_only else ROWS):
            args = inputs(gen, row)
            runs = {f"{n} split {sp * PAGE}": launcher(libs[n][0], sp, *args)
                    for n in VARIANTS for sp in SPLIT_PAGES}
            readings[row] = med = timed_in_turns(runs, rounds)
            print(f"{row} {ROWS[row]}: " + ", ".join(
                f"{n} {t:.4f} ms" for n, t in med.items()), flush=True)
        for row in WINDOW_ROWS:
            args = inputs(gen, row)
            q, pools = args[0], args[1]
            b, s_q, h = q.shape[0], q.shape[1], q.shape[2]
            hkv = pools[0].shape[2] // D
            plan = pa.window_plan(
                b, h // hkv * s_q, hkv, D, PAGE, PPS,
                torch.cuda.get_device_properties(0).multi_processor_count)[0]
            runs = {}
            for n, (_, splits) in WINDOW_VARIANTS.items():
                if "dequant" in n and args[2] is None:
                    continue                 # bf16 pages have no dequantize
                runs[n] = launcher(libs[n][0], 0, *args,
                                   window_splits=splits or plan)
            if b == 1 and args[2] is None:
                # yardstick: the dense forward (B2, non-causal) on the same
                # keys gathered into contiguous K/V, a CTA per 128 rows
                n_keys = int(args[3][0])
                kv = [p_[args[4][0].long()].reshape(1, -1, hkv, D)[:, :n_keys]
                      .contiguous() for p_ in pools]
                runs["dense B2 non-causal"] = (
                    lambda q=q, kv=kv: flash_attention(q, *kv, causal=False))
            readings[row] = med = timed_in_turns(runs, rounds)
            print(f"{row} {WINDOW_ROWS[row]} (grid {plan} splits): " +
                  ", ".join(f"{n} {t:.4f} ms" for n, t in med.items()),
                  flush=True)
        ptxas = {n: r for n, (_, r) in libs.items()}
    return {"ms": readings, "ptxas": ptxas}


def main() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("ablate_paged: no CUDA device")
    name = card()
    print(f"card: {name}", flush=True)
    print(f"package: {Path(pa.__file__).resolve().parent.parent}",
          flush=True)
    if "--wrappers-only" in sys.argv[1:]:
        result = {"card": name, "wrappers": wrappers_only()}
    else:
        result = {"card": name,
                  **variants(window_only="--window" in sys.argv[1:])}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
