"""Ablations of the paged few-rows kernel (``csrc/paged_attention.cu``).

Builds variants of the kernel source, each with one textual change (one
part of the work removed, another ring depth, a register cap for three
CTAs an SM, or int8 pages in 8-byte copies), next to the unchanged build,
and times them in turns, each at key splits of 1, 2 and 4 pages of
128 keys, on the same inputs at the shapes ``chip_smoke.py`` times B3,
B4, B5, B7 (decode) and B7 windows at. The variants' outputs are not
checked (a variant that drops work is wrong by design); ``chip_smoke.py``
holds the real kernel to its plain version. Prints the card, ptxas's
registers and spill bytes per variant, one line per shape, and the
readings as one JSON line.

With ``--wrappers-only`` it times only the public wrappers of those rows
(device ms a call, and the host's µs a call) through whichever
``merlin_tpu_torch`` is first on the path, so that two checkouts can be
compared in one run:

    python3 -m merlin_tpu_torch.utils.ablate_paged
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
    # every CTA returns at once: the launch and the grid alone
    "empty": [("  const int group = a.h / a.hkv;\n"
               "  const int rows = group * a.s_q;",
               "  if (a.b >= 0) return;\n"
               "  const int group = a.h / a.hkv;\n"
               "  const int rows = group * a.s_q;")],
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
    b, s_q, h, hkv, lengths, q8, alibi = ROWS[row]
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
          "B7": pa.paged_attention_dma_q8,
          "B7w": pa.paged_attention_dma_multi_q8}[row]
    if scales is None:
        return lambda: fn(q, pools[0], pools[1], lens, tables, **kw)
    return lambda: fn(q, pools[0], scales[0], pools[1], scales[1], lens,
                      tables, **kw)


def launcher(lib, split_pages, q, pools, scales, lens, tables, slopes):
    """One launch of a variant's few-rows kernel at ``split_pages`` pages
    a split, with its own workspace and zeroed counters."""
    b, h = q.shape[0], q.shape[-2]
    s_q = q.shape[1] if q.dim() == 4 else 1
    hkv = pools[0].shape[2] // D
    rows = h // hkv * s_q
    n_splits = -(-PPS // split_pages)
    ws = torch.empty(b * hkv * n_splits * rows * (D + 2), device="cuda")
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
        if scales is None:
            pages = (q.data_ptr(), pools[0].data_ptr(), pools[1].data_ptr())
            tail = (split_pages, scale)
        else:
            pages = (q.data_ptr(), pools[0].data_ptr(),
                     scales[0].data_ptr(), pools[1].data_ptr(),
                     scales[1].data_ptr())
            tail = (scales[0].shape[2], split_pages, scale)
        if q.dim() == 3:
            entry = ("merlin_paged_decode_bf16" if scales is None
                     else "merlin_paged_decode_q8")
            code = getattr(lib, entry)(*pages, *common, *shape, *tail,
                                       stream)
        else:
            entry = ("merlin_paged_window_bf16" if scales is None
                     else "merlin_paged_window_q8")
            code = getattr(lib, entry)(*pages, *common, *shape, *tail, 1,
                                       stream)
        if code:
            raise RuntimeError(f"{entry} failed: {code}")
    run.keep = (ws, counters, out)
    return run


def build(tmp: Path):
    """One library per variant, all compiled at once; returns {name:
    (CDLL, ptxas report of the few-rows kernel)}."""
    nvcc = _build._nvcc()
    procs = {}
    for name, edits in VARIANTS.items():
        src = SOURCE.read_text()
        for old, new in edits:
            if old not in src:
                raise RuntimeError(f"{name}: edit anchor not found")
            src = src.replace(old, new)
        d = tmp / name
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
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{out}")
        report, fn = {}, None
        for line in out.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                fn = m.group(1) if "paged_rows" in m.group(1) else None
                if fn:
                    report[fn] = {}
            m = re.search(r"(\d+) bytes spill stores", line)
            if m and fn:
                report[fn]["spill_store_bytes"] = int(m.group(1))
            m = re.search(r"Used (\d+) registers", line)
            if m and fn:
                report[fn]["registers"] = int(m.group(1))
        lib = ctypes.CDLL(str(tmp / name / "lib.so"))
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
    for row in ROWS:
        fn = wrapper(row, *inputs(gen, row))
        ms = sorted(time_ms(fn) for _ in range(rounds))[rounds // 2]
        us = sorted(host_us(fn) for _ in range(rounds))[rounds // 2]
        readings[row] = {"ms": ms, "host_us": us}
        print(f"{row} wrapper: {ms:.4f} ms, {us:.1f} us of host time a "
              f"call", flush=True)
    return readings


def variants(rounds: int = 3) -> dict:
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        t0 = time.perf_counter()
        libs = build(Path(tmp))
        print(f"built {len(libs)} variants in {time.perf_counter() - t0:.1f} "
              f"s", flush=True)
        for name, (_, report) in libs.items():
            print(f"ptxas {name}: {report}", flush=True)
        gen = torch.Generator(device="cuda").manual_seed(0)
        readings = {}
        for row in ROWS:
            args = inputs(gen, row)
            runs = {f"{n} split {sp * PAGE}": launcher(lib, sp, *args)
                    for n, (lib, _) in libs.items() for sp in SPLIT_PAGES}
            times = {n: [] for n in runs}
            for i in range(rounds):  # in turns, the order reversed each round
                for n in (list(runs) if i % 2 == 0 else list(runs)[::-1]):
                    times[n].append(time_ms(runs[n]))
            med = {n: sorted(t)[len(t) // 2] for n, t in times.items()}
            readings[row] = med
            print(f"{row} {ROWS[row]}: " + ", ".join(
                f"{n} {t:.4f} ms" for n, t in med.items()), flush=True)
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
        result = {"card": name, **variants()}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
