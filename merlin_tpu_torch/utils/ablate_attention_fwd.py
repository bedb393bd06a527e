"""Ablations of the dense attention forward (``csrc/attention_fwd.cu``).

Builds variants of the kernel source, each with one textual change (one
part of the work removed, or other tiles), next to the unchanged build, and
times them in turns on the same inputs at the shapes B1, B2 and B12 run on
the main path. The variants' outputs are not checked (a variant that drops
work is wrong by design); ``chip_smoke.py`` holds the real kernel to its
plain version. Prints the card, ptxas's registers and spill bytes per
variant, one line per shape, and the readings as one JSON line.

    python3 -m merlin_tpu_torch.utils.ablate_attention_fwd
"""

from __future__ import annotations

import ctypes
import json
import re
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

from merlin_tpu_torch.ops import _build

SOURCE = _build.CSRC / "attention_fwd.cu"
TILES = ("static constexpr int kWarpGroups = DP == 128 ? 2 : 1;\n"
         "  static constexpr int kKeys = DP == 128 ? 128 : 64;")


def tiles(d64, d128):
    """FwdTiles with (warpgroups, keys) at d = 64 and at d = 128."""
    return [(TILES,
             f"static constexpr int kWarpGroups = DP == 128 ? {d128[0]} : "
             f"DP == 64 ? {d64[0]} : 1;\n  static constexpr int kKeys = "
             f"DP == 128 ? {d128[1]} : DP == 64 ? {d64[1]} : 64;")]


SOFTMAX = ("    const int k0 = j * KEYS;\n"
           "    const int* ks = kseg_s + (j & 1) * KEYS;\n")

# variant -> textual edits of attention_fwd.cu (each anchor replaced
# wherever it stands)
VARIANTS = {
    "kernel": [],
    # the softmax pass left out: P is S packed, O is never rescaled
    "no_softmax": [(SOFTMAX, "    alpha[0] = alpha[1] = lsum[0] = "
                             "lsum[1] = 1.f;\n    if (j >= 0) return;\n"
                    + SOFTMAX)],
    # the loop's K/V copies left out (tiles 0 and 1 are reused)
    "no_loads": [("    if (j + 1 < n_tiles) load_k(j + 1);\n"
                  "    load_v(j);\n", "")],
    # query and key tiles: 64 rows / 64 keys at d = 128, 128 / 128 at 64
    "d128_64rows_64keys": tiles((1, 64), (1, 64)),
    "d128_64rows_128keys": tiles((1, 64), (1, 128)),
    "d64_128rows_128keys": tiles((2, 128), (2, 128)) + [
        ("DP == 64 ? 3 : 1", "1")],
}

SHAPES = (  # (b, s, h, d), causal, entry
    ((1, 512, 32, 128), True, "flash"),     # B2, the prompt
    ((1, 2048, 32, 128), True, "flash"),    # B2, training
    ((1, 1025, 16, 64), False, "onepass"),  # B1, one image
    ((8, 1025, 16, 64), False, "onepass"),  # B12, training
)


def build(tmp: Path):
    """One library per variant, all compiled at once; returns {name:
    (CDLL, ptxas report)}."""
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
            m = re.search(r"Compiling entry function '_ZN6merlin\d+(\w+?)I"
                          r"Li(\d+)ELi(\d+)ELi(\d+)E(Lb(\d))?", line)
            if m:
                fn = f"{m.group(1)}<{m.group(2)},{m.group(3)},{m.group(4)}" \
                     f"{',' + m.group(6) if m.group(6) else ''}>"
            m = re.search(r"(\d+) bytes spill stores", line)
            if m and fn:
                report[fn] = {"spill_store_bytes": int(m.group(1))}
            m = re.search(r"Used (\d+) registers", line)
            if m and fn:
                report[fn]["registers"] = int(m.group(1))
        lib = ctypes.CDLL(str(tmp / name / "lib.so"))
        for entry in ("merlin_flash_attention_fwd_bf16",
                      "merlin_onepass_attention_bf16"):
            getattr(lib, entry).argtypes = _build.SIGNATURES[entry]
            getattr(lib, entry).restype = ctypes.c_int
        libs[name] = (lib, report)
    return libs


def launcher(lib, q, k, v, causal, entry):
    """One call of the variant's B2 (flash) or B1/B12 (onepass) entry."""
    b, sq, h, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    strides = (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    stream = _build.stream_handle(q.device)

    def run():
        if entry == "flash":
            code = lib.merlin_flash_attention_fwd_bf16(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr(), None, None, None, b, sq, k.shape[1], h,
                k.shape[2], d, *strides, d ** -0.5, int(causal), stream)
        else:
            code = lib.merlin_onepass_attention_bf16(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr(), b, sq, k.shape[1], h, d, *strides,
                d ** -0.5, stream)
        if code:
            raise RuntimeError(f"launch failed: {code}")
    return run


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


def main(rounds: int = 3) -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("ablate_attention_fwd: no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
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
        for shape, causal, entry in SHAPES:
            q, k, v = (torch.randn(shape, generator=gen, device="cuda").to(
                torch.bfloat16) for _ in range(3))
            runs = {n: launcher(lib, q, k, v, causal, entry)
                    for n, (lib, _) in libs.items()}
            times = {n: [] for n in runs}
            for i in range(rounds):  # in turns, the order reversed each round
                for n in (list(runs) if i % 2 == 0 else list(runs)[::-1]):
                    times[n].append(time_ms(runs[n]))
            med = {n: sorted(t)[len(t) // 2] for n, t in times.items()}
            key = f"{entry} {shape} causal={causal}"
            readings[key] = med
            print(key + ": " + ", ".join(f"{n} {t:.4f} ms"
                                         for n, t in med.items()), flush=True)
    result = {"card": card, "ms": readings,
              "ptxas": {n: r for n, (_, r) in libs.items()}}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
