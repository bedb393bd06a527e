"""Build and load the port's CUDA kernels (``merlin_tpu_torch/csrc``).

Route (b) of a hand-written Hopper kernel: every ``csrc/*.cu`` is compiled
by ``nvcc`` for ``sm_90a`` with a plain C interface (no PyTorch headers, so
a build takes seconds, not minutes), linked into one shared library and
loaded with :mod:`ctypes`. The sources compile in parallel, one ``nvcc``
each. The library lands in ``csrc/build/`` (listed in ``.gitignore``)
under a name that hashes the sources, so an edited source rebuilds and an
unchanged one loads the library already built. ptxas reports each
kernel's registers, shared memory and spills (``-Xptxas -v``); the report
is kept beside the library (:func:`ptxas_log`).

Every C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` raises on a non-zero code. Each
wrapper counts its launches (:func:`count_launch`); a CUDA graph's replay
calls no wrapper, so whoever replays one adds the launches its capture
counted (:func:`recorded_launches`, :func:`add_launches`).
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Iterator, List, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_int64
_F = ctypes.c_float

# argtypes of every C entry point: pointers and the stream as c_void_p
# (a plain int would be cut to 32 bits)
SIGNATURES = {
    # q, k, v, out, lse (or NULL), b, sq, skv, h, d, q/k/v strides (b, s,
    # h), scale, stream
    "merlin_onepass_attention_bf16": (
        [_P] * 5 + [_I] * 5 + [_L] * 9 + [_F, _P]),
    # q, k, v, out, lse, qseg, kseg, slopes, b, sq, skv, h, hkv, d,
    # q/k/v strides (b, s, h), scale, causal, stream
    "merlin_flash_attention_fwd_bf16": (
        [_P] * 8 + [_I] * 6 + [_L] * 9 + [_F, _I, _P]),
    # q, k, v, out (or NULL), do, lse, di, dq_acc, dq, dk, dv, qseg, kseg,
    # slopes, b, sq, skv, h, hkv, d, q/k/v/do/out strides (b, s, h), scale,
    # causal, stream
    "merlin_flash_attention_bwd_bf16": (
        [_P] * 14 + [_I] * 6 + [_L] * 15 + [_F, _I, _P]),
    # q, k_pages, v_pages, lengths, tables, slopes, out, ws, counters, b,
    # h, hkv, d, page_size, pages_per_seq, split_pages, scale, stream
    "merlin_paged_decode_bf16": [_P] * 9 + [_I] * 7 + [_F, _P],
    # q, k_pages, v_pages, lengths, tables, slopes, out, ws, counters, b,
    # s_q, h, hkv, d, page_size, pages_per_seq, split (few-rows kernel:
    # pages a key split; window kernel: most key splits a row tile), scale,
    # few_rows, stream
    "merlin_paged_window_bf16": [_P] * 9 + [_I] * 8 + [_F, _I, _P],
    # q, k_pages, k_scales, v_pages, v_scales, lengths, tables, slopes, out,
    # ws, counters, b, h, hkv, d, page_size, pages_per_seq, scale_lanes,
    # split_pages, scale, stream
    "merlin_paged_decode_q8": [_P] * 11 + [_I] * 8 + [_F, _P],
    # q, k_pages, k_scales, v_pages, v_scales, lengths, tables, slopes, out,
    # ws, counters, b, s_q, h, hkv, d, page_size, pages_per_seq,
    # scale_lanes, split, scale, few_rows, stream
    "merlin_paged_window_q8": [_P] * 11 + [_I] * 9 + [_F, _I, _P],
    # the dense f32 kernels (3xTF32): q, k, v, out, lse (or NULL), qseg,
    # kseg, slopes, b, sq, skv, h, hkv, d, q/k/v strides (b, s, h), scale,
    # causal, stream
    "merlin_attention_f32": [_P] * 8 + [_I] * 6 + [_L] * 9 + [_F, _I, _P],
    # q, k, v, out (or NULL), do, lse, di, dq, dk, dv, qseg, kseg, slopes,
    # b, sq, skv, h, hkv, d, q/k/v/do/out strides (b, s, h), scale, causal,
    # stream
    "merlin_attention_bwd_f32": (
        [_P] * 13 + [_I] * 6 + [_L] * 15 + [_F, _I, _P]),
    # q, k_pages, k_scales, v_pages, v_scales, lengths, tables, slopes,
    # out, ws, counters, b, s_q, h, hkv, d, page_size, pps, scale_lanes,
    # q_bf16, page_kind (0 bf16, 1 f32, 2 int8), bf16_ops, split (few-rows
    # kernel: pages a key split; window kernel: most key splits of a
    # sequence), few_rows, scale, stream
    "merlin_paged_attention_f32": [_P] * 11 + [_I] * 13 + [_F, _P],
}

_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the port's CUDA "
                       "kernels are built from source on first use")


def sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    digest = hashlib.sha256()
    for src in sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libmerlin_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels (one nvcc per source, all at once) and link
    them; returns the library path. A no-op when it is already built."""
    target = library_path()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    cu = sorted(CSRC.glob("*.cu"))
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (src.stem + ".o") for src in cu]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(cu, objs)]
        failed, report = [], []
        for src, proc in zip(cu, procs):
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{src.name}:\n{out}")
            report.append(f"{src.name}:\n{out}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp_lib = Path(tmp) / target.name
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o",
             str(tmp_lib)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + link.stdout)
        target.with_suffix(".log").write_text("".join(report))
        os.replace(tmp_lib, target)
    return target


def ptxas_log() -> str:
    """What nvcc and ptxas printed while building the library (registers,
    shared memory and spill bytes of every kernel)."""
    return build().with_suffix(".log").read_text()


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        handle.merlin_error_string.argtypes = [ctypes.c_int]
        handle.merlin_error_string.restype = ctypes.c_char_p
        _lib = handle
    return _lib


def check(code: int, what: str) -> None:
    """Raise when a C entry point reports a CUDA error."""
    if code != 0:
        msg = lib().merlin_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


_recorders: List[collections.Counter] = []


def count_launch(wrapper, f32: bool, n: int = 1) -> None:
    """``n`` launches of ``wrapper``'s kernel: the bf16 kernel counts in
    ``wrapper.launches``, the f32 kernel in ``wrapper.launches_f32``."""
    attr = "launches_f32" if f32 else "launches"
    setattr(wrapper, attr, getattr(wrapper, attr) + n)
    for counts in _recorders:
        counts[wrapper, f32] += n


@contextlib.contextmanager
def recorded_launches() -> Iterator[collections.Counter]:
    """The launches counted inside the block, (wrapper, f32) -> count."""
    counts = collections.Counter()
    _recorders.append(counts)
    try:
        yield counts
    finally:
        _recorders.remove(counts)


def add_launches(counts: collections.Counter, times: int = 1) -> None:
    """Count each launch of ``counts`` (from :func:`recorded_launches`)
    ``times`` times more."""
    for (wrapper, f32), n in counts.items():
        count_launch(wrapper, f32, n * times)


def stream_handle(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def check_qkv(name: str, q, k, v, *, max_d: int) -> None:
    """Raise unless q/k/v are what the attention kernels read: one dtype,
    bf16 (the wgmma kernels) or f32 (the 3xTF32 kernels), as the JAX dense
    path gives them, on one CUDA device, (b, s, h, d) with the same b and
    d, d % 8 == 0 and <= max_d, the head dim contiguous, every other
    stride and each base pointer 16-byte aligned (the kernels load 16
    bytes at a time: 8 bf16 or 4 f32)."""
    import torch

    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: q must be bfloat16 or float32, got "
                         f"{q.dtype}")
    for t, tn in ((k, "k"), (v, "v")):
        if t.dtype != q.dtype:
            raise ValueError(f"{name}: {tn} must be {q.dtype} as q is, got "
                             f"{t.dtype}")
    for t, tn in ((q, "q"), (k, "k"), (v, "v")):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name}: {tn} must be on q's CUDA device, "
                             f"got {t.device}")
        if t.dim() != 4:
            raise ValueError(f"{name}: {tn} must be (b, s, h, d), got "
                             f"{tuple(t.shape)}")
        per16 = 16 // t.element_size()
        if t.stride(3) != 1 or any(s % per16 for s in t.stride()[:3]):
            raise ValueError(f"{name}: {tn} strides {t.stride()} must keep "
                             f"d contiguous and the rest multiples of {per16}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {tn} is not 16-byte aligned")
    b, _, _, d = q.shape
    if k.shape[0] != b or v.shape[0] != b or k.shape[3] != d \
            or v.shape[3] != d or k.shape != v.shape:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)} k "
                         f"{tuple(k.shape)} v {tuple(v.shape)} disagree")
    if d % 8 or d > max_d:
        raise ValueError(f"{name}: head dim {d} must be a multiple of 8 "
                         f"and at most {max_d}")
