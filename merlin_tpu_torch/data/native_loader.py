"""ctypes bindings for the native C++ tar-shard loader (a copy of
``merlin_tpu/data/native_loader.py``; the port's own source is
``merlin_tpu_torch/native/tar_loader.cc``).

The native loader replaces the stdlib tarfile path in
:mod:`merlin_tpu_torch.data.shards` when available: a C++ thread pool
streams shards (seed-shuffled infinite epochs) into a bounded queue off the
Python GIL, the host's equivalent of the reference's torch DataLoader
worker processes + webdataset C IO.

It is host code, not a kernel: the host compiler builds it at first use
(``c++ -O2 -std=c++17 -fPIC -pthread -shared``) into
``merlin_tpu_torch/native/build/`` and the library is cached there, rebuilt
when the source is newer. ``MERLIN_NATIVE_LOADER=0`` switches it off. When
it cannot be built, :func:`native_available` is False and
``shard_sample_stream`` reads with tarfile, as JAX does.
"""

from __future__ import annotations

import ctypes
import logging
import os
import struct
import subprocess
import threading
from typing import Dict, Iterator, List, Optional, Sequence

logger = logging.getLogger("merlin_tpu_torch.data")

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native")
_SOURCE = os.path.join(_NATIVE_DIR, "tar_loader.cc")
_SO_PATH = os.path.join(_NATIVE_DIR, "build", "libmerlin_loader.so")
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-pthread", "-shared")

_lib = None
_lib_lock = threading.Lock()


def build(force: bool = False) -> str:
    """Compile the loader with the host compiler (``$CXX``, else ``c++``)
    unless a library newer than the source is there; returns its path.
    The library is written under a temporary name and renamed, so
    processes that build at once never load a half-written file."""
    if not force and os.path.exists(_SO_PATH) and \
            os.path.getmtime(_SO_PATH) >= os.path.getmtime(_SOURCE):
        return _SO_PATH
    os.makedirs(os.path.dirname(_SO_PATH), exist_ok=True)
    tmp = f"{_SO_PATH}.{os.getpid()}.tmp"
    cmd = [os.environ.get("CXX", "c++"), *CXX_FLAGS, "-o", tmp, _SOURCE]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed:\n{proc.stderr[-2000:]}")
    os.replace(tmp, _SO_PATH)
    return _SO_PATH


def load_library() -> Optional[ctypes.CDLL]:
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        try:
            path = build()
        except Exception as e:
            logger.warning("native tar loader did not build: %s", e)
            return None
        lib = ctypes.CDLL(path)
        lib.mtl_open.restype = ctypes.c_void_p
        lib.mtl_open.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_uint64,
            ctypes.c_int, ctypes.c_int, ctypes.c_uint64]
        lib.mtl_open_at.restype = ctypes.c_void_p
        lib.mtl_open_at.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_uint64,
            ctypes.c_int, ctypes.c_int, ctypes.c_uint64, ctypes.c_uint64]
        lib.mtl_position.restype = ctypes.c_uint64
        lib.mtl_position.argtypes = [ctypes.c_void_p]
        lib.mtl_next.restype = ctypes.POINTER(ctypes.c_char)
        lib.mtl_next.argtypes = [ctypes.c_void_p,
                                 ctypes.POINTER(ctypes.c_uint64)]
        lib.mtl_free.argtypes = [ctypes.POINTER(ctypes.c_char)]
        lib.mtl_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def native_available() -> bool:
    if os.environ.get("MERLIN_NATIVE_LOADER", "1") == "0":
        return False
    return load_library() is not None


def _parse_sample(buf: bytes) -> Dict[str, bytes]:
    (n_fields,) = struct.unpack_from("<I", buf, 0)
    off = 4
    out: Dict[str, bytes] = {}
    for _ in range(n_fields):
        (name_len,) = struct.unpack_from("<I", buf, off)
        off += 4
        name = buf[off: off + name_len].decode()
        off += name_len
        (data_len,) = struct.unpack_from("<Q", buf, off)
        off += 8
        out[name] = buf[off: off + data_len]
        off += data_len
    return out


class NativeTarStream:
    """Iterator of sample dicts {field: bytes, '__key__': bytes} pulled from
    the C++ loader. Same contract as shards.tar_to_samples over an infinite
    shard list."""

    def __init__(self, shards: Sequence[str], *, seed: int = 3407,
                 queue_cap: int = 256, n_threads: int = 2,
                 max_epochs: int = 0, start_index: int = 0,
                 skip: Optional[Dict[int, int]] = None):
        lib = load_library()
        if lib is None:
            raise RuntimeError("native loader unavailable")
        self._lib = lib
        self._init_kwargs = dict(seed=seed, queue_cap=queue_cap,
                                 n_threads=n_threads, max_epochs=max_epochs)
        arr = (ctypes.c_char_p * len(shards))(
            *[s.encode() for s in shards])
        self._handle = lib.mtl_open_at(arr, len(shards), seed, queue_cap,
                                       n_threads, max_epochs, start_index)
        if not self._handle:
            raise RuntimeError("mtl_open failed (empty shard list?)")
        # sample-granular resume bookkeeping (consumer-thread only).
        # The skip prefix was consumed by the run that WROTE the cursor,
        # so it seeds _consumed: a checkpoint taken after this resume must
        # still report it, or a chained resume (checkpoint -> resume ->
        # checkpoint -> resume) would under-count the prefix and replay it.
        self._skip: Dict[int, int] = dict(skip or {})
        self._consumed: Dict[int, int] = dict(self._skip)

    # -- sample-granular resume cursor ----------------------------------
    # Every sample carries its global shard index ("__shard__",
    # tar_loader.cc push); per-shard delivery order is the tar order, so
    # the cursor is (earliest unfinished shard S, samples consumed per
    # shard >= S). Restoring reopens at S and skips exactly the consumed
    # prefix of each partially-consumed shard: no sample is lost or
    # replayed (multiset-exact with racing threads; bit-exact ORDER with
    # n_threads=1). Cursor methods must run on the consumer thread.
    def get_state(self) -> Dict:
        pos = int(self._lib.mtl_position(self._handle))
        consumed = {int(k): int(v) for k, v in self._consumed.items()
                    if k >= pos and v > 0}
        # prune fully-consumed history (< pos) so the cursor stays small
        self._consumed = dict(consumed)
        return {"shard_pos": pos, "consumed": consumed}

    @staticmethod
    def restore(shards: Sequence[str], state: Dict, **kwargs
                ) -> "NativeTarStream":
        skip = {int(k): int(v)
                for k, v in (state.get("consumed") or {}).items()}
        return NativeTarStream(shards, start_index=int(state["shard_pos"]),
                               skip=skip, **kwargs)

    def __iter__(self) -> Iterator[Dict[str, bytes]]:
        return self

    def __next__(self) -> Dict[str, bytes]:
        while True:
            n = ctypes.c_uint64()
            ptr = self._lib.mtl_next(self._handle, ctypes.byref(n))
            if not ptr or n.value == 0:
                raise StopIteration
            try:
                raw = ctypes.string_at(ptr, n.value)
            finally:
                self._lib.mtl_free(ptr)
            sample = _parse_sample(raw)
            shard = int(sample.pop("__shard__", b"-1"))
            if shard >= 0:
                left = self._skip.get(shard, 0)
                if left > 0:
                    # consumed before the checkpoint: drop (already counted
                    # into _consumed by __init__)
                    self._skip[shard] = left - 1
                    continue
                self._consumed[shard] = self._consumed.get(shard, 0) + 1
            key = sample.pop("__key__", b"")
            sample["__key__"] = key.decode(errors="replace")
            return sample

    def close(self):
        if getattr(self, "_handle", None):
            self._lib.mtl_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
