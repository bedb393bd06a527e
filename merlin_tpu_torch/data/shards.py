"""Tar-shard streaming: the webdataset pipeline rebuilt on the stdlib (a
copy of ``merlin_tpu/data/shards.py``).

Reference pipeline (pair_webdataset.py:38-49):
  InfiniteShardList(seed=3407) -> shuffle(world_size, rng=42) -> split_by_node
  -> split_by_worker -> tarfile_to_samples -> shuffle(1000, weak) -> decode

Here each stage is a small generator; distribution is by process index
(``torch.distributed``'s rank when a process group is initialized, else 0
of 1: :func:`process_index_count`) and an optional worker id.
Every stage swallows-and-logs per-sample failures (the reference's
``warn_and_continue`` fault tolerance, SURVEY.md §5).
"""

from __future__ import annotations

import logging
import os
import random
import tarfile
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

logger = logging.getLogger("merlin_tpu_torch.data")

IMAGE_EXTS = ("jpg", "jpeg", "png", "webp")


def process_index_count() -> Tuple[int, int]:
    """(rank, world size) of the initialized ``torch.distributed`` process
    group, else (0, 1): the port's ``jax.process_index()`` and
    ``jax.process_count()``."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def infinite_shard_list(shards: Sequence[str], seed: int = 3407
                        ) -> Iterator[str]:
    """Yield shards forever, reshuffled each epoch from a deterministic seed
    (webdataset InfiniteShardList semantics)."""
    shards = list(shards)
    if not shards:
        raise ValueError("empty shard list")
    rng = random.Random(seed)
    while True:
        epoch = list(shards)
        rng.shuffle(epoch)
        yield from epoch


def split_by_host(it: Iterator[str], *, process_index: Optional[int] = None,
                  process_count: Optional[int] = None) -> Iterator[str]:
    """Round-robin shard assignment per host (split_by_node equivalent)."""
    if process_index is None:
        process_index, process_count = process_index_count()
    for i, shard in enumerate(it):
        if i % process_count == process_index:
            yield shard


def split_by_worker(it: Iterator[str], worker_id: int = 0,
                    num_workers: int = 1) -> Iterator[str]:
    for i, shard in enumerate(it):
        if i % num_workers == worker_id:
            yield shard


def _open_shard(path: str):
    """Local file or remote object. s3:// goes through the credentialed
    storage adapter (boto3 when available, env endpoint/keys — the
    reference's boto3/megfile path, base_dataset.py:33-35), other remote
    schemes through fsspec."""
    if "://" in path:
        from merlin_tpu_torch.data.storage import smart_open

        return smart_open(path, "rb")
    return open(path, "rb")


def indexed_tar_samples(shard: str) -> Iterator[tuple]:
    """One shard's grouped samples as (raw_index, sample) — the raw index
    is the sample's position among ALL grouped samples in the tar, the
    stable coordinate the resume cursor uses."""
    with tarfile.open(fileobj=_open_shard(shard), mode="r|*") as tf:
        idx = 0
        current_key = None
        sample: Dict[str, bytes] = {}
        for member in tf:
            if not member.isfile():
                continue
            name = os.path.basename(member.name)
            if "." not in name:
                continue
            key, ext = name.split(".", 1)
            ext = ext.lower()
            if current_key is not None and key != current_key:
                if sample:
                    sample["__key__"] = current_key
                    yield idx, sample
                    idx += 1
                sample = {}
            current_key = key
            data = tf.extractfile(member)
            if data is not None:
                sample[ext] = data.read()
        if sample and current_key is not None:
            sample["__key__"] = current_key
            yield idx, sample


def tar_to_samples(shard_it: Iterator[str]) -> Iterator[Dict[str, bytes]]:
    """Stream tar members grouped by key (basename before first dot) into
    sample dicts {ext: bytes, '__key__': key}."""
    for shard in shard_it:
        try:
            for _, sample in indexed_tar_samples(shard):
                yield sample
        except Exception as e:  # skip-and-continue fault tolerance
            logger.warning("shard %s failed: %s", shard, e)
            continue


def buffer_shuffle(it: Iterator, bufsize: int = 1000,
                   seed: int = 42) -> Iterator:
    """Weak shuffle through a bounded reservoir (wds.shuffle(1000))."""
    rng = random.Random(seed)
    buf: List = []
    for item in it:
        if len(buf) < bufsize:
            buf.append(item)
            continue
        idx = rng.randrange(bufsize)
        yield buf[idx]
        buf[idx] = item
    rng.shuffle(buf)
    yield from buf


def has_caption_and_image(sample: Dict[str, bytes]) -> bool:
    """wds filter_no_caption_or_no_image equivalent. Image fields may be
    compound (interpair frames are stored as key.frameN.jpg -> field
    'frameN.jpg'), so match by suffix."""
    has_img = any(k.endswith(IMAGE_EXTS) for k in sample if k != "__key__")
    has_txt = "txt" in sample or "json" in sample
    return has_img and has_txt


def first_image_bytes(sample: Dict[str, bytes]) -> Optional[bytes]:
    for ext in IMAGE_EXTS:
        if ext in sample:
            return sample[ext]
    for k, v in sample.items():
        if k != "__key__" and k.endswith(IMAGE_EXTS):
            return v
    return None


class ResumableSampleStream:
    """The python shard pipeline with an EXACT-resume cursor.

    Yields the same sample sequence as the composed generators in
    :func:`shard_sample_stream` (same stages, same rng seeds), but tracks a
    checkpointable cursor: ``get_state()`` returns a small dict (rng state,
    current shard index in this worker's substream, raw sample offset in
    that shard, and the shuffle reservoir's samples as (shard, index)
    COORDINATES — ~16KB for the default 1000-buffer, not megabytes of
    pixels). ``set_state()`` re-fetches the reservoir by coordinate
    (bounded I/O: the few shards the reservoir spans), skims the current
    shard to the offset, and continues bit-identically to an uninterrupted
    run. The reference explicitly cannot checkpoint webdataset state
    (SURVEY.md §5 "data-stream state is NOT checkpointed"): a resume there
    replays the stream from zero.
    """

    def __init__(self, shards: Sequence[str], *, seed: int = 3407,
                 shard_shuffle_seed: int = 42, sample_buffer: int = 1000,
                 process_index: Optional[int] = None,
                 process_count: Optional[int] = None,
                 worker_id: int = 0, num_workers: int = 1,
                 select=has_caption_and_image):
        self.shards = list(shards)
        self.seed = seed
        self.shard_shuffle_seed = shard_shuffle_seed
        self.bufsize = sample_buffer
        self.process_index = process_index
        self.process_count = process_count
        self.worker_id = worker_id
        self.num_workers = num_workers
        self.select = select

        self._rng = random.Random(shard_shuffle_seed)
        self._buf: List[tuple] = []     # [((shard_pos, raw_idx), sample)]
        self._shard_pos = -1            # current shard in the substream
        self._raw_idx = 0               # raw samples consumed from it
        self._shard_iter = self._shard_paths()
        self._cur: Iterator = iter(())

    def _shard_paths(self) -> Iterator[str]:
        """This worker's deterministic infinite shard substream (the same
        stage composition shard_sample_stream uses)."""
        it = infinite_shard_list(self.shards, self.seed)
        it = buffer_shuffle(it, bufsize=max(self.process_count or 1, 1),
                            seed=self.shard_shuffle_seed)
        it = split_by_host(it, process_index=self.process_index,
                           process_count=self.process_count)
        return split_by_worker(it, self.worker_id, self.num_workers)

    def _shard_path_at(self, pos: int) -> str:
        """Path of substream shard `pos` by deterministic replay (host-side
        string work only, no I/O)."""
        it = self._shard_paths()
        for _ in range(pos):
            next(it)
        return next(it)

    # -- upstream: next selected sample with its coordinate --------------
    def _next_selected(self):
        while True:
            for idx, sample in self._cur:
                self._raw_idx = idx + 1
                if self.select(sample):
                    return (self._shard_pos, idx), sample
            self._shard_pos += 1
            self._raw_idx = 0
            path = next(self._shard_iter)
            try:
                self._cur = indexed_tar_samples(path)
            except Exception as e:  # skip-and-continue fault tolerance
                logger.warning("shard %s failed: %s", path, e)
                self._cur = iter(())

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, bytes]:
        # identical reservoir algorithm (and seed) to buffer_shuffle
        while len(self._buf) < self.bufsize:
            try:
                self._buf.append(self._next_selected())
            except StopIteration:
                break
        item = self._next_selected()
        i = self._rng.randrange(len(self._buf))
        _, out = self._buf[i]
        self._buf[i] = item
        return out

    # -- cursor -----------------------------------------------------------
    def get_state(self) -> Dict:
        return {
            "shard_pos": self._shard_pos,
            "raw_idx": self._raw_idx,
            "rng": self._rng.getstate(),
            "buffer": [coord for coord, _ in self._buf],
        }

    def set_state(self, state: Dict):
        self._rng.setstate(tuple(
            tuple(x) if isinstance(x, list) else x for x in state["rng"]))
        # re-fetch the reservoir by coordinate, grouped per shard
        coords = [tuple(c) for c in state["buffer"]]
        fetched: Dict[tuple, Dict] = {}
        by_shard: Dict[int, set] = {}
        for sp, ri in coords:
            by_shard.setdefault(sp, set()).add(ri)
        for sp, want in sorted(by_shard.items()):
            path = self._shard_path_at(sp)
            for idx, sample in indexed_tar_samples(path):
                if idx in want:
                    fetched[(sp, idx)] = sample
                    want.discard(idx)
                    if not want:
                        break
        missing = [c for c in coords if c not in fetched]
        if missing:
            raise ValueError(f"resume: {len(missing)} reservoir samples "
                             f"not found (shards changed?): {missing[:3]}")
        self._buf = [(c, fetched[c]) for c in coords]

        # position the live cursor: shard_iter must next yield pos+1;
        # the current shard is reopened and skimmed to raw_idx
        self._shard_pos = int(state["shard_pos"])
        self._raw_idx = int(state["raw_idx"])
        self._shard_iter = self._shard_paths()
        self._cur = iter(())
        if self._shard_pos >= 0:
            for _ in range(self._shard_pos):
                next(self._shard_iter)
            path = next(self._shard_iter)
            try:
                it = indexed_tar_samples(path)
                self._cur = (pair for pair in it if pair[0] >= self._raw_idx)
            except Exception as e:
                logger.warning("resume: shard %s failed: %s", path, e)


def shard_sample_stream(shards: Sequence[str], *, seed: int = 3407,
                        shard_shuffle_seed: int = 42,
                        sample_buffer: int = 1000,
                        process_index: Optional[int] = None,
                        process_count: Optional[int] = None,
                        worker_id: int = 0, num_workers: int = 1,
                        select=has_caption_and_image,
                        use_native: Optional[bool] = None,
                        resumable: bool = False
                        ) -> Iterator[Dict[str, bytes]]:
    """The full reference pipeline as one composed iterator.

    When the native C++ loader is available (and shards are local files),
    tar reading + sample grouping run on C++ threads off the GIL; the
    shard set is statically split per host/worker and the loader handles
    seed-shuffled infinite epochs. Fallback, as in JAX, with a warning:
    the pure-Python stages (``use_native=None`` only; ``True`` raises when
    the loader cannot be built).

    ``resumable=True`` returns a :class:`ResumableSampleStream` (python
    stages; the native loader has no cursor yet) whose state can be
    checkpointed and restored mid-shard."""
    if resumable:
        return ResumableSampleStream(
            shards, seed=seed, shard_shuffle_seed=shard_shuffle_seed,
            sample_buffer=sample_buffer, process_index=process_index,
            process_count=process_count, worker_id=worker_id,
            num_workers=num_workers, select=select)
    if use_native is None:
        try:
            from merlin_tpu_torch.data.native_loader import native_available
            use_native = native_available() and all(
                os.path.exists(s) for s in shards)
        except Exception:
            use_native = False
        if not use_native:
            logger.warning("native tar loader not used (not built, switched "
                           "off, or remote shards): reading with tarfile")

    if use_native:
        from merlin_tpu_torch.data.native_loader import NativeTarStream

        if process_index is None:
            process_index, process_count = process_index_count()
        stride = (process_count or 1) * num_workers
        offset = (process_index or 0) * num_workers + worker_id
        subset = [s for i, s in enumerate(sorted(shards))
                  if i % stride == offset] or list(shards)
        samples: Iterator[Dict[str, bytes]] = NativeTarStream(
            subset, seed=seed, n_threads=2)
    else:
        it = infinite_shard_list(shards, seed)
        it = buffer_shuffle(it, bufsize=max(process_count or 1, 1),
                            seed=shard_shuffle_seed)
        it = split_by_host(it, process_index=process_index,
                           process_count=process_count)
        it = split_by_worker(it, worker_id, num_workers)
        samples = tar_to_samples(it)
    samples = (s for s in samples if select(s))
    return buffer_shuffle(samples, bufsize=sample_buffer,
                          seed=shard_shuffle_seed)
