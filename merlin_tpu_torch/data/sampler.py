"""Length-grouped, modality-aware batch sampling (a copy of
``merlin_tpu/data/sampler.py``; reference data/sampler.py:8-103, LLaVA
lineage). The numpy RNG calls are JAX's, so the indices are equal.

Pure index math over a lengths list: shuffle -> megabatches of
world_size*batch_size sorted by length (desc) -> each megabatch split into
per-rank chunks balanced by total length. ``group_by_modality`` keeps
multimodal (length > 0) and language-only (length < 0) samples in separate
megabatches.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


def split_to_even_chunks(indices: Sequence[int], lengths: Sequence[int],
                         num_chunks: int) -> List[List[int]]:
    if len(indices) % num_chunks != 0:
        return [list(indices[i::num_chunks]) for i in range(num_chunks)]
    per_chunk = len(indices) // num_chunks
    chunks: List[List[int]] = [[] for _ in range(num_chunks)]
    totals = [0.0] * num_chunks
    for idx in indices:
        shortest = int(np.argmin(totals))
        chunks[shortest].append(idx)
        totals[shortest] += abs(lengths[idx])
        if len(chunks[shortest]) == per_chunk:
            totals[shortest] = float("inf")
    return chunks


def get_length_grouped_indices(lengths: Sequence[int], batch_size: int,
                               world_size: int,
                               rng: np.random.Generator) -> List[int]:
    perm = rng.permutation(len(lengths))
    mb = batch_size * world_size
    megabatches = [perm[i: i + mb].tolist() for i in range(0, len(perm), mb)]
    megabatches = [sorted(m, key=lambda i: abs(lengths[i]), reverse=True)
                   for m in megabatches]
    megabatches = [split_to_even_chunks(m, lengths, world_size)
                   for m in megabatches]
    return [i for m in megabatches for chunk in m for i in chunk]


def get_modality_length_grouped_indices(lengths: Sequence[int],
                                        batch_size: int, world_size: int,
                                        rng: np.random.Generator) -> List[int]:
    assert all(l != 0 for l in lengths), "zero-length sample"
    if all(l > 0 for l in lengths) or all(l < 0 for l in lengths):
        return get_length_grouped_indices(lengths, batch_size, world_size, rng)

    mm = [(i, l) for i, l in enumerate(lengths) if l > 0]
    lang = [(i, l) for i, l in enumerate(lengths) if l < 0]
    mm_shuffle = [mm[j][0] for j in get_length_grouped_indices(
        [l for _, l in mm], batch_size, world_size, rng)]
    lang_shuffle = [lang[j][0] for j in get_length_grouped_indices(
        [-l for _, l in lang], batch_size, world_size, rng)]

    mb = batch_size * world_size
    mm_mbs = [mm_shuffle[i: i + mb] for i in range(0, len(mm_shuffle), mb)]
    lang_mbs = [lang_shuffle[i: i + mb]
                for i in range(0, len(lang_shuffle), mb)]
    additional = (mm_mbs.pop() if mm_mbs else []) + \
                 (lang_mbs.pop() if lang_mbs else [])
    megabatches = mm_mbs + lang_mbs
    order = rng.permutation(len(megabatches))
    megabatches = [megabatches[i] for i in order]
    if additional:
        megabatches.append(sorted(
            additional, key=lambda i: abs(lengths[i]), reverse=True))
    return [i for m in megabatches for i in m]


class LengthGroupedSampler:
    """Iterable of dataset indices (reference data/sampler.py:73-103)."""

    def __init__(self, batch_size: int, world_size: int,
                 lengths: Sequence[int], *, group_by_modality: bool = False,
                 seed: int = 0):
        self.batch_size = batch_size
        self.world_size = world_size
        self.lengths = list(lengths)
        self.group_by_modality = group_by_modality
        self.seed = seed
        self._epoch = 0

    def set_epoch(self, epoch: int):
        self._epoch = epoch

    def __len__(self):
        return len(self.lengths)

    def __iter__(self):
        rng = np.random.default_rng(self.seed + self._epoch)
        if self.group_by_modality:
            idx = get_modality_length_grouped_indices(
                self.lengths, self.batch_size, self.world_size, rng)
        else:
            idx = get_length_grouped_indices(
                self.lengths, self.batch_size, self.world_size, rng)
        return iter(idx)
