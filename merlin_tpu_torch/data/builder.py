"""Dataset factory + host dataloader (a copy of ``merlin_tpu/data/builder.py``;
reference data/builder.py:13-79).

``build_dataloader`` instantiates one dataset per '+'-separated registry
name per family flag, concatenates them, and returns the training iterator
pieces. ``batch_iterator`` is a thread-prefetched Python iterator (the
host's equivalent of torch DataLoader workers): batches are numpy; the
``Trainer`` copies them to the device, where the train step normalizes the
images.

Two deliberate differences from JAX:
  * C34: JAX's producer thread catches only ``StopIteration``; any other
    exception from a dataset or the collator ends the thread and leaves the
    consumer blocked on the queue for ever. Here the producer hands its
    exception over and the consumer raises it; a producer that runs out
    (``StopIteration``) ends the iteration.
  * C35: the resume cursor a batch carries also counts the sampler indices
    drawn so far. JAX's holds the streams' cursors only, so a resumed run
    starts the sampler's order again: which dataset each sample comes from,
    and every map-style (conversation) sample, repeat from the start.
    :func:`resume_data` loads a cursor and returns the index to start at.
"""

from __future__ import annotations

import itertools
import queue
import threading
from typing import Dict, Iterator, List, Optional, Sequence

from merlin_tpu_torch.data.collator import Collator
from merlin_tpu_torch.data.conversation_dataset import ConversationDataset
from merlin_tpu_torch.data.registry import parse_dataset_flag
from merlin_tpu_torch.data.sampler import LengthGroupedSampler
from merlin_tpu_torch.data.webdatasets import (
    InterleaveWebDataset, InterPairWebDataset, MultimodalCfg,
    PairTokenWebDataset, PairWebDataset)


class ConcatDataset:
    def __init__(self, datasets: Sequence):
        self.datasets = list(datasets)
        self._sizes = [len(d) for d in self.datasets]

    def __len__(self):
        return sum(self._sizes)

    def __getitem__(self, i):
        for d, n in zip(self.datasets, self._sizes):
            if i < n:
                return d[i]
            i -= n
        raise IndexError(i)

    @property
    def lengths(self):
        out = []
        for d in self.datasets:
            out.extend(getattr(d, "lengths", [1] * len(d)))
        return out

    @property
    def modality_lengths(self):
        out = []
        for d in self.datasets:
            out.extend(getattr(d, "modality_lengths", [1] * len(d)))
        return out

    # -- resume cursor: one entry per child (None where unsupported) ------
    def data_state(self):
        return [d.data_state() if hasattr(d, "data_state") else None
                for d in self.datasets]

    def load_data_state(self, states):
        for d, s in zip(self.datasets, states or []):
            if s is not None and hasattr(d, "load_data_state"):
                d.load_data_state(s)


def build_dataloader(tokenizer, special_ids, data_args, training_args,
                     *, process_index: Optional[int] = None,
                     process_count: Optional[int] = None) -> Dict:
    """Returns {train_dataset, collator, sampler} (reference returns trainer
    kwargs the same way, data/builder.py:77-79)."""
    mm_cfg = MultimodalCfg(
        image_token_len=data_args.num_patches,
        use_im_start_end=True,
        image_size=data_args.image_size,
        image_aspect_ratio=data_args.image_aspect_ratio,
        box_limit=data_args.box_limit)
    common = dict(model_max_length=training_args.model_max_length,
                  seed=training_args.seed)
    stream_common = dict(process_index=process_index,
                         process_count=process_count,
                         resumable=getattr(training_args, "resumable_data",
                                           True),
                         **common)

    datasets: List = []
    if data_args.conversation_datasets:
        datasets.append(ConversationDataset(
            data_args.conversation_datasets, tokenizer, special_ids, mm_cfg,
            **common))
    for flag, cls in [(data_args.pair_datasets, PairWebDataset),
                      (data_args.pair_token_datasets, PairTokenWebDataset),
                      (data_args.interpair_datasets, InterPairWebDataset),
                      (data_args.interleave_datasets, InterleaveWebDataset)]:
        if flag:
            for name in parse_dataset_flag(flag):
                datasets.append(cls(name, tokenizer, special_ids, mm_cfg,
                                    **stream_common))
    if not datasets:
        raise ValueError("no datasets specified")
    train_dataset = (datasets[0] if len(datasets) == 1
                     else ConcatDataset(datasets))

    collator = Collator(
        pad_id=tokenizer.pad_token_id,
        max_length=training_args.model_max_length,
        max_images=getattr(data_args, "max_images", None),
        image_size=data_args.image_size,
        use_packing_segments=getattr(training_args, "packing_segment_mask",
                                     False))

    sampler = None
    if getattr(training_args, "group_by_modality_length", False) and \
            hasattr(train_dataset, "modality_lengths"):
        sampler = LengthGroupedSampler(
            training_args.per_device_train_batch_size,
            world_size=process_count or 1,
            lengths=train_dataset.modality_lengths,
            group_by_modality=True, seed=training_args.seed)
    return dict(train_dataset=train_dataset, collator=collator,
                sampler=sampler)


_END = object()


def batch_iterator(dataset, collator: Collator, *, batch_size: int,
                   sampler=None, prefetch: int = 2,
                   max_images: Optional[int] = None,
                   start: int = 0) -> Iterator[Dict]:
    """Batches forever (streaming datasets are infinite by construction);
    a background thread keeps `prefetch` collated batches ready.

    Every batch carries a ``__data_state__`` cursor taken right after its
    samples were drawn: ``{"indices": sampler indices drawn so far,
    "streams": dataset.data_state()}`` (``streams`` only when the dataset
    has a resume cursor). The cursor rides WITH the batch through the
    prefetch queues, so the trainer checkpoints the cursor of the batches
    it consumed, not of the ones in flight. ``start`` skips that many
    indices (see :func:`resume_data`). The producer's exceptions are
    raised here (C34); closing the iterator stops the producer."""
    if max_images is not None:
        collator.max_images = max_images
    track_state = hasattr(dataset, "data_state")

    def indices():
        while True:
            it = iter(sampler) if sampler is not None else iter(
                range(len(dataset)))
            yield from it

    q: queue.Queue = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def produce():
        try:
            batch, drawn = [], start
            for i in itertools.islice(indices(), start, None):
                batch.append(dataset[i])
                drawn += 1
                if len(batch) == batch_size:
                    out = collator(batch)
                    state = {"indices": drawn}
                    if track_state:
                        state["streams"] = dataset.data_state()
                    out["__data_state__"] = state
                    if not put(out):
                        return
                    batch = []
        except StopIteration:
            put(_END)
        except BaseException as e:  # C34: raised in the consumer
            put(e)

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is _END:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()


def resume_data(dataset, state: Optional[Dict]) -> int:
    """Load a batch's ``__data_state__`` (as the trainer checkpoints it)
    into ``dataset``; returns the ``start`` for :func:`batch_iterator`."""
    if not state:
        return 0
    if state.get("streams") is not None and \
            hasattr(dataset, "load_data_state"):
        dataset.load_data_state(state["streams"])
    return int(state.get("indices", 0))
