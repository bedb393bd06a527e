"""Batch collation to static shapes (a copy of ``merlin_tpu/data/collator.py``).

The reference pads to the longest sequence in the batch
(data/collator.py:12-34); JAX pads to fixed sizes, so that no batch shape
forces a recompile, and the port keeps its batches: sequences to
``model_max_length``, image stacks to ``max_images`` slots (zero images).
Emits the segment ids the model consumes directly.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from merlin_tpu_torch.utils.constants import IGNORE_INDEX


@dataclasses.dataclass
class Collator:
    pad_id: int
    max_length: int = 2048
    max_images: Optional[int] = None       # None -> batch max (dynamic!)
    image_size: int = 448
    # False (reference behavior): attention sees the whole packed sequence.
    # True: per-pair block-diagonal masking via the packed segment ids.
    use_packing_segments: bool = False

    def __call__(self, samples: Sequence[Dict[str, np.ndarray]]
                 ) -> Dict[str, np.ndarray]:
        b = len(samples)
        L = self.max_length
        input_ids = np.full((b, L), self.pad_id, np.int32)
        labels = np.full((b, L), IGNORE_INDEX, np.int32)
        segment_ids = np.zeros((b, L), np.int32)

        n_img = self.max_images or max(int(s["num_images"]) for s in samples)
        images = np.zeros((b, n_img, self.image_size, self.image_size, 3),
                          np.uint8)

        for i, s in enumerate(samples):
            ids = s["input_ids"][:L]
            n = len(ids)
            input_ids[i, :n] = ids
            labels[i, :n] = s["labels"][:L]
            if self.use_packing_segments and "segment_ids" in s:
                # +1 so padding (0) differs from the first segment
                segment_ids[i, :n] = s["segment_ids"][:L] + 1
            else:
                segment_ids[i, :n] = 1
            imgs = s["images"][:n_img]
            images[i, : len(imgs)] = imgs

        attention_mask = (input_ids != self.pad_id).astype(np.int32)
        # a fully-padded row would otherwise alias segment 0 everywhere
        segment_ids = np.where(attention_mask > 0, segment_ids, 0)
        return dict(input_ids=input_ids, labels=labels,
                    segment_ids=segment_ids, attention_mask=attention_mask,
                    images=images)
