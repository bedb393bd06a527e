"""N-pair sequence packing with task-prompt masking (a copy of
``merlin_tpu/data/packing.py``: the pretrain tokenizer path, reference
pair_webdataset.py:53-153 / interpair_webdataset.py:53-130).

``merge_round`` image-text pairs are concatenated into one model_max_length
sequence: each pair contributes [optional prompt tokens][text tokens + EOS];
prompt tokens and image special tokens are label-masked; a pair that would
overflow stops the pack and clips the image list to the images actually
referenced (so downstream never sees truncated image-token runs).

Per-pair ``segment_ids`` are emitted (JAX's addition). The reference trains
WITHOUT block-diagonal attention between merged pairs (README "without
separating the attention mask"); passing the segment ids to the model is
therefore optional (TrainingArguments.packing_segment_mask).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

from merlin_tpu_torch.utils import constants as C
from merlin_tpu_torch.utils.constants import IGNORE_INDEX


@dataclasses.dataclass
class PackedSample:
    input_ids: np.ndarray        # (L,) int32
    labels: np.ndarray           # (L,) int32, IGNORE_INDEX-masked
    segment_ids: np.ndarray      # (L,) int32, one id per merged pair
    num_images_used: int         # images surviving overflow clipping
    num_pairs_used: int


def make_replace_token(image_token_len: int, use_im_start_end: bool) -> str:
    token = C.DEFAULT_IM_PATCH_TOKEN * image_token_len
    if use_im_start_end:
        token = C.DEFAULT_IM_START_TOKEN + token + C.DEFAULT_IM_END_TOKEN
    return token


def add_image_token_pair(text: str, replace_token: str) -> str:
    """Pair datasets: replace <image>, else prepend (pair_webdataset.py:61-66)."""
    if C.DEFAULT_IMAGE_TOKEN in text:
        return text.replace(C.DEFAULT_IMAGE_TOKEN, replace_token)
    return replace_token + "\n" + text


def add_image_token_interpair(text: str, replace_token: str) -> str:
    """Interpair: disambiguate track (no newline) vs detection (with newline)
    image tokens (interpair_webdataset.py:53-61)."""
    if C.DEFAULT_IMAGE_TOKEN + "\n" in text:
        return text.replace(C.DEFAULT_IMAGE_TOKEN, replace_token)
    if C.DEFAULT_IMAGE_TOKEN in text:
        return text.replace(C.DEFAULT_IMAGE_TOKEN, replace_token + "\n")
    return replace_token + "\n" + text


class PairPacker:
    def __init__(self, tokenizer, special_ids, *, image_token_len: int,
                 use_im_start_end: bool = True, model_max_length: int = 2048,
                 interpair: bool = False):
        self.tokenizer = tokenizer
        self.ids = special_ids
        self.max_len = model_max_length
        self.use_im_start_end = use_im_start_end
        self.replace_token = make_replace_token(image_token_len,
                                                use_im_start_end)
        fn = add_image_token_interpair if interpair else add_image_token_pair
        self.add_image_token = lambda text: fn(text, self.replace_token)
        self.interpair = interpair

    def _encode(self, text: str, max_length: int) -> List[int]:
        out = self.tokenizer(text, truncation=True, max_length=max_length)
        ids = out["input_ids"]
        return list(ids[0] if ids and isinstance(ids[0], list) else ids)

    def pack(self, text_list: Sequence[Tuple[Optional[str], str]]
             ) -> PackedSample:
        """text_list: merge_round (task_prompt_or_None, caption) pairs."""
        input_ids: List[int] = []
        labels: List[int] = []
        segments: List[int] = []
        img_count = 0
        pairs_used = 0

        for i, (prompt, text) in enumerate(text_list):
            if self.interpair:
                n_img = ((prompt or "").count(C.DEFAULT_IMAGE_TOKEN)
                         + text.count(C.DEFAULT_IMAGE_TOKEN)) or 1
            else:
                n_img = 1
            if prompt is not None:
                prompt = self.add_image_token(prompt)
            else:
                text = self.add_image_token(text)

            prompt_ids = (self._encode(prompt, self.max_len)
                          if prompt is not None else [])
            text_ids = self._encode(
                text + self.tokenizer.eos_token,
                max(self.max_len - len(prompt_ids), 1))
            # de-duplicate BOS when prompt already carries one
            # (pair_webdataset.py:98-100; the reference hardcodes llama's
            # bos id 1, we use the tokenizer's)
            if prompt is not None and text_ids and \
                    text_ids[0] == self.tokenizer.bos_token_id:
                text_ids = text_ids[1:]

            if len(input_ids) + len(prompt_ids) + len(text_ids) > self.max_len:
                break  # clip: images beyond img_count are dropped

            input_ids.extend(prompt_ids + text_ids)
            labels.extend([IGNORE_INDEX] * len(prompt_ids) + text_ids)
            segments.extend([i] * (len(prompt_ids) + len(text_ids)))
            img_count += n_img
            pairs_used += 1

        ids_arr = np.asarray(input_ids, np.int32)
        lab_arr = np.asarray(labels, np.int32)
        lab_arr = mask_image_tokens(lab_arr, self.ids,
                                    self.use_im_start_end)
        return PackedSample(
            input_ids=ids_arr, labels=lab_arr,
            segment_ids=np.asarray(segments, np.int32),
            num_images_used=img_count, num_pairs_used=pairs_used)

    def pack_pretokenized(
            self, token_list: Sequence[Tuple[Sequence[int], Sequence[int]]]
    ) -> PackedSample:
        """Pair-token family: samples arrive pre-tokenized as
        (input_ids, labels) (pair_token_webdataset.py:55-70). Merge until
        overflow; each sample is truncated to max_len with EOS re-appended."""
        input_ids: List[int] = []
        labels: List[int] = []
        segments: List[int] = []
        used = 0
        eos = self.tokenizer.eos_token_id
        for i, (ids, labs) in enumerate(token_list):
            ids, labs = list(ids), list(labs)
            if len(ids) > self.max_len:
                ids = ids[: self.max_len - 1] + [eos]
                labs = labs[: self.max_len - 1] + [eos]
            if len(input_ids) + len(ids) > self.max_len:
                break
            input_ids.extend(ids)
            labels.extend(labs)
            segments.extend([i] * len(ids))
            used += 1
        lab_arr = mask_image_tokens(np.asarray(labels, np.int32), self.ids,
                                    self.use_im_start_end)
        return PackedSample(
            input_ids=np.asarray(input_ids, np.int32), labels=lab_arr,
            segment_ids=np.asarray(segments, np.int32),
            num_images_used=used, num_pairs_used=used)


def mask_image_tokens(labels: np.ndarray, special_ids,
                      use_im_start_end: bool) -> np.ndarray:
    """IGNORE image patch (+ start/end) tokens in labels
    (pair_webdataset.py:131-147)."""
    labels = labels.copy()
    mask = labels == special_ids.image_patch
    if use_im_start_end:
        mask |= (labels == special_ids.im_start) | (labels == special_ids.im_end)
    labels[mask] = IGNORE_INDEX
    return labels


def repair_truncated_image_tokens(input_ids: np.ndarray, labels: np.ndarray,
                                  special_ids, *, image_token_len: int,
                                  max_len: int, eos_id: int):
    """Conversation-path repair: if truncation cut through an image's token
    run, drop from the offending <im_start> and re-append EOS; returns
    (input_ids, labels, images_kept) (conversation_dataset.py:236-244)."""
    ids = input_ids[:max_len]
    labs = labels[:max_len]
    starts = np.flatnonzero(ids == special_ids.im_start)
    full = image_token_len + 2  # start + patches + end
    kept = 0
    for s in starts:
        if s + full <= len(ids):
            kept += 1
        else:
            ids = np.concatenate([ids[:s], [eos_id]]).astype(np.int32)
            labs = np.concatenate([labs[:s], [eos_id]]).astype(np.int32)
            break
    return ids, labs, kept
