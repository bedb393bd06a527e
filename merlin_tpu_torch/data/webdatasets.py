"""Streaming tar datasets: pair / pair_token / interpair / interleave
families (a copy of ``merlin_tpu/data/webdatasets.py``: the reference's
data/dataset/*_webdataset.py rebuilt on :mod:`merlin_tpu_torch.data.shards`
+ :mod:`merlin_tpu_torch.data.packing`).

All emit numpy sample dicts:
  {input_ids (L,), labels (L,), segment_ids (L,),
   images (n, S, S, 3) uint8, num_images int}
Broken samples are skipped (warn-and-continue); text-only packs get one
zero image (reference pair_webdataset.py:149-151).
"""

from __future__ import annotations

import dataclasses
import json
import logging
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from merlin_tpu_torch.data import registry
from merlin_tpu_torch.data.images import load_image, preprocess_pil, zero_image
from merlin_tpu_torch.data.packing import (
    PackedSample, PairPacker, mask_image_tokens, make_replace_token,
    repair_truncated_image_tokens)
from merlin_tpu_torch.data.shards import (
    first_image_bytes, has_caption_and_image, shard_sample_stream)
from merlin_tpu_torch.utils import constants as C
from merlin_tpu_torch.utils.constants import IGNORE_INDEX

logger = logging.getLogger("merlin_tpu_torch.data")


@dataclasses.dataclass
class MultimodalCfg:
    image_token_len: int = 256
    use_im_start_end: bool = True
    image_size: int = 448
    image_aspect_ratio: str = "resize"
    box_limit: int = 30


class _StreamDatasetBase:
    """Common machinery: registry lookup, shard stream, sizing."""

    family: str = "pair"

    def __init__(self, dataset: str, tokenizer, special_ids,
                 multimodal_cfg: MultimodalCfg, *, model_max_length: int = 2048,
                 seed: int = 3407, process_index: Optional[int] = None,
                 process_count: Optional[int] = None, worker_id: int = 0,
                 num_workers: int = 1, spec: Optional[registry.WebdataSpec] = None,
                 resumable: bool = False):
        self.name = dataset
        self.spec = spec or registry.get_spec(self.family, dataset)
        self.tokenizer = tokenizer
        self.special_ids = special_ids
        self.cfg = multimodal_cfg
        self.model_max_length = model_max_length
        self.merge_round = max(self.spec.merge_round, 1)
        self.data_size = self.spec.size
        self._stream = iter(shard_sample_stream(
            self.spec.shard_list(), seed=seed, process_index=process_index,
            process_count=process_count, worker_id=worker_id,
            num_workers=num_workers, select=has_caption_and_image,
            resumable=resumable))
        self.packer = PairPacker(
            tokenizer, special_ids, image_token_len=multimodal_cfg.image_token_len,
            use_im_start_end=multimodal_cfg.use_im_start_end,
            model_max_length=model_max_length,
            interpair=self.family == "interpair")

    def __len__(self) -> int:
        return self.data_size // self.merge_round

    def _process_image_bytes(self, data: bytes) -> np.ndarray:
        return preprocess_pil(load_image(data), self.cfg.image_size,
                              self.cfg.image_aspect_ratio)

    def _emit(self, packed: PackedSample,
              images: List[np.ndarray]) -> Dict[str, np.ndarray]:
        images = images[: packed.num_images_used]
        if not images:
            images = [zero_image(self.cfg.image_size)]
        return dict(
            input_ids=packed.input_ids, labels=packed.labels,
            segment_ids=packed.segment_ids,
            images=np.stack(images).astype(np.uint8),
            num_images=len(images))

    def __iter__(self):
        while True:
            yield self[0]

    # -- resume cursor (trainer checkpoint/resume; SURVEY §5 beats the
    # reference, which replays webdataset streams from zero) --------------
    def data_state(self) -> Optional[Dict]:
        get = getattr(self._stream, "get_state", None)
        return {"stream": get()} if get else None

    def load_data_state(self, state: Optional[Dict]):
        if state and hasattr(self._stream, "set_state"):
            self._stream.set_state(state["stream"])


class PairWebDataset(_StreamDatasetBase):
    """Image-caption pairs with optional task prompts
    (pair_webdataset.py)."""

    family = "pair"

    def _parse(self, sample) -> Tuple[Optional[str], str]:
        prompt, text = None, None
        if "json" in sample:
            info = json.loads(sample["json"])
            if isinstance(info, dict):
                text = str(info.get("caption", info.get("txt", "")))
                prompt = info.get("task_prompt")
            else:
                text = str(info)
        if "txt" in sample:
            text = sample["txt"].decode("utf-8", errors="replace")
        if text is None:
            raise ValueError("no caption")
        return prompt, text

    def __getitem__(self, i) -> Dict[str, np.ndarray]:
        text_list, image_list = [], []
        for _ in range(self.merge_round):
            sample = next(self._stream)
            try:
                img = self._process_image_bytes(first_image_bytes(sample))
                prompt, text = self._parse(sample)
            except Exception as e:
                logger.warning("pair sample failed: %s", e)
                continue
            image_list.append(img)
            text_list.append((prompt, text))
        return self._emit(self.packer.pack(text_list), image_list)


class PairTokenWebDataset(_StreamDatasetBase):
    """Pre-tokenized QA pairs (pair_token_webdataset.py): the tar json
    carries input_ids/labels directly."""

    family = "pair_token"

    def __getitem__(self, i) -> Dict[str, np.ndarray]:
        token_list, image_list = [], []
        for _ in range(self.merge_round):
            sample = next(self._stream)
            try:
                img = self._process_image_bytes(first_image_bytes(sample))
                info = json.loads(sample["json"])
                pair = (list(info["input_ids"]), list(info["labels"]))
            except Exception as e:
                logger.warning("pair_token sample failed: %s", e)
                continue
            image_list.append(img)
            token_list.append(pair)
        return self._emit(self.packer.pack_pretokenized(token_list),
                          image_list)


class InterPairWebDataset(_StreamDatasetBase):
    """Multi-frame video tracking/detection pairs (interpair_webdataset.py):
    one text references several frames stored as key.frameN.jpg members."""

    family = "interpair"

    def __getitem__(self, i) -> Dict[str, np.ndarray]:
        text_list, image_list = [], []
        for _ in range(self.merge_round):
            sample = next(self._stream)
            try:
                info = json.loads(sample["json"])
                frames = []
                for image_name in info["image_name_list"]:
                    field = image_name.split("-")[-1] + ".jpg"
                    frames.append(self._process_image_bytes(sample[field]))
            except Exception as e:
                logger.warning("interpair sample failed: %s", e)
                continue
            image_list.extend(frames)
            text_list.append((info.get("prompt"), info["txt"]))
        return self._emit(self.packer.pack(text_list), image_list)


class InterleaveWebDataset(_StreamDatasetBase):
    """MMC4/OBELICS-style interleaved documents (interleave_webdataset.py):
    a text list with images inserted before their matched_text_index, CLIP
    similarity filter >= 0.25, single EOS at the end."""

    family = "interleave"
    SIM_THRESHOLD = 0.25

    def _build_text(self, text_list: List[str], image_indices: List[int]) -> str:
        texts = list(text_list)
        if image_indices:
            if image_indices[-1] == len(texts):
                texts.append("")
            while image_indices and image_indices[-1] > len(texts) - 1 \
                    and image_indices[-1] >= len(texts):
                logger.warning("drop out-of-boundary image index")
                image_indices.pop()
        for idx in image_indices:
            texts[idx] = C.DEFAULT_IMAGE_TOKEN + "\n" + texts[idx]
        text = " ".join(texts) + self.tokenizer.eos_token
        replace = make_replace_token(self.cfg.image_token_len,
                                     self.cfg.use_im_start_end)
        return text.replace(C.DEFAULT_IMAGE_TOKEN, replace)

    def __getitem__(self, i) -> Dict[str, np.ndarray]:
        sample = next(self._stream)
        info = json.loads(sample["json"])
        text_list = info.get("text_list", [])
        image_list, image_indices = [], []
        for image_info in info.get("image_info", []):
            try:
                sim = image_info.get("matched_sim",
                                     image_info.get("match_sim", 1.0))
                if sim < self.SIM_THRESHOLD:
                    continue
                fname = image_info["image_name"]
                fname = (fname.split(".")[0] if "." in fname else fname) + ".jpg"
                data = sample.get(fname) or sample.get(fname.split("-")[-1])
                if data is None:
                    logger.warning("image %s not in sample", fname)
                    continue
                image_list.append(self._process_image_bytes(data))
                image_indices.append(image_info["matched_text_index"])
            except Exception as e:
                logger.warning("interleave image failed: %s", e)

        text = self._build_text(text_list, image_indices)
        enc = self.tokenizer(text, truncation=True,
                             max_length=self.model_max_length)
        ids = enc["input_ids"]
        ids = np.asarray(ids[0] if ids and isinstance(ids[0], list) else ids,
                         np.int32)
        labels = mask_image_tokens(ids.copy(), self.special_ids,
                                   self.cfg.use_im_start_end)
        pad_id = self.tokenizer.pad_token_id
        labels[ids == pad_id] = IGNORE_INDEX

        ids, labels, kept = repair_truncated_image_tokens(
            ids, labels, self.special_ids,
            image_token_len=self.cfg.image_token_len,
            max_len=self.model_max_length,
            eos_id=self.tokenizer.eos_token_id)
        images = image_list[:kept]
        if not images:
            images = [zero_image(self.cfg.image_size)]
        seg = np.zeros_like(ids)
        return dict(input_ids=ids, labels=labels, segment_ids=seg,
                    images=np.stack(images).astype(np.uint8),
                    num_images=len(images))

    def __len__(self):
        return self.data_size
