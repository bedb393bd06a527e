"""Conversation (SFT) dataset (a copy of
``merlin_tpu/data/conversation_dataset.py``; the reference's
``data/dataset/conversation_dataset.py`` rebuilt).

Pipeline per sample: registry JSON annotations (frequency repeat / fraction
sampling, optional round merging) -> ``<image>``/``<box>`` expansion
(multimodal_processor) -> Vicuna-v1 template render -> per-round label
masking with the llama-tokenizer offset arithmetic (token_processor,
conversation_dataset.py:89-176) -> image loading with zero-image fallback
and truncated-image-token repair (:186-250).

Deviation from the reference (documented): samples with an ``images`` list
keep their real images (the reference's final branch only forwards
single-``image`` samples and silently zero-fills multi-image ones,
conversation_dataset.py:246-250 — an apparent bug).

Kept for parity (trap C33): ``build_dataloader`` passes no
``instruction_offset``, so the Llama value -2 applies to every tokenizer.
With the ``TinyTokenizer`` (the fallback where no HF tokenizer files are
found) -1 is right, and -2 also trains on each round's ``ASSISTANT:``.
"""

from __future__ import annotations

import copy
import glob as _glob
import json
import logging
import os
import random
from typing import Dict, List, Optional, Sequence

import numpy as np

from merlin_tpu_torch.data import registry
from merlin_tpu_torch.data.box import serialize_boxes, shuffle_and_sample_boxes
from merlin_tpu_torch.data.images import load_image, preprocess_pil, zero_image
from merlin_tpu_torch.data.packing import (
    mask_image_tokens, make_replace_token, repair_truncated_image_tokens)
from merlin_tpu_torch.data.webdatasets import MultimodalCfg
from merlin_tpu_torch.utils import constants as C
from merlin_tpu_torch.utils.constants import IGNORE_INDEX
from merlin_tpu_torch.utils.conversation import conv_vicuna_v1

logger = logging.getLogger("merlin_tpu_torch.data")

ROLE_MAP = {"human": 0, "user": 0,
            "assistant": 1, "gpt": 1, "obj365": 1, "vg": 1}


def mask_conversation_targets(
        conversation: str, input_ids: np.ndarray, tokenizer, *,
        pad_id: int, instruction_offset: int = -2,
        keep_bos: bool = True) -> np.ndarray:
    """Per-round masking of a rendered Vicuna-v1 conversation.

    ``instruction_offset`` is the tokenizer-specific correction on the
    instruction length: -2 for llama tokenizers (BOS + trailing-space
    merge, conversation_dataset.py:160-162), -1 for baichuan-style and the
    whitespace TinyTokenizer.
    """
    conv = conv_vicuna_v1
    sep = conv.sep + conv.roles[1] + ": "
    target = input_ids.copy()
    total_len = int((target != pad_id).sum())

    cur_len = 1 if keep_bos else 0
    target[:cur_len] = IGNORE_INDEX
    for rou in conversation.split(conv.sep2):
        if rou == "":
            break
        enc = tokenizer(rou)["input_ids"]
        enc = enc[0] if enc and isinstance(enc[0], list) else enc
        round_len = len(enc)
        if not keep_bos:  # baichuan branch counts the sep2 token explicitly
            enc2 = tokenizer(rou + conv.sep2)["input_ids"]
            enc2 = enc2[0] if enc2 and isinstance(enc2[0], list) else enc2
            round_len = len(enc2)
        parts = rou.split(sep)
        if len(parts) != 2:
            break
        enc_i = tokenizer(parts[0] + sep)["input_ids"]
        enc_i = enc_i[0] if enc_i and isinstance(enc_i[0], list) else enc_i
        instruction_len = len(enc_i) + instruction_offset
        target[cur_len: cur_len + instruction_len] = IGNORE_INDEX
        cur_len += round_len
    target[cur_len:] = IGNORE_INDEX

    if cur_len < tokenizer.model_max_length and cur_len != total_len:
        target[:] = IGNORE_INDEX  # mask-and-warn on mismatch (:170-176)
        logger.warning("tokenization mismatch: %d vs %d (sample masked)",
                       cur_len, total_len)
    return target


class ConversationDataset:
    def __init__(self, datasets: str, tokenizer, special_ids,
                 multimodal_cfg: MultimodalCfg, *,
                 model_max_length: int = 2048,
                 instruction_offset: int = -2, keep_bos: bool = True,
                 seed: int = 3407):
        self.tokenizer = tokenizer
        self.special_ids = special_ids
        self.cfg = multimodal_cfg
        self.model_max_length = model_max_length
        self.instruction_offset = instruction_offset
        self.keep_bos = keep_bos
        self.rng = random.Random(seed)

        list_data, list_image_path = [], []
        for name in registry.parse_dataset_flag(datasets):
            spec = registry.get_spec("conversation", name)
            data = self._load_annotations(spec.annotations)
            if spec.merge_round:
                data = self.merge_conversations(data, spec.merge_round)
            freq = spec.frequency
            if isinstance(freq, int) or float(freq).is_integer():
                sampled = data * int(freq)
            elif "cn" in name:
                sampled = data[-int(len(data) * freq):]
            else:
                sampled = data[: int(len(data) * freq)]
            logger.info("%s: %d -> %d conversations (x%s)", name, len(data),
                        len(sampled), freq)
            list_data.extend(sampled)
            list_image_path.extend([spec.images] * len(sampled))
        self.list_data_dict = list_data
        self.list_image_path = list_image_path

    @staticmethod
    def _load_annotations(path: str) -> List[dict]:
        from merlin_tpu_torch.data.storage import smart_open

        if path.endswith(".json"):
            # local or object-store (reference loads annotation JSONs via
            # megfile.smart_open, base_dataset.py:43-54)
            with smart_open(path, "r") as f:
                return json.load(f)
        out: List[dict] = []
        for p in sorted(_glob.glob(os.path.join(path, "*.json"))):
            try:
                with open(p) as f:
                    out.extend(json.load(f))
            except Exception as e:  # bad-JSON swallow (base_dataset.py:47-54)
                logger.warning("bad json %s: %s", p, e)
        return out

    def merge_conversations(self, data: List[dict], merge_round: int
                            ) -> List[dict]:
        """Chunk consecutive samples' conversations together
        (base_dataset.py:102-140; the distributed MIN-length agreement is a
        no-op here because chunking is deterministic per host)."""
        merged = []
        rounds = merge_round if merge_round > 1 else 1
        for i in range(0, len(data), rounds):
            chunk = data[i: i + rounds]
            convs = []
            for d in chunk:
                convs.extend(d.get("conversations", d) if isinstance(d, dict)
                             else d)
            item = dict(chunk[0]) if isinstance(chunk[0], dict) else {}
            item["conversations"] = convs
            merged.append(item)
        return merged

    def __len__(self):
        return len(self.list_data_dict)

    # --- sampler support (conversation_dataset.py:57-72) -----------------
    @property
    def lengths(self) -> List[int]:
        out = []
        for s in self.list_data_dict:
            img = 128 if ("image" in s or "images" in s) else 0
            out.append(sum(len(c["value"].split())
                           for c in s["conversations"]) + img)
        return out

    @property
    def modality_lengths(self) -> List[int]:
        out = []
        for s in self.list_data_dict:
            n = sum(len(c["value"].split()) for c in s["conversations"])
            out.append(n if ("image" in s or "images" in s) else -n)
        return out

    # ---------------------------------------------------------------------
    def multimodal_processor(self, conversations: List[dict],
                             box_texts: Optional[List[str]]) -> List[dict]:
        replace = make_replace_token(self.cfg.image_token_len,
                                     self.cfg.use_im_start_end)
        idx = 0
        for sentence in conversations:
            sentence["value"] = sentence["value"].replace(
                C.DEFAULT_IMAGE_TOKEN, replace)
            n_boxes = sentence["value"].count(C.DEFAULT_BOX_TOKEN)
            if n_boxes and box_texts is not None:
                for j in range(n_boxes):
                    sentence["value"] = sentence["value"].replace(
                        C.DEFAULT_BOX_TOKEN, box_texts[idx + j], 1)
                idx += n_boxes
        return conversations

    def render(self, conversations: List[dict]) -> str:
        conv = conv_vicuna_v1.copy()
        src = conversations
        if src and ROLE_MAP.get(src[0]["from"].lower(), 0) != 0:
            src = src[1:]
        for j, sentence in enumerate(src):
            role_idx = ROLE_MAP[sentence["from"].lower()]
            assert role_idx == j % 2, "role alternation violated"
            conv.append_message(conv.roles[role_idx], sentence["value"])
        return conv.get_prompt()

    def token_processor(self, conversation: str) -> Dict[str, np.ndarray]:
        enc = self.tokenizer(conversation, truncation=True,
                             max_length=self.model_max_length)
        ids = enc["input_ids"]
        ids = np.asarray(ids[0] if ids and isinstance(ids[0], list) else ids,
                         np.int32)
        labels = mask_conversation_targets(
            conversation, ids, self.tokenizer,
            pad_id=self.tokenizer.pad_token_id,
            instruction_offset=self.instruction_offset,
            keep_bos=self.keep_bos)
        labels = mask_image_tokens(labels, self.special_ids,
                                   self.cfg.use_im_start_end)
        return dict(input_ids=ids, labels=labels)

    def __getitem__(self, i) -> Dict[str, np.ndarray]:
        data = copy.deepcopy(self.list_data_dict[i])
        conversations = (data["conversations"] if isinstance(data, dict)
                         else data)
        is_mm = isinstance(data, dict) and ("image" in data or "images" in data)

        image_list: List[np.ndarray] = []
        if is_mm:
            names = [data["image"]] if "image" in data else list(data["images"])
            image_wh = []
            image_path = ""
            for name in names:
                image_path = os.path.join(self.list_image_path[i], name)
                try:
                    img = load_image(image_path)
                    image_wh.append(img.size)
                    image_list.append(preprocess_pil(
                        img, self.cfg.image_size, self.cfg.image_aspect_ratio))
                except Exception as e:
                    logger.warning("broken image %s: %s", image_path, e)

            box_texts = None
            has_box = any(C.DEFAULT_BOX_TOKEN in c["value"]
                          for c in conversations)
            if image_list and has_box and isinstance(data, dict) and \
                    "boxes" in data:
                boxes = shuffle_and_sample_boxes(
                    data["boxes"], self.cfg.box_limit, self.rng)
                box_texts = serialize_boxes(
                    [np.asarray(boxes, np.float32)], image_wh[:1], image_path,
                    self.cfg.image_aspect_ratio)
            conversations = self.multimodal_processor(conversations, box_texts)

        rendered = self.render(conversations)
        dd = self.token_processor(rendered)

        ids, labels, kept = repair_truncated_image_tokens(
            dd["input_ids"], dd["labels"], self.special_ids,
            image_token_len=self.cfg.image_token_len,
            max_len=self.model_max_length,
            eos_id=self.tokenizer.eos_token_id)

        images = image_list[:kept] if (is_mm and kept > 0) else []
        if not images:
            images = [zero_image(self.cfg.image_size)]
        return dict(
            input_ids=ids, labels=labels,
            segment_ids=np.zeros_like(ids),
            images=np.stack(images).astype(np.uint8),
            num_images=len(images))
