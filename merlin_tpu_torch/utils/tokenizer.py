"""Tokenizer wrapper: HF tokenizer + multimodal special tokens (a copy of
``merlin_tpu/utils/tokenizer.py``).

Right padding, pad=unk fallback, and the ``<im_patch>/<im_start>/<im_end>``
(+box) special tokens, whose new embedding rows are mean-initialized
(:func:`resize_embeddings_mean_init`). ``transformers`` is imported only
when :func:`load_tokenizer` runs.

:class:`TinyTokenizer` implements the same protocol without dependencies,
for tests and offline runs. Its vocabulary grows as it encodes: a word's id
is the order in which it was first seen, and an id it has never seen
decodes to ``<unk>``. :class:`LlamaLikeTokenizer` reproduces the legacy
HF Llama tokenizer's behaviours that the SFT label mask's ``-2`` depends
on.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Sequence

import numpy as np
import torch

from merlin_tpu_torch.utils import constants as C

MM_SPECIAL_TOKENS = [C.DEFAULT_IM_PATCH_TOKEN, C.DEFAULT_IM_START_TOKEN,
                     C.DEFAULT_IM_END_TOKEN]
BOX_SPECIAL_TOKENS = [C.DEFAULT_BOX_TOKEN, C.DEFAULT_BOX_START_TOKEN,
                      C.DEFAULT_BOX_END_TOKEN]


@dataclasses.dataclass
class SpecialIds:
    pad: int
    bos: int
    eos: int
    unk: int
    image_patch: int
    im_start: int
    im_end: int


def load_tokenizer(path: str, *, model_max_length: int = 2048,
                   add_box_tokens: bool = False):
    """HF tokenizer with reference-parity settings. Returns (tokenizer,
    SpecialIds, num_added)."""
    from transformers import AutoTokenizer

    tok = AutoTokenizer.from_pretrained(
        path, model_max_length=model_max_length, padding_side="right",
        use_fast=True)
    if tok.pad_token is None:
        tok.pad_token = tok.unk_token or tok.eos_token
    tokens = list(MM_SPECIAL_TOKENS)
    if add_box_tokens:
        tokens += BOX_SPECIAL_TOKENS
    num_added = tok.add_tokens(tokens, special_tokens=True)
    ids = SpecialIds(
        pad=tok.pad_token_id, bos=tok.bos_token_id, eos=tok.eos_token_id,
        unk=getattr(tok, "unk_token_id", tok.eos_token_id) or tok.eos_token_id,
        image_patch=tok.convert_tokens_to_ids(C.DEFAULT_IM_PATCH_TOKEN),
        im_start=tok.convert_tokens_to_ids(C.DEFAULT_IM_START_TOKEN),
        im_end=tok.convert_tokens_to_ids(C.DEFAULT_IM_END_TOKEN),
    )
    return tok, ids, num_added


def resize_embeddings_mean_init(embedding: torch.Tensor,
                                new_vocab: int) -> torch.Tensor:
    """Grow (V, D) -> (new_vocab, D); the new rows are the mean of the
    existing rows."""
    v, d = embedding.shape
    if new_vocab <= v:
        return embedding
    mean = embedding.mean(dim=0, keepdim=True)
    return torch.cat([embedding, mean.expand(new_vocab - v, d)], dim=0)


class LlamaLikeTokenizer:
    """Pure-python mimic of the (legacy) HF LlamaTokenizer behaviors the
    SFT masking arithmetic depends on. The reference hardcodes ``-2`` on
    instruction lengths "for the LLaMA tokenizer"
    (conversation_dataset.py:160-162); that constant is exactly:

      * BOS (id 1) prepended to every encode                       -> -1
      * sentencepiece space handling: spaces merge INTO the following
        word ("▁word" pieces), so a string ending in a space (the
        " ASSISTANT: " separator) tokenizes standalone to a dangling
        lone "▁" that, in the full conversation, merges with the first
        word of the response                                       -> -1

    plus the round-length identity that makes per-round cursors line up:
    "</s>" (id 2) splits as a special token, and (legacy sentencepiece
    behavior — the one the reference shipped against, transformers<=4.31
    slow tokenizers) every segment after a special token gets the dummy
    "▁" prefix again, so ``len(tok(round))`` = 1 (BOS) + n = n + 1
    (the "</s>") that the round occupies in the full encoding.

    Greedy longest-match over "▁word"/"word"/punct pieces built from a
    corpus reproduces sentencepiece segmentations for in-corpus text;
    out-of-corpus characters fall back to single-character pieces (the
    byte-fallback analogue). Vocabulary ids follow the llama convention:
    unk=0, bos=1, eos=2; pad aliases unk as the reference's builder does
    (model/builder.py pad=unk fallback).
    """

    def __init__(self, corpus: Sequence[str] = (), *,
                 model_max_length: int = 2048, legacy: bool = True):
        self.model_max_length = model_max_length
        self.padding_side = "right"
        self.legacy = legacy
        self.name_or_path = "llama-like"
        self._vocab: Dict[str, int] = {}
        self._inv: Dict[int, str] = {}
        for t in ["<unk>", "<s>", "</s>"]:
            self._add(t)
        self.unk_token, self.bos_token, self.eos_token = \
            "<unk>", "<s>", "</s>"
        self.pad_token = "<unk>"
        self.special_tokens: List[str] = ["<unk>", "<s>", "</s>"]
        self._add("▁")
        self._max_piece = 1
        for text in corpus:
            self._learn(text)
        self._rebuild_special_re()

    def _add(self, piece: str) -> int:
        if piece not in self._vocab:
            idx = len(self._vocab)
            self._vocab[piece] = idx
            self._inv[idx] = piece
            self._max_piece = max(getattr(self, "_max_piece", 1), len(piece))
        return self._vocab[piece]

    def _learn(self, text: str):
        for word in re.findall(r"\w+|[^\w\s]", text):
            self._add("▁" + word)
            self._add(word)

    def _rebuild_special_re(self):
        pats = sorted(self.special_tokens, key=len, reverse=True)
        self._special_re = re.compile(
            "(" + "|".join(re.escape(p) for p in pats) + ")")

    # --- HF-compatible surface ------------------------------------------
    @property
    def pad_token_id(self):
        return self._vocab[self.pad_token]

    @property
    def bos_token_id(self):
        return self._vocab[self.bos_token]

    @property
    def eos_token_id(self):
        return self._vocab[self.eos_token]

    @property
    def unk_token_id(self):
        return self._vocab[self.unk_token]

    def __len__(self):
        return max(len(self._vocab), 128)

    def add_tokens(self, tokens: Sequence[str], special_tokens=True) -> int:
        added = 0
        for t in tokens:
            if t not in self._vocab:
                self._add(t)
                added += 1
            if t not in self.special_tokens:
                self.special_tokens.append(t)
        self._rebuild_special_re()
        return added

    def convert_tokens_to_ids(self, token: str) -> int:
        return self._vocab.get(token, self.unk_token_id)

    def _encode_segment(self, segment: str, dummy_prefix: bool) -> List[int]:
        text = segment.replace(" ", "▁")
        if dummy_prefix and not text.startswith("▁"):
            text = "▁" + text
        out: List[int] = []
        i = 0
        while i < len(text):
            for j in range(min(len(text), i + self._max_piece), i, -1):
                piece = text[i:j]
                if piece in self._vocab and piece not in self.special_tokens:
                    out.append(self._vocab[piece])
                    i = j
                    break
            else:
                # char fallback (byte-fallback analogue); learn the char so
                # round-trips stay stable within one instance
                out.append(self._add(text[i]))
                i += 1
        return out

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        ids: List[int] = [self.bos_token_id] if add_special_tokens else []
        first = True
        for part in self._special_re.split(text):
            if part == "":
                continue
            if part in self.special_tokens:
                ids.append(self._vocab[part])
                first = False
                continue
            # legacy sentencepiece: dummy prefix re-applied after specials
            ids.extend(self._encode_segment(
                part, dummy_prefix=first or self.legacy))
            first = False
        return ids

    def __call__(self, text, return_tensors=None, add_special_tokens=True,
                 truncation=False, max_length=None, padding=False):
        if isinstance(text, str):
            ids = [self.encode(text, add_special_tokens)]
        else:
            ids = [self.encode(t, add_special_tokens) for t in text]
        limit = max_length or self.model_max_length
        if truncation:
            ids = [x[:limit] for x in ids]

        class _Out(dict):
            __getattr__ = dict.__getitem__

        out = _Out(input_ids=ids)
        if return_tensors == "np":
            out["input_ids"] = np.asarray(ids)
        return out

    def decode(self, ids, skip_special_tokens: bool = False) -> str:
        parts = []
        for i in np.asarray(ids).reshape(-1).tolist():
            t = self._inv.get(int(i), self.unk_token)
            if skip_special_tokens and t in self.special_tokens:
                continue
            parts.append(t)
        return "".join(parts).replace("▁", " ")

    def batch_decode(self, batch, skip_special_tokens: bool = False):
        return [self.decode(x, skip_special_tokens) for x in batch]


class TinyTokenizer:
    """Whitespace tokenizer implementing the HF subset the framework uses.

    Vocabulary is built lazily; special tokens get fixed low ids. Intended
    for tests and dry runs only.
    """

    def __init__(self, model_max_length: int = 2048):
        self.model_max_length = model_max_length
        self.padding_side = "right"
        self._vocab: Dict[str, int] = {}
        self._inv: Dict[int, str] = {}
        for t in ["[PAD]", "<s>", "</s>", "<unk>"]:
            self._add(t)
        self.pad_token, self.bos_token = "[PAD]", "<s>"
        self.eos_token, self.unk_token = "</s>", "<unk>"
        self.special_tokens: List[str] = ["[PAD]", "<s>", "</s>", "<unk>"]
        self._special_re = None
        self._rebuild_special_re()

    def _add(self, token: str) -> int:
        if token not in self._vocab:
            idx = len(self._vocab)
            self._vocab[token] = idx
            self._inv[idx] = token
        return self._vocab[token]

    def _rebuild_special_re(self):
        pats = sorted(self.special_tokens, key=len, reverse=True)
        self._special_re = re.compile(
            "(" + "|".join(re.escape(p) for p in pats) + ")")

    # --- HF-compatible surface ------------------------------------------
    @property
    def pad_token_id(self):
        return self._vocab[self.pad_token]

    @property
    def bos_token_id(self):
        return self._vocab[self.bos_token]

    @property
    def eos_token_id(self):
        return self._vocab[self.eos_token]

    @property
    def unk_token_id(self):
        return self._vocab[self.unk_token]

    def __len__(self):
        # report a padded vocab so tiny models can host random ids in tests
        return max(len(self._vocab), 128)

    def add_tokens(self, tokens: Sequence[str], special_tokens=True) -> int:
        added = 0
        for t in tokens:
            if t not in self._vocab:
                self._add(t)
                added += 1
            if t not in self.special_tokens:
                self.special_tokens.append(t)
        self._rebuild_special_re()
        return added

    def convert_tokens_to_ids(self, token: str) -> int:
        return self._vocab.get(token, self.unk_token_id)

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for part in self._special_re.split(text):
            if not part:
                continue
            if part in self._vocab and part in self.special_tokens:
                out.append(part)
            else:
                out.extend(part.split())
        return out

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        ids = [self._add(t) for t in self.tokenize(text)]
        if add_special_tokens:
            ids = [self.bos_token_id] + ids
        return ids

    def __call__(self, text, return_tensors=None, add_special_tokens=True,
                 truncation=False, max_length=None, padding=False):
        if isinstance(text, str):
            ids = [self.encode(text, add_special_tokens)]
        else:
            ids = [self.encode(t, add_special_tokens) for t in text]
        limit = max_length or self.model_max_length
        if truncation:
            ids = [x[:limit] for x in ids]

        class _Out(dict):
            __getattr__ = dict.__getitem__

        out = _Out(input_ids=ids)
        if return_tensors == "np":
            out["input_ids"] = np.asarray(ids)
        return out

    def decode(self, ids, skip_special_tokens: bool = False) -> str:
        toks = []
        for i in np.asarray(ids).reshape(-1).tolist():
            t = self._inv.get(int(i), self.unk_token)
            if skip_special_tokens and t in self.special_tokens:
                continue
            toks.append(t)
        return " ".join(toks)

    def batch_decode(self, batch, skip_special_tokens: bool = False):
        return [self.decode(x, skip_special_tokens) for x in batch]
