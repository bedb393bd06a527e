"""Autoregressive generation over a dense or paged KV cache (counterpart of
``merlin_tpu/generate/decode.py``).

  * One prefill over the right-padded, bucketed prompt batch (images are
    spliced there), then one-token steps. Ragged prompts share one cache
    write cursor: validity ids in the cache mask the right padding, while
    positions advance per sequence (``lengths``).
  * :meth:`Generator.__call__` runs the batch to ``max_new_tokens`` or until
    every row has stopped; :meth:`Generator.stream` yields each step's
    tokens and also stops on a keyword found in a bounded tail window of
    the decoded text.

The JAX package jits prefill and step and runs the batch loop as a
``lax.while_loop``; here both are plain Python loops over eager calls.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from merlin_tpu_torch.models.decoder import init_kv_cache
from merlin_tpu_torch.ops.sampling import sample_token


@dataclasses.dataclass(frozen=True)
class GenerateConfig:
    max_new_tokens: int = 128
    do_sample: bool = False
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    # > 1 selects beam search (generate/beam.BeamSearch); Generator ignores
    # it, as JAX's does
    num_beams: int = 1
    eos_id: int = 2
    pad_id: int = 0
    # extra single-token stop ids
    stop_token_ids: Tuple[int, ...] = ()
    # torch.int8 takes int8 pages with per-(token, head) scales and needs
    # kv_layout="paged"
    cache_dtype: torch.dtype = torch.bfloat16
    # pad prompts up to a multiple of this (0 = exact length)
    prompt_bucket: int = 128
    # 'dense' contiguous KV buffers, or 'paged' fixed-size pages read by
    # the paged decode kernel (ops/paged_attention)
    kv_layout: str = "dense"


def keyword_hit(text: str, keywords: Sequence[str]) -> bool:
    """Any keyword in the generated text."""
    return any(kw in text for kw in keywords if kw)


def truncate_at_keywords(text: str, keywords: Sequence[str]) -> str:
    for kw in keywords:
        if kw and kw in text:
            text = text.split(kw)[0]
    return text


class Generator:
    """Greedy or sampled generation for a ``CausalLM`` or ``MMGPT``."""

    def __init__(self, model: nn.Module, gen_cfg: GenerateConfig, *,
                 device: Union[str, torch.device] = "cuda"):
        self.model = model
        self.cfg = gen_cfg
        self.device = torch.device(device)

    def _as_tensor(self, x, dtype=None) -> torch.Tensor:
        t = x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))
        return t.to(self.device, dtype) if dtype else t.to(self.device)

    @torch.no_grad()
    def _start(self, input_ids, images, attention_mask):
        """Bucket-pad, allocate the cache and prefill. Returns the logits at
        each row's last prompt token, the cache and the prompt lengths."""
        cfg = self.cfg
        ids = self._as_tensor(input_ids, torch.int64)
        mask = (ids != cfg.pad_id) if attention_mask is None else \
            self._as_tensor(attention_mask, torch.bool)
        bucket = cfg.prompt_bucket
        if bucket and ids.shape[1] % bucket:
            pad = bucket - ids.shape[1] % bucket
            ids = torch.nn.functional.pad(ids, (0, pad), value=cfg.pad_id)
            mask = torch.nn.functional.pad(mask, (0, pad), value=False)
        b, s = ids.shape
        model_cfg = self.model.cfg
        lm_cfg = model_cfg.lm if hasattr(model_cfg, "lm") else model_cfg
        cache = init_kv_cache(lm_cfg, b, s + cfg.max_new_tokens,
                              dtype=cfg.cache_dtype, layout=cfg.kv_layout,
                              device=self.device)
        kwargs = {}
        if images is not None:
            kwargs["images"] = self._as_tensor(images)
        positions = torch.arange(s, device=self.device).expand(b, s)
        logits, cache = self.model(
            ids, segment_ids=mask.to(torch.int32), positions=positions,
            kv_cache=cache, **kwargs)
        lengths = mask.sum(dim=1)
        last = logits[torch.arange(b, device=self.device), lengths - 1]
        return last, cache, lengths

    @torch.no_grad()
    def _step(self, token, positions, cache):
        logits, cache = self.model(token[:, None], positions=positions[:, None],
                                   kv_cache=cache)
        return logits[:, 0], cache

    def _default_generator(self) -> torch.Generator:
        """A fresh generator seeded 0: the same request samples the same
        tokens on every call, as JAX's ``jax.random.key(0)`` default gives."""
        return torch.Generator(device=self.device).manual_seed(0)

    def _pick(self, logits, generator):
        cfg = self.cfg
        return sample_token(logits, generator=generator,
                            temperature=cfg.temperature, top_k=cfg.top_k,
                            top_p=cfg.top_p, do_sample=cfg.do_sample)

    @torch.no_grad()
    def __call__(self, input_ids, *, images=None, attention_mask=None,
                 generator: Optional[torch.Generator] = None) -> np.ndarray:
        """Batch generation. Returns (b, max_new_tokens) int32, pad-filled
        after a stop token (which is included). Without ``generator`` a
        sampled call draws from a fresh one seeded 0."""
        cfg = self.cfg
        if generator is None:
            generator = self._default_generator()
        logits, cache, lengths = self._start(input_ids, images, attention_mask)
        b = logits.shape[0]
        stop_ids = torch.tensor((cfg.eos_id,) + tuple(cfg.stop_token_ids),
                                device=self.device)
        out = torch.full((b, cfg.max_new_tokens), cfg.pad_id,
                         dtype=torch.int32, device=self.device)
        done = torch.zeros(b, dtype=torch.bool, device=self.device)
        for i in range(cfg.max_new_tokens):
            tok = self._pick(logits, generator)
            tok = torch.where(done, cfg.pad_id, tok)
            out[:, i] = tok.to(torch.int32)
            done = done | torch.isin(tok, stop_ids)
            # the host reads `done` once per step, as the while_loop's
            # condition does on the device
            if i + 1 == cfg.max_new_tokens or bool(done.all()):
                break
            logits, cache = self._step(tok, lengths + i, cache)
        return out.cpu().numpy()

    @torch.no_grad()
    def stream(self, input_ids, *, images=None, attention_mask=None,
               generator: Optional[torch.Generator] = None, tokenizer=None,
               keywords: Sequence[str] = ()) -> Iterator[np.ndarray]:
        """Step-by-step generation for serving: yields (b,) token ids each
        step; stops on EOS/stop ids everywhere or a keyword hit. Seeded as
        :meth:`__call__` is."""
        cfg = self.cfg
        if generator is None:
            generator = self._default_generator()
        logits, cache, lengths = self._start(input_ids, images, attention_mask)
        b = logits.shape[0]
        done = np.zeros((b,), bool)
        stop_ids = [cfg.eos_id, *cfg.stop_token_ids]
        history: list = []
        # keyword checks decode only a bounded tail window (longest keyword
        # in tokens + slack for merge boundaries)
        window = 0
        if tokenizer is not None and keywords:
            for kw in keywords:
                enc = tokenizer(kw, add_special_tokens=False)["input_ids"]
                enc = enc[0] if enc and isinstance(enc[0], list) else enc
                window = max(window, len(enc))
            window += 8
        for i in range(cfg.max_new_tokens):
            tok = self._pick(logits, generator).cpu().numpy().astype(np.int32)
            tok = np.where(done, cfg.pad_id, tok)
            done = done | np.isin(tok, stop_ids)
            history.append(tok)
            yield tok
            if window:
                seq = np.stack(history[-window:], axis=1)
                for j in range(b):
                    if not done[j]:
                        tail = tokenizer.decode(seq[j], skip_special_tokens=False)
                        if keyword_hit(tail, keywords):
                            done[j] = True
            if done.all() or i + 1 == cfg.max_new_tokens:
                return
            logits, cache = self._step(
                torch.from_numpy(tok).to(self.device, torch.int64),
                lengths + i, cache)
