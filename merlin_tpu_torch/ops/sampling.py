"""Logit warping and sampling (counterpart of
``merlin_tpu/ops/sampling.py``): temperature, top-k, top-p and
``sample_token`` over (b, V) logits, with randomness from an explicit
``torch.Generator``."""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e10


def apply_temperature(logits: torch.Tensor, temperature: float) -> torch.Tensor:
    return logits / max(temperature, 1e-6)


def apply_top_k(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Mask everything below the k-th largest logit."""
    if k <= 0:
        return logits
    k = min(k, logits.shape[-1])
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return torch.where(logits < kth, NEG_INF, logits)


def apply_top_p(logits: torch.Tensor, p: float) -> torch.Tensor:
    """Nucleus filtering: keep the smallest set of tokens whose cumulative
    probability exceeds p (the top token always survives)."""
    if p >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep_sorted = (cum - probs) < p
    threshold = torch.where(keep_sorted, sorted_logits,
                            torch.full_like(sorted_logits, float("inf"))
                            ).amin(dim=-1, keepdim=True)
    return torch.where(logits < threshold, NEG_INF, logits)


def sample_token(logits: torch.Tensor, *,
                 generator: Optional[torch.Generator] = None,
                 temperature: float = 1.0, top_k: int = 0,
                 top_p: float = 1.0, do_sample: bool = True) -> torch.Tensor:
    """(b, V) logits -> (b,) int64 token ids. ``generator`` must live on
    the logits' device."""
    if not do_sample:
        return torch.argmax(logits, dim=-1)
    logits = apply_temperature(logits.float(), temperature)
    logits = apply_top_k(logits, top_k)
    logits = apply_top_p(logits, top_p)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]
