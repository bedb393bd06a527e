"""Speculative-decoding helpers (counterpart of
``merlin_tpu/generate/speculative.py``). Only what the serving engine's
speculative windows use is ported; the speculative ``Generator`` comes
with a later slice.
"""

from __future__ import annotations

import torch


def _scatter_rows(buf: torch.Tensor, start: torch.Tensor, vals: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """buf[i, start[i] + j] = vals[i, j] where mask[i, j]; writes past the
    end of a row are dropped. Returns a new tensor (buf is not changed)."""
    b, w = vals.shape
    cols = start.long()[:, None] + torch.arange(w, device=buf.device)[None]
    keep = mask & (cols < buf.shape[1])
    # dropped writes land in a spare column, cut off below
    cols = torch.where(keep, cols, buf.shape[1])
    out = torch.cat([buf, buf.new_zeros((b, 1))], dim=1)
    rows = torch.arange(b, device=buf.device)[:, None].expand(b, w)
    out[rows, cols] = vals.to(buf.dtype)
    return out[:, :-1].contiguous()
