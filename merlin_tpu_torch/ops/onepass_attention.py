"""B1: bidirectional attention for short-KV shapes (the ViT tower).

Counterpart of ``merlin_tpu/ops/onepass_attention.py`` (inference path,
``_make_kernel(emit_lse=False)`` / ``_make_kernel_bd`` via
``_onepass_fwd``). The CUDA kernel is ``csrc/onepass_attention.cu``; its
source note says what bounds it on the H100 and why it tiles the KV where
the TPU kernel held it whole.

:func:`onepass_attention` launches the kernel for CUDA tensors and raises on
anything it does not take; :func:`onepass_attention_plain` is the same
function in plain PyTorch, used for CPU tensors and as the kernel's yardstick
on the card.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from merlin_tpu_torch.ops import _build

LOG2E = math.log2(math.e)


def onepass_attention_plain(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *,
                            scale: Optional[float] = None) -> torch.Tensor:
    """q/k/v (b, s, h, d), same h -> (b, sq, h, d) in q's dtype.

    Scores in f32 scaled by scale*log2(e), exp2 after subtracting the row
    max (the TPU inference kernel clamps at 2^120 instead and skips the
    max; the two agree while natural logits stay below ~88, trap C5); p
    rounded to v's dtype for P@V, the denominator summed from f32 p.
    """
    d = q.shape[-1]
    scale = scale if scale is not None else d ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (scale * LOG2E)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), v.float())
    return (acc / l).permute(0, 2, 1, 3).to(q.dtype)


def onepass_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      scale: Optional[float] = None) -> torch.Tensor:
    """Bidirectional attention; q/k/v (b, s, h, d) with the same h, any
    sequence lengths (the kernel masks the ragged edge itself)."""
    if q.device.type == "cpu":
        return onepass_attention_plain(q, k, v, scale=scale)
    _build.check_qkv("onepass_attention", q, k, v, max_d=128)
    if k.shape[2] != q.shape[2]:
        raise ValueError("onepass_attention: GQA is not supported "
                         f"(h={q.shape[2]}, hkv={k.shape[2]})")
    b, sq, h, d = q.shape
    skv = k.shape[1]
    scale = scale if scale is not None else d ** -0.5
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    code = _build.lib().merlin_onepass_attention_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, sq, skv, h, d, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        float(scale), _build.stream_handle(q.device))
    _build.check(code, "onepass_attention")
    onepass_attention.launches += 1
    return out


onepass_attention.launches = 0
