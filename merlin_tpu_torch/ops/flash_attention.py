"""B2: flash-attention forward (the decoder's no-cache path).

Counterpart of ``merlin_tpu/ops/flash_attention.py`` ``_fwd_kernel`` via
``_flash_fwd_pallas``. The CUDA kernel is ``csrc/flash_attention.cu``; its
source note says what bounds it on the H100 and how the design answers.
Forward only: the backward kernels come with the training slice.

:func:`flash_attention` launches the kernel for CUDA tensors and raises on
anything it does not take; :func:`flash_attention_plain` is the same
function in plain PyTorch, used for CPU tensors and as the kernel's
yardstick on the card. Both return ``(out, lse)``: out in q's dtype, the
natural-log LSE in f32 as (b, h, sq). No sequence length needs padding.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from merlin_tpu_torch.ops import _build

NEG_INF = -1e30


def flash_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    segment_ids_q: Optional[torch.Tensor] = None,
    segment_ids_kv: Optional[torch.Tensor] = None,
    alibi_slopes: Optional[torch.Tensor] = None,
    causal: bool = True, scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """q (b, sq, h, d); k/v (b, skv, hkv, d). Causal masking is top-left
    aligned (key k visible to query q iff k <= q), as in the TPU kernel.

    Masked scores take the finite NEG_INF and masked p is zeroed, so a row
    with no visible key gives l = 0, output 0 and LSE = NEG_INF (trap C2).
    """
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    if hkv != h:
        k = k.repeat_interleave(h // hkv, dim=2)
        v = v.repeat_interleave(h // hkv, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    q_pos = torch.arange(sq, device=q.device)[:, None]
    k_pos = torch.arange(skv, device=q.device)[None, :]
    if alibi_slopes is not None:
        s = s + alibi_slopes.float()[None, :, None, None] * (k_pos - q_pos)
    mask = torch.ones((b, 1, sq, skv), dtype=torch.bool, device=q.device)
    if segment_ids_q is not None:
        mask = mask & (segment_ids_q[:, None, :, None]
                       == segment_ids_kv[:, None, None, :])
    if causal:
        mask = mask & (k_pos <= q_pos)
    s = torch.where(mask, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(mask, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0, 1.0, l)
    acc = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), v.float())
    out = (acc / l_safe).permute(0, 2, 1, 3).to(q.dtype)
    lse = torch.where(l == 0, NEG_INF, m + torch.log(l_safe))[..., 0]
    return out, lse


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    segment_ids_q: Optional[torch.Tensor] = None,
    segment_ids_kv: Optional[torch.Tensor] = None,
    alibi_slopes: Optional[torch.Tensor] = None,
    causal: bool = True, scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash attention forward; see :func:`flash_attention_plain`."""
    kw = dict(segment_ids_q=segment_ids_q, segment_ids_kv=segment_ids_kv,
              alibi_slopes=alibi_slopes, causal=causal, scale=scale)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, **kw)
    _build.check_qkv("flash_attention", q, k, v, max_d=256)
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if h % hkv:
        raise ValueError(f"flash_attention: h={h} is not a multiple of "
                         f"hkv={hkv}")
    if (segment_ids_q is None) != (segment_ids_kv is None):
        raise ValueError("flash_attention: give both segment id arrays "
                         "or neither")
    if segment_ids_q is not None:
        for t, shape, tn in ((segment_ids_q, (b, sq), "segment_ids_q"),
                             (segment_ids_kv, (b, skv), "segment_ids_kv")):
            if (t.device != q.device or t.dtype != torch.int32
                    or tuple(t.shape) != shape or not t.is_contiguous()):
                raise ValueError(f"flash_attention: {tn} must be contiguous "
                                 f"int32 {shape} on {q.device}")
    if alibi_slopes is not None and (
            alibi_slopes.device != q.device
            or alibi_slopes.dtype != torch.float32
            or tuple(alibi_slopes.shape) != (h,)
            or not alibi_slopes.is_contiguous()):
        raise ValueError(f"flash_attention: alibi_slopes must be contiguous "
                         f"float32 ({h},) on {q.device}")
    scale = scale if scale is not None else d ** -0.5
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)

    def ptr(t):
        return t.data_ptr() if t is not None else None

    code = _build.lib().merlin_flash_attention_fwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), ptr(segment_ids_q), ptr(segment_ids_kv),
        ptr(alibi_slopes), b, sq, skv, h, hkv, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        float(scale), int(causal), _build.stream_handle(q.device))
    _build.check(code, "flash_attention")
    flash_attention.launches += 1
    return out, lse


flash_attention.launches = 0
