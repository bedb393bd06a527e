"""B1, B12, B13: bidirectional attention for short-KV shapes (the ViT tower).

Counterpart of ``merlin_tpu/ops/onepass_attention.py``:

  * B1, the inference path: ``_make_kernel(emit_lse=False)`` /
    ``_make_kernel_bd`` via ``_onepass_fwd`` -> :func:`onepass_attention`
    (``csrc/onepass_attention.cu``);
  * B12, the trained path's forward: ``_make_kernel(emit_lse=True)`` via
    ``_onepass_fwd_rule`` -> :func:`onepass_attention_lse`, the same kernel
    writing the natural-log LSE as well;
  * B13, its backward: ``_make_dq_kernel`` / ``_make_dkv_kernel`` via
    ``_onepass_bwd_rule`` -> :func:`onepass_attention_bwd`, one launch of
    the fused flash backward (``csrc/flash_attention_bwd.cu``) non-causal
    and unmasked: it masks the ragged edge at 1025 itself, where the TPU
    pads to 128 and lets the zero rows cancel.

Each wrapper launches its kernel for CUDA tensors and raises on anything it
does not take; its ``*_plain`` version is the same function in plain
PyTorch, used for CPU tensors and as the kernel's yardstick on the card.
:func:`differentiable_onepass_attention` is what the dispatcher calls: B1
when no gradient is asked for, else B12 forward and B13 backward.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from merlin_tpu_torch.ops import _build
from merlin_tpu_torch.ops.flash_attention import (
    _check_bwd, _check_out, _launch_bwd, attention_di)

LOG2E = math.log2(math.e)


def _onepass_plain(q, k, v, scale):
    """(out, m, l): out in q's dtype, the log2-domain row max m and the
    sum l of the f32 p = exp2(s - m)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (scale * LOG2E)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp2(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), v.float())
    return (acc / l).permute(0, 2, 1, 3).to(q.dtype), m, l


def onepass_attention_plain(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *,
                            scale: Optional[float] = None) -> torch.Tensor:
    """q/k/v (b, s, h, d), same h -> (b, sq, h, d) in q's dtype.

    Scores in f32 scaled by scale*log2(e), exp2 after subtracting the row
    max (the TPU inference kernel clamps at 2^120 instead and skips the
    max; the two agree while natural logits stay below ~88, trap C5); p
    rounded to v's dtype for P@V, the denominator summed from f32 p.
    """
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    return _onepass_plain(q, k, v, scale)[0]


def onepass_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      scale: Optional[float] = None) -> torch.Tensor:
    """B1: bidirectional attention; q/k/v (b, s, h, d) with the same h, any
    sequence lengths (the kernel masks the ragged edge itself)."""
    if q.device.type == "cpu":
        return onepass_attention_plain(q, k, v, scale=scale)
    out, _ = _launch_forward("onepass_attention", q, k, v, scale, lse=False)
    onepass_attention.launches += 1
    return out


onepass_attention.launches = 0


def onepass_attention_lse_plain(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        scale: Optional[float] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`onepass_attention_plain` and the natural-log LSE
    (m / log2(e) + log l) as (b, h, sq) f32."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    out, m, l = _onepass_plain(q, k, v, scale)
    return out, (m / LOG2E + torch.log(l))[..., 0]


def onepass_attention_lse(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        scale: Optional[float] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """B12: (out, lse), the trained path's forward; see
    :func:`onepass_attention_lse_plain`."""
    if q.device.type == "cpu":
        return onepass_attention_lse_plain(q, k, v, scale=scale)
    out, lse = _launch_forward("onepass_attention_lse", q, k, v, scale,
                               lse=True)
    onepass_attention_lse.launches += 1
    return out, lse


onepass_attention_lse.launches = 0


def _launch_forward(name, q, k, v, scale, *, lse: bool):
    """Launch the one-pass kernel (B1, or B12 with ``lse``)."""
    _build.check_qkv(name, q, k, v, max_d=128)
    if k.shape[2] != q.shape[2]:
        raise ValueError(f"{name}: GQA is not supported "
                         f"(h={q.shape[2]}, hkv={k.shape[2]})")
    b, sq, h, d = q.shape
    skv = k.shape[1]
    scale = scale if scale is not None else d ** -0.5
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse_t = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
             if lse else None)
    code = _build.lib().merlin_onepass_attention_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse_t.data_ptr() if lse else None,
        b, sq, skv, h, d, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        float(scale), _build.stream_handle(q.device))
    _build.check(code, name)
    return out, lse_t


def onepass_attention_bwd_plain(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
        lse: torch.Tensor, di: torch.Tensor, *,
        scale: Optional[float] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) as the TPU's one-pass backward computes them: scores in
    the log2 domain, p = exp2(s - lse log2(e)), ds = p (do v^T - di) scale,
    dq = ds k, dk = ds^T q, dv = p^T do, with p and ds rounded to the
    operands' dtype for the products and f32 sums."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (scale * LOG2E)
    p = torch.exp2(s - lse[..., None] * LOG2E)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    ds = p * (dp - di[..., None]) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(), k.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def onepass_attention_bwd(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
        lse: torch.Tensor, out: torch.Tensor, *,
        scale: Optional[float] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """B13: (dq, dk, dv) from B12's out and LSE; see
    :func:`onepass_attention_bwd_plain`, fed di = sum(out * do). One call
    makes one launch of the fused flash backward, non-causal with no masks,
    whose pre-pass computes di."""
    if q.device.type == "cpu":
        return onepass_attention_bwd_plain(q, k, v, do, lse,
                                           attention_di(out, do), scale=scale)
    _check_bwd("onepass_attention_bwd", q, k, v, do, lse)
    if k.shape[2] != q.shape[2]:
        raise ValueError("onepass_attention_bwd: GQA is not supported")
    _check_out("onepass_attention_bwd", q, k, v, out)
    grads = _launch_bwd("onepass_attention_bwd", q, k, v, do, lse, None, out,
                        None, None, None, False, scale)
    onepass_attention_bwd.launches += 1
    return grads


onepass_attention_bwd.launches = 0


class OnepassAttentionFn(torch.autograd.Function):
    """One-pass attention with its kernels' backward, as the JAX package's
    ``_onepass`` custom VJP on its trained path: B12 saves out and the LSE,
    the backward runs B13 from them."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = onepass_attention_lse(q, k, v, scale=scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = onepass_attention_bwd(q, k, v, do.contiguous(), lse,
                                           out, scale=ctx.scale)
        return dq, dk, dv, None


def differentiable_onepass_attention(
        q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        scale: Optional[float] = None) -> torch.Tensor:
    """B1 when no gradient is asked of q, k or v; otherwise B12 forward and
    B13 backward (the JAX forward rule always emits the LSE)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return OnepassAttentionFn.apply(q, k, v, scale)
    return onepass_attention(q, k, v, scale=scale)
