"""B2, B10, B11: flash attention forward and backward (the decoder's
no-cache path).

Counterpart of ``merlin_tpu/ops/flash_attention.py``: ``_fwd_kernel`` via
``_flash_fwd_pallas`` (B2, ``csrc/attention_fwd.cu``, the dense forward it
shares with B1 and B12), and
``_bwd_dq_kernel`` / ``_bwd_dkv_gqa_kernel`` via ``_flash_bwd_pallas``
(B10 / B11, both served by one fused kernel in
``csrc/flash_attention_bwd.cu``). Each source note says what bounds its
kernel on the H100 and how the design answers.

Each kernel has a wrapper that launches it for CUDA tensors and raises on
anything it does not take, and a ``*_plain`` version: the same function in
plain PyTorch, used for CPU tensors and as the kernel's yardstick on the
card. :func:`flash_attention` returns ``(out, lse)``: out in q's dtype, the
natural-log LSE in f32 as (b, h, sq). :func:`flash_attention_bwd_dq` (B10)
and :func:`flash_attention_bwd_dkv` (B11) take that LSE and
di = sum(out * do) per row (:func:`attention_di`, plain torch, as JAX
computes it in XLA) and return dq, and dk/dv per kv head; on the card
each is one launch of the fused backward. :func:`flash_attention_bwd`
takes the forward's out instead of di and returns all three from one
launch. No sequence length needs padding.
:func:`differentiable_flash_attention` is the autograd function the
dispatcher calls: B2 forward, :func:`flash_attention_bwd` backward.

Dtypes: q, k and v are one dtype, as JAX's dense path gives them. bf16
runs the wgmma kernels above and counts in ``.launches``; f32 runs the
3xTF32 kernels (``csrc/attention_f32.cu``,
``csrc/flash_attention_bwd_f32.cu``: every product as three TF32 passes on
the tensor cores, at f32 accuracy) and counts in ``.launches_f32``. Each
computes what the TPU kernel computes at its operands' dtype
(:data:`DTYPE_RULE`); any other dtype raises. The plain versions already
apply the TPU kernels' rounding (p and ds rounded to the operands' dtype
for their products, which at f32 rounds nothing).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from merlin_tpu_torch.ops import _build

NEG_INF = -1e30
# head dims the kernels take (multiples of 8): the backward takes every d
# the forward does, so a route that runs B2 can train
FWD_MAX_D = 256
BWD_MAX_D = 256
# the rule every kernel wrapper of the port follows on a CUDA tensor
DTYPE_RULE = (
    "on a CUDA tensor the kernel computes what the TPU kernel computes at "
    "these operand dtypes: products accumulate in f32; q.k is taken at the "
    "promoted dtype (bf16 widened, never f32 narrowed); p is rounded to V's "
    "dtype before P.V; out is written in q's dtype from the f32 "
    "accumulator; a row that sees no key writes 0 (C2). On a CPU tensor the "
    "plain version follows JAX's CPU route.")


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


def _check_masks(name, q, k, segment_ids_q, segment_ids_kv,
                 alibi_slopes) -> None:
    """Raise unless the GQA grouping, segment ids and ALiBi slopes are what
    the flash kernels read."""
    b, sq, h, _ = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if h % hkv:
        raise ValueError(f"{name}: h={h} is not a multiple of hkv={hkv}")
    if (segment_ids_q is None) != (segment_ids_kv is None):
        raise ValueError(f"{name}: give both segment id arrays or neither")
    if segment_ids_q is not None:
        for t, shape, tn in ((segment_ids_q, (b, sq), "segment_ids_q"),
                             (segment_ids_kv, (b, skv), "segment_ids_kv")):
            if (t.device != q.device or t.dtype != torch.int32
                    or tuple(t.shape) != shape or not t.is_contiguous()):
                raise ValueError(f"{name}: {tn} must be contiguous int32 "
                                 f"{shape} on {q.device}")
    if alibi_slopes is not None and (
            alibi_slopes.device != q.device
            or alibi_slopes.dtype != torch.float32
            or tuple(alibi_slopes.shape) != (h,)
            or not alibi_slopes.is_contiguous()):
        raise ValueError(f"{name}: alibi_slopes must be contiguous float32 "
                         f"({h},) on {q.device}")


def _ptr(t: Optional[torch.Tensor]):
    return t.data_ptr() if t is not None else None


def flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    segment_ids_q: Optional[torch.Tensor] = None,
    segment_ids_kv: Optional[torch.Tensor] = None,
    alibi_slopes: Optional[torch.Tensor] = None,
    causal: bool = True, scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flash attention forward (B2); see :func:`flash_attention_plain`.
    bf16 or f32 q/k/v (one dtype) under :data:`DTYPE_RULE`."""
    kw = dict(segment_ids_q=segment_ids_q, segment_ids_kv=segment_ids_kv,
              alibi_slopes=alibi_slopes, causal=causal, scale=scale)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, **kw)
    _build.check_qkv("flash_attention", q, k, v, max_d=FWD_MAX_D)
    _check_masks("flash_attention", q, k, segment_ids_q, segment_ids_kv,
                 alibi_slopes)
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    f32 = q.dtype == torch.float32
    entry = (_build.lib().merlin_attention_f32 if f32
             else _build.lib().merlin_flash_attention_fwd_bf16)
    code = entry(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), _ptr(segment_ids_q), _ptr(segment_ids_kv),
        _ptr(alibi_slopes), b, sq, skv, h, hkv, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        float(scale), int(causal), _build.stream_handle(q.device))
    _build.check(code, "flash_attention")
    _build.count_launch(flash_attention, f32)
    return out, lse


flash_attention.launches = 0
flash_attention.launches_f32 = 0


# ---------------------------------------------------------------------------
# backward
# ---------------------------------------------------------------------------

def attention_di(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """di = sum(out * do) over d per (b, h, q), f32: the backward's row
    term, in the LSE's (b, h, sq) layout."""
    return torch.einsum("bshd,bshd->bhs", out.float(), do.float())


def _bwd_p_ds(q, k, v, do, lse, di, segment_ids_q, segment_ids_kv,
              alibi_slopes, causal, scale):
    """(p, ds) per (b, h, q, key) in f32, recomputed from the saved LSE
    with B2's mask: p = exp(s - lse), masked p = 0 (so a row that saw no
    key contributes 0, trap C2), ds = p (do v^T - di) scale. k and v come
    back repeated over each GQA group."""
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
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
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), v.float())
    ds = p * (dp - di[..., None]) * scale
    return p, ds, k


def flash_attention_bwd_dq_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, di: torch.Tensor, *,
    segment_ids_q: Optional[torch.Tensor] = None,
    segment_ids_kv: Optional[torch.Tensor] = None,
    alibi_slopes: Optional[torch.Tensor] = None,
    causal: bool = True, scale: Optional[float] = None,
) -> torch.Tensor:
    """dq = ds k, ds rounded to k's dtype for the product (as the TPU
    kernel rounds it), f32 sums; (b, sq, h, d) in q's dtype."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    _, ds, k_rep = _bwd_p_ds(q, k, v, do, lse, di, segment_ids_q,
                             segment_ids_kv, alibi_slopes, causal, scale)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(),
                      k_rep.float())
    return dq.to(q.dtype)


def flash_attention_bwd_dkv_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, di: torch.Tensor, *,
    segment_ids_q: Optional[torch.Tensor] = None,
    segment_ids_kv: Optional[torch.Tensor] = None,
    alibi_slopes: Optional[torch.Tensor] = None,
    causal: bool = True, scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """dk = ds^T q and dv = p^T do, p and ds rounded to the operands' dtype
    for the products, each kv head's sum taken over its query group in f32
    before one rounding; (b, skv, hkv, d) in k's and v's dtypes."""
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    p, ds, _ = _bwd_p_ds(q, k, v, do, lse, di, segment_ids_q,
                         segment_ids_kv, alibi_slopes, causal, scale)
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(), q.float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    group = (b, skv, hkv, h // hkv, d)
    return (dk.reshape(group).sum(3).to(k.dtype),
            dv.reshape(group).sum(3).to(v.dtype))


def _check_bwd(name, q, k, v, do, lse, di=None):
    """Raise unless do, lse and di (when given) are what the backward
    kernel reads."""
    _build.check_qkv(name, q, k, v, max_d=BWD_MAX_D)
    _build.check_qkv(name, do, k, v, max_d=BWD_MAX_D)
    if do.shape != q.shape:
        raise ValueError(f"{name}: do {tuple(do.shape)} must match q "
                         f"{tuple(q.shape)}")
    shape = (q.shape[0], q.shape[2], q.shape[1])
    for t, tn in ((lse, "lse"), (di, "di")):
        if t is not None and (
                t.device != q.device or t.dtype != torch.float32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"{name}: {tn} must be contiguous float32 "
                             f"{shape} on {q.device}")


def _check_out(name, q, k, v, out):
    """Raise unless the forward's out is what the pre-pass reads for di."""
    _build.check_qkv(name, out, k, v, max_d=BWD_MAX_D)
    if out.shape != q.shape:
        raise ValueError(f"{name}: out {tuple(out.shape)} must match q "
                         f"{tuple(q.shape)}")


def _launch_bwd(name, q, k, v, do, lse, di, out, segment_ids_q,
                segment_ids_kv, alibi_slopes, causal, scale):
    """One launch of the backward on checked inputs. bf16: the fused
    kernel with its pre-pass (zeroes the f32 dq buffer; given ``out``
    instead of ``di``, computes di = sum(out * do)) and post-pass (dq to
    bf16). f32: the dq kernel (di from ``out`` when given) then the dk/dv
    kernel. Returns dq (b, sq, h, d) and dk, dv (b, skv, hkv, d)."""
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    if di is None:
        di = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    if q.dtype == torch.float32:
        dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        dk = torch.empty(k.shape, dtype=k.dtype, device=q.device)
        dv = torch.empty(v.shape, dtype=v.dtype, device=q.device)
        code = _build.lib().merlin_attention_bwd_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(out),
            do.data_ptr(), lse.data_ptr(), di.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), _ptr(segment_ids_q),
            _ptr(segment_ids_kv), _ptr(alibi_slopes), b, sq, skv, h, hkv, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *do.stride()[:3],
            *(out.stride()[:3] if out is not None else (0, 0, 0)),
            float(scale), int(causal), _build.stream_handle(q.device))
        _build.check(code, name)
        return dq, dk, dv
    dq_acc = torch.empty((b, sq, h, d), dtype=torch.float32, device=q.device)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=q.device)
    code = _build.lib().merlin_flash_attention_bwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(out), do.data_ptr(),
        lse.data_ptr(), di.data_ptr(), dq_acc.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), _ptr(segment_ids_q),
        _ptr(segment_ids_kv), _ptr(alibi_slopes), b, sq, skv, h, hkv, d,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3], *do.stride()[:3],
        *(out.stride()[:3] if out is not None else (0, 0, 0)), float(scale),
        int(causal), _build.stream_handle(q.device))
    _build.check(code, name)
    return dq, dk, dv


def flash_attention_bwd_dq(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, di: torch.Tensor, *,
    segment_ids_q: Optional[torch.Tensor] = None,
    segment_ids_kv: Optional[torch.Tensor] = None,
    alibi_slopes: Optional[torch.Tensor] = None,
    causal: bool = True, scale: Optional[float] = None,
) -> torch.Tensor:
    """B10: dq; see :func:`flash_attention_bwd_dq_plain`. On the card, one
    launch of the backward (bf16 or f32 operands, :data:`DTYPE_RULE`), of
    which dq is returned."""
    kw = dict(segment_ids_q=segment_ids_q, segment_ids_kv=segment_ids_kv,
              alibi_slopes=alibi_slopes, causal=causal, scale=scale)
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_plain(q, k, v, do, lse, di, **kw)
    _check_bwd("flash_attention_bwd_dq", q, k, v, do, lse, di)
    _check_masks("flash_attention_bwd_dq", q, k, segment_ids_q,
                 segment_ids_kv, alibi_slopes)
    dq, _, _ = _launch_bwd("flash_attention_bwd_dq", q, k, v, do, lse, di,
                           None, segment_ids_q, segment_ids_kv, alibi_slopes,
                           causal, scale)
    _build.count_launch(flash_attention_bwd_dq, q.dtype == torch.float32)
    return dq


flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dq.launches_f32 = 0


def flash_attention_bwd_dkv(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, do: torch.Tensor,
    lse: torch.Tensor, di: torch.Tensor, *,
    segment_ids_q: Optional[torch.Tensor] = None,
    segment_ids_kv: Optional[torch.Tensor] = None,
    alibi_slopes: Optional[torch.Tensor] = None,
    causal: bool = True, scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """B11: (dk, dv) per kv head; see :func:`flash_attention_bwd_dkv_plain`.
    On the card, one launch of the backward (bf16 or f32 operands,
    :data:`DTYPE_RULE`), of which dk and dv are returned."""
    kw = dict(segment_ids_q=segment_ids_q, segment_ids_kv=segment_ids_kv,
              alibi_slopes=alibi_slopes, causal=causal, scale=scale)
    if q.device.type == "cpu":
        return flash_attention_bwd_dkv_plain(q, k, v, do, lse, di, **kw)
    _check_bwd("flash_attention_bwd_dkv", q, k, v, do, lse, di)
    _check_masks("flash_attention_bwd_dkv", q, k, segment_ids_q,
                 segment_ids_kv, alibi_slopes)
    _, dk, dv = _launch_bwd("flash_attention_bwd_dkv", q, k, v, do, lse, di,
                            None, segment_ids_q, segment_ids_kv,
                            alibi_slopes, causal, scale)
    _build.count_launch(flash_attention_bwd_dkv, q.dtype == torch.float32)
    return dk, dv


flash_attention_bwd_dkv.launches = 0
flash_attention_bwd_dkv.launches_f32 = 0


def flash_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
    lse: torch.Tensor, do: torch.Tensor, *,
    segment_ids_q: Optional[torch.Tensor] = None,
    segment_ids_kv: Optional[torch.Tensor] = None,
    alibi_slopes: Optional[torch.Tensor] = None,
    causal: bool = True, scale: Optional[float] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) from the forward's out and LSE (B10 + B11); see
    :func:`flash_attention_bwd_plain`. On the card, one launch of the
    backward (bf16 or f32 operands, :data:`DTYPE_RULE`), which computes di
    from out and do."""
    kw = dict(segment_ids_q=segment_ids_q, segment_ids_kv=segment_ids_kv,
              alibi_slopes=alibi_slopes, causal=causal, scale=scale)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, out, lse, do, **kw)
    _check_bwd("flash_attention_bwd", q, k, v, do, lse)
    _check_out("flash_attention_bwd", q, k, v, out)
    _check_masks("flash_attention_bwd", q, k, segment_ids_q, segment_ids_kv,
                 alibi_slopes)
    grads = _launch_bwd("flash_attention_bwd", q, k, v, do, lse, None, out,
                        segment_ids_q, segment_ids_kv, alibi_slopes, causal,
                        scale)
    _build.count_launch(flash_attention_bwd, q.dtype == torch.float32)
    return grads


flash_attention_bwd.launches = 0
flash_attention_bwd.launches_f32 = 0


def flash_attention_bwd_plain(q, k, v, out, lse, do, **kw):
    """:func:`flash_attention_bwd` in plain PyTorch on any device: di by
    :func:`attention_di`, then the B10 and B11 plain versions; the
    yardstick of the fused kernel on the card."""
    di = attention_di(out, do)
    dq = flash_attention_bwd_dq_plain(q, k, v, do, lse, di, **kw)
    dk, dv = flash_attention_bwd_dkv_plain(q, k, v, do, lse, di, **kw)
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention with its kernels' backward, as the JAX package's
    ``_flash`` custom VJP: the forward (B2) saves out and the LSE, the
    backward makes one fused launch (B10 + B11) from them."""

    @staticmethod
    def forward(ctx, q, k, v, segment_ids_q, segment_ids_kv, alibi_slopes,
                causal, scale):
        kw = dict(segment_ids_q=segment_ids_q, segment_ids_kv=segment_ids_kv,
                  alibi_slopes=alibi_slopes, causal=causal, scale=scale)
        out, lse = flash_attention(q, k, v, **kw)
        ctx.save_for_backward(q, k, v, out, lse, segment_ids_q,
                              segment_ids_kv, alibi_slopes)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, seg_q, seg_kv, slopes = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(
            q, k, v, out, lse, do.contiguous(), segment_ids_q=seg_q,
            segment_ids_kv=seg_kv, alibi_slopes=slopes, causal=ctx.causal,
            scale=ctx.scale)
        return dq, dk, dv, None, None, None, None, None


def differentiable_flash_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    segment_ids_q: Optional[torch.Tensor] = None,
    segment_ids_kv: Optional[torch.Tensor] = None,
    alibi_slopes: Optional[torch.Tensor] = None,
    causal: bool = True, scale: Optional[float] = None,
) -> torch.Tensor:
    """Flash attention's output with a kernel backward (B2; the fused
    B10 + B11)."""
    return FlashAttentionFn.apply(q, k, v, segment_ids_q, segment_ids_kv,
                                  alibi_slopes, causal, scale)
