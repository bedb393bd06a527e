"""Multi-head attention: dispatcher + plain reference implementation.

Counterpart of ``merlin_tpu/ops/attention.py``. Layout throughout:
``(batch, seq, heads, head_dim)``; GQA when num_kv_heads divides num_heads.

  * :func:`mha_reference` - plain PyTorch attention (a copy of the JAX
    package's): finite ``NEG_INF`` masking, f32 softmax, ``q_offset`` and
    ``k_positions`` for decode steps against a cache.
  * :func:`attention` - the self-attention dispatcher, with the JAX
    package's routing rule: bidirectional short-KV calls go to the one-pass
    kernel (B1), the rest of the flash-eligible calls to the flash forward
    kernel (B2), short sequences and CPU tensors to :func:`mha_reference`.
    The ring-attention and mesh branches of the JAX dispatcher are left out:
    the port runs on one card. Both kernel routes are differentiable: B1's
    route runs B12/B13 when a gradient is asked for, B2's runs B10/B11 in
    the backward.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def _q_positions(q_offset, q_len: int, device) -> torch.Tensor:
    """Query positions as (1 or b, q). ``q_offset`` may be an int or a
    per-sequence (b,)/(b, 1) tensor (ragged decode against padded caches)."""
    ar = torch.arange(q_len, device=device)
    if not torch.is_tensor(q_offset):
        return (q_offset + ar)[None]
    off = q_offset.to(device).reshape(q_offset.shape[0], -1)[:, :1]
    return off + ar[None]


def mha_reference(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True,
    segment_ids_q: Optional[torch.Tensor] = None,
    segment_ids_kv: Optional[torch.Tensor] = None,
    alibi_slopes: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    q_offset=0,
    k_positions: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain attention. q: (b, sq, h, d); k/v: (b, skv, hkv, d).

    ``q_offset`` shifts query positions (int or per-sequence (b,));
    ``alibi_slopes`` (h,) adds slope * (k_pos - q_pos); ``k_positions``
    (b, skv) overrides slot indices as key positions for ALiBi. Softmax in
    float32 whatever the input dtype. A row that sees no key gets the
    uniform average of v, as the JAX reference does.
    """
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    scale = scale if scale is not None else d ** -0.5
    if hkv != h:
        assert h % hkv == 0, (h, hkv)
        k = k.repeat_interleave(h // hkv, dim=2)
        v = v.repeat_interleave(h // hkv, dim=2)

    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale

    q_pos = None
    if alibi_slopes is not None or causal:
        q_pos = _q_positions(q_offset, sq, q.device)           # (1|b, q)
    if alibi_slopes is not None:
        if k_positions is not None:
            k_pos = k_positions[:, None, :]                    # (b, 1, k)
        else:
            k_pos = torch.arange(skv, device=q.device)[None, None, :]
        dist = (k_pos - q_pos[:, :, None]).float()             # (1|b, q, k)
        logits = logits + alibi_slopes.float()[None, :, None, None] \
            * dist[:, None]

    mask = None
    if causal:
        k_ar = torch.arange(skv, device=q.device)[None, None, :]
        mask = (k_ar <= q_pos[:, :, None])[:, None]            # (1|b, 1, q, k)
    if segment_ids_q is not None:
        seg = (segment_ids_q[:, :, None]
               == segment_ids_kv[:, None, :])[:, None]         # (b, 1, q, k)
        mask = seg if mask is None else (mask & seg)
    if mask is not None:
        logits = torch.where(mask, logits, NEG_INF)

    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(),
                       v.float())
    return out.to(q.dtype)


def attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
    causal: bool = True,
    segment_ids_q: Optional[torch.Tensor] = None,
    segment_ids_kv: Optional[torch.Tensor] = None,
    alibi_slopes: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Self-attention dispatcher (q_offset = 0).

    Routing (``merlin_tpu/ops/attention.py:192-206``): CPU tensors, sq < 128
    or d > 256 go to :func:`mha_reference`; a non-causal call with no ALiBi,
    no segment ids, no GQA, skv <= 4096 and d <= 128 goes to the one-pass
    kernel (B1; B12/B13 under autograd); everything else to the flash
    kernels (B2; B10/B11 in the backward). The route
    depends on the device and the shapes only: the kernels take bfloat16,
    and their wrappers raise on any other dtype. They need no padding: they
    mask the ragged edge themselves.
    """
    sq, skv, d = q.shape[1], k.shape[1], q.shape[-1]
    if q.device.type == "cpu" or sq < 128 or d > 256:
        return mha_reference(
            q, k, v, causal=causal, segment_ids_q=segment_ids_q,
            segment_ids_kv=segment_ids_kv, alibi_slopes=alibi_slopes,
            scale=scale)

    if (not causal and alibi_slopes is None and segment_ids_q is None
            and q.shape[2] == k.shape[2] and skv <= 4096 and d <= 128):
        from merlin_tpu_torch.ops.onepass_attention import (
            differentiable_onepass_attention)

        return differentiable_onepass_attention(q, k, v, scale=scale)

    from merlin_tpu_torch.ops.flash_attention import (
        differentiable_flash_attention)

    if segment_ids_q is not None:
        segment_ids_q = segment_ids_q.to(torch.int32).contiguous()
        segment_ids_kv = segment_ids_kv.to(torch.int32).contiguous()
    if alibi_slopes is not None:
        alibi_slopes = alibi_slopes.to(q.device, torch.float32).contiguous()
    return differentiable_flash_attention(
        q, k, v, causal=causal, segment_ids_q=segment_ids_q,
        segment_ids_kv=segment_ids_kv, alibi_slopes=alibi_slopes,
        scale=scale)
