"""Ring attention: context parallelism over the mesh's ``seq`` axis
(counterpart of ``merlin_tpu/ops/ring_attention.py``).

Q/K/V are split over the sequence; the K/V (and segment id) blocks rotate
around the ranks of the seq group with ``batch_isend_irecv`` while each
rank attends its query chunk to the block in front of it, and the partial
softmax statistics merge online. The local step is plain PyTorch, as the
JAX package's is an einsum (there is no ``pallas_call`` here).

Autograd does not pass through send/recv, so the ring is one
``torch.autograd.Function`` whose backward runs the ring again: the K/V
blocks travel with their dK/dV accumulators, and after n rotations each
accumulator is back at the rank that owns its block (JAX gets this
backward from ``ppermute``'s transpose).

A row that sees no key writes 0 here (the ring's ``l == 0`` guard), where
:func:`merlin_tpu_torch.ops.attention.mha_reference` writes the uniform
average of v (trap C2): both are kept as in JAX.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from merlin_tpu_torch.core.parallel import gather_from_group, split_to_group

NEG_INF = -1e30


def _offsets(idx: int, src: int, s_local: int):
    """Global positions of the first query of rank ``idx`` and the first
    key of the block made by rank ``src``."""
    return idx * s_local, src * s_local


def _mask(sq, sk, q_offset, k_offset, causal, q_seg, k_seg, device):
    mask = None
    if causal:
        q_pos = q_offset + torch.arange(sq, device=device)
        k_pos = k_offset + torch.arange(sk, device=device)
        mask = (k_pos[None, :] <= q_pos[:, None])[None]          # (1, q, k)
    if q_seg is not None:
        seg = q_seg[:, :, None] == k_seg[:, None, :]             # (b, q, k)
        mask = seg if mask is None else (mask & seg)
    return mask


def _local_attention_with_stats(q, k, v, *, scale, q_offset, k_offset,
                                causal, q_seg=None, k_seg=None):
    """Attention of local q against one kv block, returning the
    unnormalized output and (m, l) statistics for cross-block merging.

    q: (b, sq, h, d); k/v: (b, sk, h, d). Positions are global via the
    offsets; q_seg/k_seg are optional (b, s_local) segment ids."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    mask = _mask(q.shape[1], k.shape[1], q_offset, k_offset, causal, q_seg,
                 k_seg, q.device)
    if mask is not None:
        s = torch.where(mask[:, None], s, NEG_INF)
    m = s.amax(dim=-1)                                           # (b, h, q)
    p = torch.exp(s - m[..., None])
    # fully-masked rows have m == NEG_INF and exp(s - m) == 1: zero them
    p = torch.where(s > NEG_INF / 2, p, 0.0)
    l = p.sum(dim=-1)                                            # (b, h, q)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return o, m, l


def _merge(o1, m1, l1, o2, m2, l2):
    """Online-softmax merge of two partial attention results."""
    m = torch.maximum(m1, m2)
    a1 = torch.exp(m1 - m)
    a2 = torch.exp(m2 - m)
    o = o1 * a1.transpose(1, 2)[..., None] + o2 * a2.transpose(1, 2)[..., None]
    l = l1 * a1 + l2 * a2
    return o, m, l


def _rotate(tensors, group):
    """Send each tensor to the next rank of ``group`` and receive the
    previous rank's, all in one batch of point-to-point ops."""
    ranks = dist.get_process_group_ranks(group)
    i = dist.get_rank(group)
    n = len(ranks)
    nxt, prv = ranks[(i + 1) % n], ranks[(i - 1) % n]
    out = [torch.empty_like(t) for t in tensors]
    ops = []
    for t, r in zip(tensors, out):
        ops.append(dist.P2POp(dist.isend, t.contiguous(), nxt, group))
        ops.append(dist.P2POp(dist.irecv, r, prv, group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, seg, group, causal, scale, use_seg):
        n, idx = dist.get_world_size(group), dist.get_rank(group)
        b, sq, h, d = q.shape
        o = torch.zeros((b, sq, h, d), dtype=torch.float32, device=q.device)
        m = torch.full((b, h, sq), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
        kb, vb, sb = k, v, seg
        for step in range(n):
            src = (idx - step) % n
            q_off, k_off = _offsets(idx, src, sq)
            o2, m2, l2 = _local_attention_with_stats(
                q, kb, vb, scale=scale, q_offset=q_off, k_offset=k_off,
                causal=causal, q_seg=seg if use_seg else None,
                k_seg=sb if use_seg else None)
            o, m, l = _merge(o, m, l, o2, m2, l2)
            if step < n - 1:
                kb, vb, sb = _rotate((kb, vb, sb), group)
        l_safe = torch.where(l == 0.0, 1.0, l)
        out = (o / l_safe.transpose(1, 2)[..., None]).to(q.dtype)
        ctx.save_for_backward(q, k, v, seg, out, m + torch.log(l_safe),
                              l == 0.0)
        ctx.group, ctx.causal, ctx.scale, ctx.use_seg = (group, causal,
                                                         scale, use_seg)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, seg, out, lse, empty = ctx.saved_tensors
        group, scale = ctx.group, ctx.scale
        n, idx = dist.get_world_size(group), dist.get_rank(group)
        sq = q.shape[1]
        qf, do = q.float(), dout.float()
        delta = (do * out.float()).sum(-1).transpose(1, 2)       # (b, h, q)
        dq = torch.zeros_like(qf)
        kb, vb, sb = k, v, seg
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        for step in range(n):
            src = (idx - step) % n
            q_off, k_off = _offsets(idx, src, sq)
            s = torch.einsum("bqhd,bkhd->bhqk", qf, kb.float()) * scale
            mask = _mask(sq, kb.shape[1], q_off, k_off, ctx.causal,
                         seg if ctx.use_seg else None,
                         sb if ctx.use_seg else None, q.device)
            keep = ~empty[..., None]
            if mask is not None:
                keep = keep & mask[:, None]
            p = torch.where(keep, torch.exp(s - lse[..., None]), 0.0)
            dv = dv + torch.einsum("bhqk,bqhd->bkhd", p, do)
            dp = torch.einsum("bqhd,bkhd->bhqk", do, vb.float())
            ds = p * (dp - delta[..., None])
            dq = dq + torch.einsum("bhqk,bkhd->bqhd", ds, kb.float()) * scale
            dk = dk + torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
            # the block and its accumulators travel on; after n rotations
            # each accumulator is back at its block's owner
            if step < n - 1:
                kb, vb, sb, dk, dv = _rotate((kb, vb, sb, dk, dv), group)
            else:
                dk, dv = _rotate((dk, dv), group)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None, None)


def ring_attention_local(q, k, v, segment_ids, *, group, causal: bool = True,
                         scale: Optional[float] = None,
                         use_segments: bool = True):
    """The ring on this rank's chunks: q/k/v (b, s_local, h, d) and
    segment ids (b, s_local) of rank ``i`` of ``group`` hold global
    positions [i * s_local, (i + 1) * s_local). Returns this rank's
    output chunk; differentiable."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    return _RingAttention.apply(q, k, v, segment_ids, group, causal, scale,
                                use_segments)


def ring_self_attention(q, k, v, *, mesh, axis: str = "seq",
                        causal: bool = True,
                        segment_ids: Optional[torch.Tensor] = None,
                        scale: Optional[float] = None):
    """Self-attention with Q/K/V split over mesh axis ``axis`` along the
    sequence. q/k/v: (b, s, h, d) GLOBAL tensors, the same on every rank of
    the axis (as JAX's global arrays); the output is global too: each rank
    computes its chunk and the chunks are all-gathered (the gather's
    backward hands each rank its own chunk's gradient, and the split's
    backward gathers the input gradients, so everything outside the ring
    stays replicated over the axis). Requires s % axis_size == 0."""
    group = mesh.get_group(axis)
    n = dist.get_world_size(group)
    if q.shape[1] % n:
        raise ValueError(f"sequence {q.shape[1]} does not split over the "
                         f"{axis} axis ({n})")
    use_seg = segment_ids is not None
    if segment_ids is None:
        segment_ids = torch.ones(q.shape[:2], dtype=torch.int32,
                                 device=q.device)
    seg = segment_ids.chunk(n, dim=1)[dist.get_rank(group)].contiguous()
    ql, kl, vl = (split_to_group(t, group, 1) for t in (q, k, v))
    out = ring_attention_local(ql, kl, vl, seg, group=group, causal=causal,
                               scale=scale, use_segments=use_seg)
    return gather_from_group(out, group, dim=1)
