"""Paged KV cache: page allocator, page writes and paged attention
(counterpart of ``merlin_tpu/ops/paged_attention.py``), over float pages
and over int8 pages with per-(token, kv head) f32 scales.

Each sequence's K/V lives in fixed-size pages of one shared pool; a page
table maps its logical blocks to physical pages. Pages are HEAD-PACKED,
``(total_pages, page_size, hkv * d)``: one token of every kv head is one
contiguous row, so a token's write is one row and a head's keys are a
``d``-wide column slice of each row.

Four TPU kernels sit on the serving path; two CUDA kernels
(``csrc/paged_attention.cu``) stand in for them, and both split each
sequence's keys over CTAs and take any query group and any head dim that
is a multiple of 8 up to :data:`MAX_HEAD_DIM` (256; two forms each, up to
128 and past it):

  * the few-rows kernel: paged decode, one query token per sequence,
    :func:`paged_attention_dma` (B3, no ALiBi) and :func:`paged_attention`
    (B4, ALiBi); and paged windows of up to :data:`WINDOW_SMALL_ROWS` query
    rows per kv head (speculative verify), :func:`paged_attention_dma_multi`
    (B5);
  * the window kernel (wgmma, 128 query rows of a kv head a CTA at 64 <
    d <= 128; 64 rows and one 128-column half of O a CTA at d > 128):
    paged windows, ``s_q`` queries per sequence, causal from their true
    positions, for chunked prefill:
    :func:`paged_attention_multi_blocked` (B6).
    :func:`paged_window_attention` picks B5 or B6 from the window's shape.

The same two CUDA kernels read int8 pages (their scale pages ``(P, page,
128)`` f32 in the strided layout of :func:`_scale_row`) for the three int8
TPU kernels:

  * int8 paged decode: :func:`paged_attention_dma_q8` (B7 at s_q = 1, what
    the decoder's token step calls) and :func:`paged_attention_quantized`
    (B9), on the few-rows kernel;
  * int8 paged window: :func:`paged_attention_dma_multi_q8` (B7 windows,
    the few-rows kernel) and :func:`paged_attention_multi_blocked_q8` (B8,
    the window kernel). :func:`paged_window_attention_q8` picks one.

Their plain versions (:func:`paged_attention_q8_plain`,
:func:`paged_attention_multi_q8_plain`) copy the JAX decoder's CPU route:
:func:`dequantize_pages` to bf16, then the float plain version.

Each wrapper computes its plain version (:func:`paged_attention_plain`,
:func:`paged_attention_multi_plain`, copies of the JAX references) for CPU
tensors, and for CUDA tensors launches its kernel or raises. The TPU
wrappers' ``pages_per_block`` and VMEM routing are layout, not contract,
and have no counterpart. Each wrapper counts its launches in
``.launches``.

A row that sees no key (a sequence length of 0, or below the window) gets
the uniform average of V from the plain versions, as in JAX, and 0 from
the kernels (trap C2); the decoder never produces one.

Dtypes: q is bf16 or f32, pages bf16, f32 or int8. bf16 q over bf16 or
int8 pages runs the two kernels above and counts in ``.launches``; every
other pair runs their f32 counterparts (``csrc/paged_attention_f32.cu``,
products on the tensor cores in 3xTF32 or fewer passes, routed as the
bf16 ones; the few-rows kernel splits keys by :func:`rows_plan` as the
bf16 one does, the window kernel by :func:`window_plan` with ``f32``) and counts
in ``.launches_f32``.
On a CUDA tensor each wrapper computes what its TPU kernel computes at
these operand dtypes: f32 sums, q.k at the promoted dtype, p rounded to
the page dtype before P.V (C48), out in q's dtype, C2's zero rows; B8 and
B9 dequantize int8 pages to q's dtype, B7 computes with bf16 operands
whatever q's dtype (C49). On a CPU tensor the plain version follows JAX's
CPU route (the references, int8 pages dequantized to bf16), which keeps p
in f32. The plain versions' ``kernel_rounding`` applies the TPU kernel's
rule instead, on blocks of ``block_keys`` keys (the TPU kernels' page;
:data:`F32_TILE_KEYS`, the f32 kernels' tile, on the card), and
``split_keys`` walks the keys in the f32 kernels' key splits, each
rounding p against its own running max (the TPU kernel walks them in
one).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from merlin_tpu_torch.ops import _build

NEG_INF = -1e30
# query rows per kv head up to which a window takes the few-rows kernel
# (B5, B7 windows)
WINDOW_SMALL_ROWS = 16
# keys per CTA of the few-rows kernel, rounded down to whole pages (at least
# one); the kernel takes at most 256 splits of a table row
SPLIT_KEYS = 256
# the window kernel's most key splits of a row tile (its kWindowMaxSplits)
WINDOW_MAX_SPLITS = 16
# keys of the f32 kernels' tiles, the block on which they round p
F32_TILE_KEYS = 64
# the window kernels' tiles: (query rows and keys a tile, CTAs an SM,
# threads, O accumulators a thread, column halves a row tile); the bf16
# kernel's at 64 < d <= 128, at d <= 64 and at d > 128, the f32 kernel's at
# d <= 128 and at d > 128 (a CTA a 128-column half of O)
BF16_WINDOW_TILES = ((128, 1, 256, 64, 1), (64, 1, 128, 32, 1),
                     (64, 1, 128, 64, 2))
F32_WINDOW_TILES = (64, 2, 128, 64, 1)
F32_WINDOW_TILES_WIDE = (64, 1, 128, 64, 2)
# head dims the paged kernels take: multiples of 8 up to this
MAX_HEAD_DIM = 256
_COUNTERS = {}    # device -> both kernels' int32 arrival counters
# counters replaced by larger ones: a captured CUDA graph's launches still
# point at them, so they are never freed
_RETIRED_COUNTERS = []
_SMS = {}         # device -> its SM count


# ---------------------------------------------------------------------------
# Page allocator (host side)
# ---------------------------------------------------------------------------

class PagePool:
    """Fixed pool of KV pages + per-sequence page tables (vLLM-style,
    host-side bookkeeping). The free list hands out physical page 0 first."""

    def __init__(self, total_pages: int, page_size: int,
                 pages_per_seq: int):
        self.page_size = page_size
        self.pages_per_seq = pages_per_seq
        self._free = list(range(total_pages - 1, -1, -1))
        self.tables = {}   # seq id -> list of physical pages
        self.lengths = {}  # seq id -> tokens written

    def allocate(self, seq_id, num_tokens: int):
        """Reserve pages for `num_tokens`; returns the page table list.

        Atomic on failure: a MemoryError returns any newly-grabbed pages
        to the pool (and removes an empty table entry), so a failed
        reservation never leaves pages parked on a queued request."""
        needed = -(-num_tokens // self.page_size)
        if needed > self.pages_per_seq:
            raise ValueError("sequence exceeds pages_per_seq")
        table = self.tables.setdefault(seq_id, [])
        start = len(table)
        while len(table) < needed:
            if not self._free:
                self._free.extend(reversed(table[start:]))
                del table[start:]
                if not table:
                    self.tables.pop(seq_id, None)
                raise MemoryError("page pool exhausted")
            table.append(self._free.pop())
        self.lengths[seq_id] = num_tokens
        return table

    def extend(self, seq_id, new_tokens: int = 1):
        return self.allocate(seq_id, self.lengths[seq_id] + new_tokens)

    def release(self, seq_id):
        for page in self.tables.pop(seq_id, []):
            self._free.append(page)
        self.lengths.pop(seq_id, None)

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def table_array(self, seq_ids) -> np.ndarray:
        """Padded (n, pages_per_seq) int32 table for the kernels; unused
        entries point at page 0 (masked out by lengths)."""
        out = np.zeros((len(seq_ids), self.pages_per_seq), np.int32)
        for i, sid in enumerate(seq_ids):
            t = self.tables.get(sid, [])
            out[i, : len(t)] = t
        return out


# ---------------------------------------------------------------------------
# Page writes
# ---------------------------------------------------------------------------

LANES = 128   # scale-row width of int8 pages


def _page_targets(positions: torch.Tensor, page_tables: torch.Tensor,
                  page_size: int):
    """Where each position (b, n) lands through its row of the tables, for
    :func:`_write_rows`: (physical page, offset, source row) of each of the
    b * n rows, and whether any row is kept.

    A position whose logical page lies past the table is dropped, as JAX's
    scatter drops it (trap C9). A dropped row takes the target and the
    source of the first kept row, so the scatter writes that row's bits
    twice and nothing else: it neither races with a live write to its own
    clamped slot (a window longer than a page can land there) nor needs a
    host sync to leave it out. When no row is kept, every row targets the
    first one's clamped slot and :func:`_write_rows` writes that slot's
    own contents back."""
    pos = positions.long()
    logical = pos // page_size
    kept = (logical < page_tables.shape[1]).reshape(-1)
    phys = torch.gather(page_tables.long(), 1,
                        logical.clamp(max=page_tables.shape[1] - 1))
    row = (phys * page_size + pos % page_size).reshape(-1)
    first = torch.argmax(kept.int())     # the first kept row, else row 0
    src = torch.where(kept, torch.arange(kept.numel(), device=kept.device),
                      first)
    row = row[src]
    return row // page_size, row % page_size, src, kept.any()


def _write_rows(pages: torch.Tensor, rows: torch.Tensor, targets) -> None:
    """``pages[phys, offset] = rows[src]`` IN PLACE for the targets of
    :func:`_page_targets`; with no kept row, the targeted slot keeps its
    contents. rows: (b * n, pages.shape[-1])."""
    phys, offset, src, any_kept = targets
    pages[phys, offset] = torch.where(any_kept, rows[src].to(pages.dtype),
                                      pages[phys, offset])


def write_token_to_pages(k_pages, v_pages, k_new, v_new, *, positions,
                         page_tables):
    """Scatter one decode step's K/V into the paged cache, IN PLACE (the
    JAX function returns new arrays).

    k_new/v_new: (b, hkv, d); positions: (b,) token index per sequence;
    page_tables: (b, pages_per_seq). Each token is one head-packed
    (hkv*d,) row; duplicate targets only occur on the trash page, where
    any write order is acceptable, and a position past the table writes
    nothing. Returns (k_pages, v_pages)."""
    targets = _page_targets(positions[:, None], page_tables,
                            k_pages.shape[1])
    b = k_new.shape[0]
    _write_rows(k_pages, k_new.reshape(b, -1), targets)
    _write_rows(v_pages, v_new.reshape(b, -1), targets)
    return k_pages, v_pages


def write_tokens_to_pages(k_pages, v_pages, k_new, v_new, *,
                          start_positions, page_tables):
    """Scatter an s_q-token window's K/V into the paged cache, IN PLACE.

    k_new/v_new: (b, s_q, hkv, d); start_positions: (b,) first token
    index per sequence (token j lands at start+j); page_tables:
    (b, pages_per_seq). One batched scatter of b*s_q head-packed rows; a
    token past the table writes nothing. Returns (k_pages, v_pages)."""
    b, s_q = k_new.shape[:2]
    positions = start_positions.long()[:, None] + torch.arange(
        s_q, device=start_positions.device)[None]
    targets = _page_targets(positions, page_tables, k_pages.shape[1])
    _write_rows(k_pages, k_new.reshape(b * s_q, -1), targets)
    _write_rows(v_pages, v_new.reshape(b * s_q, -1), targets)
    return k_pages, v_pages


# ---------------------------------------------------------------------------
# int8 pages: quantization and page writes
# ---------------------------------------------------------------------------

def _scale_row(sc: torch.Tensor, lanes: int) -> torch.Tensor:
    """(..., hkv) per-head scales -> (..., lanes) STRIDED scale row: head i's
    scale at lane i * max(lanes // hkv, 1), zeros elsewhere (lane blocks
    stay head blocks, so scale pages shard like the value pages)."""
    hkv = sc.shape[-1]
    stride = max(lanes // hkv, 1)
    out = sc.new_zeros(sc.shape[:-1] + (lanes,))
    out[..., 0:hkv * stride:stride] = sc
    return out


def _quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., d) -> (int8 values, (...) f32 scales): per-row absmax / 127,
    floored at 1e-8, values rounded half to even and clipped to +-127."""
    x = x.float()
    sc = torch.clamp(x.abs().amax(-1) / 127.0, min=1e-8)
    q8 = torch.clamp(torch.round(x / sc[..., None]), -127, 127)
    return q8.to(torch.int8), sc


def quantize_pages(pages: torch.Tensor, head_dim: int, lanes: int = LANES
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(P, page, hkv*d) float -> (int8 values of the same shape, scales
    (P, page, lanes) f32): one scale per (token, kv head), strided lanes
    (a tensor-parallel rank's pool has 128 / tp lanes)."""
    p_, page, packed = pages.shape
    hkv = packed // head_dim
    values, sc = _quantize_rows(pages.reshape(p_, page, hkv, head_dim))
    return values.reshape(p_, page, packed), _scale_row(sc, lanes)


def dequantize_pages(values: torch.Tensor, scales: torch.Tensor,
                     head_dim: int, dtype=torch.bfloat16) -> torch.Tensor:
    """int8 pages and their scale pages -> (P, page, hkv*d) in ``dtype``
    (bf16 by default, whatever the model's dtype, as in JAX)."""
    p_, page, packed = values.shape
    hkv = packed // head_dim
    stride = max(scales.shape[-1] // hkv, 1)
    split = values.float().reshape(p_, page, hkv, head_dim)
    sc = scales[..., 0:hkv * stride:stride]
    return (split * sc[..., None]).to(dtype).reshape(p_, page, packed)


def write_token_to_pages_q8(k_pages, k_scales, v_pages, v_scales, k_new,
                            v_new, *, positions, page_tables):
    """:func:`write_token_to_pages` over int8 pages, IN PLACE: each token's
    per-head rows are quantized on write, their scales land in the strided
    scale row; a position past the table writes neither. k/v_new:
    (b, hkv, d). Returns the four arrays."""
    targets = _page_targets(positions[:, None], page_tables,
                            k_pages.shape[1])
    for pages, scales, new in ((k_pages, k_scales, k_new),
                               (v_pages, v_scales, v_new)):
        q8, sc = _quantize_rows(new)
        _write_rows(pages, q8.reshape(q8.shape[0], -1), targets)
        _write_rows(scales, _scale_row(sc, scales.shape[-1]), targets)
    return k_pages, k_scales, v_pages, v_scales


def write_tokens_to_pages_q8(k_pages, k_scales, v_pages, v_scales, k_new,
                             v_new, *, start_positions, page_tables):
    """:func:`write_tokens_to_pages` over int8 pages, IN PLACE. k/v_new:
    (b, s_q, hkv, d). Returns the four arrays."""
    b, s_q, hkv = k_new.shape[:3]
    positions = start_positions.long()[:, None] + torch.arange(
        s_q, device=start_positions.device)[None]
    targets = _page_targets(positions, page_tables, k_pages.shape[1])
    for pages, scales, new in ((k_pages, k_scales, k_new),
                               (v_pages, v_scales, v_new)):
        q8, sc = _quantize_rows(new)
        _write_rows(pages, q8.reshape(b * s_q, -1), targets)
        _write_rows(scales, _scale_row(sc.reshape(b * s_q, hkv),
                                       scales.shape[-1]), targets)
    return k_pages, k_scales, v_pages, v_scales


# ---------------------------------------------------------------------------
# Plain versions (copies of the JAX references)
# ---------------------------------------------------------------------------

def _gather_seq(pages, page_tables, hkv, d):
    """(P, page, hkv*d) through (b, pps) tables -> (b, pps*page, hkv, d)."""
    b, pps = page_tables.shape
    seq = pages[page_tables.long()]
    return seq.reshape(b, pps * pages.shape[1], hkv, d)


def _rounded(dtype):
    """The dtype p is rounded to before P V when V is in ``dtype`` (None
    for f32: no rounding)."""
    return None if dtype == torch.float32 else dtype


def _kernel_rule(q, k_seq, v_seq, q_pos, alibi_slopes, scale, p_dtype,
                 block, k_scale=None, v_scale=None, split_keys=None):
    """What a TPU paged kernel computes, in plain PyTorch: q (b, s_q, h, d)
    and k_seq/v_seq (b, keys, hkv, d) as the f32 values it multiplies, q_pos
    (b, s_q) each row's position (it sees keys <= it). Scores in f32
    (times ``k_scale`` (b, keys, hkv) per key first, B7), then scale and
    ALiBi; an online softmax over blocks of ``block`` keys, p = exp(s -
    the running max) rounded to ``p_dtype`` (or, with ``v_scale``, p *
    v_scale rounded to bf16, B7) for P V while l sums the f32 p. A row that
    sees no key reads 0, as the kernels write it (C2). Returns (b, s_q, h,
    d) f32.

    ``split_keys`` walks the keys as the f32 kernels split them over CTAs:
    splits of that many keys from key 0 (an int, or one per sequence), each
    starting from m = NEG_INF and walking its blocks from its own first key,
    then merged by the LSE rescale in split order. None (or a split that
    holds every key) is the TPU kernel's single walk."""
    if split_keys is not None and not isinstance(split_keys,
                                                 (int, np.integer)):
        def row(t, i):
            return None if t is None else t[i:i + 1]
        return torch.cat([_kernel_rule(
            q[i:i + 1], k_seq[i:i + 1], v_seq[i:i + 1], q_pos[i:i + 1],
            alibi_slopes, scale, p_dtype, block, row(k_scale, i),
            row(v_scale, i), int(n)) for i, n in enumerate(split_keys)])
    b, s_q, h, d = q.shape
    n_keys, hkv = k_seq.shape[1], k_seq.shape[2]
    group = h // hkv
    s = torch.einsum("bthgd,bkhd->bhgtk", q.reshape(b, s_q, hkv, group, d),
                     k_seq)
    if k_scale is not None:
        s = s * k_scale.permute(0, 2, 1)[:, :, None, None, :]
    s = s * scale
    k_pos = torch.arange(n_keys, device=q.device)
    if alibi_slopes is not None:
        slopes = alibi_slopes.float().reshape(hkv, group)
        dist = (k_pos[None, None, :] - q_pos[:, :, None]).float()
        s = s + slopes[None, :, :, None, None] * dist[:, None, None]
    mask = (k_pos[None, None, :] <= q_pos[:, :, None])[:, None, None]
    split_keys = int(split_keys or n_keys)
    parts = []
    for s0 in range(0, n_keys, split_keys):
        s1 = min(s0 + split_keys, n_keys)
        m = torch.full(s.shape[:-1], NEG_INF, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros(s.shape[:-1] + (d,), device=q.device)
        for k0 in range(s0, s1, block):
            k1 = min(k0 + block, s1)
            seen = mask[..., k0:k1]
            sb = torch.where(seen, s[..., k0:k1], NEG_INF)
            m_new = torch.maximum(m, sb.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.where(seen, torch.exp(sb - m_new[..., None]), 0.0)
            l = alpha * l + p.sum(-1)
            if v_scale is not None:
                p = (p * v_scale[:, k0:k1].permute(0, 2, 1)[
                    :, :, None, None, :]).to(torch.bfloat16).float()
            elif p_dtype is not None:
                p = p.to(p_dtype).float()
            acc = acc * alpha[..., None] + torch.einsum(
                "bhgtk,bkhd->bhgtd", p, v_seq[:, k0:k1])
            m = m_new
        parts.append((m, l, acc))
    # one split merges to itself exactly (a weight of exp(0) = 1)
    top = torch.stack([m for m, _, _ in parts]).amax(0)
    l = torch.zeros_like(top)
    acc = torch.zeros_like(parts[0][2])
    for m, l_s, acc_s in parts:
        w = torch.exp(m - top)
        l = l + l_s * w
        acc = acc + acc_s * w[..., None]
    out = acc / torch.where(l == 0, 1.0, l)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(b, s_q, h, d)


def _window_pos(lengths, s_q, device):
    """(b, s_q) positions of a window's rows: lengths include the window."""
    return (lengths.long()[:, None] - s_q) + torch.arange(
        s_q, device=device)[None]


def paged_attention_plain(q, k_pages, v_pages, lengths, page_tables, *,
                          alibi_slopes=None, scale=None,
                          kernel_rounding=False, block_keys=None,
                          split_keys=None):
    """One query token per sequence over its pages. q (b, h, d); keys at
    positions < lengths[b] are visible; ALiBi adds slope * (k - (len-1)).
    f32 softmax with NEG_INF masking (JAX's reference: p stays f32).
    Returns (b, h, d) in q's dtype. ``kernel_rounding`` computes what the
    TPU kernel computes instead (C48): see
    :func:`paged_attention_multi_plain`."""
    if kernel_rounding:
        return paged_attention_multi_plain(
            q[:, None], k_pages, v_pages, lengths, page_tables,
            alibi_slopes=alibi_slopes, scale=scale, kernel_rounding=True,
            block_keys=block_keys, split_keys=split_keys)[:, 0]
    b, h, d = q.shape
    hkv = k_pages.shape[2] // d
    group = h // hkv
    scale = scale if scale is not None else d ** -0.5
    k_seq = _gather_seq(k_pages, page_tables, hkv, d).float()
    v_seq = _gather_seq(v_pages, page_tables, hkv, d).float()
    max_len = k_seq.shape[1]
    qg = q.reshape(b, hkv, group, d).float()
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k_seq) * scale
    k_pos = torch.arange(max_len, device=q.device)
    lengths = lengths.long()
    if alibi_slopes is not None:
        slopes = alibi_slopes.float().reshape(hkv, group)
        dist = (k_pos[None, :] - (lengths - 1)[:, None]).float()
        s = s + slopes[None, :, :, None] * dist[:, None, None, :]
    mask = k_pos[None, :] < lengths[:, None]
    s = torch.where(mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p, v_seq)
    return out.reshape(b, h, d).to(q.dtype)


def paged_attention_multi_plain(q, k_pages, v_pages, lengths, page_tables,
                                *, alibi_slopes=None, scale=None,
                                kernel_rounding=False, block_keys=None,
                                split_keys=None):
    """An s_q-token window per sequence over its pages. q (b, s_q, h, d);
    ``lengths`` INCLUDE the window (its K/V already written); query t sits
    at lengths-s_q+t and sees keys at positions <= its own. ALiBi adds
    slope * (k - q_pos). Returns (b, s_q, h, d) in q's dtype.

    Without ``kernel_rounding``, JAX's reference (its CPU route): p stays
    f32. With it, the TPU kernel's rule (B3-B6, trap C48): the online
    softmax over blocks of ``block_keys`` keys (default: the page, the TPU
    BlockSpec kernels' block), p rounded to the page dtype before P V, a
    row with no key 0 (C2); ``split_keys`` walks the keys in the f32
    kernels' key splits (see :func:`_kernel_rule`)."""
    b, s_q, h, d = q.shape
    hkv = k_pages.shape[2] // d
    group = h // hkv
    scale = scale if scale is not None else d ** -0.5
    k_seq = _gather_seq(k_pages, page_tables, hkv, d).float()
    v_seq = _gather_seq(v_pages, page_tables, hkv, d).float()
    if kernel_rounding:
        return _kernel_rule(
            q.float(), k_seq, v_seq, _window_pos(lengths, s_q, q.device),
            alibi_slopes, scale, _rounded(v_pages.dtype),
            block_keys or k_pages.shape[1],
            split_keys=split_keys).to(q.dtype)
    max_len = k_seq.shape[1]
    qg = q.reshape(b, s_q, hkv, group, d).float()
    s = torch.einsum("bthgd,bkhd->bhgtk", qg, k_seq) * scale
    k_pos = torch.arange(max_len, device=q.device)
    q_pos = _window_pos(lengths, s_q, q.device)                  # (b, s_q)
    if alibi_slopes is not None:
        slopes = alibi_slopes.float().reshape(hkv, group)
        dist = (k_pos[None, None, :] - q_pos[:, :, None]).float()
        s = s + slopes[None, :, :, None, None] * dist[:, None, None]
    mask = k_pos[None, None, :] <= q_pos[:, :, None]             # causal
    s = torch.where(mask[:, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgtk,bkhd->bthgd", p, v_seq)
    return out.reshape(b, s_q, h, d).to(q.dtype)


def paged_attention_q8_plain(q, k_values, k_scales, v_values, v_scales,
                             lengths, page_tables, *, alibi_slopes=None,
                             scale=None, kernel_rounding=False,
                             bf16_operands=False, block_keys=None,
                             split_keys=None):
    """:func:`paged_attention_plain` over int8 pages, as the JAX decoder's
    CPU route computes it (``decoder.py:300-306``): both pools dequantized
    to bf16 first. ``kernel_rounding`` computes what the TPU kernel
    computes instead: see :func:`paged_attention_multi_q8_plain`."""
    if kernel_rounding:
        return paged_attention_multi_q8_plain(
            q[:, None], k_values, k_scales, v_values, v_scales, lengths,
            page_tables, alibi_slopes=alibi_slopes, scale=scale,
            kernel_rounding=True, bf16_operands=bf16_operands,
            block_keys=block_keys, split_keys=split_keys)[:, 0]
    d = q.shape[-1]
    return paged_attention_plain(
        q, dequantize_pages(k_values, k_scales, d),
        dequantize_pages(v_values, v_scales, d), lengths, page_tables,
        alibi_slopes=alibi_slopes, scale=scale)


def _head_scales(scales, page_tables, hkv):
    """(P, page, S) scale pages through (b, pps) tables -> (b, keys, hkv):
    kv head i's scale at lane i * max(S // hkv, 1)."""
    lanes = scales.shape[-1]
    stride = max(lanes // hkv, 1)
    seq = _gather_seq(scales, page_tables, 1, lanes)[:, :, 0]
    return seq[..., 0:hkv * stride:stride]


def paged_attention_multi_q8_plain(q, k_values, k_scales, v_values,
                                   v_scales, lengths, page_tables, *,
                                   alibi_slopes=None, scale=None,
                                   kernel_rounding=False,
                                   bf16_operands=False, block_keys=None,
                                   split_keys=None):
    """:func:`paged_attention_multi_plain` over int8 pages, as the JAX
    decoder's CPU route (``decoder.py:400-408``): dequantize to bf16 first.

    With ``kernel_rounding``, the TPU kernel's rule on blocks of
    ``block_keys`` keys (default: the page): B8 and B9 dequantize to q's
    dtype and round p to it (``paged_attention.py:820-823``); with
    ``bf16_operands``, B7's (trap C49): q rounded to bf16, s = (q . k_int8)
    * k_scale * scale, p * v_scale rounded to bf16 for the product with
    the int8 V (``:1033-1034,1067,1131``), whatever q's dtype.
    ``split_keys``: the f32 kernels' key splits (see :func:`_kernel_rule`)."""
    b, s_q, h, d = q.shape
    if not kernel_rounding:
        return paged_attention_multi_plain(
            q, dequantize_pages(k_values, k_scales, d),
            dequantize_pages(v_values, v_scales, d), lengths, page_tables,
            alibi_slopes=alibi_slopes, scale=scale)
    hkv = k_values.shape[2] // d
    scale = scale if scale is not None else d ** -0.5
    q_pos = _window_pos(lengths, s_q, q.device)
    block = block_keys or k_values.shape[1]
    if bf16_operands:
        out = _kernel_rule(
            q.to(torch.bfloat16).float(),
            _gather_seq(k_values, page_tables, hkv, d).float(),
            _gather_seq(v_values, page_tables, hkv, d).float(), q_pos,
            alibi_slopes, scale, None, block,
            k_scale=_head_scales(k_scales, page_tables, hkv),
            v_scale=_head_scales(v_scales, page_tables, hkv),
            split_keys=split_keys)
    else:
        k_seq = _gather_seq(dequantize_pages(k_values, k_scales, d, q.dtype),
                            page_tables, hkv, d).float()
        v_seq = _gather_seq(dequantize_pages(v_values, v_scales, d, q.dtype),
                            page_tables, hkv, d).float()
        out = _kernel_rule(q.float(), k_seq, v_seq, q_pos, alibi_slopes,
                           scale, _rounded(q.dtype), block,
                           split_keys=split_keys)
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check_paged(name, q, k_pages, v_pages, lengths, page_tables,
                 alibi_slopes, k_scales=None, v_scales=None) -> int:
    """Raise unless the inputs are what the paged kernels read; returns
    hkv. q (b, [s_q,] h, d) bf16 or f32 and the (P, page, hkv*d) pages,
    bf16 or f32 or, with scales, int8, contiguous and 16-byte aligned on
    one CUDA device, with d % 8 == 0 and d <= 256; int8 pages' scales (P,
    page, S) contiguous f32 with hkv <= S; lengths (b,) and page_tables
    (b, pps) contiguous int32; slopes (h,) contiguous f32."""
    q8 = k_scales is not None
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"{name}: q must be bfloat16 or float32, got "
                         f"{q.dtype}")
    page_dtypes = ((torch.int8,) if q8
                   else (torch.bfloat16, torch.float32))
    if k_pages.dtype not in page_dtypes or v_pages.dtype != k_pages.dtype:
        raise ValueError(f"{name}: pages must be one of {page_dtypes}, got "
                         f"{k_pages.dtype} / {v_pages.dtype}")
    tensors = [(q, "q"), (k_pages, "k_pages"), (v_pages, "v_pages")]
    if q8:
        tensors += [(k_scales, "k_scales"), (v_scales, "v_scales")]
        for t, tn in tensors[3:]:
            if t.dtype != torch.float32:
                raise ValueError(f"{name}: {tn} must be float32, got "
                                 f"{t.dtype}")
    b, h, d = q.shape[0], q.shape[-2], q.shape[-1]
    if d % 8 or d > MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {d} must be a multiple of 8 "
                         f"and at most {MAX_HEAD_DIM}")
    for t, tn in tensors:
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name}: {tn} must be on q's CUDA device, "
                             f"got {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {tn} must be contiguous and 16-byte "
                             "aligned")
    if k_pages.dim() != 3 or k_pages.shape != v_pages.shape \
            or k_pages.shape[2] % d or h % (k_pages.shape[2] // d):
        raise ValueError(f"{name}: pages {tuple(k_pages.shape)} / "
                         f"{tuple(v_pages.shape)} do not hold kv heads of "
                         f"q {tuple(q.shape)}")
    for t, shape, tn in ((lengths, (b,), "lengths"),
                         (page_tables, (b, page_tables.shape[-1]),
                          "page_tables")):
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
    hkv = k_pages.shape[2] // d
    if q8 and (k_scales.dim() != 3 or k_scales.shape != v_scales.shape
               or k_scales.shape[:2] != k_pages.shape[:2]
               or hkv > k_scales.shape[2]):
        raise ValueError(f"{name}: scales {tuple(k_scales.shape)} / "
                         f"{tuple(v_scales.shape)} must be (P, page, S) with "
                         f"S >= hkv = {hkv} for pages {tuple(k_pages.shape)}")
    return hkv


def _f32_kernel(q, pages) -> bool:
    """Whether the (q, pages) pair runs the f32 kernel: every pair but bf16
    q over bf16 or int8 pages."""
    return not (q.dtype == torch.bfloat16
                and pages.dtype in (torch.bfloat16, torch.int8))


def _launch_f32(name, q, k_pages, v_pages, lengths, page_tables,
                alibi_slopes, scale, few_rows, k_scales, v_scales, bf16_ops):
    """The f32 kernels on checked inputs: q (b, s_q, h, d), decode at s_q =
    1; the few-rows kernel with ``few_rows`` (its key splits as the bf16
    route's, :func:`rows_plan`), else the window kernel (its splits by
    :func:`window_plan` with ``f32``); ``bf16_ops`` for B7's rule over int8 pages.
    Returns out like q."""
    b, s_q, h, d = q.shape
    hkv = k_pages.shape[2] // d
    page_size, pps = k_pages.shape[1], page_tables.shape[1]
    rows = h // hkv * s_q
    split, ws, ws_ptr, counters = (
        _split_workspace(q, b, rows, hkv, d, page_size, pps) if few_rows
        else _window_workspace(q, b, rows, hkv, d, page_size, pps,
                               f32=True))
    out = torch.empty_like(q)
    kind = {torch.bfloat16: 0, torch.float32: 1, torch.int8: 2}[
        k_pages.dtype]
    ptr = (lambda t: t.data_ptr() if t is not None else None)
    code = _build.lib().merlin_paged_attention_f32(
        q.data_ptr(), k_pages.data_ptr(), ptr(k_scales), v_pages.data_ptr(),
        ptr(v_scales), lengths.data_ptr(), page_tables.data_ptr(),
        ptr(alibi_slopes), out.data_ptr(), ws_ptr, counters, b, s_q, h, hkv,
        d, page_size, pps, k_scales.shape[2] if k_scales is not None else 0,
        int(q.dtype == torch.bfloat16), kind, int(bf16_ops), split,
        int(few_rows), float(scale if scale is not None else d ** -0.5),
        _build.stream_handle(q.device))
    _build.check(code, name)
    return out


def _counters(device, need: int) -> int:
    """The device's arrival counters, at least ``need`` of them, shared by
    both kernels on the port's one stream (each launch leaves them at 0):
    zeroed once when allocated or grown, so no call launches a memset; two
    streams must not share them. Returns their pointer."""
    counters = _COUNTERS.get(device)
    if counters is None or counters.numel() < need:
        if counters is not None:
            _RETIRED_COUNTERS.append(counters)
        counters = torch.zeros(need, dtype=torch.int32, device=device)
        _COUNTERS[device] = counters
    return counters.data_ptr()


def rows_plan(b, rows, hkv, d, page_size, pps):
    """The few-rows kernels' key splits (bf16 and f32 alike): (pages a
    split, workspace floats, counters). A split is ``SPLIT_KEYS`` keys
    rounded down to whole pages (at least one). With more than one split
    of a table row, an f32 workspace for each split's (O, m, l) of each of
    the ``rows`` query rows of a kv head, and counters for each (sequence,
    kv head, 16-row tile); one split takes neither."""
    split_pages = max(1, SPLIT_KEYS // page_size)
    n_splits = -(-pps // split_pages)
    if n_splits == 1:
        return split_pages, 0, 0
    return (split_pages, b * hkv * n_splits * rows * (d + 2),
            b * hkv * -(-rows // 16))


def rows_split_keys(page_size):
    """The keys of a few-rows kernel's key split at ``page_size``."""
    return max(1, SPLIT_KEYS // page_size) * page_size


def _split_workspace(q, b, rows, hkv, d, page_size, pps):
    """What the few-rows kernels need to split each sequence's keys over
    CTAs, by :func:`rows_plan`: (pages per split, the workspace tensor, its
    pointer, the counters' pointer). The workspace is ``torch.empty``: a
    split writes its rows before the last one reads them."""
    split_pages, ws_floats, need = rows_plan(b, rows, hkv, d, page_size,
                                             pps)
    if ws_floats == 0:
        return split_pages, None, None, None
    ws = torch.empty(ws_floats, dtype=torch.float32, device=q.device)
    return split_pages, ws, ws.data_ptr(), _counters(q.device, need)


def _window_tiles(d, f32):
    """The window kernel's tiles at head dim ``d``: the f32 one's with
    ``f32``, else the bf16 one's."""
    if f32:
        return F32_WINDOW_TILES if d <= 128 else F32_WINDOW_TILES_WIDE
    return BF16_WINDOW_TILES[0 if 64 < d <= 128 else 1 if d <= 64 else 2]


def _window_units(b, rows, hkv, d, f32):
    """The window kernel's CTAs at one key split: (sequence, kv head, row
    tile, column half)s."""
    tile, _, _, _, halves = _window_tiles(d, f32)
    return b * hkv * -(-rows // tile) * halves


def window_workspace_floats(b, rows, hkv, d, splits, f32=False):
    """A window kernel's f32 workspace for ``splits`` key splits a row
    tile: each split of each (sequence, kv head, row tile, column half)
    keeps its CTA's O accumulators and its rows' (m, l), 4 floats a
    thread, in fragment order (the kernel's tiles,
    :data:`BF16_WINDOW_TILES` or, with ``f32``, :data:`F32_WINDOW_TILES`
    and :data:`F32_WINDOW_TILES_WIDE`)."""
    _, _, threads, acc, _ = _window_tiles(d, f32)
    return (_window_units(b, rows, hkv, d, f32) * splits * threads
            * (acc + 4))


def window_plan(b, rows, hkv, d, page_size, pps, sms, f32=False):
    """A window kernel's key splits on a card of ``sms`` SMs: (most splits
    of a row tile, workspace floats, counters); the bf16 kernel's, or the
    f32 one's with ``f32``. The grid holds about one CTA for each of the
    kernel's CTA slots on the card (the bf16 kernel runs one CTA an SM,
    the f32 one two, one at d > 128; each CTA sizes its split from the
    lengths so that the live ones fill the card about once, and this caps
    the grid and the workspace), at most ``WINDOW_MAX_SPLITS`` and one a
    key tile of the table row for each (sequence, kv head, row tile,
    column half); one split takes no workspace. The counters cover the few-rows kernels'
    16-row tiles and the window kernel's CTAs at one split: all share
    them."""
    tile, per_sm, _, _, _ = _window_tiles(d, f32)
    units = _window_units(b, rows, hkv, d, f32)
    splits = max(1, min(WINDOW_MAX_SPLITS, -(-pps * page_size // tile),
                        -(-per_sm * sms // units)))
    if splits == 1:
        return 1, 0, 0
    return (splits, window_workspace_floats(b, rows, hkv, d, splits, f32),
            max(units, b * hkv * -(-rows // 16)))


def _sm_count(device) -> int:
    """The SM count of ``device``, read once."""
    sms = _SMS.get(device)
    if sms is None:
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        _SMS[device] = sms
    return sms


def _window_workspace(q, b, rows, hkv, d, page_size, pps, f32=False):
    """What a window kernel needs to split each sequence's keys over CTAs:
    (its most splits, the workspace tensor, its pointer, the counters'
    pointer), by :func:`window_plan` for q's card."""
    splits, ws_floats, need = window_plan(b, rows, hkv, d, page_size, pps,
                                          _sm_count(q.device), f32)
    if splits == 1:
        return 1, None, None, None
    ws = torch.empty(ws_floats, dtype=torch.float32, device=q.device)
    return splits, ws, ws.data_ptr(), _counters(q.device, need)


def f32_window_split_keys(lengths, splits, page_size, pps):
    """The keys of each sequence's key splits in the f32 window kernel at
    ``splits`` (:func:`window_plan` with ``f32``): its keys (its length,
    cut to the table) in tiles of ``F32_TILE_KEYS`` keys, cut into
    at most ``splits`` runs of whole tiles (at every d: at d > 128 both
    column halves walk the same splits). The plain versions take this
    list as ``split_keys``."""
    tile = F32_TILE_KEYS
    out = []
    for n in lengths:
        tiles = -(-min(max(int(n), 0), pps * page_size) // tile)
        out.append(tile * max(1, -(-tiles // splits)))
    return out


def _launch_decode(name, q, k_pages, v_pages, lengths, page_tables,
                   alibi_slopes, scale, k_scales=None, v_scales=None,
                   bf16_ops=False):
    """One query token per sequence: the few-rows kernel (any query group),
    the bf16 one for bf16 q over bf16 pages or int8 pages with their scale
    pages, the f32 one for every other pair."""
    if q.dim() != 3:
        raise ValueError(f"{name}: q must be (b, h, d), got {tuple(q.shape)}")
    hkv = _check_paged(name, q, k_pages, v_pages, lengths, page_tables,
                       alibi_slopes, k_scales, v_scales)
    if _f32_kernel(q, k_pages):
        return _launch_f32(name, q[:, None], k_pages, v_pages, lengths,
                           page_tables, alibi_slopes, scale, True, k_scales,
                           v_scales, bf16_ops)[:, 0]
    b, h, d = q.shape
    page_size, pps = k_pages.shape[1], page_tables.shape[1]
    split_pages, ws, ws_ptr, counters = _split_workspace(
        q, b, h // hkv, hkv, d, page_size, pps)
    out = torch.empty_like(q)
    common = (lengths.data_ptr(), page_tables.data_ptr(),
              alibi_slopes.data_ptr() if alibi_slopes is not None else None,
              out.data_ptr(), ws_ptr, counters, b, h, hkv, d, page_size, pps)
    scale = float(scale if scale is not None else d ** -0.5)
    stream = _build.stream_handle(q.device)
    if k_scales is None:
        code = _build.lib().merlin_paged_decode_bf16(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), *common,
            split_pages, scale, stream)
    else:
        code = _build.lib().merlin_paged_decode_q8(
            q.data_ptr(), k_pages.data_ptr(), k_scales.data_ptr(),
            v_pages.data_ptr(), v_scales.data_ptr(), *common,
            k_scales.shape[2], split_pages, scale, stream)
    _build.check(code, name)
    return out


def _launch_window(name, q, k_pages, v_pages, lengths, page_tables,
                   alibi_slopes, scale, few_rows, k_scales=None,
                   v_scales=None, bf16_ops=False):
    """An s_q-token window per sequence: the few-rows kernel with
    ``few_rows``, else the window kernel; the bf16 ones for bf16 q over
    bf16 pages, or int8 pages with their scale pages, the f32 ones for
    every other pair."""
    if q.dim() != 4:
        raise ValueError(f"{name}: q must be (b, s_q, h, d), got "
                         f"{tuple(q.shape)}")
    hkv = _check_paged(name, q, k_pages, v_pages, lengths, page_tables,
                       alibi_slopes, k_scales, v_scales)
    if _f32_kernel(q, k_pages):
        return _launch_f32(name, q, k_pages, v_pages, lengths, page_tables,
                           alibi_slopes, scale, few_rows, k_scales, v_scales,
                           bf16_ops)
    b, s_q, h, d = q.shape
    page_size, pps = k_pages.shape[1], page_tables.shape[1]
    split, ws, ws_ptr, counters = (
        _split_workspace if few_rows else _window_workspace)(
            q, b, h // hkv * s_q, hkv, d, page_size, pps)
    out = torch.empty_like(q)
    common = (lengths.data_ptr(), page_tables.data_ptr(),
              alibi_slopes.data_ptr() if alibi_slopes is not None else None,
              out.data_ptr(), ws_ptr, counters, b, s_q, h, hkv, d, page_size,
              pps)
    scale = float(scale if scale is not None else d ** -0.5)
    stream = _build.stream_handle(q.device)
    if k_scales is None:
        code = _build.lib().merlin_paged_window_bf16(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), *common,
            split, scale, int(few_rows), stream)
    else:
        code = _build.lib().merlin_paged_window_q8(
            q.data_ptr(), k_pages.data_ptr(), k_scales.data_ptr(),
            v_pages.data_ptr(), v_scales.data_ptr(), *common,
            k_scales.shape[2], split, scale, int(few_rows), stream)
    _build.check(code, name)
    return out


def paged_attention_dma(q, k_pages, v_pages, lengths, page_tables, *,
                        scale: Optional[float] = None):
    """B3: decode-step attention over a paged cache, no ALiBi. q (b, h, d),
    lengths (b,) >= 1 tokens per sequence. Returns (b, h, d).
    Dtypes: bf16 or f32 q over bf16 or f32 pages; on the card, the TPU
    kernel's rule (f32 sums, q.k at the promoted dtype, p rounded to the
    page dtype before P.V, out in q's dtype from the f32 accumulator, C2's
    zero rows; C48); on the CPU, JAX's reference."""
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pages, v_pages, lengths,
                                     page_tables, scale=scale)
    out = _launch_decode("paged_attention_dma", q, k_pages, v_pages, lengths,
                         page_tables, None, scale)
    _build.count_launch(paged_attention_dma, _f32_kernel(q, k_pages))
    return out


def paged_attention(q, k_pages, v_pages, lengths, page_tables, *,
                    alibi_slopes=None, scale: Optional[float] = None):
    """B4: decode-step attention over a paged cache with per-query-head
    ALiBi relative to the token at lengths-1. Returns (b, h, d).
    Dtypes: bf16 or f32 q over bf16 or f32 pages; on the card, the TPU
    kernel's rule (f32 sums, q.k at the promoted dtype, p rounded to the
    page dtype before P.V, out in q's dtype from the f32 accumulator, C2's
    zero rows; C48); on the CPU, JAX's reference."""
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pages, v_pages, lengths,
                                     page_tables, alibi_slopes=alibi_slopes,
                                     scale=scale)
    out = _launch_decode("paged_attention", q, k_pages, v_pages, lengths,
                         page_tables, alibi_slopes, scale)
    _build.count_launch(paged_attention, _f32_kernel(q, k_pages))
    return out


def paged_attention_dma_multi(q, k_pages, v_pages, lengths, page_tables, *,
                              alibi_slopes=None,
                              scale: Optional[float] = None):
    """B5: an s_q-token window per sequence over arbitrary page tables
    (see :func:`paged_attention_multi_plain`), any s_q, on the few-rows
    kernel: tiles of 16 query rows of a kv head, each sequence's keys split
    over CTAs. Returns (b, s_q, h, d).
    Dtypes: bf16 or f32 q over bf16 or f32 pages; on the card, the TPU
    kernel's rule (f32 sums, q.k at the promoted dtype, p rounded to the
    page dtype before P.V, out in q's dtype from the f32 accumulator, C2's
    zero rows; C48); on the CPU, JAX's reference."""
    if q.device.type == "cpu":
        return paged_attention_multi_plain(
            q, k_pages, v_pages, lengths, page_tables,
            alibi_slopes=alibi_slopes, scale=scale)
    out = _launch_window("paged_attention_dma_multi", q, k_pages, v_pages,
                         lengths, page_tables, alibi_slopes, scale, True)
    _build.count_launch(paged_attention_dma_multi, _f32_kernel(q, k_pages))
    return out


def paged_attention_multi_blocked(q, k_pages, v_pages, lengths, page_tables,
                                  *, alibi_slopes=None,
                                  scale: Optional[float] = None):
    """B6: B5's contract on the window kernel, for large windows (chunked
    prefill): tiles of 128 query rows of a kv head (64 at d <= 64, and at
    d > 128 64 rows a CTA for each 128-column half of the output), each
    sequence's keys split over CTAs. Returns (b, s_q, h, d).
    Dtypes: bf16 or f32 q over bf16 or f32 pages; on the card, the TPU
    kernel's rule (f32 sums, q.k at the promoted dtype, p rounded to the
    page dtype before P.V, out in q's dtype from the f32 accumulator, C2's
    zero rows; C48); on the CPU, JAX's reference."""
    if q.device.type == "cpu":
        return paged_attention_multi_plain(
            q, k_pages, v_pages, lengths, page_tables,
            alibi_slopes=alibi_slopes, scale=scale)
    out = _launch_window("paged_attention_multi_blocked", q, k_pages,
                         v_pages, lengths, page_tables, alibi_slopes, scale,
                         False)
    _build.count_launch(paged_attention_multi_blocked, _f32_kernel(q, k_pages))
    return out


paged_attention_dma.launches = 0
paged_attention_dma.launches_f32 = 0
paged_attention.launches = 0
paged_attention.launches_f32 = 0
paged_attention_dma_multi.launches = 0
paged_attention_dma_multi.launches_f32 = 0
paged_attention_multi_blocked.launches = 0
paged_attention_multi_blocked.launches_f32 = 0


def paged_window_attention(q, k_pages, v_pages, lengths, page_tables, *,
                           alibi_slopes=None):
    """A window's attention, routed by its query rows per kv head
    (group * s_q): up to :data:`WINDOW_SMALL_ROWS` (a verify window) to
    B5, whose 16-row tiles suit a few rows; more (a prefill window) to
    B6, whose wgmma tiles read each K/V tile once for 128 rows."""
    group = q.shape[2] // (k_pages.shape[2] // q.shape[3])
    fn = (paged_attention_dma_multi
          if group * q.shape[1] <= WINDOW_SMALL_ROWS
          else paged_attention_multi_blocked)
    return fn(q, k_pages, v_pages, lengths, page_tables,
              alibi_slopes=alibi_slopes)


def paged_attention_dma_q8(q, k_values, k_scales, v_values, v_scales,
                           lengths, page_tables, *, alibi_slopes=None,
                           scale: Optional[float] = None):
    """B7 at s_q = 1: decode-step attention over int8 pages (any grouping,
    optional ALiBi), the decoder's token step. q (b, h, d); k/v_values
    (P, page, hkv*d) int8; k/v_scales (P, page, S) f32, head i at lane
    i * (S // hkv). Returns (b, h, d).
    Dtypes: bf16 or f32 q; on the card the TPU kernel's rule, bf16
    operands whatever q's dtype (q and p * v_scale rounded to bf16, f32
    sums, out in q's dtype, C2's zero rows; C49); on the CPU, JAX's route
    (pages dequantized to bf16)."""
    if q.device.type == "cpu":
        return paged_attention_q8_plain(
            q, k_values, k_scales, v_values, v_scales, lengths, page_tables,
            alibi_slopes=alibi_slopes, scale=scale)
    out = _launch_decode("paged_attention_dma_q8", q, k_values, v_values,
                         lengths, page_tables, alibi_slopes, scale,
                         k_scales, v_scales, bf16_ops=True)
    _build.count_launch(paged_attention_dma_q8, _f32_kernel(q, k_values))
    return out


def paged_attention_quantized(q, k_values, k_scales, v_values, v_scales,
                              lengths, page_tables, *, alibi_slopes=None,
                              scale: Optional[float] = None):
    """B9: single-token decode over int8 pages, the contract of
    :func:`paged_attention_dma_q8` (the same CUDA kernel). Returns
    (b, h, d).
    Dtypes: bf16 or f32 q; on the card the TPU kernel's rule (K/V
    dequantized to q's dtype, p rounded to it, f32 sums, out in q's dtype,
    C2's zero rows); on the CPU, JAX's route (pages dequantized to bf16)."""
    if q.device.type == "cpu":
        return paged_attention_q8_plain(
            q, k_values, k_scales, v_values, v_scales, lengths, page_tables,
            alibi_slopes=alibi_slopes, scale=scale)
    out = _launch_decode("paged_attention_quantized", q, k_values, v_values,
                         lengths, page_tables, alibi_slopes, scale,
                         k_scales, v_scales)
    _build.count_launch(paged_attention_quantized, _f32_kernel(q, k_values))
    return out


def paged_attention_dma_multi_q8(q, k_values, k_scales, v_values, v_scales,
                                 lengths, page_tables, *, alibi_slopes=None,
                                 scale: Optional[float] = None):
    """B7: an s_q-token window per sequence over int8 pages (the contract
    of :func:`paged_attention_multi_q8_plain`), on B5's few-rows kernel.
    Returns (b, s_q, h, d).
    Dtypes: bf16 or f32 q; on the card the TPU kernel's rule, bf16
    operands whatever q's dtype (q and p * v_scale rounded to bf16, f32
    sums, out in q's dtype, C2's zero rows; C49); on the CPU, JAX's route
    (pages dequantized to bf16)."""
    if q.device.type == "cpu":
        return paged_attention_multi_q8_plain(
            q, k_values, k_scales, v_values, v_scales, lengths, page_tables,
            alibi_slopes=alibi_slopes, scale=scale)
    out = _launch_window("paged_attention_dma_multi_q8", q, k_values,
                         v_values, lengths, page_tables, alibi_slopes, scale,
                         True, k_scales, v_scales, bf16_ops=True)
    _build.count_launch(paged_attention_dma_multi_q8, _f32_kernel(q, k_values))
    return out


def paged_attention_multi_blocked_q8(q, k_values, k_scales, v_values,
                                     v_scales, lengths, page_tables, *,
                                     alibi_slopes=None,
                                     scale: Optional[float] = None):
    """B8: B7's window contract on B6's window kernel, for chunked-prefill
    windows over int8 pages. Returns (b, s_q, h, d).
    Dtypes: bf16 or f32 q; on the card the TPU kernel's rule (K/V
    dequantized to q's dtype, p rounded to it, f32 sums, out in q's dtype,
    C2's zero rows); on the CPU, JAX's route (pages dequantized to bf16)."""
    if q.device.type == "cpu":
        return paged_attention_multi_q8_plain(
            q, k_values, k_scales, v_values, v_scales, lengths, page_tables,
            alibi_slopes=alibi_slopes, scale=scale)
    out = _launch_window("paged_attention_multi_blocked_q8", q, k_values,
                         v_values, lengths, page_tables, alibi_slopes, scale,
                         False, k_scales, v_scales)
    _build.count_launch(paged_attention_multi_blocked_q8, _f32_kernel(q, k_values))
    return out


paged_attention_dma_q8.launches = 0
paged_attention_dma_q8.launches_f32 = 0
paged_attention_quantized.launches = 0
paged_attention_quantized.launches_f32 = 0
paged_attention_dma_multi_q8.launches = 0
paged_attention_dma_multi_q8.launches_f32 = 0
paged_attention_multi_blocked_q8.launches = 0
paged_attention_multi_blocked_q8.launches_f32 = 0


def paged_window_attention_q8(q, k_values, k_scales, v_values, v_scales,
                              lengths, page_tables, *, alibi_slopes=None):
    """:func:`paged_window_attention` over int8 pages: up to
    :data:`WINDOW_SMALL_ROWS` query rows per kv head to B7, more to B8."""
    group = q.shape[2] // (k_values.shape[2] // q.shape[3])
    fn = (paged_attention_dma_multi_q8
          if group * q.shape[1] <= WINDOW_SMALL_ROWS
          else paged_attention_multi_blocked_q8)
    return fn(q, k_values, k_scales, v_values, v_scales, lengths,
              page_tables, alibi_slopes=alibi_slopes)
