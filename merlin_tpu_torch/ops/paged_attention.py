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
sequence's keys over CTAs and take any query group:

  * the few-rows kernel: paged decode, one query token per sequence,
    :func:`paged_attention_dma` (B3, no ALiBi) and :func:`paged_attention`
    (B4, ALiBi); and paged windows of up to :data:`WINDOW_SMALL_ROWS` query
    rows per kv head (speculative verify), :func:`paged_attention_dma_multi`
    (B5);
  * the window kernel (wgmma, 128 query rows of a kv head a CTA at d >
    64): paged windows, ``s_q`` queries per sequence, causal from their
    true positions, for chunked prefill:
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
_COUNTERS = {}    # device -> both kernels' int32 arrival counters
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


def quantize_pages(pages: torch.Tensor, head_dim: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(P, page, hkv*d) float -> (int8 values of the same shape, scales
    (P, page, 128) f32): one scale per (token, kv head), strided lanes."""
    p_, page, packed = pages.shape
    hkv = packed // head_dim
    values, sc = _quantize_rows(pages.reshape(p_, page, hkv, head_dim))
    return values.reshape(p_, page, packed), _scale_row(sc, LANES)


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


def paged_attention_plain(q, k_pages, v_pages, lengths, page_tables, *,
                          alibi_slopes=None, scale=None):
    """One query token per sequence over its pages. q (b, h, d); keys at
    positions < lengths[b] are visible; ALiBi adds slope * (k - (len-1)).
    f32 softmax with NEG_INF masking. Returns (b, h, d) in q's dtype."""
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
                                *, alibi_slopes=None, scale=None):
    """An s_q-token window per sequence over its pages. q (b, s_q, h, d);
    ``lengths`` INCLUDE the window (its K/V already written); query t sits
    at lengths-s_q+t and sees keys at positions <= its own. ALiBi adds
    slope * (k - q_pos). Returns (b, s_q, h, d) in q's dtype."""
    b, s_q, h, d = q.shape
    hkv = k_pages.shape[2] // d
    group = h // hkv
    scale = scale if scale is not None else d ** -0.5
    k_seq = _gather_seq(k_pages, page_tables, hkv, d).float()
    v_seq = _gather_seq(v_pages, page_tables, hkv, d).float()
    max_len = k_seq.shape[1]
    qg = q.reshape(b, s_q, hkv, group, d).float()
    s = torch.einsum("bthgd,bkhd->bhgtk", qg, k_seq) * scale
    k_pos = torch.arange(max_len, device=q.device)
    q_pos = (lengths.long()[:, None] - s_q) + torch.arange(
        s_q, device=q.device)[None]                              # (b, s_q)
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
                             scale=None):
    """:func:`paged_attention_plain` over int8 pages, as the JAX decoder's
    CPU route computes it (``decoder.py:300-306``): both pools dequantized
    to bf16 first."""
    d = q.shape[-1]
    return paged_attention_plain(
        q, dequantize_pages(k_values, k_scales, d),
        dequantize_pages(v_values, v_scales, d), lengths, page_tables,
        alibi_slopes=alibi_slopes, scale=scale)


def paged_attention_multi_q8_plain(q, k_values, k_scales, v_values,
                                   v_scales, lengths, page_tables, *,
                                   alibi_slopes=None, scale=None):
    """:func:`paged_attention_multi_plain` over int8 pages, as the JAX
    decoder's CPU route (``decoder.py:400-408``): dequantize to bf16 first."""
    d = q.shape[-1]
    return paged_attention_multi_plain(
        q, dequantize_pages(k_values, k_scales, d),
        dequantize_pages(v_values, v_scales, d), lengths, page_tables,
        alibi_slopes=alibi_slopes, scale=scale)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

def _check_paged(name, q, k_pages, v_pages, lengths, page_tables,
                 alibi_slopes, k_scales=None, v_scales=None) -> int:
    """Raise unless the inputs are what the paged kernels read; returns
    hkv. q (b, [s_q,] h, d) bf16 and the (P, page, hkv*d) pages, bf16 or,
    with scales, int8, contiguous and 16-byte aligned on one CUDA device,
    with d % 8 == 0 and d <= 128; int8 pages' scales (P, page, S)
    contiguous f32 with hkv <= S; lengths (b,) and page_tables (b, pps)
    contiguous int32; slopes (h,) contiguous f32."""
    q8 = k_scales is not None
    page_dtype = torch.int8 if q8 else torch.bfloat16
    tensors = [(q, "q", torch.bfloat16), (k_pages, "k_pages", page_dtype),
               (v_pages, "v_pages", page_dtype)]
    if q8:
        tensors += [(k_scales, "k_scales", torch.float32),
                    (v_scales, "v_scales", torch.float32)]
    for t, tn, dtype in tensors:
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name}: {tn} must be on q's CUDA device, "
                             f"got {t.device}")
        if t.dtype != dtype:
            raise ValueError(f"{name}: {tn} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {tn} must be contiguous and 16-byte "
                             "aligned")
    b, h, d = q.shape[0], q.shape[-2], q.shape[-1]
    if d % 8 or d > 128:
        raise ValueError(f"{name}: head dim {d} must be a multiple of 8 "
                         "and at most 128")
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


def _counters(device, need: int) -> int:
    """The device's arrival counters, at least ``need`` of them, shared by
    both kernels on the port's one stream (each launch leaves them at 0):
    zeroed once when allocated or grown, so no call launches a memset; two
    streams must not share them. Returns their pointer."""
    counters = _COUNTERS.get(device)
    if counters is None or counters.numel() < need:
        counters = torch.zeros(need, dtype=torch.int32, device=device)
        _COUNTERS[device] = counters
    return counters.data_ptr()


def _split_workspace(q, b, rows, hkv, d, page_size, pps):
    """What the few-rows kernel needs to split each sequence's keys over
    CTAs: (pages per split, the workspace tensor, its pointer, the
    counters' pointer). With more than one split of ``SPLIT_KEYS`` keys,
    an f32 workspace for each split's (O, m, l) of each of the ``rows``
    query rows of a kv head (``torch.empty``: a split writes its rows
    before the last one reads them), and counters for each (sequence, kv
    head, 16-row tile)."""
    split_pages = max(1, SPLIT_KEYS // page_size)
    n_splits = -(-pps // split_pages)
    if n_splits == 1:
        return split_pages, None, None, None
    ws = torch.empty(b * hkv * n_splits * rows * (d + 2),
                     dtype=torch.float32, device=q.device)
    return (split_pages, ws, ws.data_ptr(),
            _counters(q.device, b * hkv * -(-rows // 16)))


def window_workspace_floats(b, rows, hkv, d, splits):
    """The window kernel's f32 workspace for ``splits`` key splits a row
    tile: each split of each (sequence, kv head, row tile) keeps its
    CTA's O accumulators and its rows' (m, l), 4 floats a thread, in
    fragment order (its tiles: 128 rows, 256 threads and 64 accumulators
    a thread at d > 64; 64 rows, 128 threads and 32 at d <= 64)."""
    tile, threads, acc = (128, 256, 64) if d > 64 else (64, 128, 32)
    return b * hkv * -(-rows // tile) * splits * threads * (acc + 4)


def window_plan(b, rows, hkv, d, page_size, pps, sms):
    """The window kernel's key splits on a card of ``sms`` SMs: (most
    splits of a row tile, workspace floats, counters). The grid holds
    about one CTA for each SM (each CTA sizes its split from the lengths
    so that the live ones fill the card about once; this caps the grid
    and the workspace), at most ``WINDOW_MAX_SPLITS`` and one a key tile
    of the table row for each (sequence, kv head, row tile) (the kernel's
    tiles: 128 rows and 128 keys at d > 64, 64 and 64 at d <= 64); one
    split takes no workspace. The counters are sized for 16-row tiles,
    the few-rows kernel's, which covers the window kernel's too: both
    share them."""
    tile = 128 if d > 64 else 64
    units = b * hkv * -(-rows // tile)
    splits = max(1, min(WINDOW_MAX_SPLITS, -(-pps * page_size // tile),
                        -(-sms // units)))
    if splits == 1:
        return 1, 0, 0
    return (splits, window_workspace_floats(b, rows, hkv, d, splits),
            b * hkv * -(-rows // 16))


def _window_workspace(q, b, rows, hkv, d, page_size, pps):
    """What the window kernel needs to split each sequence's keys over
    CTAs: (most splits of a row tile, the workspace tensor, its pointer,
    the counters' pointer), by :func:`window_plan` for q's card."""
    sms = _SMS.get(q.device)
    if sms is None:
        sms = torch.cuda.get_device_properties(
            q.device).multi_processor_count
        _SMS[q.device] = sms
    splits, ws_floats, need = window_plan(b, rows, hkv, d, page_size, pps,
                                          sms)
    if splits == 1:
        return 1, None, None, None
    ws = torch.empty(ws_floats, dtype=torch.float32, device=q.device)
    return splits, ws, ws.data_ptr(), _counters(q.device, need)


def _launch_decode(name, q, k_pages, v_pages, lengths, page_tables,
                   alibi_slopes, scale, k_scales=None, v_scales=None):
    """One query token per sequence: bf16 pages, or int8 pages with their
    scale pages; the few-rows kernel, any query group."""
    if q.dim() != 3:
        raise ValueError(f"{name}: q must be (b, h, d), got {tuple(q.shape)}")
    hkv = _check_paged(name, q, k_pages, v_pages, lengths, page_tables,
                       alibi_slopes, k_scales, v_scales)
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
                   v_scales=None):
    """An s_q-token window per sequence: bf16 pages, or int8 pages with
    their scale pages; the few-rows kernel with ``few_rows``, else the
    window kernel."""
    if q.dim() != 4:
        raise ValueError(f"{name}: q must be (b, s_q, h, d), got "
                         f"{tuple(q.shape)}")
    hkv = _check_paged(name, q, k_pages, v_pages, lengths, page_tables,
                       alibi_slopes, k_scales, v_scales)
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
    lengths (b,) >= 1 tokens per sequence. Returns (b, h, d)."""
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pages, v_pages, lengths,
                                     page_tables, scale=scale)
    out = _launch_decode("paged_attention_dma", q, k_pages, v_pages, lengths,
                         page_tables, None, scale)
    paged_attention_dma.launches += 1
    return out


def paged_attention(q, k_pages, v_pages, lengths, page_tables, *,
                    alibi_slopes=None, scale: Optional[float] = None):
    """B4: decode-step attention over a paged cache with per-query-head
    ALiBi relative to the token at lengths-1. Returns (b, h, d)."""
    if q.device.type == "cpu":
        return paged_attention_plain(q, k_pages, v_pages, lengths,
                                     page_tables, alibi_slopes=alibi_slopes,
                                     scale=scale)
    out = _launch_decode("paged_attention", q, k_pages, v_pages, lengths,
                         page_tables, alibi_slopes, scale)
    paged_attention.launches += 1
    return out


def paged_attention_dma_multi(q, k_pages, v_pages, lengths, page_tables, *,
                              alibi_slopes=None,
                              scale: Optional[float] = None):
    """B5: an s_q-token window per sequence over arbitrary page tables
    (see :func:`paged_attention_multi_plain`), any s_q, on the few-rows
    kernel: tiles of 16 query rows of a kv head, each sequence's keys split
    over CTAs. Returns (b, s_q, h, d)."""
    if q.device.type == "cpu":
        return paged_attention_multi_plain(
            q, k_pages, v_pages, lengths, page_tables,
            alibi_slopes=alibi_slopes, scale=scale)
    out = _launch_window("paged_attention_dma_multi", q, k_pages, v_pages,
                         lengths, page_tables, alibi_slopes, scale, True)
    paged_attention_dma_multi.launches += 1
    return out


def paged_attention_multi_blocked(q, k_pages, v_pages, lengths, page_tables,
                                  *, alibi_slopes=None,
                                  scale: Optional[float] = None):
    """B6: B5's contract on the window kernel, for large windows (chunked
    prefill): tiles of 128 query rows of a kv head (64 at d <= 64), each
    sequence's keys split over CTAs. Returns (b, s_q, h, d)."""
    if q.device.type == "cpu":
        return paged_attention_multi_plain(
            q, k_pages, v_pages, lengths, page_tables,
            alibi_slopes=alibi_slopes, scale=scale)
    out = _launch_window("paged_attention_multi_blocked", q, k_pages,
                         v_pages, lengths, page_tables, alibi_slopes, scale,
                         False)
    paged_attention_multi_blocked.launches += 1
    return out


paged_attention_dma.launches = 0
paged_attention.launches = 0
paged_attention_dma_multi.launches = 0
paged_attention_multi_blocked.launches = 0


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
    i * (S // hkv). Returns (b, h, d)."""
    if q.device.type == "cpu":
        return paged_attention_q8_plain(
            q, k_values, k_scales, v_values, v_scales, lengths, page_tables,
            alibi_slopes=alibi_slopes, scale=scale)
    out = _launch_decode("paged_attention_dma_q8", q, k_values, v_values,
                         lengths, page_tables, alibi_slopes, scale,
                         k_scales, v_scales)
    paged_attention_dma_q8.launches += 1
    return out


def paged_attention_quantized(q, k_values, k_scales, v_values, v_scales,
                              lengths, page_tables, *, alibi_slopes=None,
                              scale: Optional[float] = None):
    """B9: single-token decode over int8 pages, the contract of
    :func:`paged_attention_dma_q8` (the same CUDA kernel). Returns
    (b, h, d)."""
    if q.device.type == "cpu":
        return paged_attention_q8_plain(
            q, k_values, k_scales, v_values, v_scales, lengths, page_tables,
            alibi_slopes=alibi_slopes, scale=scale)
    out = _launch_decode("paged_attention_quantized", q, k_values, v_values,
                         lengths, page_tables, alibi_slopes, scale,
                         k_scales, v_scales)
    paged_attention_quantized.launches += 1
    return out


def paged_attention_dma_multi_q8(q, k_values, k_scales, v_values, v_scales,
                                 lengths, page_tables, *, alibi_slopes=None,
                                 scale: Optional[float] = None):
    """B7: an s_q-token window per sequence over int8 pages (the contract
    of :func:`paged_attention_multi_q8_plain`), on B5's few-rows kernel.
    Returns (b, s_q, h, d)."""
    if q.device.type == "cpu":
        return paged_attention_multi_q8_plain(
            q, k_values, k_scales, v_values, v_scales, lengths, page_tables,
            alibi_slopes=alibi_slopes, scale=scale)
    out = _launch_window("paged_attention_dma_multi_q8", q, k_values,
                         v_values, lengths, page_tables, alibi_slopes, scale,
                         True, k_scales, v_scales)
    paged_attention_dma_multi_q8.launches += 1
    return out


def paged_attention_multi_blocked_q8(q, k_values, k_scales, v_values,
                                     v_scales, lengths, page_tables, *,
                                     alibi_slopes=None,
                                     scale: Optional[float] = None):
    """B8: B7's window contract on B6's window kernel, for chunked-prefill
    windows over int8 pages. Returns (b, s_q, h, d)."""
    if q.device.type == "cpu":
        return paged_attention_multi_q8_plain(
            q, k_values, k_scales, v_values, v_scales, lengths, page_tables,
            alibi_slopes=alibi_slopes, scale=scale)
    out = _launch_window("paged_attention_multi_blocked_q8", q, k_values,
                         v_values, lengths, page_tables, alibi_slopes, scale,
                         False, k_scales, v_scales)
    paged_attention_multi_blocked_q8.launches += 1
    return out


paged_attention_dma_q8.launches = 0
paged_attention_quantized.launches = 0
paged_attention_dma_multi_q8.launches = 0
paged_attention_multi_blocked_q8.launches = 0


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
