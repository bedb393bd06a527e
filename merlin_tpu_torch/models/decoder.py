"""Unified causal-decoder LM (counterpart of ``merlin_tpu/models/decoder.py``).

One decoder parameterized by :class:`DecoderConfig` covers the Llama/Vicuna,
Baichuan, Phi-2 and OPT families. Attention without a cache goes through the
dispatcher (:mod:`merlin_tpu_torch.ops.attention`, the flash kernel B2 on
the card); attention on a dense KV cache uses :func:`mha_reference` for
both prefill and the one-token step, exactly as the JAX package does
(``decoder.py:491-543``), so the two packages agree.

On a paged cache (``init_kv_cache(layout="paged")``, the serving engine's
pool) there are three branches, as in ``decoder.py:228-490``: the one-token
step writes its K/V into the pages and attends through the paged decode
kernel (B3, or B4 with ALiBi); with ``cfg.paged_multi_query`` an s-token
window appends at each sequence's length and attends causally from true
positions (B5/B6); otherwise a prompt is bulk-written into the
identity-mapped pages and attends through the dispatcher (B2). Page writes
are in place. An int8 pool (``dtype=torch.int8``) carries f32 scale pages
beside the values: writes quantize per (token, kv head), the token step
attends through B7 at s_q = 1, windows through B7/B8, and the bulk prefill
quantizes the prompt into the pages while its attention stays on B2.

``cfg.weight_dtype="int8"`` builds every attention and MLP projection and
the LM head as an int8 kernel with per-output-channel scales
(:class:`~merlin_tpu_torch.models.layers.DenseGeneral` ``weight_q8``);
embeddings and norms stay full precision.

``scan_layers=True`` holds the layer stack as ONE block whose parameters
carry a leading layer axis (``layers.block.attn.q_proj.kernel`` is (L,
...), the names of JAX's ``nn.scan`` tree); the forward runs the block once
per layer on that layer's slices, and autograd sums each layer's gradient
into the stacked leaf. Its caches are stacked too (``init_kv_cache(
stacked=True)``): a dense (L, b, len, hkv, d) pair, or ONE paged pool (L,
P, page, hkv*d) that the forward views flat as (L*P, ...), each layer
addressing its own pages through page tables offset by ``layer * P``
(``decoder.py:228-241``, ``:736-747``). ``remat`` recomputes each block in
the backward (``torch.utils.checkpoint``, nothing saved inside the block,
as ``nn.remat(policy=nothing_saveable)``), so a training step holds one
activation per layer. :func:`cross_entropy_loss` is the training loss.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
import torch.utils.checkpoint
from torch import nn

from merlin_tpu_torch.core.parallel import copy_to_group, gather_from_group
from merlin_tpu_torch.core.partitioning import set_param_axes
from merlin_tpu_torch.models.layers import (
    DenseGeneral, Embed, GatedMLP, LayerNorm, RMSNorm, SimpleMLP,
    apply_rope, cached_alibi_slopes, normal_param)
from merlin_tpu_torch.ops import paged_attention as paged
from merlin_tpu_torch.ops.attention import attention as dispatch_attention
from merlin_tpu_torch.ops.attention import mha_reference
from merlin_tpu_torch.utils.profiling import annotate


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: Optional[int] = None     # None -> MHA
    head_dim: Optional[int] = None         # None -> hidden/heads
    max_position_embeddings: int = 2048

    positional: str = "rope"               # rope | alibi | learned
    rope_theta: float = 10000.0
    rope_linear_scale: float = 1.0
    partial_rotary_factor: float = 1.0     # phi-2: 0.4
    attention_bias: bool = False           # phi-2/opt: True

    norm: str = "rms"                      # rms | ln
    norm_eps: float = 1e-6
    mlp: str = "gated"                     # gated | gelu_new | relu
    parallel_block: bool = False           # phi-2
    final_norm: bool = True

    tie_word_embeddings: bool = False
    lm_head_bias: bool = False             # phi-2: True
    normhead: bool = False                 # baichuan2: L2-normalized lm_head
    z_loss_weight: float = 0.0

    dtype: Any = torch.bfloat16
    weight_dtype: str = "bf16"
    paged_multi_query: bool = False
    remat: bool = False
    scan_layers: bool = False

    @property
    def kv_heads(self) -> int:
        return self.num_kv_heads or self.num_heads

    @property
    def head_size(self) -> int:
        return self.head_dim or self.hidden_size // self.num_heads

    def norm_layer(self):
        if self.norm == "rms":
            return RMSNorm(self.hidden_size, eps=self.norm_eps)
        return LayerNorm(self.hidden_size, eps=self.norm_eps)


def init_kv_cache(cfg: DecoderConfig, batch: int, max_len: int,
                  dtype: torch.dtype = torch.bfloat16, *, layout: str = "dense",
                  page_size: int = 128, stacked: Optional[bool] = None,
                  tensor_parallel: int = 1, device="cuda") -> Dict[str, Any]:
    """KV cache dict. The forward updates its buffers in place and returns
    the same layout with the bookkeeping advanced.

    ``layout="dense"``: per-layer (b, max_len, hkv, d) ``k``/``v`` buffers,
    ``seg`` validity/segment ids per slot (0 = empty), ``pos`` the true
    token position per slot (ragged prompts, ALiBi), and ``index`` the
    shared write cursor (a Python int).

    ``layout="paged"``: per-layer head-packed ``k_pages``/``v_pages``
    (batch * pps, page_size, hkv * d) with pps = ceil(max_len / page_size);
    with ``dtype=torch.int8`` also ``k_scales``/``v_scales`` (batch * pps,
    page_size, 128) f32, one scale per (token, kv head) at the strided lane
    of ``paged_attention._scale_row``. ``page_tables`` (batch, pps) int32
    start as the identity mapping (sequence b owns pages [b * pps,
    (b + 1) * pps)), and the serving engine hands in its own; ``lengths``
    (batch,) int32 valid tokens per sequence; ``index`` as above.

    ``stacked`` (default ``cfg.scan_layers``, which needs it): ``layers``
    is ONE dict of tensors with a leading layer axis instead of a tuple of
    per-layer dicts: (L, b, max_len, hkv, d) dense buffers, or (L, batch *
    pps, page_size, ...) pages and scale pages whose page ids (the tables,
    the trash page 0) are per layer.

    ``tensor_parallel=tp``: the pool of ONE rank of a tensor group, its
    kv heads (hkv / tp lanes of d) and, for int8, 128 / tp scale lanes in
    the same stride as the whole pool's (a lane shard is a head shard).

    A dense int8 cache is refused: it has no scales (trap C10).
    """
    if stacked is None:
        stacked = cfg.scan_layers
    L = cfg.num_layers

    def assemble(shapes):
        """name -> (shape, dtype) as per-layer dicts, or one stacked."""
        def make(lead):
            return {key: torch.zeros(lead + shape, dtype=dt, device=device)
                    for key, (shape, dt) in shapes.items()}
        if stacked:
            return make((L,))
        return tuple(make(()) for _ in range(L))

    if layout == "paged":
        pps = -(-max_len // page_size)
        total = batch * pps
        shape = (total, page_size,
                 cfg.kv_heads // tensor_parallel * cfg.head_size)
        shapes = {"k_pages": (shape, dtype), "v_pages": (shape, dtype)}
        if dtype == torch.int8:
            scales = ((total, page_size, paged.LANES // tensor_parallel),
                      torch.float32)
            shapes.update(k_scales=scales, v_scales=scales)
        return {
            "layers": assemble(shapes),
            "page_tables": torch.arange(total, dtype=torch.int32,
                                        device=device).reshape(batch, pps),
            "lengths": torch.zeros((batch,), dtype=torch.int32,
                                   device=device),
            "index": 0,
        }
    if dtype == torch.int8:
        raise ValueError("an int8 KV cache needs layout='paged': the dense "
                         "cache has no scales, and casting K/V to int8 "
                         "without one loses them")
    shape = ((batch, max_len, cfg.kv_heads // tensor_parallel,
              cfg.head_size), dtype)
    return {
        "layers": assemble({"k": shape, "v": shape}),
        "seg": torch.zeros((batch, max_len), dtype=torch.int32, device=device),
        "pos": torch.zeros((batch, max_len), dtype=torch.int32, device=device),
        "index": 0,
    }


def _prompt_rows(pages: torch.Tensor, b: int, rows: int,
                 layer_index: Optional[int]) -> torch.Tensor:
    """The (b, rows, width) view of the identity-mapped pages a prompt is
    bulk-written into; in a flat (L * P, ...) pool, the block of layer
    ``layer_index`` (``decoder.py:457-471``)."""
    if layer_index is None:
        return pages.view(b, rows, pages.shape[2])
    return pages.view(-1, b, rows, pages.shape[2])[layer_index]


class Attention(nn.Module):
    def __init__(self, cfg: DecoderConfig):
        super().__init__()
        self.cfg = cfg
        h, hkv, d, e = cfg.num_heads, cfg.kv_heads, cfg.head_size, cfg.hidden_size
        kw = dict(use_bias=cfg.attention_bias, dtype=cfg.dtype,
                  weight_q8=cfg.weight_dtype == "int8")
        col = dict(kernel_axes=("embed", "heads", "kv"), **kw)
        self.q_proj = DenseGeneral(e, (h, d), **col)
        self.k_proj = DenseGeneral(e, (hkv, d), **col)
        self.v_proj = DenseGeneral(e, (hkv, d), **col)
        self.o_proj = DenseGeneral((h, d), e,
                                   kernel_axes=("heads", "kv", "embed"), **kw)
        self.tp_rank = 0

    def forward(self, x, positions, segment_ids, layer_cache, cache_aux):
        cfg = self.cfg
        q, k, v = self.q_proj(x), self.k_proj(x), self.v_proj(x)
        if cfg.positional == "rope":
            rotary_dim = int(cfg.head_size * cfg.partial_rotary_factor)
            rope = dict(theta=cfg.rope_theta,
                        linear_scale=cfg.rope_linear_scale,
                        rotary_dim=rotary_dim)
            q = apply_rope(q, positions, **rope)
            k = apply_rope(k, positions, **rope)
        slopes = None
        if cfg.positional == "alibi":
            slopes = cached_alibi_slopes(cfg.num_heads, x.device)
            h_local = q.shape[2]
            if h_local < cfg.num_heads:
                # this rank's heads under tensor parallelism
                slopes = slopes[self.tp_rank * h_local:
                                (self.tp_rank + 1) * h_local]

        if layer_cache is None:
            out = dispatch_attention(
                q, k, v, causal=True, segment_ids_q=segment_ids,
                segment_ids_kv=segment_ids, alibi_slopes=slopes)
        elif "k_pages" in layer_cache:
            out = self._paged(q, k, v, segment_ids, slopes, layer_cache,
                              cache_aux)
        else:
            # write this call's K/V at the shared cursor (in place); the
            # caller has already written seg/pos for these slots
            idx = cache_aux["index"]
            s_q = q.shape[1]
            kc, vc = layer_cache["k"], layer_cache["v"]
            kc[:, idx:idx + s_q] = k.to(kc.dtype)
            vc[:, idx:idx + s_q] = v.to(vc.dtype)
            new_seg, new_pos = cache_aux["seg"], cache_aux["pos"]
            if s_q == 1:
                # every valid cached token is in the past: the validity
                # mask alone masks; ALiBi reads true positions on both sides
                out = mha_reference(
                    q, kc, vc, causal=False,
                    segment_ids_q=torch.ones((q.shape[0], 1), dtype=torch.int32,
                                             device=q.device),
                    segment_ids_kv=(new_seg > 0).to(torch.int32),
                    alibi_slopes=slopes, q_offset=positions,
                    k_positions=new_pos)
            else:
                seg_in = (segment_ids if segment_ids is not None else
                          torch.ones(q.shape[:2], dtype=torch.int32,
                                     device=q.device))
                out = mha_reference(
                    q, kc, vc, causal=True, segment_ids_q=seg_in,
                    segment_ids_kv=new_seg, alibi_slopes=slopes,
                    q_offset=idx)
        return self.o_proj(out)

    def tensor_parallel_(self, dims, info, prefix) -> None:
        del dims, prefix
        self.tp_rank = info.tp_rank

    def _paged(self, q, k, v, segment_ids, slopes, layer_cache, cache_aux):
        """Attention on a paged cache; writes this call's K/V into the
        layer's pages in place (``decoder.py:228-490``)."""
        tables, lengths = cache_aux["page_tables"], cache_aux["lengths"]
        kp, vp = layer_cache["k_pages"], layer_cache["v_pages"]
        s_q = q.shape[1]
        layer_index = cache_aux.get("layer_index")
        if "k_scales" in layer_cache:
            return self._paged_q8(q, k, v, segment_ids, slopes, layer_cache,
                                  tables, lengths, layer_index)
        if s_q == 1:
            paged.write_token_to_pages(kp, vp, k[:, 0], v[:, 0],
                                       positions=lengths, page_tables=tables)
            if slopes is None:
                out = paged.paged_attention_dma(q[:, 0], kp, vp, lengths + 1,
                                                tables)
            else:
                out = paged.paged_attention(q[:, 0], kp, vp, lengths + 1,
                                            tables, alibi_slopes=slopes)
            return out[:, None]
        if self.cfg.paged_multi_query:
            # a window against arbitrary tables (verify window / chunked
            # prefill): append at each sequence's length, attend causally
            # from the true positions over the whole paged history
            paged.write_tokens_to_pages(kp, vp, k, v, start_positions=lengths,
                                        page_tables=tables)
            return paged.paged_window_attention(
                q, kp, vp, lengths + s_q, tables, alibi_slopes=slopes)
        # prefill: bulk-write the prompt into the identity-mapped pages;
        # attention is plain self-attention over the prompt
        b, s = k.shape[:2]
        rows = tables.shape[1] * kp.shape[1]
        for pages, new in ((kp, k), (vp, v)):
            _prompt_rows(pages, b, rows, layer_index)[:, :s] = new.reshape(
                b, s, -1).to(pages.dtype)
        return dispatch_attention(
            q, k, v, causal=True, segment_ids_q=segment_ids,
            segment_ids_kv=segment_ids, alibi_slopes=slopes)

    def _paged_q8(self, q, k, v, segment_ids, slopes, layer_cache, tables,
                  lengths, layer_index):
        """:meth:`_paged` over int8 pages and their scale pages
        (``decoder.py:266-288``, ``:370-392``, ``:473-479``)."""
        kp, ks = layer_cache["k_pages"], layer_cache["k_scales"]
        vp, vs = layer_cache["v_pages"], layer_cache["v_scales"]
        s_q = q.shape[1]
        if s_q == 1:
            paged.write_token_to_pages_q8(kp, ks, vp, vs, k[:, 0], v[:, 0],
                                          positions=lengths,
                                          page_tables=tables)
            out = paged.paged_attention_dma_q8(q[:, 0], kp, ks, vp, vs,
                                               lengths + 1, tables,
                                               alibi_slopes=slopes)
            return out[:, None]
        if self.cfg.paged_multi_query:
            paged.write_tokens_to_pages_q8(kp, ks, vp, vs, k, v,
                                           start_positions=lengths,
                                           page_tables=tables)
            return paged.paged_window_attention_q8(
                q, kp, ks, vp, vs, lengths + s_q, tables, alibi_slopes=slopes)
        # prefill: quantize the prompt into the identity-mapped pages;
        # attention is plain self-attention over the (unquantized) prompt
        b, s = k.shape[:2]
        rows = tables.shape[1] * kp.shape[1]
        for pages, scales, new in ((kp, ks, k), (vp, vs, v)):
            values, sc = paged.quantize_pages(new.reshape(b, s, -1),
                                              self.cfg.head_size,
                                              lanes=scales.shape[-1])
            _prompt_rows(pages, b, rows, layer_index)[:, :s] = values
            _prompt_rows(scales, b, rows, layer_index)[:, :s] = sc
        return dispatch_attention(
            q, k, v, causal=True, segment_ids_q=segment_ids,
            segment_ids_kv=segment_ids, alibi_slopes=slopes)


class DecoderBlock(nn.Module):
    def __init__(self, cfg: DecoderConfig):
        super().__init__()
        self.cfg = cfg
        self.input_norm = cfg.norm_layer()
        self.attn = Attention(cfg)
        q8 = cfg.weight_dtype == "int8"
        if cfg.mlp == "gated":
            self.mlp = GatedMLP(cfg.hidden_size, cfg.intermediate_size,
                                dtype=cfg.dtype, weight_q8=q8)
        else:
            self.mlp = SimpleMLP(cfg.hidden_size, cfg.intermediate_size,
                                 activation=cfg.mlp, dtype=cfg.dtype,
                                 weight_q8=q8)
        if not cfg.parallel_block:
            self.post_attn_norm = cfg.norm_layer()

    def forward(self, x, positions, segment_ids, layer_cache, cache_aux):
        h = self.input_norm(x)
        attn_out = self.attn(h, positions, segment_ids, layer_cache, cache_aux)
        if self.cfg.parallel_block:
            # Phi-2: attention and MLP read the same normed input
            return x + attn_out + self.mlp(h)
        x = x + attn_out
        return x + self.mlp(self.post_attn_norm(x))


def _run_block(block: nn.Module, params: Dict[str, torch.Tensor], x,
               args, remat: bool):
    """``block(x, *args)`` on ``params``. With ``remat`` the block's inside
    is recomputed in the backward and only its input is kept
    (``nn.remat(policy=nothing_saveable)``, ``decoder.py:664-671``); the
    recompute reads the same ``params``, so weights a caller swapped in
    for the forward (``torch.func.functional_call``, LoRA's merged
    kernels) hold there too."""
    def run(h):
        return torch.func.functional_call(block, params, (h,) + args)

    if remat:
        return torch.utils.checkpoint.checkpoint(run, x, use_reentrant=False)
    return run(x)


def _flat_pages(pages: torch.Tensor) -> torch.Tensor:
    """(L, P, page, w) -> the (L * P, page, w) VIEW of the same storage.
    A ``reshape`` of a non-contiguous pool would copy silently, and the
    layers' in-place page writes would then be lost."""
    if not pages.is_contiguous():
        raise ValueError("a stacked paged pool must be contiguous")
    return pages.view((-1,) + tuple(pages.shape[2:]))


class ScannedLayers(nn.Module):
    """The layer stack of a ``scan_layers`` decoder: ONE
    :class:`DecoderBlock` whose parameters carry a leading layer axis, the
    tree of JAX's ``nn.scan`` (``layers/block/...``). Fresh parameters are
    drawn layer by layer (``split_rngs={"params": True}``).

    Layer ``li`` runs the block on its slices of every leaf through
    ``torch.func.functional_call``. The slices come from one ``unbind`` a
    forward, so the backward stacks the layers' gradients into each leaf
    once. Its cache is the stacked one: dense layers read their slice,
    paged layers share one flat pool through offset page tables."""

    def __init__(self, cfg: DecoderConfig):
        super().__init__()
        self.cfg = cfg
        blocks = [DecoderBlock(cfg) for _ in range(cfg.num_layers)]
        self.block = blocks[0]
        for name, param in list(self.block.named_parameters()):
            owner, _, leaf = name.rpartition(".")
            stacked = torch.stack([blk.get_parameter(name).detach()
                                   for blk in blocks])
            setattr(self.block.get_submodule(owner), leaf,
                    nn.Parameter(stacked, requires_grad=param.requires_grad))
        for module in self.block.modules():
            module.stacked_layers = True   # its parameters lead with L

    def _layer_caches(self, kv_cache, cache_aux):
        """(layer cache, cache aux) for each layer."""
        L = self.cfg.num_layers
        if kv_cache is None:
            return [(None, cache_aux)] * L
        pool = kv_cache["layers"]
        if "page_tables" not in kv_cache:
            return [({key: t[li] for key, t in pool.items()}, cache_aux)
                    for li in range(L)]
        # one flat pool for every layer; the L offset tables are made in
        # one op, not one add per layer
        flat = {key: _flat_pages(t) for key, t in pool.items()}
        per_layer = pool["k_pages"].shape[1]
        tables = kv_cache["page_tables"] + per_layer * torch.arange(
            L, dtype=torch.int32, device=pool["k_pages"].device)[:, None, None]
        return [(flat, dict(cache_aux, page_tables=tables[li],
                            layer_index=li)) for li in range(L)]

    def forward(self, x, positions, segment_ids, kv_cache, cache_aux,
                remat: bool):
        names = [n for n, _ in self.block.named_parameters()]
        slices = zip(*(p.unbind(0) for _, p in self.block.named_parameters()))
        caches = self._layer_caches(kv_cache, cache_aux)
        for layer, (layer_cache, aux) in zip(slices, caches):
            x = _run_block(self.block, dict(zip(names, layer)), x,
                           (positions, segment_ids, layer_cache, aux), remat)
        return x


class CausalLM(nn.Module):
    """Token ids (or pre-spliced embeddings) -> logits (+ updated cache)."""

    def __init__(self, cfg: DecoderConfig):
        super().__init__()
        if cfg.weight_dtype == "int8" and cfg.normhead:
            # NormHead renormalizes its kernel every forward, which a static
            # per-channel scale cannot represent (decoder.py:622-628)
            raise ValueError("int8 weights: a NormHead stays full precision")
        self.cfg = cfg
        self.tp_group = None
        self.embed_tokens = Embed(cfg.vocab_size, cfg.hidden_size,
                                  dtype=cfg.dtype)
        if cfg.positional == "learned":
            self.embed_positions = Embed(cfg.max_position_embeddings + 2,
                                         cfg.hidden_size, dtype=cfg.dtype)
        if cfg.scan_layers:
            self.layers = ScannedLayers(cfg)
        else:
            for i in range(cfg.num_layers):
                self.add_module(f"layers_{i}", DecoderBlock(cfg))
        if cfg.final_norm:
            self.final_norm = cfg.norm_layer()
        if not cfg.tie_word_embeddings:
            if cfg.normhead:
                self.lm_head_kernel = normal_param(
                    (cfg.hidden_size, cfg.vocab_size))
                set_param_axes(self, lm_head_kernel=("embed", "vocab"))
            else:
                self.lm_head = DenseGeneral(
                    cfg.hidden_size, cfg.vocab_size,
                    use_bias=cfg.lm_head_bias, dtype=cfg.dtype,
                    weight_q8=cfg.weight_dtype == "int8",
                    kernel_axes=("embed", "vocab"))

    def tensor_parallel_(self, dims, info, prefix) -> None:
        """Gather the logits over the tensor group when the head's (or the
        tied table's) vocabulary is cut."""
        pre = f"{prefix}." if prefix else ""
        head = ("embed_tokens.embedding" if self.cfg.tie_word_embeddings
                else "lm_head_kernel" if self.cfg.normhead
                else "lm_head.kernel_q8" if self.cfg.weight_dtype == "int8"
                else "lm_head.kernel")
        if pre + head in info.tp_dims:
            self.tp_group = info.tp_group

    @property
    def blocks(self):
        """The per-layer blocks of the loop stack (none when scanned)."""
        if self.cfg.scan_layers:
            return []
        return [getattr(self, f"layers_{i}") for i in range(self.cfg.num_layers)]

    def embed(self, input_ids: torch.Tensor) -> torch.Tensor:
        return self.embed_tokens(input_ids)

    def compute_logits(self, hidden: torch.Tensor) -> torch.Tensor:
        """f32 logits over the whole vocabulary (gathered over the tensor
        group when the head holds a slice of it)."""
        cfg = self.cfg
        if cfg.tie_word_embeddings:
            logits = self.embed_tokens.attend(hidden)
        elif cfg.normhead:
            hidden = copy_to_group(hidden, self.tp_group)
            kernel = self.lm_head_kernel.float()
            kernel = kernel / (torch.linalg.vector_norm(
                kernel, dim=0, keepdim=True) + 1e-7)
            # bf16 operands, f32 products and sums (preferred_element_type)
            logits = hidden.to(cfg.dtype).float() @ kernel.to(
                cfg.dtype).float()
        else:
            logits = self.lm_head(hidden)
        return gather_from_group(logits, self.tp_group, dim=-1)

    def forward(self, input_ids=None, *, inputs_embeds=None, positions=None,
                segment_ids=None, kv_cache=None, return_hidden=False):
        cfg = self.cfg
        if cfg.scan_layers and kv_cache is not None \
                and not isinstance(kv_cache["layers"], dict):
            raise ValueError(
                "scan_layers decode needs a STACKED KV cache "
                "(init_kv_cache(stacked=True)): the per-layer slices ride "
                "the layer axis")
        if inputs_embeds is None:
            inputs_embeds = self.embed_tokens(input_ids)
        b, s = inputs_embeds.shape[:2]
        dev = inputs_embeds.device
        if positions is None:
            start = kv_cache["index"] if kv_cache is not None else 0
            positions = start + torch.arange(s, device=dev).expand(b, s)
        x = inputs_embeds
        if cfg.positional == "learned":
            x = x + self.embed_positions(positions + 2)

        cache_aux = None
        paged_cache = kv_cache is not None and "page_tables" in kv_cache
        if paged_cache:
            cache_aux = {"page_tables": kv_cache["page_tables"],
                         "lengths": kv_cache["lengths"]}
        elif kv_cache is not None:
            # validity/position bookkeeping is layer-independent: written
            # once here (in place) before the layers read it
            idx = kv_cache["index"]
            seg_in = (segment_ids if segment_ids is not None
                      else torch.ones((b, s), dtype=torch.int32, device=dev))
            kv_cache["seg"][:, idx:idx + s] = seg_in.to(torch.int32)
            kv_cache["pos"][:, idx:idx + s] = positions.to(torch.int32)
            cache_aux = {"seg": kv_cache["seg"], "pos": kv_cache["pos"],
                         "index": idx}

        remat = cfg.remat and kv_cache is None and torch.is_grad_enabled()
        # one span over the layer stack, not one a layer: every layer is
        # the same, and its share is the span over num_layers
        with annotate("merlin.decoder.layers"):
            if cfg.scan_layers:
                x = self.layers(x, positions, segment_ids, kv_cache,
                                cache_aux, remat)
            for i, blk in enumerate(self.blocks):
                layer_cache = (kv_cache["layers"][i] if kv_cache is not None
                               else None)
                if remat:
                    x = _run_block(blk, dict(blk.named_parameters()), x,
                                   (positions, segment_ids, None, None), True)
                else:
                    x = blk(x, positions, segment_ids, layer_cache, cache_aux)
        with annotate("merlin.decoder.head"):
            if cfg.final_norm:
                x = self.final_norm(x)
            logits = self.compute_logits(x)

        new_cache = None
        if kv_cache is not None:
            new_cache = dict(kv_cache, index=kv_cache["index"] + s)
        if paged_cache:
            lengths = kv_cache["lengths"]
            if s == 1:
                new_cache["lengths"] = lengths + 1
            elif cfg.paged_multi_query:
                # a verify window appends s tokens; callers roll back
                # rejected drafts by overwriting lengths afterwards
                new_cache["lengths"] = lengths + s
            elif segment_ids is not None:
                new_cache["lengths"] = (segment_ids > 0).sum(
                    dim=1, dtype=torch.int32)
            else:
                new_cache["lengths"] = torch.full((b,), s, dtype=torch.int32,
                                                  device=dev)
        if return_hidden:
            return logits, new_cache, x
        return logits, new_cache


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor, *,
                       ignore_index: int = -100, z_loss_weight: float = 0.0):
    """Label-aligned cross entropy in f32 with ignore masking and an
    optional z-loss (``decoder.py:804-822``). logits (b, s, V); labels
    (b, s), already shifted by the caller. Returns (mean loss over the
    valid tokens, their count); the mean divides by at least 1."""
    total, count = cross_entropy_sum(logits, labels,
                                     ignore_index=ignore_index,
                                     z_loss_weight=z_loss_weight)
    return total / count.clamp_min(1), count


def cross_entropy_sum(logits: torch.Tensor, labels: torch.Tensor, *,
                      ignore_index: int = -100, z_loss_weight: float = 0.0):
    """(sum of the per-token losses over the valid tokens, their count):
    the parts of :func:`cross_entropy_loss` that a mesh sums over the
    (data, fsdp) ranks before dividing."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    nll = logz - torch.gather(logits, -1, safe[..., None])[..., 0]
    if z_loss_weight:
        nll = nll + z_loss_weight * logz.square()
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    return nll.sum(), valid.sum()
