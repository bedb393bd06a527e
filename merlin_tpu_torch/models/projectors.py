"""Vision-to-LM projectors (counterpart of ``merlin_tpu/models/projectors.py``):
tower features (b, P, C_vision) -> LM tokens (b, P', D_lm).

  * MLPProjector  - single linear
  * ConvProjector - the Merlin default: features on the patch grid, 3x3
    conv with stride ``conv_stride``, padding 1 (32x32 grid -> 256 tokens)
  * QWenProjector - a bare (C, D) matmul parameter
  * SAMProjector  - two bias-free stride-2 3x3 convs (C -> 2C -> 4C, no
    activation between them), then a linear
  * Resampler     - Qwen-VL's perceiver: 256 learned queries cross-attend
    the features once, at the vision width, through ``mha_reference`` as
    in JAX (no kernel); its ``pos_embed`` is a real parameter used under
    no gradient, bicubic-resized to the key grid when that differs

:func:`resampler_params_from_torch` maps Qwen-VL's ``attn_pool`` (an
``nn.MultiheadAttention`` whose ``in_proj`` packs [all q; all k; all v])
onto the Resampler's tree.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from merlin_tpu_torch.core.partitioning import set_param_axes
from merlin_tpu_torch.models.layers import (
    DenseGeneral, LayerNorm, MatmulF32, normal_param)
from merlin_tpu_torch.ops.attention import mha_reference
from merlin_tpu_torch.ops.image_ops import resize_bicubic


class StridedConv(nn.Module):
    """2D conv in the JAX package's default ``taps`` lowering: one
    (b*out_hw, cin) @ (cin, cout) matmul per kernel tap, summed in the order
    dh outer, dw inner. Each partial product is rounded to the compute
    dtype before it is added, as on the TPU (trap C4): in bf16 the sum of
    nine rounded partials differs from a convolution's single rounding, so
    parity is held at f32. ``kernel`` is HWIO (kh, kw, cin, cout)."""

    def __init__(self, cin: int, features: int,
                 kernel_size: Tuple[int, int] = (3, 3), stride: int = 2,
                 padding: int = 1, use_bias: bool = True,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.kernel_size = kernel_size
        self.stride = stride
        self.padding = padding
        self.features = features
        self.dtype = dtype
        self.kernel = normal_param(tuple(kernel_size) + (cin, features))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None
        set_param_axes(self, kernel=("conv_hw", "conv_hw", "conv_in",
                                     "conv_out"), bias=("conv_out",))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kh, kw = self.kernel_size
        s = self.stride
        b, H, W, cin = x.shape
        out_h = (H + 2 * self.padding - kh) // s + 1
        out_w = (W + 2 * self.padding - kw) // s + 1
        x = x.to(self.dtype)
        kern = self.kernel.to(self.dtype)
        if self.padding:
            p = self.padding
            x = F.pad(x, (0, 0, p, p, p, p))
        out = None
        for dh in range(kh):
            for dw in range(kw):
                tap = x[:, dh:dh + (out_h - 1) * s + 1:s,
                        dw:dw + (out_w - 1) * s + 1:s, :]
                part = tap.reshape(b * out_h * out_w, cin) @ kern[dh, dw]
                out = part if out is None else out + part
        if self.bias is not None:
            out = out + self.bias.to(self.dtype)
        return out.reshape(b, out_h, out_w, self.features)


class MLPProjector(nn.Module):
    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.proj = DenseGeneral(in_features, out_features, use_bias=True,
                                 dtype=dtype,
                                 kernel_axes=("vit_embed", "embed"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.proj(x)


class ConvProjector(nn.Module):
    """3x3 conv, stride ``conv_stride``, padding 1 over the patch grid."""

    def __init__(self, in_features: int, out_features: int,
                 conv_stride: int = 2, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.out_features = out_features
        self.dtype = dtype
        self.conv = StridedConv(in_features, out_features, kernel_size=(3, 3),
                                stride=conv_stride, padding=1, use_bias=True,
                                dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, p, c = x.shape
        side = math.isqrt(p)
        if side * side != p:
            raise ValueError(f"patch count {p} is not square")
        out = self.conv(x.reshape(b, side, side, c).to(self.dtype))
        return out.reshape(b, -1, self.out_features)


class QWenProjector(nn.Module):
    """A bare (C, D) parameter ``proj``: x @ proj, operands in the compute
    dtype, f32 sums, one rounding."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.proj = normal_param((in_features, out_features))
        set_param_axes(self, proj=("vit_embed", "embed"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, p, c = x.shape
        out = MatmulF32.apply(x.to(self.dtype).reshape(b * p, c),
                              self.proj.to(self.dtype))
        return out.to(self.dtype).reshape(b, p, -1)


class SAMProjector(nn.Module):
    """Two stride-2 3x3 convs (C -> 2C -> 4C, no bias, no activation
    between them), then a linear to the LM width: (grid / 4)^2 tokens."""

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        c = in_features
        self.dtype = dtype
        self.conv1 = StridedConv(c, 2 * c, stride=2, padding=1,
                                 use_bias=False, dtype=dtype)
        self.conv2 = StridedConv(2 * c, 4 * c, stride=2, padding=1,
                                 use_bias=False, dtype=dtype)
        self.proj = DenseGeneral(4 * c, out_features, use_bias=True,
                                 dtype=dtype,
                                 kernel_axes=("vit_embed", "embed"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, p, c = x.shape
        side = math.isqrt(p)
        grid = self.conv2(self.conv1(
            x.reshape(b, side, side, c).to(self.dtype)))
        return self.proj(grid.reshape(b, -1, grid.shape[-1]))


def sincos_2d_pos_embed(dim: int, grid: int) -> np.ndarray:
    """(grid * grid, dim) f32 2D sin-cos table: the first half of the
    channels encode the row, the second the column, each as [sin | cos]
    over dim // 4 frequencies (a copy of the JAX package's numpy
    ``_sincos_2d_pos_embed``, so the tables are bit-identical)."""
    def one_axis(d, positions):
        omega = 1.0 / (10000 ** (np.arange(d // 2, dtype=np.float64)
                                 / (d // 2)))
        out = np.einsum("p,f->pf", positions, omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    coords = np.arange(grid, dtype=np.float64)
    yy, xx = np.meshgrid(coords, coords, indexing="ij")
    emb_y = one_axis(dim // 2, yy.reshape(-1))
    emb_x = one_axis(dim // 2, xx.reshape(-1))
    return np.concatenate([emb_y, emb_x], axis=1).astype(np.float32)


def resampler_pos_init(num_queries: int, dim: int) -> torch.Tensor:
    """The Resampler's ``pos_embed`` at init: the sin-cos table of the
    query grid, zeros when the query count is not a square."""
    side = math.isqrt(num_queries)
    if side * side != num_queries:
        return torch.zeros(num_queries, dim)
    return torch.from_numpy(sincos_2d_pos_embed(dim, side))


class Resampler(nn.Module):
    """Perceiver resampler (Qwen-VL): ``num_queries`` learned queries
    cross-attend the features once; the output is always
    (b, num_queries, out_features).

    The attention runs at ``embed_dim`` (default ``out_features``; MMGPT
    passes the vision width, and only ``proj`` maps to the LM width).
    ``pos_embed`` is added to the queries and to the keys, never the
    values, without a gradient; keys on another grid than the queries' see
    it resized with JAX's bicubic (trap C1). The attention is
    ``mha_reference``, as in JAX."""

    def __init__(self, in_features: int, out_features: int,
                 num_queries: int = 256, num_heads: int = 16,
                 embed_dim: Optional[int] = None,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        dim = embed_dim or out_features
        h = num_heads
        d = dim // h
        self.dim, self.num_heads, self.num_queries = dim, h, num_queries
        self.dtype = dtype
        self.query = normal_param((num_queries, dim))
        self.pos_embed = nn.Parameter(resampler_pos_init(num_queries, dim))
        self.kv_proj = DenseGeneral(in_features, dim, dtype=dtype,
                                    kernel_axes=("vit_embed", "embed"))
        self.ln_kv = LayerNorm(dim)
        self.ln_q = LayerNorm(dim)
        col = dict(use_bias=True, dtype=dtype,
                   kernel_axes=("embed", "heads", "kv"))
        self.q_attn = DenseGeneral(dim, (h, d), **col)
        self.k_attn = DenseGeneral(dim, (h, d), **col)
        self.v_attn = DenseGeneral(dim, (h, d), **col)
        self.out_attn = DenseGeneral((h, d), dim, use_bias=True, dtype=dtype,
                                     kernel_axes=("heads", "kv", "embed"))
        self.ln_post = LayerNorm(dim)
        self.proj = normal_param((dim, out_features))
        set_param_axes(self, query=("vit_patches", "embed"),
                       pos_embed=("vit_patches", "embed"),
                       proj=("embed", "embed"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, p, c = x.shape
        dt = self.dtype
        kv_in = self.ln_kv(self.kv_proj(x))
        q_in = self.ln_q(self.query.to(dt).expand(b, -1, -1))
        pe = self.pos_embed.detach()
        q_in = q_in + pe[None].to(dt)
        k_in = kv_in
        side = math.isqrt(p)
        qside = math.isqrt(self.num_queries)
        if side * side == p and qside * qside == self.num_queries:
            if p == self.num_queries:
                pos_k = pe
            else:
                pos_k = resize_bicubic(
                    pe.float().reshape(1, qside, qside, self.dim),
                    (side, side)).reshape(p, self.dim)
            k_in = kv_in + pos_k[None].to(dt)
        out = mha_reference(self.q_attn(q_in), self.k_attn(k_in),
                            self.v_attn(kv_in), causal=False)
        out = self.ln_post(self.out_attn(out))
        return (out.to(dt) @ self.proj.to(dt)).to(dt)


def resampler_params_from_torch(state_dict: Mapping[str, Any], *, dim: int,
                                num_heads: int) -> Dict[str, Any]:
    """Qwen-VL Resampler state dict -> the Resampler's flax-named tree
    (``merlin_tpu/models/projectors.py:309-373``; keys optionally under
    'attn_pool.' or 'resampler.').

    ``attn.in_proj`` is block-packed [all q; all k; all v]. A checkpoint's
    ``pos_embed`` (a trained parameter in the reference) passes through
    unchanged; only when it is absent is the sin-cos table made.
    ``ln_post``/``proj`` are mapped when present, else left out of the
    tree (the module keeps its own)."""
    def key(name):
        for cand in (name, "attn_pool." + name, "resampler." + name):
            if cand in state_dict:
                return state_dict[cand].float()
        raise KeyError(name)

    h, d = num_heads, dim // num_heads
    w = key("attn.in_proj_weight")           # (3E, E) block-packed
    b = key("attn.in_proj_bias")
    p: Dict[str, Any] = {"query": key("query"),
                         "kv_proj": {"kernel": key("kv_proj.weight").T}}
    try:
        p["pos_embed"] = key("pos_embed")
    except KeyError:
        p["pos_embed"] = resampler_pos_init(
            p["query"].shape[0], dim).to(p["query"].device)
    p.update({
        "ln_q": {"scale": key("ln_q.weight"), "bias": key("ln_q.bias")},
        "ln_kv": {"scale": key("ln_kv.weight"), "bias": key("ln_kv.bias")},
        "q_attn": {"kernel": w[:dim].T.reshape(dim, h, d),
                   "bias": b[:dim].reshape(h, d)},
        "k_attn": {"kernel": w[dim:2 * dim].T.reshape(dim, h, d),
                   "bias": b[dim:2 * dim].reshape(h, d)},
        "v_attn": {"kernel": w[2 * dim:].T.reshape(dim, h, d),
                   "bias": b[2 * dim:].reshape(h, d)},
        "out_attn": {"kernel": key("attn.out_proj.weight").T.reshape(
            h, d, dim), "bias": key("attn.out_proj.bias")},
    })
    for src, leaf in (("ln_post.weight", "scale"), ("ln_post.bias", "bias")):
        try:
            p.setdefault("ln_post", {})[leaf] = key(src)
        except KeyError:
            pass
    try:
        p["proj"] = key("proj")
    except KeyError:
        pass
    return p


PROJECTOR_KINDS = {
    "mlp": MLPProjector,
    "linear": MLPProjector,
    "conv": ConvProjector,
    "qwen": QWenProjector,
    "sam": SAMProjector,
    "qwen_sampler": Resampler,
    "resampler": Resampler,
}


def default_resampler_heads(embed_dim: int) -> int:
    """The reference's head count, vision_hidden // 128; small test widths
    fall back to 8-wide heads."""
    if embed_dim % 128 == 0:
        return embed_dim // 128
    return max(1, embed_dim // 8)


def build_projector(kind: str, in_features: int, out_features: int, *,
                    conv_stride: int = 2,
                    dtype: torch.dtype = torch.bfloat16,
                    embed_dim: Optional[int] = None,
                    num_heads: Optional[int] = None) -> nn.Module:
    """The projector of ``kind`` from ``in_features`` (the tower's width)
    to ``out_features`` (the LM's). ``embed_dim``/``num_heads`` apply to
    the resampler kinds only (attention width, and heads defaulting to
    ``default_resampler_heads``)."""
    if kind == "conv":
        return ConvProjector(in_features, out_features,
                             conv_stride=conv_stride, dtype=dtype)
    if kind in ("qwen_sampler", "resampler"):
        dim = embed_dim or out_features
        return Resampler(in_features, out_features, embed_dim=embed_dim,
                         num_heads=num_heads or default_resampler_heads(dim),
                         dtype=dtype)
    if kind not in PROJECTOR_KINDS:
        raise ValueError(f"unknown projector kind {kind!r}; "
                         f"one of {sorted(PROJECTOR_KINDS)}")
    return PROJECTOR_KINDS[kind](in_features, out_features, dtype=dtype)
