"""Vision-to-LM projectors (counterpart of ``merlin_tpu/models/projectors.py``):
tower features (b, P, C_vision) -> LM tokens (b, P', D_lm).

  * MLPProjector  - single linear
  * ConvProjector - the Merlin default: features on the patch grid, 3x3
    conv with stride ``conv_stride``, padding 1 (32x32 grid -> 256 tokens)

The Qwen, SAM and resampler projectors come with a later slice.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from merlin_tpu_torch.models.layers import DenseGeneral, normal_param


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
                                 dtype=dtype)

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


def build_projector(kind: str, in_features: int, out_features: int, *,
                    conv_stride: int = 2,
                    dtype: torch.dtype = torch.bfloat16) -> nn.Module:
    if kind == "conv":
        return ConvProjector(in_features, out_features,
                             conv_stride=conv_stride, dtype=dtype)
    if kind in ("mlp", "linear"):
        return MLPProjector(in_features, out_features, dtype=dtype)
    raise NotImplementedError(f"projector kind {kind!r} is not ported yet")
