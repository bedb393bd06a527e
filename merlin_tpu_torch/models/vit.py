"""Vision transformer: the CLIP ViT tower (counterpart of
``merlin_tpu/models/vit.py``).

NHWC pixels, patchify as space-to-depth plus one matmul (HWIO kernel, the
flax layout), learned positions, pre-norm, f32 layer norms, and
bidirectional attention through the dispatcher (the one-pass kernel B1 on
the card). ``CLIPVisionTower`` takes hidden_states[select_layer] with the
CLS token dropped and builds only the layers that selection runs. The HF
and Qwen converters and the sincos2d positions wait for a later slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional

import torch
from torch import nn

from merlin_tpu_torch.models.layers import (
    DenseGeneral, LayerNorm, SimpleMLP, normal_param)
from merlin_tpu_torch.ops.attention import attention as shared_attention


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    patch_size: int = 14
    image_size: int = 448
    num_channels: int = 3
    layer_norm_eps: float = 1e-5
    activation: str = "quick_gelu"
    use_class_token: bool = True
    use_pre_layernorm: bool = True
    pos_embed: str = "learned"
    dtype: Any = torch.bfloat16

    @property
    def grid_size(self) -> int:
        return self.image_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid_size ** 2

    @property
    def num_positions(self) -> int:
        return self.num_patches + (1 if self.use_class_token else 0)


def clip_vit_l14(image_size: int = 448, **kw) -> ViTConfig:
    return ViTConfig(hidden_size=1024, num_layers=24, num_heads=16,
                     intermediate_size=4096, patch_size=14,
                     image_size=image_size, **kw)


def tiny_vit(**kw) -> ViTConfig:
    defaults = dict(hidden_size=32, num_layers=2, num_heads=4,
                    intermediate_size=64, patch_size=4, image_size=16,
                    dtype=torch.float32)
    defaults.update(kw)
    return ViTConfig(**defaults)


class PatchEmbed(nn.Module):
    """Patchify as space-to-depth + one matmul; ``kernel`` is HWIO
    (p, p, cin, features) and the patch columns flatten in the same
    (dh, dw, cin) order."""

    def __init__(self, features: int, patch: int, cin: int = 3,
                 use_bias: bool = False, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.patch = patch
        self.features = features
        self.dtype = dtype
        self.kernel = normal_param((patch, patch, cin, features))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        b, H, W, cin = pixels.shape
        p = self.patch
        gh, gw = H // p, W // p
        t = pixels.to(self.dtype).reshape(b, gh, p, gw, p, cin).permute(
            0, 1, 3, 2, 4, 5)
        out = t.reshape(b * gh * gw, p * p * cin) @ self.kernel.to(
            self.dtype).reshape(p * p * cin, self.features)
        if self.bias is not None:
            out = out + self.bias.to(self.dtype)
        return out.reshape(b, gh, gw, self.features)


class ViTBlock(nn.Module):
    def __init__(self, cfg: ViTConfig):
        super().__init__()
        e, h = cfg.hidden_size, cfg.num_heads
        d = e // h
        self.norm1 = LayerNorm(e, eps=cfg.layer_norm_eps)
        self.q_proj = DenseGeneral(e, (h, d), use_bias=True, dtype=cfg.dtype)
        self.k_proj = DenseGeneral(e, (h, d), use_bias=True, dtype=cfg.dtype)
        self.v_proj = DenseGeneral(e, (h, d), use_bias=True, dtype=cfg.dtype)
        self.o_proj = DenseGeneral((h, d), e, use_bias=True, dtype=cfg.dtype)
        self.norm2 = LayerNorm(e, eps=cfg.layer_norm_eps)
        self.mlp = SimpleMLP(e, cfg.intermediate_size,
                             activation=cfg.activation, dtype=cfg.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.norm1(x)
        attn = shared_attention(self.q_proj(h), self.k_proj(h),
                                self.v_proj(h), causal=False)
        x = x + self.o_proj(attn)
        return x + self.mlp(self.norm2(x))


class ViT(nn.Module):
    """CLIP-style ViT: NHWC pixels -> per-layer hidden states (index 0 =
    embeddings), like HF ``output_hidden_states=True``. ``active_layers``
    builds and runs only the first layers."""

    def __init__(self, cfg: ViTConfig, active_layers: Optional[int] = None):
        super().__init__()
        if cfg.pos_embed != "learned":
            raise NotImplementedError(
                f"pos_embed={cfg.pos_embed!r}: only 'learned' is ported")
        self.cfg = cfg
        self.n_layers = (cfg.num_layers if active_layers is None
                         else min(active_layers, cfg.num_layers))
        self.patch_embed = PatchEmbed(cfg.hidden_size, cfg.patch_size,
                                      cfg.num_channels, dtype=cfg.dtype)
        if cfg.use_class_token:
            self.class_embedding = normal_param((cfg.hidden_size,))
        self.position_embedding = normal_param(
            (cfg.num_positions, cfg.hidden_size))
        if cfg.use_pre_layernorm:
            self.pre_norm = LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        for i in range(self.n_layers):
            self.add_module(f"layers_{i}", ViTBlock(cfg))

    def forward(self, pixel_values: torch.Tensor) -> List[torch.Tensor]:
        cfg = self.cfg
        b = pixel_values.shape[0]
        x = self.patch_embed(pixel_values).reshape(b, -1, cfg.hidden_size)
        if cfg.use_class_token:
            cls = self.class_embedding.to(cfg.dtype).expand(b, 1, -1)
            x = torch.cat([cls, x], dim=1)
        x = x + self.position_embedding.to(cfg.dtype)[None]
        if cfg.use_pre_layernorm:
            x = self.pre_norm(x)
        hidden_states = [x]
        for i in range(self.n_layers):
            x = getattr(self, f"layers_{i}")(x)
            hidden_states.append(x)
        return hidden_states


class CLIPVisionTower(nn.Module):
    """hidden_states[select_layer] with CLS dropped ('patch') or kept
    ('cls_patch'); default select_layer -2 runs 23 of ViT-L's 24 layers."""

    def __init__(self, cfg: ViTConfig, select_layer: int = -2,
                 select_feature: str = "patch"):
        super().__init__()
        if select_feature not in ("patch", "cls_patch"):
            raise ValueError(f"unknown select_feature {select_feature}")
        self.cfg = cfg
        self.select_feature = select_feature
        self.idx = select_layer % (cfg.num_layers + 1)
        self.vit = ViT(cfg, active_layers=self.idx)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        feats = self.vit(pixel_values)[self.idx]
        if self.select_feature == "patch" and self.cfg.use_class_token:
            feats = feats[:, 1:]
        return feats
