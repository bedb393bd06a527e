"""Vision transformers: the CLIP-style ViT towers (counterpart of
``merlin_tpu/models/vit.py``).

NHWC pixels, patchify as space-to-depth plus one matmul (HWIO kernel, the
flax layout), learned or fixed 2D sin-cos positions, pre-norm, f32 layer
norms, and bidirectional attention through the dispatcher (the one-pass
kernel B1 on the card). ``CLIPVisionTower`` takes hidden_states
[select_layer] with the CLS token dropped and builds only the layers that
selection runs. Configs: CLIP ViT-L/14, MetaCLIP ViT-H/14 (d = 80) and
Qwen-VL ViT-bigG (d = 104, no CLS).

The converters map a torch state dict (tensors, e.g. a
:class:`~merlin_tpu_torch.models.convert.CheckpointDict`) onto the flax
tree: :func:`vit_params_from_hf` for HF ``CLIPVisionModel`` keys and
:func:`qwen_vit_params_from_torch` for the Qwen-VL tower, whose ``in_proj``
interleaves q, k and v per head. :func:`interpolate_pos_embedding` resizes
a learned table to the tower's grid with JAX's antialiased Keys bicubic
(trap C1), never ``F.interpolate``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Mapping, Optional

import torch
from torch import nn

from merlin_tpu_torch.models.convert import _o_kernel, _qkv_kernel
from merlin_tpu_torch.models.layers import (
    DenseGeneral, LayerNorm, SimpleMLP, normal_param)
from merlin_tpu_torch.models.projectors import sincos_2d_pos_embed
from merlin_tpu_torch.ops.attention import attention as shared_attention
from merlin_tpu_torch.ops.image_ops import resize_bicubic


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
    # 'learned' (CLIP) or 'sincos2d' (Qwen-VL: a fixed 2D sin-cos table for
    # the current grid)
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


def metaclip_vit_h14(image_size: int = 448, **kw) -> ViTConfig:
    """MetaCLIP ViT-H/14: 1280 wide, 32 layers, 16 heads (d = 80), gelu."""
    return ViTConfig(hidden_size=1280, num_layers=32, num_heads=16,
                     intermediate_size=5120, patch_size=14,
                     image_size=image_size, activation="gelu", **kw)


def qwen_vit_bigG(image_size: int = 448, **kw) -> ViTConfig:
    """Qwen-VL ViT-bigG: 1664 wide, 48 layers, 16 heads (d = 104), patch
    14, no CLS token, 2D sin-cos positions for the current grid (pass
    ``pos_embed='learned'`` to load pretrained weights)."""
    kw.setdefault("pos_embed", "sincos2d")
    return ViTConfig(hidden_size=1664, num_layers=48, num_heads=16,
                     intermediate_size=8192, patch_size=14,
                     image_size=image_size, activation="gelu",
                     use_class_token=False, **kw)


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
        if cfg.pos_embed not in ("learned", "sincos2d"):
            raise ValueError(f"unknown pos_embed {cfg.pos_embed!r}")
        self.cfg = cfg
        self.n_layers = (cfg.num_layers if active_layers is None
                         else min(active_layers, cfg.num_layers))
        self.patch_embed = PatchEmbed(cfg.hidden_size, cfg.patch_size,
                                      cfg.num_channels, dtype=cfg.dtype)
        if cfg.use_class_token:
            self.class_embedding = normal_param((cfg.hidden_size,))
        if cfg.pos_embed == "learned":
            self.position_embedding = normal_param(
                (cfg.num_positions, cfg.hidden_size))
        self._fixed_pos: Dict[torch.device, torch.Tensor] = {}
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
        x = x + self.positions(x.device).to(cfg.dtype)[None]
        if cfg.use_pre_layernorm:
            x = self.pre_norm(x)
        hidden_states = [x]
        for i in range(self.n_layers):
            x = getattr(self, f"layers_{i}")(x)
            hidden_states.append(x)
        return hidden_states

    def positions(self, device) -> torch.Tensor:
        """(num_positions, hidden) f32: the learned table, or the sin-cos
        table of the grid (a zero row for the CLS token first), made once
        per device."""
        cfg = self.cfg
        if cfg.pos_embed == "learned":
            return self.position_embedding
        device = torch.device(device)
        table = self._fixed_pos.get(device)
        if table is None:
            table = torch.from_numpy(sincos_2d_pos_embed(
                cfg.hidden_size, cfg.grid_size))
            if cfg.use_class_token:
                table = torch.cat([torch.zeros(1, cfg.hidden_size), table])
            table = self._fixed_pos[device] = table.to(device)
        return table


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


# ---------------------------------------------------------------------------
# torch weight conversion + position-embedding interpolation
# ---------------------------------------------------------------------------

def interpolate_pos_embedding(pos: torch.Tensor, new_positions: int,
                              has_class_token: bool = True) -> torch.Tensor:
    """Bicubic 2D interpolation of a (P, C) position table to
    ``new_positions`` rows (224 -> 448 upres), on the table's device: JAX's
    ``jax.image.resize(..., "bicubic")``, Keys a = -0.5, antialiased when
    it shrinks. A table of the right size is returned as it is."""
    if pos.shape[0] == new_positions:
        return pos
    cls_part = pos[:1] if has_class_token else pos[:0]
    grid_part = pos[1:] if has_class_token else pos
    old_size = int(math.isqrt(grid_part.shape[0]))
    new_size = int(math.isqrt(new_positions - (1 if has_class_token else 0)))
    grid = grid_part.float().reshape(1, old_size, old_size, -1)
    resized = resize_bicubic(grid, (new_size, new_size))
    return torch.cat([cls_part.float(),
                      resized.reshape(new_size * new_size, -1)], dim=0)


def qwen_vit_params_from_torch(state_dict: Mapping[str, Any],
                               cfg: ViTConfig) -> Dict[str, Any]:
    """Qwen-VL ViT-bigG state dict -> the ViT's flax-named tree
    (``merlin_tpu/models/vit.py:277-341``; keys optionally under
    'visual.', 'vision_tower.' or 'model.vision_tower.').

    ``attn.in_proj`` packs q, k and v INTERLEAVED PER HEAD (head n's rows
    are [q_n | k_n | v_n], head_dim each), not as [all q; all k; all v].
    ``positional_embedding`` is a learned (256, width) table, resized once
    here to the config's grid: load with ``pos_embed='learned'``."""
    def key(name):
        for cand in (name, "visual." + name, "vision_tower." + name,
                     "model.vision_tower." + name):
            if cand in state_dict:
                return state_dict[cand].float()
        raise KeyError(name)

    h = cfg.num_heads
    d = cfg.hidden_size // h
    p: Dict[str, Any] = {
        "patch_embed": {"kernel": key("conv1.weight").permute(2, 3, 1, 0)},
        "pre_norm": {"scale": key("ln_pre.weight"),
                     "bias": key("ln_pre.bias")},
    }
    if cfg.pos_embed == "learned":
        p["position_embedding"] = interpolate_pos_embedding(
            key("positional_embedding"), cfg.num_positions,
            cfg.use_class_token)
    for i in range(cfg.num_layers):
        lb = f"transformer.resblocks.{i}."
        w3 = key(lb + "attn.in_proj.weight").reshape(
            h, 3, d, cfg.hidden_size)               # (head, qkv, d, in)
        b3 = key(lb + "attn.in_proj.bias").reshape(h, 3, d)
        p[f"layers_{i}"] = {
            "norm1": {"scale": key(lb + "ln_1.weight"),
                      "bias": key(lb + "ln_1.bias")},
            "norm2": {"scale": key(lb + "ln_2.weight"),
                      "bias": key(lb + "ln_2.bias")},
            "q_proj": {"kernel": w3[:, 0].permute(2, 0, 1),
                       "bias": b3[:, 0]},
            "k_proj": {"kernel": w3[:, 1].permute(2, 0, 1),
                       "bias": b3[:, 1]},
            "v_proj": {"kernel": w3[:, 2].permute(2, 0, 1),
                       "bias": b3[:, 2]},
            "o_proj": {"kernel": _o_kernel(key(lb + "attn.out_proj.weight"),
                                           h, d),
                       "bias": key(lb + "attn.out_proj.bias")},
            "mlp": {"fc1": {"kernel": key(lb + "mlp.c_fc.weight").T,
                            "bias": key(lb + "mlp.c_fc.bias")},
                    "fc2": {"kernel": key(lb + "mlp.c_proj.weight").T,
                            "bias": key(lb + "mlp.c_proj.bias")}},
        }
    return p


def vit_params_from_hf(state_dict: Mapping[str, Any],
                       cfg: ViTConfig) -> Dict[str, Any]:
    """HF ``CLIPVisionModel`` state dict -> the ViT's flax-named tree
    (``merlin_tpu/models/vit.py:344-392``), keys with or without
    'vision_model.', 'model.vision_tower.' or 'vision_tower.vision_model.';
    the position table resized to the config's grid."""
    def key(name):
        for cand in (name, "vision_model." + name,
                     "model.vision_tower." + name,
                     "vision_tower.vision_model." + name):
            if cand in state_dict:
                return state_dict[cand].float()
        raise KeyError(name)

    h = cfg.num_heads
    d = cfg.hidden_size // h
    p: Dict[str, Any] = {
        "class_embedding": key("embeddings.class_embedding").reshape(-1),
        "position_embedding": interpolate_pos_embedding(
            key("embeddings.position_embedding.weight"), cfg.num_positions,
            cfg.use_class_token),
        # torch conv OIHW -> flax HWIO
        "patch_embed": {"kernel": key("embeddings.patch_embedding.weight")
                        .permute(2, 3, 1, 0)},
        "pre_norm": {"scale": key("pre_layrnorm.weight"),
                     "bias": key("pre_layrnorm.bias")},
    }
    for i in range(cfg.num_layers):
        lb = f"encoder.layers.{i}."
        layer = {
            "norm1": {"scale": key(lb + "layer_norm1.weight"),
                      "bias": key(lb + "layer_norm1.bias")},
            "norm2": {"scale": key(lb + "layer_norm2.weight"),
                      "bias": key(lb + "layer_norm2.bias")},
        }
        for name in ("q_proj", "k_proj", "v_proj"):
            layer[name] = {
                "kernel": _qkv_kernel(
                    key(lb + f"self_attn.{name}.weight"), h, d),
                "bias": key(lb + f"self_attn.{name}.bias").reshape(h, d)}
        layer["o_proj"] = {
            "kernel": _o_kernel(key(lb + "self_attn.out_proj.weight"), h, d),
            "bias": key(lb + "self_attn.out_proj.bias")}
        layer["mlp"] = {"fc1": {"kernel": key(lb + "mlp.fc1.weight").T,
                                "bias": key(lb + "mlp.fc1.bias")},
                        "fc2": {"kernel": key(lb + "mlp.fc2.weight").T,
                                "bias": key(lb + "mlp.fc2.bias")}}
        p[f"layers_{i}"] = layer
    return p
