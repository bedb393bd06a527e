"""SAM ViTDet image encoder (counterpart of ``merlin_tpu/models/sam_vit.py``).

ViT-B geometry: 1024 px / patch 16 -> 64x64 tokens, 12 layers, window-14
attention with global attention at layers (2, 5, 8, 11), decomposed
relative position embeddings, and a conv neck to 256 channels. The output
is (b, 4096, 256); the SAM projector then takes it down to 256 LM tokens.

The attention is computed here with einsums and a float32 softmax, as the
JAX package computes it outside any Pallas kernel: no kernel is owed.
Relative-position tables of another length than a block needs are resized
with JAX's antialiased linear resize (``image_ops.resize_weights``,
``method="linear"``) and indexed at coordinates truncated toward zero, as
``astype(int32)`` truncates them. The W relative bias is broadcast as
JAX broadcasts it (trap C28, see :func:`add_decomposed_rel_pos`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from merlin_tpu_torch.core.partitioning import set_param_axes
from merlin_tpu_torch.models.layers import (
    DenseGeneral, LayerNorm, MatmulF32, SimpleMLP, normal_param)
from merlin_tpu_torch.models.projectors import StridedConv
from merlin_tpu_torch.models.vit import PatchEmbed
from merlin_tpu_torch.ops.image_ops import resize_weights


@dataclasses.dataclass(frozen=True)
class SAMViTConfig:
    img_size: int = 1024
    patch_size: int = 16
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    out_chans: int = 256
    window_size: int = 14
    global_attn_indexes: Tuple[int, ...] = (2, 5, 8, 11)
    use_rel_pos: bool = True
    layer_norm_eps: float = 1e-6
    dtype: Any = torch.bfloat16

    @property
    def grid(self) -> int:
        return self.img_size // self.patch_size


def tiny_sam(**kw) -> SAMViTConfig:
    defaults = dict(img_size=32, patch_size=4, embed_dim=16, depth=2,
                    num_heads=2, out_chans=8, window_size=4,
                    global_attn_indexes=(1,), dtype=torch.float32)
    defaults.update(kw)
    return SAMViTConfig(**defaults)


def window_partition(x: torch.Tensor, window: int):
    """(b, H, W, C) -> (b * nw, win, win, C), zero-padded to whole windows;
    also returns the padded (H, W)."""
    b, h, w, c = x.shape
    pad_h = (-h) % window
    pad_w = (-w) % window
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    hp, wp = h + pad_h, w + pad_w
    x = x.reshape(b, hp // window, window, wp // window, window, c)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window, window, c)
    return x, (hp, wp)


def window_unpartition(x: torch.Tensor, window: int, pad_hw, hw):
    hp, wp = pad_hw
    h, w = hw
    b = x.shape[0] // ((hp // window) * (wp // window))
    x = x.reshape(b, hp // window, wp // window, window, window, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, -1)
    return x[:, :h, :w]


def get_rel_pos(q_size: int, k_size: int,
                rel_pos: torch.Tensor) -> torch.Tensor:
    """The (q_size, k_size, C) slice of a relative-position table, the
    table first resized (linear, antialiased when it shrinks) to
    2 * max(q_size, k_size) - 1 rows when it has another length."""
    max_rel_dist = 2 * max(q_size, k_size) - 1
    if rel_pos.shape[0] != max_rel_dist:
        w = resize_weights(rel_pos.shape[0], max_rel_dist, rel_pos.device,
                           method="linear")
        rel_pos = torch.einsum("ic,io->oc", rel_pos.float(), w)
    dev = rel_pos.device
    q_coords = torch.arange(q_size, device=dev)[:, None] \
        * max(k_size / q_size, 1.0)
    k_coords = torch.arange(k_size, device=dev)[None, :] \
        * max(q_size / k_size, 1.0)
    rel = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    # float32 coordinates truncated toward zero, as astype(int32)
    return rel_pos[rel.float().to(torch.int64)]


def add_decomposed_rel_pos(attn, q, rel_h, rel_w, q_hw, k_hw):
    """attn (b, qh*qw, kh*kw) += the decomposed H and W relative biases."""
    qh, qw = q_hw
    kh, kw = k_hw
    rh = get_rel_pos(qh, kh, rel_h)   # (qh, kh, d)
    rw = get_rel_pos(qw, kw, rel_w)   # (qw, kw, d)
    b = q.shape[0]
    rq = q.reshape(b, qh, qw, -1)
    bias_h = torch.einsum("bhwc,hkc->bhwk", rq, rh.float())
    bias_w = torch.einsum("bhwc,wkc->bhwk", rq, rw.float())
    attn = attn.reshape(b, qh, qw, kh, kw)
    # bias_w[:, :, None, :] is (b, qh, 1, qw, kw), as in JAX
    # (sam_vit.py:99): the W bias is read at the key's row instead of the
    # query's column (trap C28). It agrees with SAM only while rel_pos_w
    # is 0, as HF initializes it; the port keeps JAX's broadcast.
    attn = attn + bias_h[:, :, :, :, None] + bias_w[:, :, None, :]
    return attn.reshape(b, qh * qw, kh * kw)


class SAMAttention(nn.Module):
    def __init__(self, cfg: SAMViTConfig, input_size: Tuple[int, int]):
        super().__init__()
        e, nh = cfg.embed_dim, cfg.num_heads
        d = e // nh
        self.cfg = cfg
        self.qkv = DenseGeneral(e, (3, nh, d), use_bias=True, dtype=cfg.dtype,
                                kernel_axes=("vit_embed", None, "vit_heads",
                                             "kv"))
        if cfg.use_rel_pos:
            self.rel_pos_h = nn.Parameter(torch.zeros(2 * input_size[0] - 1,
                                                      d))
            self.rel_pos_w = nn.Parameter(torch.zeros(2 * input_size[1] - 1,
                                                      d))
        self.proj = DenseGeneral(e, e, use_bias=True, dtype=cfg.dtype,
                                 kernel_axes=("vit_embed", "vit_embed"))
        set_param_axes(self, rel_pos_h=("vit_patches", "kv"),
                       rel_pos_w=("vit_patches", "kv"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        b, h, w, _ = x.shape
        nh = cfg.num_heads
        d = cfg.embed_dim // nh
        qkv = self.qkv(x).reshape(b, h * w, 3, nh, d).permute(2, 0, 3, 1, 4)
        q, k, v = (t.reshape(b * nh, h * w, d) for t in qkv)
        # operands in the compute dtype, f32 products and sums
        attn = torch.einsum("bqd,bkd->bqk", (q * d ** -0.5).float(),
                            k.float())
        if cfg.use_rel_pos:
            attn = add_decomposed_rel_pos(attn, q.float(), self.rel_pos_h,
                                          self.rel_pos_w, (h, w), (h, w))
        attn = torch.softmax(attn.float(), dim=-1)
        out = torch.einsum("bqk,bkd->bqd", attn.to(v.dtype).float(),
                           v.float())
        out = out.reshape(b, nh, h * w, d).permute(0, 2, 1, 3)
        out = out.reshape(b, h, w, nh * d).to(cfg.dtype)
        return self.proj(out)


def _flax_layer_norm(dim: int, eps: float) -> LayerNorm:
    """A LayerNorm with no logical axes: the JAX tower uses flax's own
    ``nn.LayerNorm`` here, whose parameters carry none (replicated)."""
    norm = LayerNorm(dim, eps=eps)
    norm.param_axes = {}
    return norm


class SAMBlock(nn.Module):
    def __init__(self, cfg: SAMViTConfig, window_size: int):
        super().__init__()
        self.window_size = window_size
        self.norm1 = _flax_layer_norm(cfg.embed_dim, cfg.layer_norm_eps)
        size = (window_size, window_size) if window_size > 0 \
            else (cfg.grid, cfg.grid)
        self.attn = SAMAttention(cfg, input_size=size)
        self.norm2 = _flax_layer_norm(cfg.embed_dim, cfg.layer_norm_eps)
        self.mlp = SimpleMLP(cfg.embed_dim, int(cfg.embed_dim * cfg.mlp_ratio),
                             activation="gelu", dtype=cfg.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x
        x = self.norm1(x)
        if self.window_size > 0:
            hw = (x.shape[1], x.shape[2])
            x, pad_hw = window_partition(x, self.window_size)
        x = self.attn(x)
        if self.window_size > 0:
            x = window_unpartition(x, self.window_size, pad_hw, hw)
        x = shortcut + x
        return x + self.mlp(self.norm2(x))


class PointwiseConv(nn.Module):
    """1x1 conv without bias over NHWC, ``kernel`` HWIO (1, 1, cin, cout):
    one matmul, rounded once to the compute dtype."""

    def __init__(self, cin: int, cout: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.kernel = normal_param((1, 1, cin, cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        out = MatmulF32.apply(x.to(self.dtype).reshape(-1, c),
                              self.kernel.to(self.dtype).reshape(c, -1))
        return out.to(self.dtype).reshape(b, h, w, -1)


class SAMImageEncoder(nn.Module):
    """NHWC pixels -> (b, grid * grid, out_chans) neck features. The
    blocks' norms use ``cfg.layer_norm_eps``, the neck's 1e-6."""

    def __init__(self, cfg: SAMViTConfig):
        super().__init__()
        self.cfg = cfg
        e = cfg.embed_dim
        self.patch_embed = PatchEmbed(e, cfg.patch_size, 3, use_bias=True,
                                      dtype=cfg.dtype)
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.grid, cfg.grid, e))
        set_param_axes(self, pos_embed=(None, "vit_patches", "vit_patches",
                                        "vit_embed"))
        for i in range(cfg.depth):
            win = 0 if i in cfg.global_attn_indexes else cfg.window_size
            self.add_module(f"blocks_{i}", SAMBlock(cfg, window_size=win))
        # neck: 1x1 conv -> LN -> 3x3 conv -> LN (channels-last LN == LN2d)
        self.neck_conv1 = PointwiseConv(e, cfg.out_chans, dtype=cfg.dtype)
        self.neck_ln1 = _flax_layer_norm(cfg.out_chans, 1e-6)
        self.neck_conv2 = StridedConv(cfg.out_chans, cfg.out_chans,
                                      kernel_size=(3, 3), stride=1,
                                      padding=1, use_bias=False,
                                      dtype=cfg.dtype)
        self.neck_ln2 = _flax_layer_norm(cfg.out_chans, 1e-6)

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        x = self.patch_embed(pixel_values)
        x = x + self.pos_embed.to(cfg.dtype)
        for i in range(cfg.depth):
            x = getattr(self, f"blocks_{i}")(x)
        x = self.neck_ln2(self.neck_conv2(self.neck_ln1(self.neck_conv1(x))))
        return x.reshape(x.shape[0], -1, cfg.out_chans)


def sam_params_from_torch(state_dict: Mapping[str, Any],
                          cfg: SAMViTConfig) -> Dict[str, Any]:
    """SAM's official ``image_encoder`` state dict (keys optionally under
    'image_encoder.') -> the encoder's flax-named tree
    (``merlin_tpu/models/sam_vit.py:207-255``)."""
    def key(name):
        for cand in (name, "image_encoder." + name):
            if cand in state_dict:
                return state_dict[cand].float()
        raise KeyError(name)

    nh = cfg.num_heads
    d = cfg.embed_dim // nh
    hwio = (2, 3, 1, 0)          # torch conv OIHW -> flax HWIO
    p: Dict[str, Any] = {
        "patch_embed": {"kernel": key("patch_embed.proj.weight")
                        .permute(*hwio),
                        "bias": key("patch_embed.proj.bias")},
        "pos_embed": key("pos_embed"),
        "neck_conv1": {"kernel": key("neck.0.weight").permute(*hwio)},
        "neck_ln1": {"scale": key("neck.1.weight"),
                     "bias": key("neck.1.bias")},
        "neck_conv2": {"kernel": key("neck.2.weight").permute(*hwio)},
        "neck_ln2": {"scale": key("neck.3.weight"),
                     "bias": key("neck.3.bias")},
    }
    for i in range(cfg.depth):
        lb = f"blocks.{i}."
        blk = {
            "norm1": {"scale": key(lb + "norm1.weight"),
                      "bias": key(lb + "norm1.bias")},
            "norm2": {"scale": key(lb + "norm2.weight"),
                      "bias": key(lb + "norm2.bias")},
            "attn": {
                "qkv": {"kernel": key(lb + "attn.qkv.weight").T.reshape(
                            cfg.embed_dim, 3, nh, d),
                        "bias": key(lb + "attn.qkv.bias").reshape(3, nh, d)},
                "proj": {"kernel": key(lb + "attn.proj.weight").T,
                         "bias": key(lb + "attn.proj.bias")},
            },
            "mlp": {"fc1": {"kernel": key(lb + "mlp.lin1.weight").T,
                            "bias": key(lb + "mlp.lin1.bias")},
                    "fc2": {"kernel": key(lb + "mlp.lin2.weight").T,
                            "bias": key(lb + "mlp.lin2.bias")}},
        }
        if cfg.use_rel_pos:
            blk["attn"]["rel_pos_h"] = key(lb + "attn.rel_pos_h")
            blk["attn"]["rel_pos_w"] = key(lb + "attn.rel_pos_w")
        p[f"blocks_{i}"] = blk
    return p
