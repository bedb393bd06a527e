"""MMGPT: vision tower -> projector -> causal LM (counterpart of
``merlin_tpu/models/mmgpt.py``).

Image features are spliced into the token embeddings with one vectorized
gather: the k-th ``<im_patch>`` position of row i takes feature k of row i.

Batching contract: ``images`` is (b, max_images, H, W, C); rows with fewer
images pad with zero images, which are encoded but never gathered because
they have no ``<im_patch>`` tokens. With ``labels`` the forward also
returns the training loss, labels shifted left by one as in
``merlin_tpu/models/mmgpt.py:131-139``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
from torch import nn

from merlin_tpu_torch.models.decoder import (
    CausalLM, DecoderConfig, cross_entropy_loss)
from merlin_tpu_torch.models.projectors import build_projector
from merlin_tpu_torch.models.vision_builder import build_vision_tower
from merlin_tpu_torch.utils.constants import IGNORE_INDEX


@dataclasses.dataclass(frozen=True)
class MMGPTConfig:
    lm: DecoderConfig
    vit: Any  # ViTConfig or SAMViTConfig, per vision_kind
    projector: str = "conv"
    conv_stride: int = 2
    vision_kind: str = "clip"
    select_layer: int = -2
    select_feature: str = "patch"
    use_im_start_end: bool = True
    image_patch_id: int = -1
    im_start_id: int = -1
    im_end_id: int = -1

    @property
    def vision_grid(self) -> int:
        return getattr(self.vit, "grid_size", None) or self.vit.grid

    @property
    def vision_width(self) -> int:
        """The tower's output channels: its width, or SAM's neck."""
        return getattr(self.vit, "hidden_size", None) or self.vit.out_chans

    @property
    def image_token_len(self) -> int:
        """Tokens per image after projection: the conv's grid, the
        resampler's 256 queries, SAM's two stride-2 convs, else one token
        a patch."""
        if self.projector == "conv":
            side = self.vision_grid // self.conv_stride
            return side * side
        if self.projector in ("qwen_sampler", "resampler"):
            return 256
        if self.projector == "sam":
            return (self.vision_grid // 4) ** 2
        return self.vision_grid ** 2


def splice_image_embeds(token_embeds: torch.Tensor, patch_mask: torch.Tensor,
                        image_feats: torch.Tensor) -> torch.Tensor:
    """token_embeds (b, s, d); patch_mask (b, s) bool; image_feats
    (b, n_feats, d) in image order. The k-th True position of row i gets
    image_feats[i, k]."""
    idx = torch.cumsum(patch_mask.to(torch.int32), dim=1) - 1
    idx = idx.clamp(0, image_feats.shape[1] - 1).long()
    gathered = torch.gather(
        image_feats, 1, idx[..., None].expand(-1, -1, image_feats.shape[2]))
    return torch.where(patch_mask[..., None],
                       gathered.to(token_embeds.dtype), token_embeds)


class MMGPT(nn.Module):
    """Vision tower + projector + causal LM with embedding-level splice."""

    def __init__(self, cfg: MMGPTConfig):
        super().__init__()
        self.cfg = cfg
        self.vision_tower = build_vision_tower(
            cfg.vision_kind, cfg.vit, select_layer=cfg.select_layer,
            select_feature=cfg.select_feature)
        # the resampler kinds attend at the VISION width, and only their
        # final proj maps to the LM width (merlin_tpu/models/mmgpt.py:96-104)
        embed_dim = (getattr(cfg.vit, "hidden_size", None)
                     if cfg.projector in ("qwen_sampler", "resampler")
                     else None)
        self.projector = build_projector(
            cfg.projector, cfg.vision_width, cfg.lm.hidden_size,
            conv_stride=cfg.conv_stride, dtype=cfg.lm.dtype,
            embed_dim=embed_dim)
        self.lm = CausalLM(cfg.lm)

    def encode_images(self, images: torch.Tensor) -> torch.Tensor:
        """(n, H, W, C) pixel values -> (n, image_token_len, d_lm)."""
        return self.projector(self.vision_tower(images))

    def forward(self, input_ids, *, images: Optional[torch.Tensor] = None,
                positions=None, segment_ids=None, kv_cache=None,
                labels: Optional[torch.Tensor] = None):
        """images: (b, n_img, H, W, C) or None (text-only / decode step).
        Returns (logits, new_kv_cache), and the loss third when ``labels``
        (b, s) are given."""
        embeds = self.lm.embed(input_ids)
        if images is not None:
            b, n = images.shape[:2]
            feats = self.encode_images(images.reshape((b * n,) + images.shape[2:]))
            feats = feats.reshape(b, n * feats.shape[1], feats.shape[2])
            patch_mask = input_ids == self.cfg.image_patch_id
            embeds = splice_image_embeds(embeds, patch_mask, feats)
        logits, new_cache = self.lm(inputs_embeds=embeds, positions=positions,
                                    segment_ids=segment_ids, kv_cache=kv_cache)
        if labels is None:
            return logits, new_cache
        shifted = torch.cat([labels[:, 1:], torch.full_like(
            labels[:, :1], IGNORE_INDEX)], dim=1)
        loss, _ = cross_entropy_loss(logits, shifted,
                                     ignore_index=IGNORE_INDEX,
                                     z_loss_weight=self.cfg.lm.z_loss_weight)
        return logits, new_cache, loss
