"""Vision tower factory (counterpart of
``merlin_tpu/models/vision_builder.py``): name-substring dispatch, 'qwen',
'sam' and 'metaclip' before the default CLIP.

  * clip     - ViT-L/14 at the data's image size, hidden_states[-2], CLS
               dropped (the Merlin default);
  * metaclip - ViT-H/14, selected like CLIP;
  * qwen     - Qwen-VL ViT-bigG, its last hidden state whole (no CLS);
  * sam      - the SAM ViT-B encoder at its native 1024 px.
"""

from __future__ import annotations

from typing import Union

import torch
from torch import nn

from merlin_tpu_torch.models.sam_vit import SAMImageEncoder, SAMViTConfig
from merlin_tpu_torch.models.vit import (
    CLIPVisionTower, ViTConfig, clip_vit_l14, metaclip_vit_h14, qwen_vit_bigG)


def vision_kind_from_name(name: str) -> str:
    low = (name or "clip").lower()
    if "qwen" in low:
        return "qwen"
    if "sam" in low:
        return "sam"
    if "metaclip" in low:
        return "metaclip"
    return "clip"


def default_vision_config(kind: str, image_size: int,
                          dtype: torch.dtype = torch.bfloat16
                          ) -> Union[ViTConfig, SAMViTConfig]:
    if kind == "sam":
        return SAMViTConfig(dtype=dtype)  # SAM runs at its native 1024
    if kind == "qwen":
        return qwen_vit_bigG(image_size, dtype=dtype)
    if kind == "metaclip":
        return metaclip_vit_h14(image_size, dtype=dtype)
    return clip_vit_l14(image_size, dtype=dtype)


def build_vision_tower(kind: str, cfg, *, select_layer: int = -2,
                       select_feature: str = "patch") -> nn.Module:
    if kind == "sam":
        if not isinstance(cfg, SAMViTConfig):
            raise TypeError(f"the sam tower needs a SAMViTConfig, not {cfg}")
        return SAMImageEncoder(cfg)
    if not isinstance(cfg, ViTConfig):
        raise TypeError(f"the {kind} tower needs a ViTConfig, not {cfg}")
    if kind == "qwen":
        # the Qwen tower: last hidden state, no CLS to drop
        return CLIPVisionTower(cfg, select_layer=-1,
                               select_feature="cls_patch")
    return CLIPVisionTower(cfg, select_layer=select_layer,
                           select_feature=select_feature)
