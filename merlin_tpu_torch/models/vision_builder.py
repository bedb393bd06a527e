"""Vision tower factory (counterpart of
``merlin_tpu/models/vision_builder.py``): name-substring dispatch, 'qwen',
'sam' and 'metaclip' before the default CLIP. Only the CLIP kind is
ported; the Qwen, SAM and MetaCLIP towers come with a later slice."""

from __future__ import annotations

import torch

from merlin_tpu_torch.models.vit import CLIPVisionTower, ViTConfig, clip_vit_l14


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
                          dtype: torch.dtype = torch.bfloat16) -> ViTConfig:
    if kind != "clip":
        raise NotImplementedError(f"vision kind {kind!r} is not ported yet")
    return clip_vit_l14(image_size, dtype=dtype)


def build_vision_tower(kind: str, cfg: ViTConfig, *, select_layer: int = -2,
                       select_feature: str = "patch") -> CLIPVisionTower:
    if kind != "clip":
        raise NotImplementedError(f"vision kind {kind!r} is not ported yet")
    return CLIPVisionTower(cfg, select_layer=select_layer,
                           select_feature=select_feature)
