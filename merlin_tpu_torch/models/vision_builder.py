"""Vision tower factory (counterpart of
``merlin_tpu/models/vision_builder.py``). Only the CLIP kind is ported; the
Qwen, SAM and MetaCLIP towers come with a later slice."""

from __future__ import annotations

from merlin_tpu_torch.models.vit import CLIPVisionTower, ViTConfig


def build_vision_tower(kind: str, cfg: ViTConfig, *, select_layer: int = -2,
                       select_feature: str = "patch") -> CLIPVisionTower:
    if kind != "clip":
        raise NotImplementedError(f"vision kind {kind!r} is not ported yet")
    return CLIPVisionTower(cfg, select_layer=select_layer,
                           select_feature=select_feature)
