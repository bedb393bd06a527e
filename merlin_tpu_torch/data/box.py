"""Bounding-box normalization, serialization and parsing (a copy of
``merlin_tpu/data/box.py``).

Host-side (numpy) data-path code. Behavioral parity with the reference:

* ``serialize_boxes`` — reference ``base_dataset.py:142-176`` (box_processor):
  xywh->xyxy conversion (or pixel-denorm for OpenImages-style normalized
  input), clamping, normalization by pad-square or exact-resize geometry,
  then text serialization as ``[xxx, yyy, xxx, yyy]`` with 0-1000 ints.
* ``shuffle_and_sample_boxes`` — reference ``base_dataset.py:77-100``.
* ``extract_boxes`` / ``de_norm_box_xyxy`` — reference ``eval_box.py:55-130``
  (regex parse of generated box text, /1000 denorm back to pixels).
"""

from __future__ import annotations

import random
import re
from typing import List, Optional, Sequence, Tuple

import numpy as np

BOX_PATTERN = re.compile(
    r"\[\d*(?:\.\d*)?(?:,\d*(?:\.\d*)?){3}(?:;\d*(?:\.\d*)?(?:,\d*(?:\.\d*)?){3})*\]"
)
ID_PATTERN = re.compile(r"\<Id(\d+)\>")


def serialize_box(box: Sequence[float]) -> str:
    """One normalized [0,1] xyxy box -> ``[xxx, yyy, xxx, yyy]`` (ints*1000)."""
    return "[{:03d}, {:03d}, {:03d}, {:03d}]".format(
        int(box[0] * 1000), int(box[1] * 1000), int(box[2] * 1000), int(box[3] * 1000)
    )


def serialize_boxes(
    boxes_list: Sequence[np.ndarray],
    image_wh_list: Sequence[Tuple[int, int]],
    image_path: str = "",
    image_aspect_ratio: str = "resize",
) -> List[str]:
    """Convert per-image box arrays to serialized box text.

    Args:
      boxes_list: one (N_i, 4) float array per image. xywh pixel coords,
        except OpenImages-style paths which carry normalized xyxy.
      image_wh_list: matching (width, height) per image.
      image_path: used only for the OpenImages special case.
      image_aspect_ratio: 'pad' (normalize by the padded square edge,
        matching expand2square top-left paste) or 'resize' (normalize by
        the original W/H since the image is stretched to a square).
    """
    assert len(boxes_list) == len(image_wh_list)
    if image_aspect_ratio not in ("pad", "resize"):
        raise ValueError(f"unsupported image_aspect_ratio: {image_aspect_ratio}")

    texts: List[str] = []
    for boxes, (im_w, im_h) in zip(boxes_list, image_wh_list):
        boxes = np.asarray(boxes, dtype=np.float32).copy()
        if boxes.ndim == 1:
            boxes = boxes[None, :]
        if "OpenImages" in image_path:
            # normalized xyxy -> pixel xyxy
            boxes[:, 0::2] *= im_w
            boxes[:, 1::2] *= im_h
        else:
            # xywh -> xyxy
            boxes[:, 2:] += boxes[:, :2]
        boxes[:, 0::2] = np.clip(boxes[:, 0::2], 0, im_w)
        boxes[:, 1::2] = np.clip(boxes[:, 1::2], 0, im_h)

        if image_aspect_ratio == "pad":
            scale = float(max(im_w, im_h))
            boxes /= scale
        else:  # resize
            boxes /= np.array([im_w, im_h, im_w, im_h], dtype=np.float32)

        texts.extend(serialize_box(b) for b in boxes)
    return texts


def shuffle_and_sample_boxes(
    boxes: List, box_limit: int, rng: Optional[random.Random] = None
) -> List:
    """Clamp the number of boxes per sample to ``box_limit``.

    Random subsample (without replacement) when over the limit; pass-through
    otherwise. Reference ``base_dataset.py:77-100``.
    """
    if box_limit <= 0 or len(boxes) <= box_limit:
        return list(boxes)
    rng = rng or random
    return rng.sample(list(boxes), box_limit)


def extract_boxes(text: str) -> List[List[List[float]]]:
    """Parse serialized box groups out of generated text.

    Returns a list of groups; each ``[a,b,c,d;e,f,g,h]`` group is a list of
    4-float boxes (still in the 0-1000 integer coordinate space).
    """
    groups: List[List[List[float]]] = []
    compact = text.replace(" ", "")
    for group_str in BOX_PATTERN.findall(compact):
        boxes = []
        inner = group_str.replace("(", "").replace(")", "").replace("[", "").replace("]", "")
        for box_str in inner.split(";"):
            parts = box_str.split(",")
            if len(parts) == 4:
                try:
                    boxes.append([float(p) for p in parts])
                except ValueError:
                    continue
        if boxes:
            groups.append(boxes)
    return groups


def extract_ids(text: str) -> List[int]:
    """Parse ``<IdN>`` object-id markers out of generated text."""
    return [int(m) for m in ID_PATTERN.findall(text.replace(" ", ""))]


def de_norm_box_xyxy(box: Sequence[float], w: int, h: int) -> Tuple[float, float, float, float]:
    """Normalized [0,1] xyxy -> pixel xyxy, clamped to the image."""
    x1, y1, x2, y2 = box
    x1 = max(0.0, min(float(x1) * w, w))
    x2 = max(0.0, min(float(x2) * w, w))
    y1 = max(0.0, min(float(y1) * h, h))
    y2 = max(0.0, min(float(y2) * h, h))
    return (x1, y1, x2, y2)


def norm_box_xyxy(box: Sequence[float], w: int, h: int) -> Tuple[float, float, float, float]:
    """Pixel xyxy -> normalized [0,1] xyxy, clamped."""
    x1, y1, x2, y2 = box
    return (
        max(0.0, min(float(x1) / w, 1.0)),
        max(0.0, min(float(y1) / h, 1.0)),
        max(0.0, min(float(x2) / w, 1.0)),
        max(0.0, min(float(y2) / h, 1.0)),
    )


def box_iou_xyxy(a: Sequence[float], b: Sequence[float]) -> float:
    """IoU of two xyxy boxes (used by the tracking evaluator)."""
    ax1, ay1, ax2, ay2 = a
    bx1, by1, bx2, by2 = b
    iw = max(0.0, min(ax2, bx2) - max(ax1, bx1))
    ih = max(0.0, min(ay2, by2) - max(ay1, by1))
    inter = iw * ih
    union = (ax2 - ax1) * (ay2 - ay1) + (bx2 - bx1) * (by2 - by1) - inter
    return inter / union if union > 0 else 0.0
