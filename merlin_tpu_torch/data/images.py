"""Host-side image loading and resizing (a copy of
``merlin_tpu/data/images.py``).

PIL decodes and geometrically resizes and the result is a uint8 HWC array;
rescale and normalize happen on the device in
:mod:`merlin_tpu_torch.ops.image_ops`.
"""

from __future__ import annotations

import io

import numpy as np

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)


def _pil():
    from PIL import Image, ImageFile
    ImageFile.LOAD_TRUNCATED_IMAGES = True
    return Image


def load_image(path_or_bytes):
    Image = _pil()
    if isinstance(path_or_bytes, (bytes, bytearray)):
        return Image.open(io.BytesIO(path_or_bytes)).convert("RGB")
    return Image.open(path_or_bytes).convert("RGB")


def preprocess_pil(image, image_size: int = 448,
                   aspect_mode: str = "resize") -> np.ndarray:
    """PIL image -> uint8 (S, S, 3) under the aspect modes resize, pad
    (top-left on a mean-colour square, so box coordinates stay valid), keep
    and none (centre crop)."""
    Image = _pil()
    if aspect_mode == "resize":
        image = image.resize((image_size, image_size), Image.BICUBIC)
    elif aspect_mode == "pad":
        w, h = image.size
        side = max(w, h)
        fill = tuple(int(m * 255) for m in CLIP_MEAN)
        canvas = Image.new("RGB", (side, side), fill)
        canvas.paste(image, (0, 0))
        image = canvas.resize((image_size, image_size), Image.BICUBIC)
    elif aspect_mode == "keep":
        w, h = image.size
        aspect = max(w, h) / min(w, h)
        shortest = int(min(image_size * 2 / aspect, image_size))
        scale = shortest / min(w, h)
        image = image.resize((round(w * scale), round(h * scale)),
                             Image.BICUBIC)
    elif aspect_mode == "none":
        w, h = image.size
        scale = image_size / min(w, h)
        image = image.resize((round(w * scale), round(h * scale)),
                             Image.BICUBIC)
        left = (image.size[0] - image_size) // 2
        top = (image.size[1] - image_size) // 2
        image = image.crop((left, top, left + image_size, top + image_size))
    else:
        raise ValueError(f"unknown aspect_mode {aspect_mode!r}")
    return np.asarray(image, np.uint8)


def zero_image(image_size: int) -> np.ndarray:
    """Broken-image fallback."""
    return np.zeros((image_size, image_size, 3), np.uint8)


def load_and_preprocess(path, image_size: int = 448,
                        aspect_mode: str = "resize") -> np.ndarray:
    try:
        return preprocess_pil(load_image(path), image_size, aspect_mode)
    except Exception:
        return zero_image(image_size)
