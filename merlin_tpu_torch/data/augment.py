"""BLIP-style image augmentation (a copy of ``merlin_tpu/data/augment.py``;
reference model/vision_encoder/utils/blip_process.py rebuilt on PIL/numpy).
No path of the port calls it yet.

``RandomAugment(N, M)`` applies N ops sampled from the pool at magnitude M
per image; ``blip_train_transform`` is the BLIP training recipe
(random-resized-crop + hflip + RandAugment); ``blip_eval_transform`` is
resize-only. Used by the SAM/BLIP-processed tower paths.
"""

from __future__ import annotations

import random
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np


def _pil():
    from PIL import Image, ImageEnhance, ImageOps
    return Image, ImageEnhance, ImageOps


# --- individual ops (magnitude m in [0, 10]) --------------------------------

def _identity(img, m):
    return img


def _auto_contrast(img, m):
    _, _, ImageOps = _pil()
    return ImageOps.autocontrast(img)


def _equalize(img, m):
    _, _, ImageOps = _pil()
    return ImageOps.equalize(img)


def _rotate(img, m):
    return img.rotate((m / 10) * 30 * random.choice([-1, 1]))


def _solarize(img, m):
    _, _, ImageOps = _pil()
    return ImageOps.solarize(img, 256 - int((m / 10) * 110))


def _color(img, m):
    _, ImageEnhance, _ = _pil()
    return ImageEnhance.Color(img).enhance(1 + (m / 10) * 0.9
                                           * random.choice([-1, 1]))


def _contrast(img, m):
    _, ImageEnhance, _ = _pil()
    return ImageEnhance.Contrast(img).enhance(1 + (m / 10) * 0.9
                                              * random.choice([-1, 1]))


def _brightness(img, m):
    _, ImageEnhance, _ = _pil()
    return ImageEnhance.Brightness(img).enhance(1 + (m / 10) * 0.9
                                                * random.choice([-1, 1]))


def _sharpness(img, m):
    _, ImageEnhance, _ = _pil()
    return ImageEnhance.Sharpness(img).enhance(1 + (m / 10) * 0.9
                                               * random.choice([-1, 1]))


def _shear_x(img, m):
    Image, _, _ = _pil()
    v = (m / 10) * 0.3 * random.choice([-1, 1])
    return img.transform(img.size, Image.AFFINE, (1, v, 0, 0, 1, 0))


def _shear_y(img, m):
    Image, _, _ = _pil()
    v = (m / 10) * 0.3 * random.choice([-1, 1])
    return img.transform(img.size, Image.AFFINE, (1, 0, 0, v, 1, 0))


def _translate_x(img, m):
    Image, _, _ = _pil()
    v = (m / 10) * 0.3 * img.size[0] * random.choice([-1, 1])
    return img.transform(img.size, Image.AFFINE, (1, 0, v, 0, 1, 0))


def _translate_y(img, m):
    Image, _, _ = _pil()
    v = (m / 10) * 0.3 * img.size[1] * random.choice([-1, 1])
    return img.transform(img.size, Image.AFFINE, (1, 0, 0, 0, 1, v))


AUGMENT_OPS = {
    "Identity": _identity,
    "AutoContrast": _auto_contrast,
    "Equalize": _equalize,
    "Rotate": _rotate,
    "Solarize": _solarize,
    "Color": _color,
    "Contrast": _contrast,
    "Brightness": _brightness,
    "Sharpness": _sharpness,
    "ShearX": _shear_x,
    "ShearY": _shear_y,
    "TranslateX": _translate_x,
    "TranslateY": _translate_y,
}


class RandomAugment:
    def __init__(self, n: int = 2, m: int = 7,
                 ops: Optional[Sequence[str]] = None,
                 rng: Optional[random.Random] = None):
        self.n = n
        self.m = m
        self.ops = list(ops or AUGMENT_OPS)
        self.rng = rng or random

    def __call__(self, img):
        for name in self.rng.choices(self.ops, k=self.n):
            img = AUGMENT_OPS[name](img, self.m)
        return img


def blip_train_transform(image, image_size: int = 224,
                         min_scale: float = 0.5,
                         rng: Optional[random.Random] = None) -> np.ndarray:
    """Random-resized-crop + hflip + RandAugment -> uint8 (S, S, 3)."""
    Image, _, _ = _pil()
    rng = rng or random
    w, h = image.size
    scale = rng.uniform(min_scale, 1.0)
    area = w * h * scale
    side = int(np.sqrt(area))
    side = max(1, min(side, w, h))
    left = rng.randint(0, w - side)
    top = rng.randint(0, h - side)
    image = image.crop((left, top, left + side, top + side))
    image = image.resize((image_size, image_size), Image.BICUBIC)
    if rng.random() < 0.5:
        image = image.transpose(Image.FLIP_LEFT_RIGHT)
    image = RandomAugment(2, 7, ops=[
        "Identity", "AutoContrast", "Brightness", "Sharpness", "Equalize",
        "ShearX", "ShearY", "TranslateX", "TranslateY", "Rotate",
    ], rng=rng if isinstance(rng, random.Random) else None)(image)
    return np.asarray(image.convert("RGB"), np.uint8)


def blip_eval_transform(image, image_size: int = 224) -> np.ndarray:
    Image, _, _ = _pil()
    image = image.resize((image_size, image_size), Image.BICUBIC)
    return np.asarray(image.convert("RGB"), np.uint8)
