"""Device-side image preprocessing (counterpart of
``merlin_tpu/ops/image_ops.py``): uint8 NHWC frames -> resized, clipped,
CLIP-normalized float32 model input.

Aspect modes:
  * 'resize' - stretch to (S, S)
  * 'pad'    - expand to square with CLIP-mean fill, top-left paste, resize
  * 'none'   - resize the shortest edge to S, then center crop

The bicubic resize is written out here (trap C1): ``jax.image.resize(...,
"bicubic")`` uses the Keys kernel with a = -0.5 and, when it downscales,
widens the kernel by 1/scale (antialiasing), while
``F.interpolate(mode="bicubic")`` uses a = -0.75 with no antialiasing. The
separable weight matrices below follow JAX's ``compute_weight_mat``, for
the cubic kernel and for the triangle kernel of ``method="linear"`` (SAM's
relative-position tables, antialiased the same way when they shrink).
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def normalize(images: torch.Tensor, mean=CLIP_MEAN,
              std=CLIP_STD) -> torch.Tensor:
    """float [0,1] (or uint8) NHWC images -> normalized float32."""
    if images.dtype == torch.uint8:
        images = images.float() / 255.0
    mean_t = torch.tensor(mean, dtype=torch.float32, device=images.device)
    std_t = torch.tensor(std, dtype=torch.float32, device=images.device)
    return (images.float() - mean_t) / std_t


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys cubic convolution kernel, a = -0.5."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - x.abs(), min=0.0)


def resize_weights(in_size: int, out_size: int, device=None,
                   method: str = "cubic") -> torch.Tensor:
    """(in_size, out_size) f32 weights of a 1-D antialiased resize, cubic
    (Keys) or linear (triangle), as JAX's ``compute_weight_mat`` builds
    them (translation 0)."""
    kernel = {"cubic": _keys_cubic, "linear": _triangle}[method]
    scale = out_size / in_size
    inv_scale = 1.0 / scale
    kernel_scale = max(inv_scale, 1.0)
    sample_f = ((torch.arange(out_size, dtype=torch.float32, device=device)
                 + 0.5) * inv_scale - 0.5)
    x = (sample_f[None, :] - torch.arange(in_size, dtype=torch.float32,
                                          device=device)[:, None]
         ).abs() / kernel_scale
    w = kernel(x)
    total = w.sum(dim=0, keepdim=True)
    eps = 1000.0 * float(np.finfo(np.float32).eps)
    w = torch.where(total.abs() > eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize_bicubic(images: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """Batched antialiased bicubic resize, NHWC, float32 out. Dimensions
    already at their target size are left alone."""
    b, h, w, c = images.shape
    out = images.float()
    if h != size[0]:
        wh = resize_weights(h, size[0], out.device)
        out = torch.einsum("bhwc,hH->bHwc", out, wh)
    if w != size[1]:
        ww = resize_weights(w, size[1], out.device)
        out = torch.einsum("bhwc,wW->bhWc", out, ww)
    return out


def expand2square(images: torch.Tensor, fill=CLIP_MEAN) -> torch.Tensor:
    """Top-left paste into a square canvas filled with ``fill`` (in [0,1]
    units, scaled to 255 for uint8 input)."""
    b, h, w, c = images.shape
    side = max(h, w)
    unit = 255.0 if images.dtype == torch.uint8 else 1.0
    fill_t = torch.tensor(fill, dtype=torch.float32,
                          device=images.device) * unit
    canvas = fill_t.expand(b, side, side, c).clone()
    canvas[:, :h, :w, :] = images.float()
    return canvas


def center_crop(images: torch.Tensor, size: int) -> torch.Tensor:
    b, h, w, c = images.shape
    top = (h - size) // 2
    left = (w - size) // 2
    return images[:, top:top + size, left:left + size, :]


def preprocess_images(images: Union[np.ndarray, torch.Tensor], *,
                      image_size: int = 448, aspect_mode: str = "resize",
                      device: Union[str, torch.device] = "cuda"
                      ) -> torch.Tensor:
    """uint8/float NHWC frames -> normalized f32 (b, S, S, 3) on ``device``.
    A numpy array is copied to ``device``; a tensor stays where it is."""
    if not torch.is_tensor(images):
        images = torch.from_numpy(np.ascontiguousarray(images)).to(device)
    if images.dtype == torch.uint8:
        images = images.float() / 255.0
    if aspect_mode == "resize":
        images = resize_bicubic(images, (image_size, image_size))
    elif aspect_mode == "pad":
        images = expand2square(images)
        images = resize_bicubic(images, (image_size, image_size))
    elif aspect_mode == "none":
        _, h, w, _ = images.shape
        scale = image_size / min(h, w)
        nh, nw = round(h * scale), round(w * scale)
        images = resize_bicubic(images, (nh, nw))
        images = center_crop(images, image_size)
    else:
        raise ValueError(f"unknown aspect_mode {aspect_mode!r}")
    images = images.clamp(0.0, 1.0)
    return normalize(images)
