"""Box / tracking interactive eval (counterpart of
``merlin_tpu/eval/box_eval.py``; reference engine/eval/eval_box.py):
multi-image prompt assembly, box extraction from generated text, and
PIL-based box drawing (replacing torchvision draw_bounding_boxes).

Golden prompt patterns (eval_box.py:278-284):
  detection: 'Detect <category> in <image>.'
  tracking:  'Given image0<image> and image1<image>, track
              image0:<Id1>[x, y, x, y]</Id1> in image1.'

The drawn image goes to the temporary directory (``TMPDIR``), where the
JAX package writes ``/tmp``.
"""

from __future__ import annotations

import os
import tempfile
from typing import Optional, Sequence, Tuple, Union

import torch

from merlin_tpu_torch.data.box import de_norm_box_xyxy, extract_boxes
from merlin_tpu_torch.eval.runner import EvalConfig, EvalModel

COLORS = ["#ed7d31", "#5b9bd5", "#70ad47", "#7030a0", "#c00000",
          "#ffff00", "olive", "brown", "cyan"]

GOLDEN_CASES = [
    "Detect broccoli in <image>.",
    "What is the woman doing in <image>?",
    "Given image0<image> and image1<image>, track "
    "image0:<Id1>[100, 100, 300, 300]</Id1> in image1.",
]


def draw_boxes(image, boxes_norm1000: Sequence[Sequence[float]],
               labels: Optional[Sequence[str]] = None, width: int = 8):
    """Draw 0-1000-space boxes on a PIL image (eval_box.py:100-116)."""
    from PIL import ImageDraw

    image = image.copy()
    drawer = ImageDraw.Draw(image)
    for idx, box in enumerate(boxes_norm1000):
        color = COLORS[idx % len(COLORS)]
        xyxy = de_norm_box_xyxy([c / 1000 for c in box],
                                w=image.width, h=image.height)
        drawer.rectangle(xyxy, outline=color, width=width)
        if labels and idx < len(labels):
            drawer.text((xyxy[0], max(xyxy[1] - 12, 0)), labels[idx],
                        fill=color)
    return image


def postprocess(text: str, image=None) -> Tuple[str, Optional[object]]:
    """Extract predicted boxes from text; draw them on the image
    (eval_box.py:55-130)."""
    if image is None:
        return text, None
    groups = extract_boxes(text)
    flat = [box for group in groups for box in group]
    if not flat:
        return text, None
    return text, draw_boxes(image, flat)


def run_repl(bundle, eval_cfg: Optional[EvalConfig] = None,
             input_fn=input, print_fn=print, *,
             device: Union[str, torch.device] = "cuda"):
    """Interactive loop: 'image_path[,image_path2] ; query'."""
    from merlin_tpu_torch.data.images import load_image

    model = EvalModel(bundle, eval_cfg or EvalConfig(temperature=0.2,
                                                     do_sample=True),
                      device=device)
    while True:
        try:
            line = input_fn("images;query> ").strip()
        except (EOFError, KeyboardInterrupt):
            return
        if not line or line in ("quit", "exit"):
            return
        paths, _, query = line.partition(";")
        images = [load_image(p.strip()) for p in paths.split(",") if p.strip()]
        answer = model.ask(query.strip(), images)
        text, drawn = postprocess(answer, images[0] if images else None)
        print_fn(text)
        if drawn is not None:
            out = os.path.join(tempfile.gettempdir(), "merlin_box_vis.png")
            drawn.save(out)
            print_fn(f"[boxes drawn -> {out}]")
