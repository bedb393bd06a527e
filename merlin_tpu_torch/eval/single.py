"""Single-image QA (counterpart of ``merlin_tpu/eval/single.py``; reference
engine/eval/eval.py): one image + question -> answer. Also usable as a
smoke test of the whole decode stack."""

from __future__ import annotations

from typing import Optional, Union

import torch

from merlin_tpu_torch.data.images import load_image
from merlin_tpu_torch.eval.runner import EvalConfig, EvalModel


def run(bundle, image_path: str, question: str,
        eval_cfg: Optional[EvalConfig] = None, *,
        device: Union[str, torch.device] = "cuda") -> str:
    eval_cfg = eval_cfg or EvalConfig(do_sample=True, temperature=1.0,
                                      max_new_tokens=1024)
    model = EvalModel(bundle, eval_cfg, device=device)
    return model.ask(question, [load_image(image_path)])
