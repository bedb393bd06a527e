"""MM-Vet harness (counterpart of ``merlin_tpu/eval/mmvet.py``; reference
engine/eval/eval_mmvet.py): JSON question set -> generate ->
``{question_id: answer}`` JSON for external GPT-4 grading."""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Union

import torch

from merlin_tpu_torch.data.images import load_image
from merlin_tpu_torch.eval.runner import EvalConfig, EvalModel


def run(bundle, eval_file: str, image_dir: str, output_path: str,
        eval_cfg: Optional[EvalConfig] = None, *, limit: int = 0,
        device: Union[str, torch.device] = "cuda") -> Dict:
    eval_cfg = eval_cfg or EvalConfig(max_new_tokens=1024)
    model = EvalModel(bundle, eval_cfg, device=device)
    with open(eval_file) as f:
        questions = json.load(f)

    items = list(questions.items())
    if limit:
        items = items[:limit]
    answers: Dict[str, str] = {}
    for key, item in items:
        image = load_image(os.path.join(image_dir, item["imagename"]))
        answers[key] = model.ask(item["question"], [image])

    os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
    with open(output_path, "w") as f:
        json.dump(answers, f, indent=1, ensure_ascii=False)
    return answers
