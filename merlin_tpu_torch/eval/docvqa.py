"""DocVQA harness (counterpart of ``merlin_tpu/eval/docvqa.py``; reference
engine/eval/eval_docvqa.py): JSON QA list -> generate -> ANLS scoring."""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Union

import torch

from merlin_tpu_torch.data.images import load_image
from merlin_tpu_torch.eval.evaluators.vqa_anls import VQAEval
from merlin_tpu_torch.eval.runner import EvalConfig, EvalModel


def run(bundle, eval_file: str, image_dir: str, output_path: str,
        eval_cfg: Optional[EvalConfig] = None, *, limit: int = 0,
        datatype: str = "DocVQA",
        device: Union[str, torch.device] = "cuda") -> Dict:
    eval_cfg = eval_cfg or EvalConfig(max_new_tokens=128)
    model = EvalModel(bundle, eval_cfg, device=device)
    with open(eval_file) as f:
        data = json.load(f)
    if isinstance(data, dict) and "data" in data:
        data = data["data"]
    if limit:
        data = data[:limit]

    predictions: Dict[str, str] = {}
    gts: Dict[str, list] = {}
    for item in data:
        qid = str(item.get("questionId", item.get("question_id")))
        image = load_image(os.path.join(image_dir, item["image"]))
        predictions[qid] = model.ask(item["question"], [image])
        if "answers" in item:
            gts[qid] = item["answers"]

    os.makedirs(os.path.dirname(output_path) or ".", exist_ok=True)
    with open(output_path, "w") as f:
        json.dump(predictions, f, indent=1, ensure_ascii=False)

    if not gts:
        return {"predictions": output_path}
    scores = VQAEval(datatype).score(predictions, gts)
    with open(output_path.replace(".json", "_scores.json"), "w") as f:
        json.dump({"overall": scores["overall"], "n": scores["n"]}, f)
    return scores
