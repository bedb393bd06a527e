"""Multi-turn, multi-image chat demo REPL (counterpart of
``merlin_tpu/eval/demo.py``; reference engine/eval/demo.py — which imports
a nonexistent conv_templates as shipped).

Task modes (demo.py:269-279):
  Track  — image placeholder blocks (one per frame) PREPENDED to the query
  Detect — one image block APPENDED to the query
  ImgInd — explicit ``<image>`` tokens in the query are replaced in place

Each turn: 'img1.jpg,img2.jpg ; question'. Boxes in the answer are drawn
per frame and saved to the temporary directory (demo.py:340-350). 'reset'
clears the conversation. Each turn decodes the whole conversation through
``EvalModel``'s engine (greedy, sampled or beam search).
"""

from __future__ import annotations

import os
import tempfile
from typing import List, Optional, Sequence, Union

import torch

from merlin_tpu_torch.eval.box_eval import postprocess
from merlin_tpu_torch.eval.runner import EvalConfig, EvalModel
from merlin_tpu_torch.utils import constants as C
from merlin_tpu_torch.utils.conversation import conv_templates


def build_task_query(query: str, num_images: int, image_token_len: int,
                     task_mode: str = "ImgInd",
                     use_im_start_end: bool = True) -> str:
    block = C.image_placeholder(image_token_len, use_im_start_end)
    if task_mode == "Track":
        return block * num_images + query
    if task_mode == "Detect":
        return query + block
    # ImgInd
    if C.DEFAULT_IMAGE_TOKEN in query:
        return query.replace(C.DEFAULT_IMAGE_TOKEN, block)
    if num_images:
        return block * num_images + "\n" + query
    return query


def run_demo(bundle, *, task_mode: str = "ImgInd",
             eval_cfg: Optional[EvalConfig] = None,
             input_fn=input, print_fn=print, max_turns: int = 0,
             device: Union[str, torch.device] = "cuda"):
    from merlin_tpu_torch.data.images import load_image

    model = EvalModel(bundle, eval_cfg or EvalConfig(do_sample=True,
                                                     temperature=0.2),
                      device=device)
    conv = conv_templates["v1"].copy()
    images: List = []
    turns = 0
    while True:
        try:
            line = input_fn("demo> ").strip()
        except (EOFError, KeyboardInterrupt):
            return
        if not line or line in ("quit", "exit"):
            return
        if line == "reset":
            conv = conv_templates["v1"].copy()
            images = []
            continue
        paths, sep, query = line.partition(";")
        if not sep:
            query, paths = paths, ""
        new_images = [load_image(p.strip())
                      for p in paths.split(",") if p.strip()]
        images.extend(new_images)

        qs = build_task_query(
            query.strip(), len(new_images), bundle.config.image_token_len,
            task_mode, bundle.config.use_im_start_end)
        conv.append_message(conv.roles[0], qs)
        conv.append_message(conv.roles[1], None)

        ids = model._encode(conv.get_prompt())[None]
        out = model._run(ids, model.preprocess_images(images), None)
        answer = model.decode_output(out[0])
        conv.messages[-1][1] = answer

        text, drawn = postprocess(answer, images[-1] if images else None)
        print_fn(f"ASSISTANT: {text}")
        if drawn is not None:
            path = os.path.join(tempfile.gettempdir(),
                                f"merlin_demo_turn{turns}.png")
            drawn.save(path)
            print_fn(f"[boxes drawn -> {path}]")
        turns += 1
        if max_turns and turns >= max_turns:
            return


def main(argv: Optional[Sequence[str]] = None):
    import argparse

    from merlin_tpu_torch.models.builder import (
        build_model_tokenizer, init_or_load_params)
    from merlin_tpu_torch.train.arguments import parse_args

    p = argparse.ArgumentParser()
    p.add_argument("--task-mode", default="ImgInd",
                   choices=["Track", "Detect", "ImgInd"])
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="where the model runs (cpu for a test)")
    args, rest = p.parse_known_args(argv)
    margs, dargs, targs = parse_args(rest)
    bundle = build_model_tokenizer(margs, dargs, targs, tiny=args.tiny)
    init_or_load_params(bundle, composite_checkpoint=margs.pretrain_model,
                        device=args.device)
    run_demo(bundle, task_mode=args.task_mode, device=args.device)


if __name__ == "__main__":
    main()
