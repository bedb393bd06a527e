"""Single-object tracking harness (counterpart of
``merlin_tpu/eval/tracking.py``; reference model/mmgpt/run_llava_tracking.py
rebuilt).

Per video: walk consecutive frame pairs with the prompt
``'Given image0<image> and image1<image>, track image0:<Id1>[...]</Id1> in
image1.'`` (run_llava_tracking.py:274), regex-extract the predicted box,
fall back to the last good box when parsing fails (:387-393), and feed the
prediction into the next pair's prompt (closed loop). Predictions are
dumped one pickle per video (:400-402) and scored by mean IoU + the
LaSOT-style success AUC.

The reference shards videos across GPUs with multiprocessing (:410-436);
here one process holds one model and walks its share of the videos
(``--num-chunks``/``--chunk-idx``). A sampled answer draws from a generator
seeded 0 at every call (C32), so a video's boxes do not depend on which
chunk ran it.
"""

from __future__ import annotations

import dataclasses
import glob
import os
import pickle
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from merlin_tpu_torch.data.box import (
    box_iou_xyxy, de_norm_box_xyxy, extract_boxes, norm_box_xyxy)
from merlin_tpu_torch.data.images import load_image
from merlin_tpu_torch.eval.runner import EvalConfig, EvalModel

TRACK_PROMPT = ("Given image0<image> and image1<image>, track "
                "image0:<Id1>[{:03d}, {:03d}, {:03d}, {:03d}]</Id1> "
                "in image1.")


def serialize_norm_box(box_xyxy: Sequence[float], w: int, h: int
                       ) -> Tuple[int, int, int, int]:
    nb = norm_box_xyxy(box_xyxy, w, h)
    return tuple(int(c * 1000) for c in nb)


def parse_predicted_box(text: str) -> Optional[List[float]]:
    groups = extract_boxes(text)
    if not groups or not groups[-1]:
        return None
    return groups[-1][-1]


@dataclasses.dataclass
class VideoResult:
    name: str
    pred_boxes: List[Tuple[float, float, float, float]]  # pixel xyxy
    gt_boxes: List[Tuple[float, float, float, float]]
    ious: List[float]

    @property
    def mean_iou(self) -> float:
        return float(np.mean(self.ious)) if self.ious else 0.0

    def success_auc(self, thresholds=None) -> float:
        if not self.ious:
            return 0.0
        thresholds = (np.linspace(0, 1, 21) if thresholds is None
                      else np.asarray(thresholds))
        ious = np.asarray(self.ious)
        return float(np.mean([(ious > t).mean() for t in thresholds]))


def load_lasot_video(video_dir: str) -> Tuple[List[str], List[Tuple[float, ...]]]:
    """LaSOT layout: video_dir/img/*.jpg + groundtruth.txt of x,y,w,h."""
    frames = sorted(glob.glob(os.path.join(video_dir, "img", "*.jpg")))
    if not frames:
        frames = sorted(glob.glob(os.path.join(video_dir, "*.jpg")))
    gt = []
    gt_path = os.path.join(video_dir, "groundtruth.txt")
    if os.path.exists(gt_path):
        with open(gt_path) as f:
            for line in f:
                x, y, w, h = [float(v) for v in line.replace("\t", ",").split(",")[:4]]
                gt.append((x, y, x + w, y + h))
    return frames, gt


def track_video(model: EvalModel, frames: Sequence[str],
                init_box_xyxy: Sequence[float],
                gt_boxes: Optional[Sequence[Sequence[float]]] = None,
                *, name: str = "video", max_frames: int = 0) -> VideoResult:
    if max_frames:
        frames = frames[:max_frames]
        gt_boxes = gt_boxes[:max_frames] if gt_boxes else None
    first = load_image(frames[0])
    w, h = first.size
    last_box = tuple(init_box_xyxy)
    preds = [last_box]
    ious: List[float] = []
    prev_img = first
    for i in range(1, len(frames)):
        cur_img = load_image(frames[i])
        nb = serialize_norm_box(last_box, w, h)
        prompt = TRACK_PROMPT.format(*nb)
        text = model.ask(prompt, [prev_img, cur_img])
        parsed = parse_predicted_box(text)
        if parsed is not None:
            last_box = de_norm_box_xyxy([c / 1000 for c in parsed], w=w, h=h)
        # else: keep last good box (run_llava_tracking.py:387-393)
        preds.append(tuple(last_box))
        if gt_boxes is not None and i < len(gt_boxes):
            ious.append(box_iou_xyxy(last_box, gt_boxes[i]))
        prev_img = cur_img
    return VideoResult(name=name, pred_boxes=preds,
                       gt_boxes=list(gt_boxes or []), ious=ious)


def chunk_videos(videos: Sequence[str], num_chunks: int,
                 chunk_idx: int) -> List[str]:
    """Contiguous video split across eval workers (reference
    run_llava_tracking.py:410-436 fans chunks out with mp.spawn per GPU;
    here each chunk is one process/host invocation via
    --num-chunks/--chunk-idx)."""
    if num_chunks <= 1:
        return list(videos)
    if not 0 <= chunk_idx < num_chunks:
        raise ValueError(f"chunk_idx {chunk_idx} not in [0, {num_chunks})")
    per = -(-len(videos) // num_chunks)
    return list(videos[chunk_idx * per: (chunk_idx + 1) * per])


def run(bundle, dataset_dir: str, output_dir: str,
        eval_cfg: Optional[EvalConfig] = None, *, max_videos: int = 0,
        max_frames: int = 0, num_chunks: int = 1, chunk_idx: int = 0,
        device: Union[str, torch.device] = "cuda") -> Dict[str, float]:
    eval_cfg = eval_cfg or EvalConfig(do_sample=True, temperature=0.2,
                                      max_new_tokens=64)
    model = EvalModel(bundle, eval_cfg, device=device)
    videos = sorted(d for d in glob.glob(os.path.join(dataset_dir, "*"))
                    if os.path.isdir(d))
    if max_videos:
        videos = videos[:max_videos]
    videos = chunk_videos(videos, num_chunks, chunk_idx)
    os.makedirs(output_dir, exist_ok=True)

    results: List[VideoResult] = []
    for vdir in videos:
        frames, gt = load_lasot_video(vdir)
        if not frames or not gt:
            continue
        res = track_video(model, frames, gt[0], gt,
                          name=os.path.basename(vdir),
                          max_frames=max_frames)
        results.append(res)
        with open(os.path.join(output_dir, f"{res.name}_pred.pkl"), "wb") as f:
            pickle.dump({"boxes": res.pred_boxes, "ious": res.ious,
                         "mean_iou": res.mean_iou,
                         "success_auc": res.success_auc()}, f)

    summary = {
        "videos": len(results),
        "mean_iou": float(np.mean([r.mean_iou for r in results])) if results else 0.0,
        "success_auc": float(np.mean([r.success_auc() for r in results])) if results else 0.0,
    }
    return summary


def merge_chunks(output_dir: str) -> Dict[str, float]:
    """Aggregate every chunk's per-video pickles into the overall summary
    (the reference's post-spawn gather, run_llava_tracking.py:430-436)."""
    ious, aucs = [], []
    for path in sorted(glob.glob(os.path.join(output_dir, "*_pred.pkl"))):
        with open(path, "rb") as f:
            rec = pickle.load(f)
        if "mean_iou" in rec:
            ious.append(rec["mean_iou"])
            aucs.append(rec["success_auc"])
        else:  # pre-chunking pickles carry raw ious only
            vi = rec.get("ious", [])
            ious.append(float(np.mean(vi)) if vi else 0.0)
            t = np.linspace(0, 1, 21)
            aucs.append(float(np.mean([(np.asarray(vi) > x).mean()
                                       for x in t])) if vi else 0.0)
    return {
        "videos": len(ious),
        "mean_iou": float(np.mean(ious)) if ious else 0.0,
        "success_auc": float(np.mean(aucs)) if aucs else 0.0,
    }
