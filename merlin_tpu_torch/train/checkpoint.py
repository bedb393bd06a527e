"""Step checkpoints with rotation and auto-resume (counterpart of
``merlin_tpu/train/checkpoint.py``).

``checkpoint-{step}/`` holds ``model.pt`` and ``optimizer.pt`` (``torch.save``
of the model's and the optimizer's state dicts) and ``data_state.json``, the
data-iterator state the JAX package's checkpoints carry too. Loading reads
tensors only (``weights_only=True``).
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Dict, List, Optional, Tuple

import torch

CKPT_RE = re.compile(r"checkpoint-(\d+)$")


def list_checkpoints(output_dir: str) -> List[Tuple[int, str]]:
    if not os.path.isdir(output_dir):
        return []
    out = []
    for name in os.listdir(output_dir):
        m = CKPT_RE.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(output_dir, name)))
    return sorted(out)


def latest_checkpoint(output_dir: str) -> Optional[str]:
    ckpts = list_checkpoints(output_dir)
    return ckpts[-1][1] if ckpts else None


def save_checkpoint(output_dir: str, step: int, model, optimizer,
                    data_state: Optional[Dict] = None,
                    save_total_limit: int = 0) -> str:
    """Write checkpoint-{step}/ and keep only the newest
    ``save_total_limit`` checkpoints (0 keeps all)."""
    path = os.path.join(os.path.abspath(output_dir), f"checkpoint-{step}")
    os.makedirs(path, exist_ok=True)
    torch.save(model.state_dict(), os.path.join(path, "model.pt"))
    torch.save(optimizer.state_dict(), os.path.join(path, "optimizer.pt"))
    if data_state is not None:
        with open(os.path.join(path, "data_state.json"), "w") as f:
            json.dump(data_state, f)
    if save_total_limit > 0:
        for _, old in list_checkpoints(output_dir)[:-save_total_limit]:
            if os.path.abspath(old) != path:
                shutil.rmtree(old, ignore_errors=True)
    return path


def restore_checkpoint(path: str, model, optimizer
                       ) -> Tuple[int, Optional[Dict]]:
    """Load a checkpoint-{step} dir into ``model`` and ``optimizer`` (in
    place, onto their devices); returns (step, data_state)."""
    device = next(model.parameters()).device
    state = torch.load(os.path.join(path, "model.pt"), map_location=device,
                       weights_only=True)
    with torch.no_grad():
        model.load_state_dict(state, strict=True)
    optimizer.load_state_dict(torch.load(
        os.path.join(path, "optimizer.pt"), map_location=device,
        weights_only=True))
    data_state = None
    ds_path = os.path.join(path, "data_state.json")
    if os.path.exists(ds_path):
        with open(ds_path) as f:
            data_state = json.load(f)
    m = CKPT_RE.search(os.path.normpath(path))
    return int(m.group(1)), data_state
