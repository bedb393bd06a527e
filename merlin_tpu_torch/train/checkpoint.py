"""Step checkpoints with rotation and auto-resume (counterpart of
``merlin_tpu/train/checkpoint.py``).

``checkpoint-{step}/`` holds ``model.pt`` and ``optimizer.pt`` (``torch.save``
of the model's and the optimizer's state dicts) and ``data_state.json``, the
data-iterator state the JAX package's checkpoints carry too. Loading reads
tensors only (``weights_only=True``).

Unlike JAX's, which saves the whole state, ``model.pt`` leaves out the
parameters training cannot change, those that need no gradient:
``frozen.json`` keeps a fingerprint of each, and a restore checks that the
model it loads into holds the same values (the base weights the run
started from) before it loads the rest. A frozen Vicuna-7B would be 28.3
GB of every checkpoint.

On a mesh (``parallel=``, the model's
:class:`~merlin_tpu_torch.core.parallel.ParallelInfo`) the ranks gather the
full tensors (parameters and Adam moments: FSDP2 shards, then tensor
slices) one at a time; rank 0 copies each to the host at once and writes
them in the same format, so a checkpoint written on a mesh resumes in a
one-process run and the other way round. The device never holds more than
one full tensor beyond the sharded state: at the 32-layer recipe's size the
full parameters and moments (~81 GB) would not fit beside it. A restore
maps the files into host memory and copies each rank's part of each tensor
to the device.
"""

from __future__ import annotations

import json
import os
import re
import shutil
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from merlin_tpu_torch.core.parallel import local

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


def fingerprint(t: torch.Tensor) -> str:
    """dtype, shape and the exact integer sum of the tensor's bits: equal
    for equal tensors on any device."""
    bits = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    total = t.detach().contiguous().view(bits[t.element_size()]).sum(
        dtype=torch.int64)
    return f"{t.dtype}{list(t.shape)}:{int(total)}"


def _on_host(parallel, items, params=None) -> Dict[str, torch.Tensor]:
    """name -> the full tensor of each (name, local part) of ``items``,
    gathered one at a time (a collective: every rank calls it) and copied
    to the host on rank 0 at once; empty on the other ranks. ``params``
    maps a name to the parameter whose placement the part has."""
    main = dist.get_rank() == 0
    out = {}
    for n, t in items:
        full = parallel.full_tensor(n, t, params[n] if params else None)
        if main:
            out[n] = full.detach().to("cpu", copy=True)
        del full
    return out


def _fingerprints(model, frozen, parallel) -> Dict[str, str]:
    """The fingerprints of the parameters ``frozen`` (on a mesh, of their
    full tensors, gathered one at a time: a collective)."""
    params = dict(model.named_parameters())
    if parallel is None:
        state = model.state_dict()
        return {n: fingerprint(state[n]) for n in frozen if n in state}
    return {n: fingerprint(parallel.full_tensor(n, params[n]))
            for n in frozen if n in params}


def save_checkpoint(output_dir: str, step: int, model, optimizer,
                    data_state: Optional[Dict] = None,
                    save_total_limit: int = 0, parallel=None) -> str:
    """Write checkpoint-{step}/ and keep only the newest
    ``save_total_limit`` checkpoints (0 keeps all). The parameters that
    need no gradient are written as fingerprints only. On a mesh every
    rank calls it and rank 0 writes."""
    path = os.path.join(os.path.abspath(output_dir), f"checkpoint-{step}")
    main = parallel is None or dist.get_rank() == 0
    frozen = sorted(n for n, p in model.named_parameters()
                    if not p.requires_grad)
    prints = _fingerprints(model, frozen, parallel)
    if main:
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "frozen.json"), "w") as f:
            json.dump(prints, f)
    if parallel is None:
        state = model.state_dict()
    else:
        state = _on_host(parallel, [(n, p) for n, p in
                                    model.named_parameters()
                                    if p.requires_grad])
        if main:
            state.update({n: b.detach().to("cpu", copy=True)
                          for n, b in model.named_buffers()
                          if n not in model._non_persistent_buffers_set})
    if main:
        torch.save({n: t for n, t in state.items() if n not in frozen},
                   os.path.join(path, "model.pt"))
    del state
    opt_state = optimizer.state_dict()
    if parallel is not None:
        for key in ("mu", "nu"):
            opt_state[key] = _on_host(parallel, opt_state[key].items(),
                                      optimizer.params)
    if main:
        torch.save(opt_state, os.path.join(path, "optimizer.pt"))
    del opt_state
    if main and data_state is not None:
        with open(os.path.join(path, "data_state.json"), "w") as f:
            json.dump(data_state, f)
    if main and save_total_limit > 0:
        for _, old in list_checkpoints(output_dir)[:-save_total_limit]:
            if os.path.abspath(old) != path:
                shutil.rmtree(old, ignore_errors=True)
    if parallel is not None:
        dist.barrier()
    return path


def restore_checkpoint(path: str, model, optimizer, parallel=None
                       ) -> Tuple[int, Optional[Dict]]:
    """Load a checkpoint-{step} dir into ``model`` and ``optimizer`` (in
    place, onto their devices); returns (step, data_state). On a mesh
    every rank maps the files into host memory and copies its part of each
    tensor to the device."""
    with open(os.path.join(path, "frozen.json")) as f:
        frozen = json.load(f)
    own = _fingerprints(model, sorted(frozen), parallel)
    for name, want in frozen.items():
        if own.get(name) != want:
            raise ValueError(
                f"{path} left {name} out as frozen, and the model's differs "
                f"from the one it was saved from: resume from the same base "
                f"weights")
    if parallel is None:
        device = next(model.parameters()).device
        load = dict(map_location=device, weights_only=True)
    else:
        load = dict(map_location="cpu", weights_only=True, mmap=True)
    state = torch.load(os.path.join(path, "model.pt"), **load)
    opt_state = torch.load(os.path.join(path, "optimizer.pt"), **load)
    if parallel is None:
        with torch.no_grad():
            missing, unexpected = model.load_state_dict(state, strict=False)
    else:
        params = dict(model.named_parameters())
        unexpected = [n for n in state if n not in params]
        missing = [n for n in params if n not in state]
        with torch.no_grad():
            for n, full in state.items():
                if n in params:
                    local(params[n]).copy_(
                        parallel.local_part(n, full, params[n]))
        for key in ("mu", "nu"):
            opt_state[key] = {
                n: parallel.local_part(n, t, optimizer.params[n]).to(
                    local(optimizer.params[n]).device, copy=True)
                for n, t in opt_state[key].items()}
    del state
    optimizer.load_state_dict(opt_state)
    data_state = None
    ds_path = os.path.join(path, "data_state.json")
    if os.path.exists(ds_path):
        with open(ds_path) as f:
            data_state = json.load(f)
    m = CKPT_RE.search(os.path.normpath(path))
    return int(m.group(1)), data_state
