"""Weights made from the seed, on the device, in groups.

The benchmark makes every weight itself and hands the same values to the
program (``load_state_dict(assign=True)`` under the program's parameter
names) and to the plain reference, which makes them again, group by group,
once the program's state is freed. A group (the decoder's are its
family's: ``portbench/families``) is one decoder layer, the embedding, the
head, or the vision tower with its projector; each is ONE draw of a normal
f32 buffer from a generator seeded from (seed, group), then cut into its
leaves and scaled, and cast where the configuration states bf16 leaves.
So the same seed gives the same weights, and the reference can remake one
layer without the rest.

Norm scales are ones and biases zeros (never drawn); embeddings and
position tables N(0, 0.02); kernels N(0, 1 / fan_in), fan_in the
contracted input size. This module imports nothing of the program.
"""

from __future__ import annotations

import hashlib
import math
from typing import Dict, Sequence, Tuple

import torch

Leaf = Tuple[str, Tuple[int, ...], str]   # (name, shape, init)


def group_seed(seed: int, group: str) -> int:
    digest = hashlib.sha256(f"{int(seed)}/{group}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def init_of(name: str, shape: Sequence[int]) -> str:
    """'ones', 'zeros', or 'normal:<std>' for a leaf by its name."""
    leaf = name.rpartition(".")[2]
    if leaf in ("scale", "kernel_scale"):
        return "ones"
    if leaf == "bias":
        return "zeros"
    if leaf in ("embedding", "class_embedding", "position_embedding"):
        return "normal:0.02"
    owner = name.rpartition(".")[0].rpartition(".")[2]
    if owner in ("q_proj", "k_proj", "v_proj"):
        fan_in = shape[0]
    elif leaf == "lm_head_kernel":
        fan_in = shape[0]
    else:
        fan_in = math.prod(shape[:-1])
    return f"normal:{1.0 / math.sqrt(fan_in)!r}"


def leaf_dtype(config: Dict) -> torch.dtype:
    """The dtype of the leaves handed to the program: bf16 where the
    configuration states ``"weights": "bf16"``; f32 otherwise (``int8``
    weights are quantised by the port from its f32 leaves)."""
    return torch.bfloat16 if config["weights"] == "bf16" else torch.float32


def make_group(seed: int, group: str, leaves: Sequence[Leaf], device,
               dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """One group's leaves: one f32 normal draw for all its drawn leaves,
    cut into views and scaled in place; ones and zeros made apart; then
    each cast to ``dtype`` on ``device`` (bf16 leaves are the rounding of
    the f32 draw, which is freed)."""
    drawn = [(n, s, float(i.split(":")[1])) for n, s, i in leaves
             if i.startswith("normal:")]
    total = sum(math.prod(s) for _, s, _ in drawn)
    out = {}
    if total:
        gen = torch.Generator(device=device)
        gen.manual_seed(group_seed(seed, group))
        flat = torch.empty(total, dtype=torch.float32, device=device)
        flat.normal_(generator=gen)
        offset = 0
        for name, shape, std in drawn:
            n = math.prod(shape)
            out[name] = flat[offset:offset + n].view(shape).mul_(std)
            offset += n
    for name, shape, init in leaves:
        if init == "ones":
            out[name] = torch.ones(shape, device=device)
        elif init == "zeros":
            out[name] = torch.zeros(shape, device=device)
    if dtype != torch.float32:
        out = {name: t.to(dtype) for name, t in out.items()}
    return out
