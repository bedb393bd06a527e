"""Checkpoint surgery tools (counterpart of ``merlin_tpu/utils/surgery.py``).

* position-embedding interpolation for resolution upgrades (224 -> 448),
  through :func:`merlin_tpu_torch.models.vit.interpolate_pos_embedding`
  (the load path applies it too; this rewrites a saved parameter set);
* weight deltas for license-safe release: delta = finetuned - base; apply =
  base + delta.

Parameter sets are the port's flat state dicts (names are the flax paths
joined by "."); nested dicts of arrays, JAX's trees, work as well. The
files are the port's own format: ``torch.save`` of the flat dict (JAX's are
orbax directories).

    python -m merlin_tpu_torch.utils.surgery make-delta \\
        --base base.pt --finetuned fine.pt --delta delta.pt
    python -m merlin_tpu_torch.utils.surgery apply-delta \\
        --base base.pt --delta delta.pt --out fine.pt
"""

from __future__ import annotations

import os
from typing import Any, Callable, Dict, Mapping

import numpy as np
import torch

POS_EMBED = "vision_tower.vit.position_embedding"


def _as_tensor(x):
    return x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))


def _map2(fn: Callable, a: Any, b: Any) -> Any:
    """``fn`` leaf by leaf over two trees of the same structure."""
    if isinstance(a, Mapping):
        if set(a) != set(b):
            raise KeyError(f"the trees differ: {sorted(set(a) ^ set(b))[:8]}")
        return {k: _map2(fn, a[k], b[k]) for k in a}
    return fn(_as_tensor(a), _as_tensor(b))


def tree_sub(fine: Any, base: Any) -> Any:
    """delta = fine - base."""
    return _map2(lambda f, b: f - b, fine, base)


def tree_add(base: Any, delta: Any) -> Any:
    """fine = base + delta."""
    return _map2(lambda b, d: b + d, base, delta)


def save_params(path: str, params: Dict[str, torch.Tensor]) -> None:
    """Write a flat parameter dict (tensors moved to the host)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.save({k: _as_tensor(v).detach().cpu() for k, v in params.items()},
               os.path.abspath(path))


def load_params(path: str) -> Dict[str, torch.Tensor]:
    return torch.load(os.path.abspath(path), map_location="cpu",
                      weights_only=True)


def make_delta(base_path: str, finetuned_path: str, delta_path: str) -> None:
    save_params(delta_path, tree_sub(load_params(finetuned_path),
                                     load_params(base_path)))


def apply_delta(base_path: str, delta_path: str, out_path: str) -> None:
    save_params(out_path, tree_add(load_params(base_path),
                                   load_params(delta_path)))


def interpolate_checkpoint_pos_embed(params: Dict, new_positions: int) -> Dict:
    """Bicubic-resize the vision tower's position table inside a parameter
    set (flat, or nested as JAX's tree); returns a shallow copy."""
    from merlin_tpu_torch.models.vit import interpolate_pos_embedding

    if POS_EMBED in params:
        out = dict(params)
        out[POS_EMBED] = interpolate_pos_embedding(_as_tensor(
            params[POS_EMBED]), new_positions)
        return out
    out = dict(params)
    tower = dict(out["vision_tower"])
    vit = dict(tower["vit"])
    vit["position_embedding"] = interpolate_pos_embedding(
        _as_tensor(vit["position_embedding"]), new_positions)
    tower["vit"] = vit
    out["vision_tower"] = tower
    return out


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="checkpoint surgery")
    sub = p.add_subparsers(dest="cmd", required=True)
    mk = sub.add_parser("make-delta")
    mk.add_argument("--base", required=True)
    mk.add_argument("--finetuned", required=True)
    mk.add_argument("--delta", required=True)
    ap = sub.add_parser("apply-delta")
    ap.add_argument("--base", required=True)
    ap.add_argument("--delta", required=True)
    ap.add_argument("--out", required=True)
    args = p.parse_args(argv)
    if args.cmd == "make-delta":
        make_delta(args.base, args.finetuned, args.delta)
    else:
        apply_delta(args.base, args.delta, args.out)


if __name__ == "__main__":
    main()
