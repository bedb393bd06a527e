"""Optimizer: AdamW + cosine/warmup schedule + layer-wise LR decay + the
freeze matrix (counterpart of ``merlin_tpu/train/optimizer.py``).

:class:`Optimizer` computes exactly the JAX package's optax chain
(``optimizer.py:123-158``), written out over the trainable parameters:

  1. clip by the global norm, ``g * max_norm / norm`` when the norm reaches
     ``max_norm`` (no epsilon, unlike ``torch.nn.utils.clip_grad_norm_``);
  2. Adam moments (b1, b2) and their bias corrections, eps outside the sqrt;
  3. decoupled weight decay ``u + wd * p``, not on biases or rank <= 1;
  4. the LLRD scale of the parameter's path (ViT layer i 0.9**(n - i - 2),
     other tower parameters 0.1; LM layer i 0.931**(n - i - 1));
  5. the learning rate, read at the update count BEFORE it is incremented,
     so a warmup schedule from 0 gives lr = 0 on the first update (decay
     included: steps 3-5 scale the decay too);
  6. last, the embedding row mask: rows of a frozen LM's original
     vocabulary get no update, decay included, while Adam's moments of
     those rows still see their gradients.

Frozen parameters (``trainable_fn`` false) get no update and no state. A
path is the parameter's name split at '.', which the port keeps equal to
the flax path (``vision_tower.vit.layers_3.q_proj.kernel``). The update is
computed in the gradient buffers by ``torch._foreach_*`` ops over runs of
tensors, so the step copies neither the parameters nor the gradients; its
only temporaries are the Adam denominators of one run.

On a mesh (``parallel=``, :class:`merlin_tpu_torch.core.parallel.
ParallelInfo`) the chain runs on each rank's local shards (FSDP2's
DTensors' local tensors, the tensor slices), element for element the
same; the clip's norm, and the reported norms, are of the WHOLE tree
(``optimizer.py:138``): each shard's squares weighted by 1 / the number of
ranks that hold it, summed over the world. The decay masks and the LLRD
scales are read by name, as before; the embedding row mask is cut to the
rows this rank holds.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from merlin_tpu_torch.core.parallel import local


def path_names(name: str) -> Tuple[str, ...]:
    """Parameter name -> the flax path tuple."""
    return tuple(name.split("."))


def _layer_index(names: Tuple[str, ...]) -> Optional[int]:
    for n in names:
        if n.startswith("layers_"):
            return int(n.split("_")[1])
    return None


def lr_scale_for_path(names: Tuple[str, ...], *, llrd: bool, llm_llrd: bool,
                      n_vit_layers: int, n_llm_layers: int) -> float:
    if llrd and names[0] == "vision_tower":
        idx = _layer_index(names)
        if idx is not None:
            return 0.9 ** (n_vit_layers - idx - 2)
        return 0.1
    if llm_llrd and names[0] == "lm":
        idx = _layer_index(names)
        if idx is not None:
            return 0.931 ** (n_llm_layers - idx - 1)
    return 1.0


def decays(names: Tuple[str, ...], param: torch.Tensor) -> bool:
    """Weight decay applies to every parameter but biases and rank <= 1."""
    return not (names[-1] == "bias" or param.dim() <= 1)


def make_lr_schedule(args) -> Callable[[int], float]:
    """The learning rate at an update count (optax's schedules)."""
    total = args.max_steps if args.max_steps > 0 else args.num_train_steps
    warmup = max(int(total * args.warmup_ratio), 1)
    peak = args.learning_rate
    if args.lr_scheduler_type == "cosine":
        decay_steps = max(total, warmup + 1) - warmup

        def cosine(count: int) -> float:
            if count < warmup:
                return peak * count / warmup
            t = min(count - warmup, decay_steps)
            return peak * 0.5 * (1 + math.cos(math.pi * t / decay_steps))

        return cosine
    if args.lr_scheduler_type == "linear":
        def linear(count: int) -> float:
            if count < warmup:
                return peak * count / warmup
            if total <= warmup:
                return peak
            t = min(count - warmup, total - warmup)
            return peak * (1 - t / (total - warmup))

        return linear
    return lambda _: peak


# elements of the temporary denominators held at once: 2 GiB of f32
_CHUNK_ELEMENTS = 1 << 29


def _chunks(sizes, budget):
    """(lo, hi) runs of consecutive tensors, each of at most ``budget``
    elements unless one tensor alone holds more."""
    lo, total = 0, 0
    for i, n in enumerate(sizes):
        if i > lo and total + n > budget:
            yield lo, i
            lo, total = i, 0
        total += n
    if lo < len(sizes):
        yield lo, len(sizes)


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in f32."""
    tensors = list(tensors)
    return torch.linalg.vector_norm(torch.stack(
        [n.float() for n in torch._foreach_norm(tensors)]))


class Optimizer:
    """The chain above over ``params`` (name -> trainable parameter).

    ``step(grads)`` consumes the gradients (each buffer is overwritten with
    its parameter's update), moves the parameters in place and returns the
    pre-clip ``grad_norm`` and the ``update_norm``, as 0-d tensors."""

    def __init__(self, params: Dict[str, torch.Tensor], *, b1: float,
                 b2: float, eps: float, weight_decay: float,
                 max_grad_norm: float, schedule: Callable[[int], float],
                 scale_fn: Callable[[Tuple[str, ...]], float],
                 embed_row_mask: Optional[np.ndarray] = None,
                 parallel=None):
        self.params = params
        self.parallel = parallel
        self._norm_weight = (None if parallel is None else
                             {n: 1.0 / parallel.replication(n, p)
                              for n, p in params.items()})
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.max_grad_norm = max_grad_norm
        self.schedule = schedule
        self.scale = {n: scale_fn(path_names(n)) for n in params}
        self.decay = {n: decays(path_names(n), p) for n, p in params.items()}
        self.row_mask = {}
        if embed_row_mask is not None:
            for n, p in params.items():
                if path_names(n)[-2:] == ("embed_tokens", "embedding"):
                    mask = torch.as_tensor(embed_row_mask)
                    if parallel is not None:
                        mask = mask[parallel.local_index(n, 0, p)]
                    q = local(self.params[n])
                    self.row_mask[n] = mask.to(q.device, q.dtype)[:, None]
        self.count = 0
        self.mu: Dict[str, torch.Tensor] = {}
        self.nu: Dict[str, torch.Tensor] = {}

    def init_state(self) -> None:
        """Zero moments for every trainable parameter, count 0."""
        self.count = 0
        self.mu = {n: torch.zeros_like(local(p))
                   for n, p in self.params.items()}
        self.nu = {n: torch.zeros_like(local(p))
                   for n, p in self.params.items()}

    def _norm(self, names, tensors) -> torch.Tensor:
        """The global norm of the tree (of the whole tree on a mesh)."""
        if self.parallel is None:
            return global_norm(tensors)
        norms = torch._foreach_norm(tensors)
        sq = torch.stack([n.float().square() * self._norm_weight[name]
                          for name, n in zip(names, norms)]).sum()
        dist.all_reduce(sq)
        return sq.sqrt()

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """``grads``: name -> the gradient of this rank's local part."""
        names = list(self.params)
        g = [grads[n] for n in names]
        mu = [self.mu[n] for n in names]
        nu = [self.nu[n] for n in names]
        grad_norm = self._norm(names, g)
        # 1. clip: t / norm * max_norm once the norm reaches max_norm
        clip = grad_norm >= self.max_grad_norm
        one = torch.ones_like(grad_norm)
        torch._foreach_div_(g, torch.where(clip, grad_norm, one))
        torch._foreach_mul_(g, torch.where(
            clip, torch.full_like(grad_norm, self.max_grad_norm), one))
        # 2. Adam moments
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, g, alpha=1 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, g, g, value=1 - self.b2)
        count_inc = self.count + 1
        bc1 = 1 - self.b1 ** count_inc
        bc2 = 1 - self.b2 ** count_inc
        lr = self.schedule(self.count)
        for lo, hi in _chunks([u.numel() for u in g], _CHUNK_ELEMENTS):
            u, p = g[lo:hi], [local(self.params[n]) for n in names[lo:hi]]
            den = torch._foreach_div(nu[lo:hi], bc2)
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, self.eps)
            torch._foreach_copy_(u, mu[lo:hi])
            torch._foreach_div_(u, bc1)
            torch._foreach_div_(u, den)
            del den
            dec = [i for i, n in enumerate(names[lo:hi]) if self.decay[n]]
            if dec:                                  # 3. decoupled decay
                torch._foreach_add_([u[i] for i in dec], [p[i] for i in dec],
                                    alpha=self.weight_decay)
            torch._foreach_mul_(u, [self.scale[n]    # 4. LLRD
                                    for n in names[lo:hi]])
            torch._foreach_mul_(u, -lr)              # 5. schedule
        for n, mask in self.row_mask.items():        # 6. frozen rows
            grads[n].mul_(mask)
        update_norm = self._norm(names, g)
        torch._foreach_add_([local(self.params[n]) for n in names], g)
        self.count = count_inc
        return {"grad_norm": grad_norm, "update_norm": update_norm}

    def state_dict(self) -> Dict:
        return {"count": self.count, "mu": dict(self.mu), "nu": dict(self.nu)}

    def load_state_dict(self, state: Dict) -> None:
        self.count = int(state["count"])
        own = {n: local(p) for n, p in self.params.items()}
        self.mu = {n: state["mu"][n].to(p.device, p.dtype)
                   for n, p in own.items()}
        self.nu = {n: state["nu"][n].to(p.device, p.dtype)
                   for n, p in own.items()}


def build_optimizer(args, named_params: Iterable[Tuple[str, torch.Tensor]],
                    *, n_vit_layers: int = 24, n_llm_layers: int = 32,
                    trainable_fn: Optional[Callable] = None,
                    embed_row_mask: Optional[np.ndarray] = None,
                    parallel=None
                    ) -> Tuple[Optimizer, Callable[[int], float]]:
    """The optimizer over the parameters ``trainable_fn`` accepts (all when
    it is None), and its schedule. Call ``init_state`` before stepping.
    ``parallel``: the model's placement on a mesh, once applied."""
    schedule = make_lr_schedule(args)

    def scale_fn(names):
        return lr_scale_for_path(
            names, llrd=args.llrd, llm_llrd=args.llm_llrd,
            n_vit_layers=n_vit_layers, n_llm_layers=n_llm_layers)

    params = {n: p for n, p in named_params
              if trainable_fn is None or trainable_fn(path_names(n))}
    opt = Optimizer(params, b1=args.adam_beta1, b2=args.adam_beta2,
                    eps=args.adam_epsilon, weight_decay=args.weight_decay,
                    max_grad_norm=args.max_grad_norm, schedule=schedule,
                    scale_fn=scale_fn, embed_row_mask=embed_row_mask,
                    parallel=parallel)
    return opt, schedule
