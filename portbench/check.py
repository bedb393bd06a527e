"""Whether what the timed path served is correct.

Once the window has closed and the program's state is freed, a sample of
the finished requests, drawn from the seed and holding the one that served
the most tokens, goes through the plain reference of the configuration's
decoder family once each: its prompt and served tokens. A served token's
gap is how far the reference's logit for it lies below the reference's best
at that position; the widest gap over the sample is held against the
configuration's limit. The control (``portbench/controls.py``) reads the
same gap for the tokens a lower precision would put first.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

from portbench import weights
from portbench.record import Req


def judge(config: Dict, traffic: Dict, gap: float, failed: int,
          served: int):
    """(correct, checks): the verdict on one reading of the widest gap,
    with the run's failed requests and the served tokens compared, and
    each number beside its limit. The benchmark's runs judge the served
    tokens by it, the controls the tokens a lower precision puts first."""
    finite = math.isfinite(gap)
    checks = {
        "gap_max": {"value": gap if finite else None,
                    "limit": config["gap_limit"]},
        "failed_max": {"value": failed, "limit": 0},
        "served_tokens_min": {"value": served,
                              "limit": traffic["check_min_tokens"]},
    }
    correct = (finite and gap <= config["gap_limit"] and not failed
               and served >= traffic["check_min_tokens"])
    return correct, checks


def sample(requests: Sequence[Req], k: int, seed: int) -> List[Req]:
    """``k`` finished requests drawn from the seed, the longest first."""
    done = [r for r in requests if r.done and r.error is None and r.tokens]
    if not done:
        return []
    longest = max(range(len(done)), key=lambda i: len(done[i].tokens))
    rest = [i for i in range(len(done)) if i != longest]
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32, 7])
    picked = rng.choice(len(rest), size=min(k - 1, len(rest)), replace=False)
    return [done[longest]] + [done[rest[i]] for i in sorted(picked)]


def widest_gaps(family, config: Dict, seed: int, reqs: Sequence[Req],
                precisions: Sequence[str], device) -> List[float]:
    """For the first precision: the widest gap of the served tokens. For
    each further one: the widest gap, in the first precision's logits, of
    the tokens that precision puts first at the same positions. The
    reference is the configuration's decoder ``family``'s; it computes in
    f32 from the leaves the program was handed (bf16 leaves: their
    values)."""
    lm = family.widths(config)
    groups = family.groups(lm)
    dtype = weights.leaf_dtype(config)

    def group(name):
        return {leaf: t.float() for leaf, t in weights.make_group(
            seed, name, groups[name], device, dtype).items()}

    seqs = [{"ids": np.concatenate([r.ids, np.asarray(r.tokens[:-1],
                                                      np.int64)]),
             "prompt_len": r.prompt_len} for r in reqs]
    logits = family.served_logits(lm, group, seqs, precisions,
                                  config["pages"] == "int8", device)
    ref = logits[0]
    out = []
    for pi in range(len(precisions)):
        widest = 0.0
        for r, rows_ref, rows in zip(reqs, ref, logits[pi]):
            if pi == 0:
                picked = torch.as_tensor(r.tokens, device=rows_ref.device)
            else:
                picked = rows.argmax(-1)
            gap = rows_ref.amax(-1) - rows_ref.gather(
                1, picked.long()[:, None])[:, 0]
            widest = max(widest, float(gap.max()))
        out.append(widest)
    return out
