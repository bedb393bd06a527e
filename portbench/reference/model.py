"""Plain PyTorch reference of the served decoders, in float32.

A no-cache causal forward of one sequence through Baichuan2 (RoPE,
NormHead) or Baichuan (ALiBi), layer by layer, each layer's weights made
again from the seed (``portbench.weights``), so that it runs after the
program's state is freed and holds one layer at a time. It follows the
published models: RMSNorm, rotate-half RoPE at theta 10000, ALiBi slopes
by Press et al. with the interleave for head counts that are no power of
two, SiLU-gated MLP, and Baichuan2's head normalised by column.

What the configuration states is computed here too, from the f32 weights,
never taken from the program: int8 weights (per output channel, absmax /
127, rounded half to even) and int8 K/V pages (per token and kv head,
absmax / 127), which decode-step queries read, while a prompt attends its
own unquantised K/V as a prefill does.

Other precisions stand in for a program that computes lower than the
configuration states (the control): ``int4`` weights (absmax / 7) and
``fp8`` (e4m3 operands of every projection and of the head, scaled by row
of the activations and by column of the weights). This module imports
nothing of the program.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List, Sequence

import torch

PRECISIONS = ("f32", "int8", "int4", "fp8")
FP8_MAX = 448.0


@contextlib.contextmanager
def exact_f32():
    """float32 matmuls without TF32, restored on exit."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def quantize_columns(w: torch.Tensor, levels: int) -> torch.Tensor:
    """(k_in, k_out) f32 -> the same, each column on a symmetric grid of
    +-levels steps of absmax / levels (what int8 or int4 weights hold)."""
    scale = torch.clamp(w.abs().amax(dim=0, keepdim=True) / levels,
                        min=1e-12)
    return torch.clamp(torch.round(w / scale), -levels, levels) * scale


def fp8_round(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x through float8 e4m3, scaled so each slice along ``dim`` has its
    absmax at e4m3's largest value."""
    scale = torch.clamp(x.abs().amax(dim=dim, keepdim=True) / FP8_MAX,
                        min=1e-30)
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def prepare(w: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "int8":
        return quantize_columns(w, 127)
    if precision == "int4":
        return quantize_columns(w, 7)
    if precision == "fp8":
        return fp8_round(w, 0)
    return w


def project(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "fp8":
        x = fp8_round(x, -1)
    return x @ w


def rms_norm(x, scale, eps):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (T, h, d), positions 0..T-1, rotate-half (HF Llama/Baichuan2)."""
    t, _, d = x.shape
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                       device=x.device) / d)
    ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def alibi_slopes(h: int) -> List[float]:
    def pow2(n):
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return [start ** (i + 1) for i in range(n)]
    if math.log2(h).is_integer():
        return pow2(h)
    closest = 2 ** math.floor(math.log2(h))
    return pow2(closest) + pow2(2 * closest)[0::2][:h - closest]


def kv_int8(x: torch.Tensor) -> torch.Tensor:
    """(T, hkv, d) through int8 with one scale per (token, kv head)."""
    sc = torch.clamp(x.abs().amax(-1, keepdim=True) / 127.0, min=1e-8)
    return torch.clamp(torch.round(x / sc), -127, 127) * sc


def attend(q, k, v, q_pos, slopes):
    """Causal attention of queries at ``q_pos`` over keys 0..T-1."""
    h, d = q.shape[1], q.shape[2]
    group = h // k.shape[1]
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)
    s = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(d)
    k_pos = torch.arange(k.shape[0], device=q.device)
    dist = (k_pos[None, :] - q_pos[:, None]).float()
    if slopes is not None:
        s = s + slopes[:, None, None] * dist[None]
    s = s.masked_fill((dist > 0)[None], float("-inf"))
    return torch.einsum("hqk,khd->qhd", torch.softmax(s, dim=-1), v)


class Layer:
    """One decoder layer's matrices, as 2-d (in, out) f32 in a precision."""

    def __init__(self, w: Dict[str, torch.Tensor], prefix: str,
                 precision: str):
        def mat(name):
            t = w[prefix + name]
            if name.endswith("o_proj.kernel"):
                return prepare(t.reshape(-1, t.shape[-1]), precision)
            return prepare(t.reshape(t.shape[0], -1), precision)
        self.q, self.k, self.v = (mat(f"attn.{n}_proj.kernel")
                                  for n in "qkv")
        self.o = mat("attn.o_proj.kernel")
        self.gate, self.up = mat("mlp.gate_proj.kernel"), mat("mlp.up_proj.kernel")
        self.down = mat("mlp.down_proj.kernel")
        self.norm1 = w[prefix + "input_norm.scale"]
        self.norm2 = w[prefix + "post_attn_norm.scale"]


def block(x, layer: Layer, lm: Dict, prompt_len: int, precision: str,
          pages_int8: bool, slopes):
    t = x.shape[0]
    h, hkv, d = lm["num_heads"], lm["num_kv_heads"], lm["head_dim"]
    n = rms_norm(x, layer.norm1, lm["rms_norm_eps"])
    q = project(n, layer.q, precision).reshape(t, h, d)
    k = project(n, layer.k, precision).reshape(t, hkv, d)
    v = project(n, layer.v, precision).reshape(t, hkv, d)
    if lm["positional"] == "rope":
        q, k = rope(q, lm["rope_theta"]), rope(k, lm["rope_theta"])
    pos = torch.arange(t, device=x.device)
    if pages_int8 and prompt_len < t:
        # a prompt attends its own K/V (prefill); decode steps read pages
        out = torch.cat([
            attend(q[:prompt_len], k, v, pos[:prompt_len], slopes),
            attend(q[prompt_len:], kv_int8(k), kv_int8(v), pos[prompt_len:],
                   slopes)])
    else:
        out = attend(q, k, v, pos, slopes)
    x = x + project(out.reshape(t, h * d), layer.o, precision)
    n = rms_norm(x, layer.norm2, lm["rms_norm_eps"])
    mlp = torch.nn.functional.silu(project(n, layer.gate, precision)) \
        * project(n, layer.up, precision)
    return x + project(mlp, layer.down, precision)


@torch.no_grad()
def served_logits(lm: Dict, group: Callable[[str], Dict[str, torch.Tensor]],
                  seqs: Sequence[Dict], precisions: Sequence[str],
                  pages_int8: bool, device) -> List[List[torch.Tensor]]:
    """For each precision and each sequence (``ids``: the prompt and the
    served tokens but the last; ``prompt_len``), the f32 logits of the rows
    that served tokens: prompt_len - 1 onward. ``group(name)`` makes one
    weight group (see ``portbench.weights.lm_groups``)."""
    for p in precisions:
        if p not in PRECISIONS:
            raise ValueError(f"unknown precision {p}")
    slopes = (torch.tensor(alibi_slopes(lm["num_heads"]), device=device)
              if lm["positional"] == "alibi" else None)
    with exact_f32():
        table = group("lm.embed")["lm.embed_tokens.embedding"]
        hidden = [[table[torch.as_tensor(s["ids"], device=device).long()]
                   for s in seqs] for _ in precisions]
        del table
        for i in range(lm["num_hidden_layers"]):
            w = group(f"lm.layer{i}")
            for pi, p in enumerate(precisions):
                layer = Layer(w, f"lm.layers_{i}.", p)
                hidden[pi] = [block(x, layer, lm, s["prompt_len"], p,
                                    pages_int8, slopes)
                              for x, s in zip(hidden[pi], seqs)]
            del w
        w = group("lm.head")
        out = []
        for pi, p in enumerate(precisions):
            if lm["normhead"]:
                kernel = w["lm.lm_head_kernel"]
                kernel = kernel / kernel.norm(dim=0, keepdim=True)
                head = fp8_round(kernel, 0) if p == "fp8" else kernel
            else:
                head = prepare(w["lm.lm_head.kernel"], p)
            rows = []
            for x, s in zip(hidden[pi], seqs):
                n = rms_norm(x[s["prompt_len"] - 1:], w["lm.final_norm.scale"],
                             lm["rms_norm_eps"])
                rows.append(project(n, head, p))
            out.append(rows)
        return out
