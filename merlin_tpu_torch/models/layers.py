"""Shared building blocks (counterpart of ``merlin_tpu/models/layers.py``).

Parameter names and layouts follow the flax modules exactly (``kernel`` in
(in..., out...) order, ``scale``/``bias``/``embedding``), so a flax param
tree maps onto a ``state_dict`` by joining its path with '.'
(:mod:`merlin_tpu_torch.models.bridge`). Numerics: norms in float32,
matmuls in the module's compute dtype with an f32 result, to which the
int8 scale and the bias are applied before ONE rounding to the compute
dtype, as JAX's ``preferred_element_type=float32`` order does.

Parameters start as N(0, 0.02) (norm scales 1, biases 0); real weights come
from ``load_state_dict`` or :func:`~merlin_tpu_torch.models.bridge.init_params`.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

Shape = Union[int, Sequence[int]]


def _tuple(x: Shape) -> Tuple[int, ...]:
    return (x,) if isinstance(x, int) else tuple(x)


def normal_param(shape: Shape, std: float = 0.02) -> nn.Parameter:
    return nn.Parameter(torch.empty(_tuple(shape)).normal_(0.0, std))


class RMSNorm(nn.Module):
    """Root-mean-square norm, f32 statistics."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        var = x32.square().mean(dim=-1, keepdim=True)
        norm = x32 * torch.rsqrt(var + self.eps)
        return (norm * self.scale).to(x.dtype)


class LayerNorm(nn.Module):
    """Layer norm with bias, f32 statistics."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mean = x32.mean(dim=-1, keepdim=True)
        var = (x32 - mean).square().mean(dim=-1, keepdim=True)
        norm = (x32 - mean) * torch.rsqrt(var + self.eps)
        return (norm * self.scale + self.bias).to(x.dtype)


class MatmulF32(torch.autograd.Function):
    """a @ b of 2-d operands in the compute dtype with an f32 result
    (products exact, f32 sums), and no rounding to the compute dtype.

    The forward is ``torch.mm(..., out_dtype=torch.float32)`` on the card
    (an overload with no derivative of its own) and the f32 matmul of the
    upcast operands on the CPU. The backward returns da and db in the
    operands' dtypes, as JAX's transpose of a bf16 ``dot_general`` with
    ``preferred_element_type=float32`` does: the f32 cotangent is contracted
    with the other operand and the result rounded once. On the CPU that
    contraction runs in f32; on the card the cotangent is rounded to the
    compute dtype first so that both products stay on the tensor cores
    (trap C13: one extra rounding of the cotangent).
    """

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        if a.dtype == torch.float32:
            return a @ b
        if a.device.type == "cpu":
            # the CPU build has no kernel for mm's out_dtype overload
            return a.float() @ b.float()
        return torch.mm(a, b, out_dtype=torch.float32)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        if a.dtype == torch.float32 or a.device.type == "cpu":
            g = g.float()
            da = (g @ b.float().T).to(a.dtype) if ctx.needs_input_grad[0] \
                else None
            db = (a.float().T @ g).to(b.dtype) if ctx.needs_input_grad[1] \
                else None
            return da, db
        g = g.to(a.dtype)
        da = g @ b.T if ctx.needs_input_grad[0] else None
        db = a.T @ g if ctx.needs_input_grad[1] else None
        return da, db


def _inference_only(grad):
    """Tensor hook on an int8 layer's output: the int8 kernels are for
    serving, so a gradient reaching it raises."""
    raise RuntimeError("DenseGeneral(weight_q8=True) is inference-only: "
                       "it has no gradient")


class DenseGeneral(nn.Module):
    """Dense layer contracting the trailing ``len(in_shape)`` axes of x with
    a kernel of shape ``in_shape + features`` (the flax layout).

    ``weight_q8=True`` holds the kernel as int8 ``kernel_q8`` with a
    per-output-channel f32 ``kernel_scale`` (weight-only quantization for
    serving, ``merlin_tpu/models/layers.py:70-138``): y = (x @ q8) * scale
    (+ bias), exactly x @ (q8 * scale), rounded once. Build the weights
    with :func:`merlin_tpu_torch.models.convert.quantize_decoder_params_int8`.
    The int8 kernel is for inference: a gradient asked of its output
    raises.
    """

    def __init__(self, in_shape: Shape, features: Shape, *,
                 use_bias: bool = False, dtype: torch.dtype = torch.bfloat16,
                 weight_q8: bool = False):
        super().__init__()
        self.in_shape = _tuple(in_shape)
        self.features = _tuple(features)
        self.dtype = dtype
        self.weight_q8 = weight_q8
        if weight_q8:
            self.kernel_q8 = nn.Parameter(
                torch.zeros(self.in_shape + self.features, dtype=torch.int8),
                requires_grad=False)
            self.kernel_scale = nn.Parameter(torch.ones(self.features))
        else:
            self.kernel = normal_param(self.in_shape + self.features)
        self.bias = (nn.Parameter(torch.zeros(self.features))
                     if use_bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n_in = len(self.in_shape)
        batch = x.shape[:x.dim() - n_in]
        k_in = math.prod(self.in_shape)
        k_out = math.prod(self.features)
        x2 = x.to(self.dtype).reshape(-1, k_in)
        if self.weight_q8:
            out = MatmulF32.apply(
                x2, self.kernel_q8.to(self.dtype).reshape(k_in, k_out))
            out = out * self.kernel_scale.float().reshape(k_out)
            if out.requires_grad:
                out.register_hook(_inference_only)
        else:
            out = MatmulF32.apply(
                x2, self.kernel.to(self.dtype).reshape(k_in, k_out))
        if self.bias is not None:
            out = out + self.bias.float().reshape(k_out)
        return out.to(self.dtype).reshape(batch + self.features)


class Embed(nn.Module):
    """Token embedding with an optional tied decode (``attend``).

    Out-of-range ids (trap C3) give NaN rows, as ``jnp.take`` fills them in
    the JAX package, instead of raising: on the card an index error would be
    a device assert that kills the context, and a host-side check would
    cost a sync per decode step. Negative ids in [-V, 0) wrap, as in JAX.
    """

    def __init__(self, num_embeddings: int, features: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.embedding = normal_param((num_embeddings, features))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        n = self.embedding.shape[0]
        idx = torch.where(ids < 0, ids + n, ids)
        oob = (idx < 0) | (idx >= n)
        rows = F.embedding(idx.clamp(0, n - 1), self.embedding).to(self.dtype)
        return torch.where(oob[..., None], float("nan"), rows)

    def attend(self, x: torch.Tensor) -> torch.Tensor:
        """Tied decode: hidden @ embedding^T -> f32 logits."""
        # operands in the compute dtype, f32 products and sums
        return x.to(self.dtype).float() @ self.embedding.to(self.dtype).float().T


# ---------------------------------------------------------------------------
# Rotary position embeddings (linear scaling + partial rotary)
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float = 10000.0,
                     rotary_dim: Optional[int] = None,
                     device=None) -> torch.Tensor:
    """Inverse frequencies (rotary_dim/2,) f32."""
    rotary_dim = rotary_dim or head_dim
    exponent = torch.arange(0, rotary_dim, 2, dtype=torch.float32,
                            device=device) / rotary_dim
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *,
               theta: float = 10000.0, linear_scale: float = 1.0,
               rotary_dim: Optional[int] = None) -> torch.Tensor:
    """Rotate q or k. x: (b, s, h, d); positions: (b, s) int.

    Half-split convention (HF Llama): [x1, x2] -> [x1*cos - x2*sin,
    x2*cos + x1*sin]; only the first ``rotary_dim`` channels rotate
    (Phi-2 partial rotary); position / ``linear_scale`` stretches context.
    """
    d = x.shape[-1]
    rotary_dim = rotary_dim or d
    inv_freq = rope_frequencies(d, theta, rotary_dim, device=x.device)
    pos = positions.float() / linear_scale
    angles = pos[..., None] * inv_freq[None, None, :]        # (b, s, rd/2)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x_rot = x[..., :rotary_dim].float()
    half = rotary_dim // 2
    x1, x2 = x_rot[..., :half], x_rot[..., half:]
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                        dim=-1).to(x.dtype)
    if rotary_dim == d:
        return rotated
    return torch.cat([rotated, x[..., rotary_dim:]], dim=-1)


# ---------------------------------------------------------------------------
# ALiBi
# ---------------------------------------------------------------------------

def alibi_slopes(num_heads: int, device=None) -> torch.Tensor:
    """Standard ALiBi slopes (Press et al.), geometric in 2^(-8/n), with the
    non-power-of-two interleave rule."""
    def pow2_slopes(n):
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return [start * (start ** i) for i in range(n)]

    if math.log2(num_heads).is_integer():
        slopes = pow2_slopes(num_heads)
    else:
        closest = 2 ** math.floor(math.log2(num_heads))
        slopes = pow2_slopes(closest)
        slopes = slopes + pow2_slopes(2 * closest)[0::2][: num_heads - closest]
    return torch.tensor(slopes, dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class GatedMLP(nn.Module):
    """SiLU-gated MLP (Llama/Baichuan): down(silu(gate(x)) * up(x))."""

    def __init__(self, dim: int, intermediate: int,
                 dtype: torch.dtype = torch.bfloat16, weight_q8: bool = False):
        super().__init__()
        kw = dict(dtype=dtype, weight_q8=weight_q8)
        self.gate_proj = DenseGeneral(dim, intermediate, **kw)
        self.up_proj = DenseGeneral(dim, intermediate, **kw)
        self.down_proj = DenseGeneral(intermediate, dim, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class SimpleMLP(nn.Module):
    """Two-layer MLP with biases and a configurable activation (Phi-2
    gelu_new, OPT relu, CLIP quick_gelu)."""

    def __init__(self, dim: int, intermediate: int,
                 activation: str = "gelu_new",
                 dtype: torch.dtype = torch.bfloat16, weight_q8: bool = False):
        super().__init__()
        if activation not in ("gelu_new", "gelu", "quick_gelu", "relu"):
            raise ValueError(f"unknown activation {activation}")
        self.activation = activation
        kw = dict(use_bias=True, dtype=dtype, weight_q8=weight_q8)
        self.fc1 = DenseGeneral(dim, intermediate, **kw)
        self.fc2 = DenseGeneral(intermediate, dim, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.fc1(x)
        if self.activation == "gelu_new":
            h = F.gelu(h, approximate="tanh")
        elif self.activation == "gelu":
            h = F.gelu(h)
        elif self.activation == "quick_gelu":
            h = quick_gelu(h)
        else:
            h = F.relu(h)
        return self.fc2(h)
