"""Mixed-precision policy (counterpart of ``merlin_tpu/core/precision.py``).

Params in float32, compute in bfloat16, and softmax/normalization
statistics and the loss in float32. The JAX package gets f32 accumulation
from ``preferred_element_type=float32`` on its matmuls; on the card a bf16
matmul accumulates in f32 inside the tensor cores the same way.

TF32 is switched off explicitly, for matmuls and for cuDNN convolutions:
an f32 model on the card must compute in full f32 so that it can be held
against the JAX reference, and cuDNN's default (TF32 on) would keep only
about three decimal digits in every f32 convolution.
"""

from __future__ import annotations

import dataclasses

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


@dataclasses.dataclass(frozen=True)
class Policy:
    param_dtype: torch.dtype = torch.float32
    compute_dtype: torch.dtype = torch.bfloat16
    # dtype for numerically sensitive reductions (norms, softmax, loss)
    reduce_dtype: torch.dtype = torch.float32

    def cast_to_compute(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.compute_dtype)

    def cast_to_reduce(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.reduce_dtype)


DEFAULT_POLICY = Policy()
FULL_PRECISION = Policy(compute_dtype=torch.float32)
HALF_PARAMS = Policy(param_dtype=torch.bfloat16)
