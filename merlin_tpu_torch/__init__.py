"""PyTorch/CUDA port of merlin_tpu for NVIDIA Hopper (H100).

Mirrors ``merlin_tpu``'s layout (``core/``, ``ops/``, ``models/``,
``generate/``, ``serve/``) so each module has an obvious counterpart.
Imports torch, numpy and the standard library only: nothing of JAX and
nothing of ``merlin_tpu``. Every Pallas kernel on the ported path has a hand-written
CUDA C++ kernel for ``sm_90a`` under ``csrc/``, built on first use by
:mod:`merlin_tpu_torch.ops._build`, with a plain PyTorch version beside it
that runs only for tensors on the CPU.
"""

from merlin_tpu_torch.core import precision as _precision  # noqa: F401
