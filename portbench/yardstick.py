"""The yardstick: the chip's peaks, the least time a piece of work could
take on it, and the pieces of name that sort device operations. The
operations and bytes the served work needs are counted by the
configuration's decoder family (``portbench/families``).

Peaks are NVIDIA's data sheet for one H100 SXM (dense, no sparsity):
989 TFLOP/s in bf16, 3.35 TB/s of HBM3. A roofline share is the least time
the chip could take for the work (the larger of its operations over the
peak rate and its bytes over the peak bandwidth) over the device time the
kernel took.
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def causal_pairs(n: int) -> float:
    """(query, key) pairs of ``n`` tokens attending causally to themselves."""
    return n * (n + 1) / 2.0


def bound_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES)


# device operations by a piece of their name (the families of the port's
# own profiles): cuBLAS's matrix products, and the dtype casts that feed
# them (f32 leaves to bf16 at each use, int8 weights to bf16)
GEMM_KEYS = ("gemm", "nvjet", "xmma", "cutlass")
CAST_KEYS = ("direct_copy_kernel", "bfloat16_copy_kernel")
PAGED_ROWS_KEYS = ("paged_rows_kernel",)
FLASH_FWD_KEYS = ("flash_attention_fwd_kernel",)
