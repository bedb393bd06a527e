"""The yardstick: the chip's peaks and the operations and bytes that the
served work needs, from the configuration's widths alone.

Peaks are NVIDIA's data sheet for one H100 SXM (dense, no sparsity):
989 TFLOP/s in bf16, 3.35 TB/s of HBM3. A roofline share is the least time
the chip could take for the work (the larger of its operations over the
peak rate and its bytes over the peak bandwidth) over the device time the
kernel took. Model FLOPs count what the tokens need: the projections and
the head once per token that needs them (a prefill needs the head for its
last position only), and attention over the keys each query sees. Nothing
recomputed, nothing padded.
"""

from __future__ import annotations

from typing import Dict

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12


def layer_matmul_params(lm: Dict) -> int:
    """Weights one token multiplies in one decoder layer."""
    e, h, d = lm["hidden_size"], lm["num_heads"], lm["head_dim"]
    hkv, inter = lm["num_kv_heads"], lm["intermediate_size"]
    return e * h * d * 2 + e * hkv * d * 2 + 3 * e * inter


def token_flops(lm: Dict, tokens: int, head_rows: int) -> float:
    """The projections of ``tokens`` tokens in every layer and the head on
    ``head_rows`` of them (2 FLOPs a multiply-add)."""
    return 2.0 * (lm["num_hidden_layers"] * layer_matmul_params(lm) * tokens
                  + lm["hidden_size"] * lm["vocab_size"] * head_rows)


def attention_flops(lm: Dict, pairs: float) -> float:
    """q.k and p.v over ``pairs`` (query, key) pairs in every layer."""
    return 4.0 * lm["num_heads"] * lm["head_dim"] \
        * lm["num_hidden_layers"] * pairs


def causal_pairs(n: int) -> float:
    return n * (n + 1) / 2.0


def prefill_flops(lm: Dict, prompt_len: int) -> float:
    return token_flops(lm, prompt_len, 1) \
        + attention_flops(lm, causal_pairs(prompt_len))


def decode_flops(lm: Dict, context: int) -> float:
    """One decode token whose query sees ``context`` keys (itself too)."""
    return token_flops(lm, 1, 1) + attention_flops(lm, context)


def kv_bytes(lm: Dict, keys: int, value_bytes: float) -> float:
    """K and V of ``keys`` cached tokens in every layer. int8 pages add a
    4-byte scale per token and kv head for each of K and V."""
    per_head = lm["head_dim"] * value_bytes + (4 if value_bytes == 1 else 0)
    return 2.0 * lm["num_hidden_layers"] * lm["num_kv_heads"] \
        * per_head * keys


def bound_s(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES)


# device operations by a piece of their name (the families of the port's
# own profiles): cuBLAS's matrix products, and the dtype casts that feed
# them (f32 leaves to bf16 at each use, int8 weights to bf16)
GEMM_KEYS = ("gemm", "nvjet", "xmma", "cutlass")
CAST_KEYS = ("direct_copy_kernel", "bfloat16_copy_kernel")
PAGED_ROWS_KEYS = ("paged_rows_kernel",)
FLASH_FWD_KEYS = ("flash_attention_fwd_kernel",)
