"""Checkpoint conversion for the port (counterpart of
``merlin_tpu/models/convert.py``): int8 weight-only quantization of a
decoder's ``state_dict``.
"""

from __future__ import annotations

from typing import Dict

import torch

# modules whose kernels quantize for int8 weight-only serving, mapped to the
# number of CONTRACTION (input) axes of their kernel; the remaining trailing
# axes are output channels, one scale each (convert.py:101-103). CLIP's MLP
# uses the names fc1/fc2 too: only the decoder's state is ever quantized.
_Q8_KERNELS = {"q_proj": 1, "k_proj": 1, "v_proj": 1, "o_proj": 2,
               "gate_proj": 1, "up_proj": 1, "down_proj": 1,
               "fc1": 1, "fc2": 1, "lm_head": 1}


@torch.no_grad()
def quantize_decoder_params_int8(state_dict: Dict[str, torch.Tensor],
                                 prefix: str = "") -> Dict[str, torch.Tensor]:
    """A decoder's ``state_dict`` -> the ``weight_dtype="int8"`` one.

    Per-output-channel symmetric absmax quantization (convert.py:130-184):
    each ``<module>.kernel`` of a module named in ``_Q8_KERNELS`` becomes
    ``kernel_q8`` (int8, rint of kernel / scale, clipped to +-127) and
    ``kernel_scale`` (f32 over the output dims: max |kernel| / 127, floored
    at 1e-12). Embeddings, norms and biases pass through as they are.

    Only the entries under ``prefix`` are the decoder's: pass an MMGPT's
    whole ``state_dict`` with ``prefix="lm."`` so that the vision tower
    (whose MLP also has fc1/fc2) passes through untouched, as JAX quantizes
    only the LM subtree (``serve/worker.py:410-413``). Tensors stay on their
    device and are converted one kernel at a time, so the peak is the
    source, its int8 copy and one kernel in f32.
    """
    if not prefix and any(name.startswith("lm.") for name in state_dict):
        raise ValueError("an MMGPT state_dict: pass prefix='lm.' so that the "
                         "vision tower is left alone")
    out = {}
    for name, tensor in state_dict.items():
        module, _, leaf = name.rpartition(".")
        n_contract = _Q8_KERNELS.get(module.rpartition(".")[2])
        if not name.startswith(prefix) or leaf != "kernel" \
                or n_contract is None:
            out[name] = tensor
            continue
        k = tensor.float()
        axes = tuple(range(n_contract))
        scale = torch.clamp(k.abs().amax(dim=axes, keepdim=True) / 127.0,
                            min=1e-12)
        out[f"{module}.kernel_q8"] = torch.clamp(
            torch.round(k / scale), -127, 127).to(torch.int8)
        out[f"{module}.kernel_scale"] = scale.reshape(
            scale.shape[n_contract:])
        del k
    return out
