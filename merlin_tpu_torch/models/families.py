"""Named model-family configs (a copy of ``merlin_tpu/models/families.py``).

Each function returns a :class:`DecoderConfig`; :func:`tiny` is for tests.
``config_from_name`` reproduces the reference's name-substring dispatch.
"""

from __future__ import annotations

import dataclasses

import torch

from merlin_tpu_torch.models.decoder import DecoderConfig


def vicuna_7b(**kw) -> DecoderConfig:
    """Llama-1/2 7B geometry (Vicuna-7B-v1.5; the Merlin default LM)."""
    return DecoderConfig(
        vocab_size=32000, hidden_size=4096, intermediate_size=11008,
        num_layers=32, num_heads=32, max_position_embeddings=4096,
        positional="rope", norm="rms", norm_eps=1e-5, mlp="gated", **kw)


def vicuna_13b(**kw) -> DecoderConfig:
    return DecoderConfig(
        vocab_size=32000, hidden_size=5120, intermediate_size=13824,
        num_layers=40, num_heads=40, max_position_embeddings=4096,
        positional="rope", norm="rms", norm_eps=1e-5, mlp="gated", **kw)


def baichuan_7b(**kw) -> DecoderConfig:
    return DecoderConfig(
        vocab_size=64000, hidden_size=4096, intermediate_size=11008,
        num_layers=32, num_heads=32, max_position_embeddings=4096,
        positional="rope", norm="rms", norm_eps=1e-6, mlp="gated", **kw)


def baichuan_13b(**kw) -> DecoderConfig:
    """Baichuan-13B: ALiBi attention, no RoPE."""
    return DecoderConfig(
        vocab_size=64000, hidden_size=5120, intermediate_size=13696,
        num_layers=40, num_heads=40, max_position_embeddings=4096,
        positional="alibi", norm="rms", norm_eps=1e-6, mlp="gated", **kw)


def baichuan2_7b(**kw) -> DecoderConfig:
    """Baichuan2-7B: RoPE + NormHead + z-loss."""
    return DecoderConfig(
        vocab_size=125696, hidden_size=4096, intermediate_size=11008,
        num_layers=32, num_heads=32, max_position_embeddings=4096,
        positional="rope", norm="rms", norm_eps=1e-6, mlp="gated",
        normhead=True, z_loss_weight=2e-4, **kw)


def baichuan2_13b(**kw) -> DecoderConfig:
    """Baichuan2-13B: ALiBi + NormHead + z-loss."""
    return DecoderConfig(
        vocab_size=125696, hidden_size=5120, intermediate_size=13696,
        num_layers=40, num_heads=40, max_position_embeddings=4096,
        positional="alibi", norm="rms", norm_eps=1e-6, mlp="gated",
        normhead=True, z_loss_weight=2e-4, **kw)


def phi2(**kw) -> DecoderConfig:
    """Phi-2: partial rotary (0.4), parallel block, LayerNorm, gelu, biases."""
    return DecoderConfig(
        vocab_size=51200, hidden_size=2560, intermediate_size=10240,
        num_layers=32, num_heads=32, max_position_embeddings=2048,
        positional="rope", partial_rotary_factor=0.4, attention_bias=True,
        norm="ln", norm_eps=1e-5, mlp="gelu_new", parallel_block=True,
        lm_head_bias=True, **kw)


def opt_6_7b(**kw) -> DecoderConfig:
    return DecoderConfig(
        vocab_size=50272, hidden_size=4096, intermediate_size=16384,
        num_layers=32, num_heads=32, max_position_embeddings=2048,
        positional="learned", attention_bias=True, norm="ln", norm_eps=1e-5,
        mlp="relu", tie_word_embeddings=True, **kw)


def tiny(positional="rope", **kw) -> DecoderConfig:
    defaults = dict(
        vocab_size=128, hidden_size=32, intermediate_size=64,
        num_layers=2, num_heads=4, max_position_embeddings=128,
        positional=positional, dtype=torch.float32)
    defaults.update(kw)
    return DecoderConfig(**defaults)


FAMILY_BUILDERS = {
    "vicuna_7b": vicuna_7b,
    "vicuna_13b": vicuna_13b,
    "llama_7b": vicuna_7b,
    "baichuan_7b": baichuan_7b,
    "baichuan_13b": baichuan_13b,
    "baichuan2_7b": baichuan2_7b,
    "baichuan2_13b": baichuan2_13b,
    "phi2": phi2,
    "opt_6_7b": opt_6_7b,
}


def config_from_name(model_name_or_path: str, *,
                     model_max_length: int = 2048, **kw) -> DecoderConfig:
    """Name-substring dispatch, with the RoPE linear-scaling rewrite when
    the requested context exceeds max_position_embeddings."""
    name = model_name_or_path.lower()
    if "baichuan2" in name:
        cfg = baichuan2_13b(**kw) if "13b" in name else baichuan2_7b(**kw)
    elif "baichuan" in name:
        cfg = baichuan_13b(**kw) if "13b" in name else baichuan_7b(**kw)
    elif "phi" in name:
        cfg = phi2(**kw)
    elif "opt" in name:
        cfg = opt_6_7b(**kw)
    elif "13b" in name:
        cfg = vicuna_13b(**kw)
    else:
        cfg = vicuna_7b(**kw)

    if (cfg.positional == "rope"
            and model_max_length > cfg.max_position_embeddings):
        scale = model_max_length / cfg.max_position_embeddings
        cfg = dataclasses.replace(
            cfg, rope_linear_scale=scale,
            max_position_embeddings=model_max_length)
    return cfg
