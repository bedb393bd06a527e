"""The dense decoder family: Baichuan, Baichuan2 and their Llama-shaped
siblings (RMSNorm, RoPE or ALiBi, grouped kv heads where the file gives
``num_key_value_heads``, a SiLU-gated MLP, NormHead or a plain head), as
the port's ``config_from_name`` builds them. A configuration file without
a ``"family"`` key is of this family.

Work counts: the projections and the head once per token that needs them
(a prefill needs the head for its last position only), and attention over
the keys each query sees; nothing recomputed, nothing padded.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

from portbench.reference.model import served_logits  # noqa: F401
from portbench.weights import Leaf, init_of
from portbench.yardstick import causal_pairs


def widths(config: Dict) -> Dict:
    """The decoder's widths from a configuration file (published keys at
    the top; the multimodal tokens the entry adds to the vocabulary)."""
    heads = config["num_attention_heads"]
    return {
        "hidden_size": config["hidden_size"],
        "intermediate_size": config["intermediate_size"],
        "num_hidden_layers": config["num_hidden_layers"],
        "num_heads": heads,
        "num_kv_heads": config.get("num_key_value_heads", heads),
        "head_dim": config["hidden_size"] // heads,
        "vocab_size": config["vocab_size"] + config["mm_tokens"],
        "rms_norm_eps": config["rms_norm_eps"],
        "positional": config["positional"],
        "rope_theta": config.get("rope_theta", 10000.0),
        "normhead": config["normhead"],
    }


def groups(lm: Dict) -> Dict[str, List[Leaf]]:
    """The decoder's groups under the program's names (``lm.`` prefix):
    ``lm.embed``, ``lm.layer<i>``, ``lm.head`` (with the final norm)."""
    e, h, d = lm["hidden_size"], lm["num_heads"], lm["head_dim"]
    hkv, inter, v = lm["num_kv_heads"], lm["intermediate_size"], lm["vocab_size"]

    def leaves(names_shapes):
        return [(n, tuple(s), init_of(n, s)) for n, s in names_shapes]

    out = {"lm.embed": leaves([("lm.embed_tokens.embedding", (v, e))])}
    for i in range(lm["num_hidden_layers"]):
        p = f"lm.layers_{i}."
        out[f"lm.layer{i}"] = leaves([
            (p + "input_norm.scale", (e,)),
            (p + "attn.q_proj.kernel", (e, h, d)),
            (p + "attn.k_proj.kernel", (e, hkv, d)),
            (p + "attn.v_proj.kernel", (e, hkv, d)),
            (p + "attn.o_proj.kernel", (h, d, e)),
            (p + "post_attn_norm.scale", (e,)),
            (p + "mlp.gate_proj.kernel", (e, inter)),
            (p + "mlp.up_proj.kernel", (e, inter)),
            (p + "mlp.down_proj.kernel", (inter, e)),
        ])
    head = ("lm.lm_head_kernel" if lm["normhead"] else "lm.lm_head.kernel")
    out["lm.head"] = leaves([("lm.final_norm.scale", (e,)), (head, (e, v))])
    return out


def build_lm(config: Dict, lm: Dict, dtype):
    """``config_from_name`` as the worker's entry calls it, the vocabulary
    grown by the multimodal tokens as ``build_model_tokenizer`` grows it;
    refused where the port's widths are not the configuration's."""
    from merlin_tpu_torch.models.families import config_from_name

    build = config["build"]
    cfg = config_from_name(build["model_name_or_path"],
                           model_max_length=build["model_max_length"],
                           dtype=dtype)
    cfg = dataclasses.replace(cfg, vocab_size=lm["vocab_size"])
    mine = {"hidden_size": cfg.hidden_size, "num_heads": cfg.num_heads,
            "num_kv_heads": cfg.kv_heads, "head_dim": cfg.head_size,
            "intermediate_size": cfg.intermediate_size,
            "num_hidden_layers": cfg.num_layers, "normhead": cfg.normhead,
            "positional": cfg.positional, "rms_norm_eps": cfg.norm_eps}
    for key, value in mine.items():
        if lm[key] != value:
            raise ValueError(f"the port's {key} is {value}, the "
                             f"configuration's {lm[key]}")
    return cfg


def layer_matmul_params(lm: Dict) -> int:
    """Weights one token multiplies in one decoder layer."""
    e, h, d = lm["hidden_size"], lm["num_heads"], lm["head_dim"]
    hkv, inter = lm["num_kv_heads"], lm["intermediate_size"]
    return e * h * d * 2 + e * hkv * d * 2 + 3 * e * inter


def token_flops(lm: Dict, tokens: int, head_rows: int) -> float:
    """The projections of ``tokens`` tokens in every layer and the head on
    ``head_rows`` of them."""
    return 2.0 * (lm["num_hidden_layers"] * layer_matmul_params(lm) * tokens
                  + lm["hidden_size"] * lm["vocab_size"] * head_rows)


def pair_flops(lm: Dict, pairs: float) -> float:
    """q.k and p.v over ``pairs`` (query, key) pairs in every layer."""
    return 4.0 * lm["num_heads"] * lm["head_dim"] \
        * lm["num_hidden_layers"] * pairs


def attention_flops(lm: Dict, n: int) -> float:
    """A prompt of ``n`` tokens attending causally to itself."""
    return pair_flops(lm, causal_pairs(n))


def prefill_flops(lm: Dict, n: int) -> float:
    return token_flops(lm, n, 1) + attention_flops(lm, n)


def decode_flops(lm: Dict, context: int) -> float:
    """One decode token whose query sees ``context`` keys (itself too)."""
    return token_flops(lm, 1, 1) + pair_flops(lm, context)


def kv_bytes(lm: Dict, keys: int, value_bytes: float) -> float:
    """K and V of ``keys`` cached tokens in every layer. int8 pages add a
    4-byte scale per token and kv head for each of K and V."""
    per_head = lm["head_dim"] * value_bytes + (4 if value_bytes == 1 else 0)
    return 2.0 * lm["num_hidden_layers"] * lm["num_kv_heads"] \
        * per_head * keys


def decode_rows_bytes(lm: Dict) -> int:
    """One decode token's q and output rows (bf16) in every layer."""
    return 2 * lm["num_heads"] * lm["head_dim"] * 2 * lm["num_hidden_layers"]
