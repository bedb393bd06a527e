"""The plain reference against the port at narrow widths on the CPU: a
no-cache f32 forward of the port's decoder (RoPE + NormHead, ALiBi, int8
weights) on the same weights; the int8 pages' quantiser; the lower
precisions reading farther from the f32 reference than the port does; and
bf16 leaves, the rounding of the f32 draw, as the check hands them to the
reference."""

from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import weights
from portbench.families import dense
from portbench.reference import model as ref

WIDTHS = {"hidden_size": 48, "intermediate_size": 96, "num_hidden_layers": 2,
          "num_kv_heads": None, "vocab_size": 300, "rms_norm_eps": 1e-6,
          "rope_theta": 10000.0}


def widths(heads, positional, normhead):
    lm = dict(WIDTHS, num_heads=heads, num_kv_heads=heads,
              head_dim=48 // heads, positional=positional,
              normhead=normhead)
    return lm


def port_model(lm, weight_dtype="bf16"):
    from merlin_tpu_torch.models.decoder import CausalLM, DecoderConfig

    cfg = DecoderConfig(
        vocab_size=lm["vocab_size"], hidden_size=lm["hidden_size"],
        intermediate_size=lm["intermediate_size"],
        num_layers=lm["num_hidden_layers"], num_heads=lm["num_heads"],
        max_position_embeddings=512, positional=lm["positional"],
        norm_eps=lm["rms_norm_eps"], normhead=lm["normhead"],
        dtype=torch.float32)
    with torch.device("meta"):
        m = CausalLM(cfg)
    return m, cfg


def seed_state(lm, seed):
    groups = dense.groups(lm)
    state = {}
    for g, leaves in groups.items():
        state.update(weights.make_group(seed, g, leaves, "cpu"))
    return groups, {k[len("lm."):]: v for k, v in state.items()}


def ref_rows(lm, groups, seed, ids, prompt_len, precision="f32"):
    def group(name):
        return weights.make_group(seed, name, groups[name], "cpu")
    return ref.served_logits(lm, group, [{"ids": ids, "prompt_len":
                                          prompt_len}], [precision], False,
                             "cpu")[0][0]


@pytest.mark.parametrize("heads,positional,normhead", [
    (4, "rope", True), (6, "alibi", False)])
def test_reference_matches_the_port_at_f32(heads, positional, normhead):
    lm = widths(heads, positional, normhead)
    groups, state = seed_state(lm, 11)
    model, _ = port_model(lm)
    model.load_state_dict(state, strict=True, assign=True)
    ids = np.random.default_rng(0).integers(0, 300, size=37)
    with torch.no_grad():
        logits, _ = model(torch.as_tensor(ids)[None])
    rows = ref_rows(lm, groups, 11, ids, 20)
    want = logits[0, 19:].float()
    assert rows.shape == want.shape
    assert torch.allclose(rows, want, atol=2e-4, rtol=1e-4), \
        (rows - want).abs().max()


def test_reference_int8_weights_match_the_ports_quantiser():
    from merlin_tpu_torch.models.convert import quantize_decoder_params_int8

    lm = widths(4, "alibi", False)
    groups, state = seed_state(lm, 12)
    model, cfg = port_model(lm)
    with torch.device("meta"):
        from merlin_tpu_torch.models.decoder import CausalLM
        q8 = CausalLM(dataclasses.replace(cfg, weight_dtype="int8"))
    q8.load_state_dict(quantize_decoder_params_int8(state), strict=True,
                       assign=True)
    ids = np.random.default_rng(1).integers(0, 300, size=29)
    with torch.no_grad():
        logits, _ = q8(torch.as_tensor(ids)[None])
    rows = ref_rows(lm, groups, 12, ids, 10, "int8")
    assert torch.allclose(rows, logits[0, 9:].float(), atol=2e-4, rtol=1e-4)
    # and they are not the f32 weights' logits
    f32 = ref_rows(lm, groups, 12, ids, 10, "f32")
    assert (rows - f32).abs().max() > 1e-3


def test_reference_int8_pages_match_the_ports_page_quantiser():
    from merlin_tpu_torch.ops.paged_attention import (
        dequantize_pages, quantize_pages)

    x = torch.randn(3, 16, 2 * 8, generator=torch.Generator().manual_seed(0))
    values, scales = quantize_pages(x, 8)
    port = dequantize_pages(values, scales, 8, dtype=torch.float32)
    mine = ref.kv_int8(x.reshape(3, 16, 2, 8)).reshape(3, 16, 16)
    assert torch.allclose(port, mine, atol=1e-6)


def test_lower_precisions_read_farther_than_f32():
    lm = widths(4, "rope", True)
    groups, _ = seed_state(lm, 13)
    ids = np.random.default_rng(2).integers(0, 300, size=40)
    f32 = ref_rows(lm, groups, 13, ids, 8)
    err = {p: (ref_rows(lm, groups, 13, ids, 8, p) - f32).abs().max()
           for p in ("int8", "fp8", "int4")}
    assert 0 < err["int8"] < err["fp8"] and err["int8"] < err["int4"]


def test_bf16_leaves_are_the_rounding_of_the_f32_draw():
    """``"weights": "bf16"``: every leaf of every group is the bf16 rounding
    of what ``"f32"`` gives for the same seed; the check's reference reads
    those values back in f32."""
    from portbench import check

    assert weights.leaf_dtype({"weights": "bf16"}) == torch.bfloat16
    assert weights.leaf_dtype({"weights": "f32"}) == torch.float32
    assert weights.leaf_dtype({"weights": "int8"}) == torch.float32
    lm = widths(4, "rope", True)
    for g, leaves in dense.groups(lm).items():
        f32 = weights.make_group(21, g, leaves, "cpu")
        bf16 = weights.make_group(21, g, leaves, "cpu", torch.bfloat16)
        assert list(bf16) == list(f32)
        for name, t in f32.items():
            assert t.dtype == torch.float32
            assert bf16[name].dtype == torch.bfloat16
            assert torch.equal(bf16[name], t.to(torch.bfloat16)), name
    # the check hands the reference the leaves the program was handed
    seen = []

    def served_logits(lm, group, seqs, precisions, int8_pages, device):
        seen.append(group("lm.layer0"))
        return [[] for _ in precisions]

    family = SimpleNamespace(widths=lambda config: lm, groups=dense.groups,
                             served_logits=served_logits)
    for kind in ("f32", "bf16"):
        check.widest_gaps(family, {"weights": kind, "pages": "bf16"}, 21,
                          [], ["f32"], "cpu")
    f32, bf16 = seen
    for name, t in f32.items():
        assert bf16[name].dtype == torch.float32
        assert torch.equal(bf16[name], t.to(torch.bfloat16).float()), name
    assert any(not torch.equal(bf16[n], f32[n]) for n in f32)
