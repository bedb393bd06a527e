"""The port's decoder against HF's ``LlamaForCausalLM`` on the card, layer
by layer: what ``chip_smoke.py``'s K1 logit check stands on.

HF's Llama is built from a config at Vicuna-7B's widths and depth with
random weights (seed 11, HF's init, std 0.02), converted by
``decoder_params_from_hf`` into the port's ``CausalLM`` (bf16 weights), and
both run 512 random ids. Printed, each as max |difference| of max |value|:
the hidden state after each layer, the logits, the port on B2 against the
port on ``mha_reference``, and HF in bf16 and the port against HF in f32
(the rounding noise of the model itself). ``--cast`` builds HF in f32 and casts it with ``.to(bfloat16)``,
which also rounds Llama's rotary ``inv_freq`` buffer (trap C29); without
it HF is built with bf16 as the default dtype, as ``from_pretrained``
builds it.

    python3 -m merlin_tpu_torch.utils.compare_hf_llama [--cast]
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch


def gap(a, b) -> float:
    return ((a.float() - b.float()).abs().max() / b.float().abs().max()
            ).item()


def main(argv=None) -> None:
    from transformers import LlamaConfig, LlamaForCausalLM

    from merlin_tpu_torch.models import decoder as dec
    from merlin_tpu_torch.models.convert import (
        decoder_params_from_hf, flat_state_dict)
    from merlin_tpu_torch.models.families import vicuna_7b
    from merlin_tpu_torch.ops.attention import mha_reference

    p = argparse.ArgumentParser()
    p.add_argument("--cast", action="store_true")
    args = p.parse_args(argv)
    cfg = dataclasses.replace(vicuna_7b(), vocab_size=32003)
    n = cfg.num_layers
    torch.manual_seed(11)
    if not args.cast:
        torch.set_default_dtype(torch.bfloat16)
    with torch.device("cuda"):
        hf = LlamaForCausalLM(LlamaConfig(
            vocab_size=32003, hidden_size=4096, intermediate_size=11008,
            num_hidden_layers=n, num_attention_heads=32,
            num_key_value_heads=32, max_position_embeddings=4096,
            rms_norm_eps=1e-5, tie_word_embeddings=False))
    torch.set_default_dtype(torch.float32)
    if args.cast:
        hf = hf.to(torch.bfloat16)
    hf.eval()
    print("buffers", {k: b.dtype for k, b in hf.named_buffers()}, flush=True)
    with torch.device("meta"):
        lm = dec.CausalLM(cfg)
    lm.load_state_dict({k: v.to(torch.bfloat16) for k, v in flat_state_dict(
        decoder_params_from_hf(hf.state_dict(), cfg)).items()},
        assign=True, strict=True)
    lm.eval()
    ids = torch.from_numpy(np.random.default_rng(10).integers(
        10, 32000, size=(1, 512))).cuda()
    ids[0, 0] = 1
    outs = {}
    hooks = [getattr(lm, f"layers_{i}").register_forward_hook(
        lambda m, a, o, i=i: outs.__setitem__(i, o)) for i in range(n)]
    with torch.no_grad():
        theirs = hf(ids, output_hidden_states=True)
        ours, _ = lm(ids)
        for i in range(n - 1):
            print(f"after layer {i}: "
                  f"{gap(outs[i], theirs.hidden_states[i + 1]):.3e}")
        agree = (ours.argmax(-1) == theirs.logits.argmax(-1)).float()
        print(f"logits: {gap(ours, theirs.logits):.4e} of max |logit| "
              f"{theirs.logits.float().abs().max().item():.3f}; argmax "
              f"agrees at {agree.mean().item():.3f} of the positions")
        dispatch = dec.dispatch_attention
        dec.dispatch_attention = lambda q, k, v, **kw: mha_reference(
            q, k, v, **kw)
        plain, _ = lm(ids)
        dec.dispatch_attention = dispatch
        print(f"port B2 vs port mha_reference: {gap(ours, plain):.4e}; "
              f"port mha_reference vs HF: {gap(plain, theirs.logits):.4e}")
        for h in hooks:
            h.remove()
        del lm, outs, plain
        torch.cuda.empty_cache()
        exact = hf.float()(ids).logits
        print(f"HF bf16 vs HF f32: {gap(theirs.logits, exact):.4e}; port "
              f"bf16 vs HF f32: {gap(ours, exact):.4e}", flush=True)


if __name__ == "__main__":
    main()
