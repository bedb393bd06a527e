"""The port's checkpoint reader and decoder converter against the JAX
package on the CPU (``merlin_tpu_torch/models/convert.py``).

  * ``decoder_params_from_hf`` for every family: llama (GQA), phi and opt
    from tiny HF models built from config objects, baichuan from a
    hand-made ``W_pack`` state dict (with and without NormHead). The port's
    tree, flattened, equals ``params_from_flax`` of JAX's tree leaf for
    leaf, exactly; the logits at f32 agree with JAX's to 1e-5 and with
    HF's to 2e-4 / 3e-4 (atol; rtol 2e-3), the JAX package's own HF
    tolerances.
  * ``load_torch_state_dict`` on a single ``.bin``, a single
    ``.safetensors``, sharded ``.bin`` and safetensors indexes and a
    directory scan that skips ``training_args``: the same names and f32
    values as JAX's loader, exactly. bf16 safetensors (which JAX's numpy
    route cannot read) load on the port side as the exact f32 upcast.

Nothing is fetched: every model is built in code with random weights.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from merlin_tpu.models import convert as jconv
from merlin_tpu.models.decoder import CausalLM as JCausalLM
from merlin_tpu.models.families import tiny as j_tiny

from merlin_tpu_torch.models import convert as tconv
from merlin_tpu_torch.models.bridge import params_from_flax
from merlin_tpu_torch.models.decoder import CausalLM
from merlin_tpu_torch.models.families import tiny

V = 128


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _llama():
    from transformers import LlamaConfig, LlamaForCausalLM

    torch.manual_seed(0)
    hf = LlamaForCausalLM(LlamaConfig(
        vocab_size=V, hidden_size=32, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=64, rms_norm_eps=1e-6,
        attention_bias=False)).eval()
    return hf, dict(num_kv_heads=2)


def _phi():
    from transformers import PhiConfig, PhiForCausalLM

    torch.manual_seed(0)
    hf = PhiForCausalLM(PhiConfig(
        vocab_size=V, hidden_size=32, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=4,
        max_position_embeddings=64, partial_rotary_factor=0.5,
        layer_norm_eps=1e-5, attn_pdrop=0.0, resid_pdrop=0.0,
        embd_pdrop=0.0)).eval()
    return hf, dict(norm="ln", norm_eps=1e-5, mlp="gelu_new",
                    parallel_block=True, attention_bias=True,
                    lm_head_bias=True, partial_rotary_factor=0.5)


def _opt():
    from transformers import OPTConfig, OPTForCausalLM

    torch.manual_seed(0)
    hf = OPTForCausalLM(OPTConfig(
        vocab_size=V, hidden_size=32, ffn_dim=64, num_hidden_layers=2,
        num_attention_heads=4, max_position_embeddings=64,
        do_layer_norm_before=True, word_embed_proj_dim=32,
        dropout=0.0)).eval()
    return hf, dict(positional="learned", norm="ln", norm_eps=1e-5,
                    mlp="relu", attention_bias=True,
                    tie_word_embeddings=True, max_position_embeddings=64)


def _baichuan_sd(cfg, rng):
    """Baichuan layout: the fused W_pack QKV (3H, H), a bare lm_head."""
    H, I = cfg.hidden_size, cfg.intermediate_size

    def r(*shape):
        return torch.from_numpy(rng.normal(scale=0.05, size=shape).astype(
            np.float32))

    sd = {"model.embed_tokens.weight": r(V, H), "model.norm.weight": r(H),
          "lm_head.weight": r(V, H)}
    for i in range(cfg.num_layers):
        lb = f"model.layers.{i}."
        sd.update({lb + "self_attn.W_pack.weight": r(3 * H, H),
                   lb + "self_attn.o_proj.weight": r(H, H),
                   lb + "mlp.gate_proj.weight": r(I, H),
                   lb + "mlp.up_proj.weight": r(I, H),
                   lb + "mlp.down_proj.weight": r(H, I),
                   lb + "input_layernorm.weight": 1 + r(H),
                   lb + "post_attention_layernorm.weight": 1 + r(H)})
    return sd


def _ids(seed):
    return np.random.default_rng(seed).integers(1, V, size=(2, 12))


def _both(sd, kw, family):
    """JAX's and the port's converted trees, and their logits at f32."""
    jcfg, tcfg = j_tiny(**kw), tiny(**kw)
    jtree = jconv.decoder_params_from_hf(sd, jcfg, family=family)
    ttree = tconv.decoder_params_from_hf(sd, tcfg, family=family)
    want = params_from_flax(jtree)
    got = tconv.flat_state_dict(ttree)
    return jcfg, tcfg, jtree, want, got


def _assert_same_leaves(got, want):
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        assert got[name].dtype == torch.float32, name
        assert torch.equal(got[name], w), name


@pytest.mark.parametrize("family,build", [("llama", _llama), ("phi", _phi),
                                          ("opt", _opt)])
def test_hf_decoder_converts_like_jax_and_runs_like_hf(family, build):
    hf, kw = build()
    sd = hf.state_dict()
    jcfg, tcfg, jtree, want, got = _both(sd, kw, family)
    _assert_same_leaves(got, want)

    ids = _ids(len(family))
    model = CausalLM(tcfg)
    model.load_state_dict(got, strict=True)
    with torch.no_grad():
        ours = model(torch.from_numpy(ids))[0].numpy()
        theirs = hf(torch.from_numpy(ids)).logits.numpy()
    jl, _ = JCausalLM(jcfg).apply({"params": jax.tree.map(jnp.asarray,
                                                          jtree)},
                                  jnp.asarray(ids))
    np.testing.assert_allclose(ours, np.asarray(jl), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(ours, theirs,
                               atol=2e-4 if family == "llama" else 3e-4,
                               rtol=2e-3)


@pytest.mark.parametrize("normhead", [False, True], ids=["head", "normhead"])
def test_baichuan_w_pack_splits_like_jax(normhead):
    kw = dict(normhead=normhead)
    sd = _baichuan_sd(tiny(**kw), np.random.default_rng(4))
    jcfg, tcfg, jtree, want, got = _both(sd, kw, "baichuan")
    _assert_same_leaves(got, want)
    H = tcfg.hidden_size
    assert ("lm_head_kernel" in got) == normhead
    assert ("lm_head.kernel" in got) != normhead
    # q's kernel is the first H rows of W_pack, transposed
    np.testing.assert_array_equal(
        got["layers_0.attn.q_proj.kernel"].reshape(H, H).numpy(),
        sd["model.layers.0.self_attn.W_pack.weight"][:H].T.numpy())
    ids = _ids(7)
    model = CausalLM(tcfg)
    model.load_state_dict(got, strict=True)
    with torch.no_grad():
        ours = model(torch.from_numpy(ids))[0].numpy()
    jl, _ = JCausalLM(jcfg).apply({"params": jax.tree.map(jnp.asarray,
                                                          jtree)},
                                  jnp.asarray(ids))
    np.testing.assert_allclose(ours, np.asarray(jl), atol=1e-5, rtol=1e-5)


def test_missing_key_names_the_candidates():
    hf, kw = _llama()
    sd = dict(hf.state_dict())
    del sd["model.layers.1.mlp.up_proj.weight"]
    with pytest.raises(KeyError, match="up_proj"):
        tconv.decoder_params_from_hf(sd, tiny(**kw), family="llama")
    with pytest.raises(ValueError, match="unknown family"):
        tconv.decoder_params_from_hf(hf.state_dict(), tiny(**kw),
                                     family="gpt2")


# ---------------------------------------------------------------------------
# load_torch_state_dict
# ---------------------------------------------------------------------------

def _sd(rng):
    return {f"block.{i}.weight": torch.from_numpy(
        rng.normal(size=(3 + i, 4)).astype(np.float32)) for i in range(5)}


def _write(path, layout, sd):
    """``sd`` on disk in one of the layouts HF saves."""
    from safetensors.torch import save_file

    os.makedirs(path, exist_ok=True)
    keys = sorted(sd)
    if layout == "bin":
        torch.save(sd, os.path.join(path, "pytorch_model.bin"))
        return os.path.join(path, "pytorch_model.bin")
    if layout == "safetensors":
        save_file(sd, os.path.join(path, "model.safetensors"))
        return os.path.join(path, "model.safetensors")
    if layout == "scan":
        # no index: every weight file is read, training_args skipped
        torch.save({k: sd[k] for k in keys[:2]}, os.path.join(path, "a.bin"))
        save_file({k: sd[k] for k in keys[2:]},
                  os.path.join(path, "b.safetensors"))
        torch.save({"block.0.weight": torch.zeros(1)},
                   os.path.join(path, "training_args.bin"))
        return path
    ext = ".bin" if layout == "bin_index" else ".safetensors"
    index = ("pytorch_model.bin.index.json" if ext == ".bin"
             else "model.safetensors.index.json")
    weight_map = {}
    for s in range(2):
        shard = f"model-{s + 1:05d}-of-00002{ext}"
        chunk = {k: sd[k] for k in keys[s::2]}
        if ext == ".bin":
            torch.save(chunk, os.path.join(path, shard))
        else:
            save_file(chunk, os.path.join(path, shard))
        weight_map.update(dict.fromkeys(chunk, shard))
    # a stray file beside the shards is not read
    torch.save({"stray": torch.ones(2)}, os.path.join(path, "extra.bin"))
    with open(os.path.join(path, index), "w") as f:
        json.dump({"metadata": {"total_size": 0}, "weight_map": weight_map},
                  f)
    return path


@pytest.mark.parametrize("layout", ["bin", "safetensors", "bin_index",
                                    "safetensors_index", "scan"])
def test_load_torch_state_dict_matches_jax(tmp_path, layout):
    sd = _sd(np.random.default_rng(1))
    path = _write(str(tmp_path / layout), layout, sd)
    want = jconv.load_torch_state_dict(path)
    got = tconv.load_torch_state_dict(path, device="cpu")
    assert isinstance(got, tconv.CheckpointDict)
    assert sorted(got) == sorted(want) == sorted(sd)
    for name in sd:
        t = got[name]
        assert t.dtype == torch.float32 and t.device.type == "cpu"
        np.testing.assert_array_equal(t.numpy(), np.asarray(want[name]))


def test_checkpoint_dict_hands_out_fresh_tensors(tmp_path):
    """A lookup reads the file anew: writing into what it returned changes
    neither the file nor the next lookup."""
    sd = _sd(np.random.default_rng(2))
    path = _write(str(tmp_path / "ck"), "bin", sd)
    ck = tconv.load_torch_state_dict(path, device="cpu")
    first = ck["block.1.weight"]
    first.zero_()
    assert torch.equal(ck["block.1.weight"], sd["block.1.weight"])


@pytest.mark.parametrize("layout", ["safetensors", "safetensors_index"])
def test_bf16_safetensors_upcast_exactly(tmp_path, layout):
    """A bf16 checkpoint (what HF saves for Vicuna) reads as the exact f32
    of its values, and converts as its f32 copy would."""
    hf, kw = _llama()
    sd = {k: v.to(torch.bfloat16) for k, v in hf.state_dict().items()}
    path = _write(str(tmp_path / "bf16"), layout, sd)
    ck = tconv.load_torch_state_dict(path, device="cpu")
    assert sorted(ck) == sorted(sd)
    for name, v in sd.items():
        assert torch.equal(ck[name], v.float()), name
    cfg = tiny(**kw)
    got = tconv.flat_state_dict(tconv.decoder_params_from_hf(ck, cfg))
    want = tconv.flat_state_dict(tconv.decoder_params_from_hf(
        {k: v.float() for k, v in sd.items()}, cfg))
    _assert_same_leaves(got, want)


def test_extract_by_prefix_is_a_lazy_view(tmp_path):
    """The composite re-extraction renames without reading: a value is read
    only when it is looked up."""
    reads = []

    class Counting(dict):
        def __getitem__(self, k):
            reads.append(k)
            return dict.__getitem__(self, k)

    sd = Counting({"model.vision_tower.a": torch.ones(1),
                   "model.vision_tower.b": torch.ones(2),
                   "model.layers.0.x": torch.ones(3)})
    tower = tconv.extract_by_prefix(sd, "model.vision_tower.")
    lm = tconv.drop_prefixes(sd, ("model.vision_tower",))
    assert sorted(tower) == ["a", "b"] and sorted(lm) == ["model.layers.0.x"]
    assert reads == []
    assert tower["b"].shape == (2,) and reads == ["model.vision_tower.b"]
    assert sorted(jconv.extract_by_prefix(dict(sd), "model.vision_tower.")) \
        == sorted(tower)
