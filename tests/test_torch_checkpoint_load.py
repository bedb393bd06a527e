"""``init_or_load_params`` with checkpoints, the port against the JAX
package on the same files, on the CPU.

  * A composite MMGPT save (sharded ``.bin`` with an index, the reference's
    key layout as ``tests/test_composite_checkpoint.py`` writes it) for
    every projector kind: every leaf the port builds equals JAX's exactly
    (JAX also carries the tower's last layer, which the selection never
    runs and the port never builds), and a multimodal forward agrees to
    1e-5 at f32. The same from bf16 sharded safetensors, which only the
    port reads.
  * ``lm_checkpoint``: new special-token rows (and NormHead columns) mean-
    initialized, tied embeddings, the ``family`` argument; the LM leaves
    equal JAX's (the old rows exactly, the means to 1e-6).
  * ``vision_checkpoint``: an HF CLIP tower.
  * Refusals: a leaf of another shape than the model's, and a tower
    checkpoint through the CLIP converter for a SAM tower (trap C25).
  * ``python -m merlin_tpu_torch.serve.worker --tiny --device cpu
    --pretrain_model <ckpt>`` loads and answers a request.
"""

import os
import pathlib
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from merlin_tpu.models import builder as j_builder
from merlin_tpu.train.arguments import (
    DataArguments, ModelArguments, TrainingArguments)

from merlin_tpu_torch.models import builder as t_builder
from merlin_tpu_torch.models.bridge import params_from_flax
from merlin_tpu_torch.serve import cli as t_cli
from merlin_tpu_torch.serve.protocol import http_json
from merlin_tpu_torch.train.arguments import parse_args

from test_checkpoint_smoke import _baichuan_sd, _write_bin_sharded
from test_checkpoint_smoke import _llama_sd as _lm_sd
from test_composite_checkpoint import (
    _clip_tower_sd, _llama_sd, _projector_sd, _write_sharded)

ROOT = pathlib.Path(__file__).resolve().parent.parent
KINDS = ["conv", "mlp", "qwen", "sam", "resampler"]


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _bundles(projector="conv", **lm):
    """The tiny bundle of each package (16 px tower, vocab 128)."""
    jb = j_builder.build_model_tokenizer(
        ModelArguments(projector=projector), DataArguments(image_size=16),
        TrainingArguments(gradient_checkpointing=False, model_max_length=64),
        tiny=True)
    tb = t_builder.build_model_tokenizer(
        *parse_args(["--projector", projector, "--image_size", "16",
                     "--model_max_length", "64"]), tiny=True)
    if lm:
        import dataclasses

        from merlin_tpu.models.mmgpt import MMGPT as JMMGPT
        from merlin_tpu_torch.models.mmgpt import MMGPT

        jb.config = dataclasses.replace(jb.config, lm=dataclasses.replace(
            jb.config.lm, **lm))
        jb.model = JMMGPT(jb.config)
        tb.config = dataclasses.replace(tb.config, lm=dataclasses.replace(
            tb.config.lm, **lm))
        with torch.device("meta"):
            tb.model = MMGPT(tb.config)
    return jb, tb


def _composite(cfg, kind, seed):
    rng = np.random.default_rng(seed)
    sd = {}
    sd.update(_llama_sd(cfg.lm, rng))
    sd.update(_clip_tower_sd(cfg.vit, rng))
    sd.update(_projector_sd(kind, cfg, rng))
    return sd


def _assert_leaves(got, jparams, prefix=""):
    want = {k: v for k, v in params_from_flax(jax.device_get(
        jparams)).items() if k.startswith(prefix)}
    got = {k: v for k, v in got.items() if k.startswith(prefix)}
    # JAX's tree also holds the tower layers its selection never runs
    extra = [k for k in set(want) - set(got)
             if not k.startswith("vision_tower.vit.layers_")]
    assert set(got) <= set(want) and not extra, extra
    for name, t in got.items():
        assert t.dtype == torch.float32, name
        assert torch.equal(t, want[name]), name
    return len(got)


def _forward_agrees(jb, tb, jparams, seed, atol=1e-5):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, 90, size=(1, 8))
    ids[0, 2] = tb.config.image_patch_id
    images = rng.normal(size=(1, 1, 16, 16, 3)).astype(np.float32)
    want, _ = jb.model.apply({"params": jparams}, jnp.asarray(ids),
                             images=jnp.asarray(images))
    with torch.no_grad():
        got, _ = tb.model(torch.from_numpy(ids),
                          images=torch.from_numpy(images))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                               rtol=atol)


@pytest.mark.parametrize("kind", KINDS)
def test_composite_checkpoint_loads_like_jax(tmp_path, kind):
    jb, tb = _bundles(kind)
    sd = _composite(jb.config, kind, seed=7)
    ckpt = str(tmp_path / "composite")
    _write_sharded(ckpt, sd)
    jparams = j_builder.init_or_load_params(jb, composite_checkpoint=ckpt)
    got = t_builder.init_or_load_params(tb, composite_checkpoint=ckpt,
                                        device="cpu")
    assert got is tb.params
    # every leaf came from the checkpoint: the tower's, the projector's
    # and the LM's, none left at a random init
    assert _assert_leaves(got, jparams) == len(got)
    _forward_agrees(jb, tb, jparams, seed=1)


def test_composite_bf16_safetensors(tmp_path):
    """The same composite as sharded bf16 safetensors (what an HF bf16
    save holds): each leaf is the f32 of the bf16 value. JAX's reader
    cannot take bf16, so the port is held to JAX loading the f32 upcast."""
    from safetensors.torch import save_file

    jb, tb = _bundles("conv")
    sd = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in _composite(
        jb.config, "conv", seed=8).items()}
    up = str(tmp_path / "f32")
    _write_sharded(up, {k: v.float().numpy() for k, v in sd.items()})
    bf = tmp_path / "bf16"
    bf.mkdir()
    keys = sorted(sd)
    weight_map = {}
    for s in range(3):
        shard = f"model-{s + 1:05d}-of-00003.safetensors"
        save_file({k: sd[k] for k in keys[s::3]}, str(bf / shard))
        weight_map.update(dict.fromkeys(keys[s::3], shard))
    import json
    (bf / "model.safetensors.index.json").write_text(json.dumps(
        {"metadata": {"total_size": 0}, "weight_map": weight_map}))
    jparams = j_builder.init_or_load_params(jb, composite_checkpoint=up)
    got = t_builder.init_or_load_params(tb, composite_checkpoint=str(bf),
                                        device="cpu")
    assert _assert_leaves(got, jparams) == len(got)
    _forward_agrees(jb, tb, jparams, seed=2)


@pytest.mark.parametrize("case", ["untied", "tied", "normhead"])
def test_lm_checkpoint_resizes_like_jax(tmp_path, case):
    """A checkpoint that predates the 8 added tokens: the embedding grows
    by mean-initialized rows, an untied head by mean rows, a NormHead
    (Baichuan2, ``family="baichuan"``) by mean columns."""
    rng = np.random.default_rng(3)
    lm = {"untied": {}, "tied": dict(tie_word_embeddings=True),
          "normhead": dict(normhead=True)}[case]
    jb, tb = _bundles("mlp", **lm)
    cfg = tb.config.lm
    vocab = cfg.vocab_size - 8
    if case == "normhead":
        sd, family = _baichuan_sd(cfg, rng, vocab=vocab), "baichuan"
    else:
        sd, family = _lm_sd(cfg, rng, vocab=vocab,
                            tied=case == "tied"), "llama"
    ckpt = str(tmp_path / case)
    _write_bin_sharded(ckpt, sd)
    jparams = j_builder.init_or_load_params(jb, lm_checkpoint=ckpt,
                                            family=family)
    got = t_builder.init_or_load_params(tb, lm_checkpoint=ckpt,
                                        family=family, device="cpu")
    want = params_from_flax(jax.device_get(jparams["lm"]))
    lm_got = {k[3:]: v for k, v in got.items() if k.startswith("lm.")}
    assert sorted(lm_got) == sorted(want)
    grown = {"embed_tokens.embedding": 0, "lm_head.kernel": 1,
             "lm_head_kernel": 1}
    for name, w in want.items():
        g = lm_got[name]
        if name in grown:
            axis = grown[name]
            old = g.narrow(axis, 0, vocab)
            new = g.narrow(axis, vocab, 8)
            assert torch.equal(old, w.narrow(axis, 0, vocab)), name
            np.testing.assert_allclose(new.numpy(),
                                       w.narrow(axis, vocab, 8).numpy(),
                                       rtol=1e-6, atol=1e-7)
            assert g.shape[axis] == cfg.vocab_size
        else:
            assert torch.equal(g, w), name
    assert ("lm.lm_head.kernel" in got) == (case == "untied")
    assert ("lm.lm_head_kernel" in got) == (case == "normhead")


def test_vision_checkpoint_loads_like_jax(tmp_path):
    from transformers import CLIPVisionConfig, CLIPVisionModel

    torch.manual_seed(0)
    hf = CLIPVisionModel(CLIPVisionConfig(
        hidden_size=32, intermediate_size=64, num_hidden_layers=2,
        num_attention_heads=4, image_size=16, patch_size=4,
        layer_norm_eps=1e-5, hidden_act="quick_gelu")).eval()
    path = str(tmp_path / "pytorch_model.bin")
    torch.save(hf.state_dict(), path)
    jb, tb = _bundles("conv")
    jparams = j_builder.init_or_load_params(jb, vision_checkpoint=path)
    got = t_builder.init_or_load_params(tb, vision_checkpoint=path,
                                        device="cpu")
    n = _assert_leaves(got, jparams, prefix="vision_tower.")
    assert n == sum(k.startswith("vision_tower.") for k in got)
    pixels = np.random.default_rng(4).normal(size=(2, 16, 16, 3)).astype(
        np.float32)
    with torch.no_grad():
        ours = tb.model.vision_tower(torch.from_numpy(pixels)).numpy()
        theirs = hf(torch.from_numpy(pixels.transpose(0, 3, 1, 2)),
                    output_hidden_states=True).hidden_states[-2][:, 1:]
    np.testing.assert_allclose(ours, theirs.numpy(), atol=3e-4, rtol=2e-3)


def test_family_defaults_to_llama_and_opt_loads(tmp_path):
    """``family`` is back, "llama" by default as in JAX (trap C26: JAX's
    worker never passes it); an OPT checkpoint loads with family='opt'."""
    import inspect

    from transformers import OPTConfig, OPTForCausalLM

    for fn in (t_builder.init_or_load_params,
               j_builder.init_or_load_params):
        assert inspect.signature(fn).parameters["family"].default == "llama"
    lm = dict(positional="learned", norm="ln", norm_eps=1e-5, mlp="relu",
              attention_bias=True, tie_word_embeddings=True,
              max_position_embeddings=64)
    jb, tb = _bundles("conv", **lm)
    torch.manual_seed(0)
    hf = OPTForCausalLM(OPTConfig(
        vocab_size=tb.config.lm.vocab_size, hidden_size=32, ffn_dim=64,
        num_hidden_layers=2, num_attention_heads=4,
        max_position_embeddings=64, do_layer_norm_before=True,
        word_embed_proj_dim=32, dropout=0.0)).eval()
    path = str(tmp_path / "opt.bin")
    torch.save(hf.state_dict(), path)
    jparams = j_builder.init_or_load_params(jb, lm_checkpoint=path,
                                            family="opt")
    got = t_builder.init_or_load_params(tb, lm_checkpoint=path,
                                        family="opt", device="cpu")
    assert _assert_leaves(got, jparams, prefix="lm.") == sum(
        k.startswith("lm.") for k in got)
    with pytest.raises(KeyError):
        t_builder.init_or_load_params(tb, lm_checkpoint=path, device="cpu")


def test_checkpoint_of_another_shape_is_refused(tmp_path):
    """JAX's flax tree takes a leaf of any shape; the port refuses one that
    does not fit its module (here an LM saved before the special tokens,
    loaded as a composite, which does not resize)."""
    _, tb = _bundles("conv")
    cfg = tb.config
    rng = np.random.default_rng(5)
    sd = _lm_sd(cfg.lm, rng, vocab=cfg.lm.vocab_size - 8, tied=False)
    path = str(tmp_path / "short")
    _write_bin_sharded(path, sd)
    with pytest.raises(ValueError, match="embed_tokens.embedding"):
        t_builder.init_or_load_params(tb, composite_checkpoint=path,
                                      device="cpu")


def test_composite_tower_goes_through_the_clip_converter(tmp_path):
    """Trap C25: JAX sends any composite tower to ``vit_params_from_hf``.
    A SAM-tower bundle's composite therefore fails in the tower's
    conversion, in the port as in the JAX converter it mirrors."""
    from merlin_tpu_torch.models.mmgpt import MMGPT, MMGPTConfig
    from merlin_tpu_torch.models.sam_vit import tiny_sam

    _, tb = _bundles("conv")
    cfg = MMGPTConfig(lm=tb.config.lm, vit=tiny_sam(), projector="sam",
                      vision_kind="sam")
    with torch.device("meta"):
        tb.model = MMGPT(cfg)
    tb.config = cfg
    rng = np.random.default_rng(6)
    sd = _llama_sd(cfg.lm, rng)
    sd.update({"model.vision_tower.patch_embed.proj.weight": np.zeros(
        (16, 3, 4, 4), np.float32)})
    path = str(tmp_path / "sam")
    _write_sharded(path, sd)
    with pytest.raises(AttributeError, match="hidden_size"):
        t_builder.init_or_load_params(tb, composite_checkpoint=path,
                                      device="cpu")


def test_missing_checkpoint_is_refused():
    _, tb = _bundles("conv")
    with pytest.raises(FileNotFoundError):
        t_builder.init_or_load_params(tb, composite_checkpoint="/nonexistent",
                                      device="cpu")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_worker_main_serves_a_composite_checkpoint(tmp_path):
    """The worker's ``--pretrain_model`` loads a composite on ``--device
    cpu`` and answers a request."""
    jb, _ = _bundles("conv")
    sd = _composite(jb.config, "conv", seed=9)
    ckpt = str(tmp_path / "composite")
    _write_sharded(ckpt, sd)
    port = _free_port()
    env = dict(os.environ, HF_HUB_OFFLINE="1", TRANSFORMERS_OFFLINE="1",
               PYTHONPATH=str(ROOT))
    proc = subprocess.Popen(
        [sys.executable, "-m", "merlin_tpu_torch.serve.worker", "--tiny",
         "--device", "cpu", "--host", "127.0.0.1", "--port", str(port),
         "--image_size", "16", "--pretrain_model", ckpt],
        cwd=ROOT, env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE)
    try:
        addr = f"http://127.0.0.1:{port}"
        deadline = time.time() + 120
        while True:
            try:
                status = http_json("POST", addr + "/worker_get_status")
                break
            except OSError:
                assert proc.poll() is None, proc.stderr.read().decode()
                assert time.time() < deadline, "the worker did not start"
                time.sleep(0.5)
        assert status["model_names"] == ["merlin-tpu"]
        chunks = list(t_cli.stream_request(addr, {
            "prompt": "hello there", "temperature": 0.0,
            "max_new_tokens": 3}))
        assert chunks and all(c["error_code"] == 0 for c in chunks)
    finally:
        proc.terminate()
        proc.wait(timeout=30)
        proc.stderr.close()
