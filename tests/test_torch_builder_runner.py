"""The port's builder and eval runner against the JAX package on the CPU.

  * ``build_model_tokenizer``: the tiny build and the name-built Vicuna-7B
    (under ``meta``: no weight exists) give the JAX configs field by field;
    a tokenizer that does not load falls back to the ``TinyTokenizer`` and
    says so. Loading the HF tokenizer is replaced by a failing stub in both
    packages, so no test reaches the network.
  * ``init_or_load_params``: the flax tree's names (joined by '.'), shapes
    and dtypes, the constant leaves equal, the random ones at flax's
    scales; a checkpoint that does not exist is refused.
  * ``quantize_bundle_lm_int8``: JAX's int8 leaves and scales, the tower
    untouched (trap C12).
  * ``EvalModel``: ``build_prompt``, ``ask`` and ``ask_batch`` give JAX's
    text, greedy, with 3 beams and speculative at draft 2, from the same
    parameters and tokenizers primed alike (so no answer is empty).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from merlin_tpu.eval.runner import EvalConfig as JEvalConfig
from merlin_tpu.eval.runner import EvalModel as JEvalModel
from merlin_tpu.models import builder as j_builder
from merlin_tpu.train.arguments import parse_args as j_parse_args

from merlin_tpu_torch.eval.runner import EvalConfig, EvalModel
from merlin_tpu_torch.models import builder as t_builder
from merlin_tpu_torch.models.bridge import params_from_flax
from merlin_tpu_torch.train.arguments import parse_args

VOCAB_TINY = 128


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def no_hub(monkeypatch):
    """Neither package may fetch a tokenizer: loading fails at once."""
    def refuse(path, **kw):
        raise OSError(f"offline test: no tokenizer for {path}")

    monkeypatch.setattr(j_builder, "load_tokenizer", refuse)
    monkeypatch.setattr(t_builder, "load_tokenizer", refuse)


def _same(jval, tval, where):
    if dataclasses.is_dataclass(jval):
        for f in dataclasses.fields(jval):
            _same(getattr(jval, f.name), getattr(tval, f.name),
                  f"{where}.{f.name}")
    elif where.endswith(".dtype"):
        assert jnp.dtype(jval).name == str(tval).replace("torch.", ""), where
    else:
        assert jval == tval, where


def _builds(argv, tiny):
    jb_args, tb_args = j_parse_args(argv), parse_args(argv)
    jb = j_builder.build_model_tokenizer(*jb_args, tiny=tiny)
    tb = t_builder.build_model_tokenizer(*tb_args, tiny=tiny)
    return jb, tb, jb_args, tb_args


@pytest.mark.parametrize("argv,tiny", [([], True), ([], False),
                                       (["--bf16", "False",
                                         "--model_max_length", "8192",
                                         "--freeze_lm_model", "True"],
                                        False)],
                         ids=["tiny", "vicuna-7b", "vicuna-7b-f32-8k"])
def test_build_gives_jax_configs(no_hub, argv, tiny):
    jb, tb, jargs, targs = _builds(argv, tiny)
    _same(jb.config, tb.config, "config")
    assert tb.orig_vocab_size == jb.orig_vocab_size
    assert tb.special_ids == t_builder.SpecialIds(
        **dataclasses.asdict(jb.special_ids))
    assert (targs[1].num_patches, targs[1].image_size) == \
        (jargs[1].num_patches, jargs[1].image_size)
    assert type(tb.tokenizer).__name__ == type(jb.tokenizer).__name__ \
        == "TinyTokenizer"
    assert all(p.device.type == "meta" for p in tb.model.parameters())
    assert tb.params is None
    if jb.embed_row_trainable is None:
        assert tb.embed_row_trainable is None
    else:
        np.testing.assert_array_equal(tb.embed_row_trainable,
                                      jb.embed_row_trainable)
    for path in (("lm", "embed_tokens", "embedding"),
                 ("vision_tower", "vit", "layers_0", "fc1"),
                 ("vision_tower", "vit", "layers_1", "fc1"),
                 ("projector", "conv", "kernel")):
        assert tb.trainable_mask(path) == jb.trainable_mask(path)
    if not tiny:
        assert tb.config.lm.vocab_size == 32003
        assert tb.config.lm.num_layers == 32 and tb.config.vit.num_layers == 24


def test_tokenizer_fallback_is_logged(no_hub, caplog):
    with caplog.at_level("WARNING", logger=t_builder.logger.name):
        t_builder.build_model_tokenizer(*parse_args([]))
    assert "TinyTokenizer" in caplog.text and "offline test" in caplog.text


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        name = f"{prefix}.{k}" if prefix else k
        out.update(_flat(v, name) if isinstance(v, dict) else {name: v})
    return out


@pytest.fixture(scope="module")
def tiny_pair():
    """The tiny JAX bundle with its params, and the port's bundle holding
    the same params."""
    jb = j_builder.build_model_tokenizer(*j_parse_args([]), tiny=True)
    j_builder.init_or_load_params(jb, rng=jax.random.key(0))
    tb = t_builder.build_model_tokenizer(*parse_args([]), tiny=True)
    tb.model.load_state_dict(params_from_flax(jax.device_get(jb.params)),
                             strict=True, assign=True)
    tb.params = tb.model.state_dict()
    return jb, tb


def test_init_gives_the_flax_tree(tiny_pair):
    jb, _ = tiny_pair
    tb = t_builder.build_model_tokenizer(*parse_args([]), tiny=True)
    gen = torch.Generator().manual_seed(0)
    sd = t_builder.init_or_load_params(tb, generator=gen, device="cpu")
    assert sd is tb.params
    want = {k: np.asarray(v) for k, v in _flat(jax.device_get(jb.params))
            .items()}
    assert sorted(sd) == sorted(want)
    for name, w in want.items():
        got = sd[name]
        assert tuple(got.shape) == w.shape, name
        assert str(got.dtype).replace("torch.", "") == w.dtype.name, name
        leaf = name.rpartition(".")[2]
        if leaf in ("scale", "bias"):
            np.testing.assert_array_equal(got.numpy(), w, err_msg=name)
        elif leaf == "kernel" and w.size >= 512:
            # lecun_normal: std sqrt(1 / fan_in) after the truncation
            std = math.sqrt(w.shape[-1] / w.size)
            assert 0.8 * std < got.std().item() < 1.2 * std, name
            assert got.abs().max().item() <= 2 * std / 0.8796 + 1e-6, name
        elif leaf == "embedding":
            assert 0.016 < got.std().item() < 0.024, name
    assert all(p.device.type == "cpu" for p in tb.model.parameters())
    # the same generator state gives the same weights
    again = t_builder.build_model_tokenizer(*parse_args([]), tiny=True)
    t_builder.init_or_load_params(
        again, generator=torch.Generator().manual_seed(0), device="cpu")
    for name, t in again.params.items():
        assert torch.equal(t, sd[name]), name


@pytest.mark.parametrize("which", ["lm_checkpoint", "vision_checkpoint",
                                   "composite_checkpoint"])
def test_checkpoints_are_refused(which):
    """A checkpoint that is not there is refused before any weight exists
    (loading real ones is held in ``test_torch_checkpoint_load.py``)."""
    tb = t_builder.build_model_tokenizer(*parse_args([]), tiny=True)
    with pytest.raises(FileNotFoundError):
        t_builder.init_or_load_params(tb, device="cpu",
                                      **{which: "/nonexistent"})
    assert tb.params is None
    assert all(p.device.type == "meta" for p in tb.model.parameters())


def test_quantize_bundle_lm_int8_matches_jax(tiny_pair):
    jb, tb = tiny_pair
    jq = j_builder.quantize_bundle_lm_int8(dataclasses.replace(
        jb, params=jax.tree.map(jnp.array, jb.params)))
    tq = t_builder.quantize_bundle_lm_int8(tb)
    assert tq.config.lm.weight_dtype == "int8"
    assert tb.config.lm.weight_dtype == "bf16"
    want = _flat(jax.device_get(jq.params))
    assert sorted(tq.params) == sorted(want)
    for name, w in want.items():
        got = tq.params[name].numpy()
        if name.endswith("kernel_q8"):
            assert got.dtype == np.int8
            np.testing.assert_array_equal(got, np.asarray(w), err_msg=name)
        else:
            np.testing.assert_allclose(got, np.asarray(w), rtol=1e-6,
                                       atol=0, err_msg=name)
    fc1 = "vision_tower.vit.layers_0.mlp.fc1.kernel"
    assert tq.params[fc1].dtype == torch.float32
    assert tq.params[fc1].data_ptr() == tb.params[fc1].data_ptr()
    assert "lm.layers_0.mlp.gate_proj.kernel_q8" in tq.params


def _prime(jtok, ttok, vocab, needed):
    """Encode one string of distinct words in both tokenizers, so that
    every id from the first free one up to ``vocab`` is a word: the needed
    words first (the template's and the questions'), then fillers."""
    words = list(dict.fromkeys(w for text in needed
                               for w in jtok.tokenize(text)))
    words = [w for w in words if jtok.convert_tokens_to_ids(w) ==
             jtok.unk_token_id]
    free = vocab - len(jtok._vocab)
    words += [f"w{i}" for i in range(free - len(words))]
    line = " ".join(words)
    assert jtok.encode(line) == ttok.encode(line)
    assert len(jtok._vocab) == len(ttok._vocab) == vocab


QUESTIONS = ["what is shown here", "describe the scene <image> in detail",
             "count the dogs"]


@pytest.fixture(scope="module")
def primed(tiny_pair):
    jb, tb = tiny_pair
    jb, tb = dataclasses.replace(jb), dataclasses.replace(tb)
    jb.tokenizer = j_builder._tiny_tokenizer_with_mm_tokens(2048)[0]
    tb.tokenizer = t_builder._tiny_tokenizer_with_mm_tokens(2048)[0]
    probe = JEvalModel(jb, JEvalConfig(max_new_tokens=1))
    prompts = [probe.build_prompt(q, num_images=0) for q in QUESTIONS]
    _prime(jb.tokenizer, tb.tokenizer, VOCAB_TINY, prompts)
    return jb, tb


def _frames():
    rng = np.random.default_rng(9)
    arr = rng.integers(0, 256, size=(16, 16, 3), dtype=np.uint8)
    pil = Image.fromarray(rng.integers(0, 256, size=(30, 40, 3),
                                       dtype=np.uint8))
    return arr, pil


@pytest.mark.parametrize("cfg_kw", [dict(), dict(num_beams=3),
                                    dict(speculative=2)],
                         ids=["greedy", "beam3", "speculative2"])
def test_eval_model_gives_jax_text(primed, cfg_kw):
    jb, tb = primed
    kw = dict(max_new_tokens=8, **cfg_kw)
    jm = JEvalModel(jb, JEvalConfig(**kw))
    tm = EvalModel(tb, EvalConfig(**kw), device="cpu")
    arr, pil = _frames()
    for q, n in zip(QUESTIONS, (0, 1, 2)):
        assert tm.build_prompt(q, n) == jm.build_prompt(q, n)
    for q, imgs in ((QUESTIONS[0], ()), (QUESTIONS[1], (arr,)),
                    (QUESTIONS[2], (arr, pil))):
        got, want = tm.ask(q, images=imgs), jm.ask(q, images=imgs)
        assert got == want
        assert got, "an empty answer compares nothing"
    images = [(), (pil,), (arr, arr)]
    got = tm.ask_batch(QUESTIONS, images)
    assert got == jm.ask_batch(QUESTIONS, images)
    assert all(got)
