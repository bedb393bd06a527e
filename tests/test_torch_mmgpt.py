"""The port's whole slice against the JAX package at a tiny size, on the CPU:
uint8 frames -> preprocess -> tiny CLIP tower -> conv projector -> splice ->
tiny decoder logits, and greedy generation over a dense cache, with one set
of flax params bridged into the port by ``params_from_flax``.

Everything runs in f32, where the two frameworks differ only in summation
order (tolerance 1e-4 on logits of magnitude ~1), and greedy tokens must
match exactly (trap C6: bf16 rounding flips near-tied argmaxes on random
weights, so token-exact checks run at f32).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from merlin_tpu.generate.decode import GenerateConfig as JGenerateConfig
from merlin_tpu.generate.decode import Generator as JGenerator
from merlin_tpu.models.families import tiny as j_tiny
from merlin_tpu.models.mmgpt import MMGPT as JMMGPT
from merlin_tpu.models.mmgpt import MMGPTConfig as JMMGPTConfig
from merlin_tpu.models.vit import tiny_vit as j_tiny_vit
from merlin_tpu.ops.image_ops import preprocess_images as j_preprocess

from merlin_tpu_torch.generate.decode import GenerateConfig, Generator
from merlin_tpu_torch.models.bridge import params_from_flax
from merlin_tpu_torch.models.families import tiny
from merlin_tpu_torch.models.mmgpt import MMGPT, MMGPTConfig
from merlin_tpu_torch.models.vit import tiny_vit
from merlin_tpu_torch.ops.image_ops import preprocess_images

PATCH, START, END = 100, 101, 102
EOS, PAD = 2, 0
LOGIT_TOL = 1e-4


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _configs(positional="rope"):
    jcfg = JMMGPTConfig(lm=j_tiny(positional=positional), vit=j_tiny_vit(),
                        projector="conv", conv_stride=2,
                        image_patch_id=PATCH, im_start_id=START,
                        im_end_id=END)
    tcfg = MMGPTConfig(lm=tiny(positional=positional), vit=tiny_vit(),
                       projector="conv", conv_stride=2,
                       image_patch_id=PATCH, im_start_id=START,
                       im_end_id=END)
    return jcfg, tcfg


def _models(positional="rope", seed=0):
    """The same random params in both packages (flax init, then every leaf
    perturbed so that norm scales and biases are not trivially 1 and 0)."""
    jcfg, tcfg = _configs(positional)
    jmodel = JMMGPT(jcfg)
    ids = jnp.ones((1, 8), jnp.int32)
    images = jnp.zeros((1, 1, 16, 16, 3), jnp.float32)
    params = nn.unbox(jmodel.init(jax.random.key(seed), ids,
                                  images=images)["params"])
    rng = np.random.default_rng(seed)
    params = jax.tree.map(
        lambda x: np.asarray(x) + 0.05 * rng.normal(size=x.shape).astype(
            np.float32), params)
    tmodel = MMGPT(tcfg).eval()
    tmodel.load_state_dict(params_from_flax(params), strict=True)
    return jmodel, params, tmodel, jcfg


def _image_block(n_tok):
    return [START] + [PATCH] * n_tok + [END]


def _frames(rng, n):
    return rng.integers(0, 256, size=(n, 20, 24, 3), dtype=np.uint8)


def test_mmgpt_logits_match_jax_f32():
    jmodel, params, tmodel, jcfg = _models()
    tok = jcfg.image_token_len
    rng = np.random.default_rng(1)
    ids = rng.integers(3, 90, size=(2, 20)).astype(np.int32)
    ids[0, 1:3 + tok] = _image_block(tok)
    ids[1, 4:6 + tok] = _image_block(tok)
    frames = _frames(rng, 2)

    jpix = np.asarray(j_preprocess(jnp.asarray(frames), image_size=16))
    tpix = preprocess_images(frames, image_size=16, device="cpu")
    np.testing.assert_allclose(tpix.numpy(), jpix, atol=1e-5, rtol=1e-5)

    jlogits, _ = jmodel.apply({"params": params}, jnp.asarray(ids),
                              images=jnp.asarray(jpix)[:, None])
    with torch.no_grad():
        tlogits, cache = tmodel(torch.from_numpy(ids).long(),
                                images=tpix[:, None])
    assert cache is None
    assert tlogits.shape == (2, 20, 128)
    np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)


@pytest.mark.parametrize("positional", ["rope", "alibi"])
def test_greedy_generation_matches_jax_token_for_token(positional):
    jmodel, params, tmodel, jcfg = _models(positional, seed=3)
    tok = jcfg.image_token_len
    rng = np.random.default_rng(2)
    # ragged, right-padded batch: 13 and 9 real tokens, one image each
    batch = np.full((2, 13), PAD, np.int32)
    batch[0] = [5, *_image_block(tok), 17, 33, 41, 9, 11, 13]
    batch[1, :9] = [7, *_image_block(tok), 9, 12]
    mask = batch != PAD
    frames = _frames(rng, 2)
    jpix = j_preprocess(jnp.asarray(frames), image_size=16)[:, None]
    tpix = preprocess_images(frames, image_size=16, device="cpu")[:, None]

    jgen = JGenerator(jmodel, JGenerateConfig(
        max_new_tokens=8, eos_id=EOS, pad_id=PAD, prompt_bucket=8,
        cache_dtype=jnp.float32))
    want = jgen(params, batch, images=jpix, attention_mask=mask)
    gen = Generator(tmodel, GenerateConfig(
        max_new_tokens=8, eos_id=EOS, pad_id=PAD, prompt_bucket=8,
        cache_dtype=torch.float32), device="cpu")
    got = gen(batch, images=tpix, attention_mask=mask)
    assert got.dtype == np.int32
    assert got.tolist() == np.asarray(want).tolist()

    streamed = np.stack(list(gen.stream(batch, images=tpix,
                                        attention_mask=mask)), axis=1)
    assert streamed.tolist() == got[:, :streamed.shape[1]].tolist()


def test_out_of_range_ids_give_nan_like_jax():
    """Trap C3: the port fills out-of-range ids with NaN, as jnp.take does
    in the JAX package, and wraps negative ids in [-V, 0)."""
    jmodel, params, tmodel, _ = _models()
    ids = np.asarray([[5, 9, 130, 11, -1, 7]], np.int32)   # vocab is 128
    jlogits, _ = jmodel.apply({"params": params}, jnp.asarray(ids))
    with torch.no_grad():
        tlogits, _ = tmodel(torch.from_numpy(ids).long())
    jl, tl = np.asarray(jlogits), tlogits.numpy()
    # a NaN value row poisons every query through 0 * NaN in P @ V, in both
    assert np.isnan(tl).all()
    np.testing.assert_array_equal(np.isnan(tl), np.isnan(jl))

    emb = tmodel.lm.embed_tokens
    rows = emb(torch.tensor([[127, -1, -128, 128, -129]])).detach().numpy()
    table = emb.embedding.detach().numpy()
    np.testing.assert_array_equal(rows[0, 0], table[127])
    np.testing.assert_array_equal(rows[0, 1], table[127])
    np.testing.assert_array_equal(rows[0, 2], table[0])
    assert np.isnan(rows[0, 3:]).all()


def test_family_configs_match_jax():
    """Every named family (and the name dispatch with its RoPE stretch) is
    a field-for-field copy of the JAX package's config, dtype aside."""
    from merlin_tpu.models import families as jf
    from merlin_tpu_torch.models import families as tf

    def fields(cfg):
        d = dataclasses.asdict(cfg)
        d.pop("dtype")
        return d

    assert sorted(tf.FAMILY_BUILDERS) == sorted(jf.FAMILY_BUILDERS)
    for name in jf.FAMILY_BUILDERS:
        assert fields(tf.FAMILY_BUILDERS[name]()) == fields(
            jf.FAMILY_BUILDERS[name]()), name
    for name, length in [("lmsys/vicuna-7b-v1.5", 8192),
                         ("baichuan2-13b", 2048), ("phi-2", 2048),
                         ("opt-6.7b", 1024)]:
        assert fields(tf.config_from_name(name, model_max_length=length)) \
            == fields(jf.config_from_name(name, model_max_length=length))
    assert fields(tf.tiny("alibi")) == fields(jf.tiny("alibi"))


LM_VARIANTS = {
    "phi2_like": dict(partial_rotary_factor=0.5, attention_bias=True,
                      norm="ln", mlp="gelu_new", parallel_block=True,
                      lm_head_bias=True),
    "opt_like": dict(positional="learned", attention_bias=True, norm="ln",
                     mlp="relu", tie_word_embeddings=True),
    "baichuan2_like": dict(positional="alibi", normhead=True),
    "gqa_scaled_rope": dict(num_kv_heads=2, rope_linear_scale=2.0),
}


@pytest.mark.parametrize("variant", sorted(LM_VARIANTS))
def test_causal_lm_variants_match_jax_f32(variant):
    """The decoder's family flags (parallel block, partial rotary, learned
    positions, tied and NormHead heads, ALiBi, GQA), no cache and on a
    dense cache (prefill + two one-token steps)."""
    from merlin_tpu.models.decoder import CausalLM as JLM
    from merlin_tpu.models.decoder import init_kv_cache as j_cache
    from merlin_tpu_torch.models.decoder import CausalLM
    from merlin_tpu_torch.models.decoder import init_kv_cache

    kw = LM_VARIANTS[variant]
    jmodel, tmodel = JLM(j_tiny(**kw)), CausalLM(tiny(**kw)).eval()
    ids = np.random.default_rng(4).integers(1, 120, size=(2, 9)).astype(
        np.int32)
    params = nn.unbox(jmodel.init(jax.random.key(1),
                                  jnp.asarray(ids))["params"])
    rng = np.random.default_rng(5)
    params = jax.tree.map(
        lambda x: np.asarray(x) + 0.05 * rng.normal(size=x.shape).astype(
            np.float32), params)
    tmodel.load_state_dict(params_from_flax(params), strict=True)

    jlog, _ = jmodel.apply({"params": params}, jnp.asarray(ids))
    with torch.no_grad():
        tlog, _ = tmodel(torch.from_numpy(ids).long())
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)

    seg = np.ones((2, 9), np.int32)
    seg[1, 6:] = 0                                   # ragged second row
    pos = np.broadcast_to(np.arange(9, dtype=np.int32), (2, 9))
    jc = j_cache(jmodel.cfg, 2, 12, jnp.float32)
    tc = init_kv_cache(tmodel.cfg, 2, 12, torch.float32, device="cpu")
    jlog, jc = jmodel.apply({"params": params}, jnp.asarray(ids),
                            positions=jnp.asarray(pos),
                            segment_ids=jnp.asarray(seg), kv_cache=jc)
    with torch.no_grad():
        tlog, tc = tmodel(torch.from_numpy(ids).long(),
                          positions=torch.from_numpy(pos.copy()),
                          segment_ids=torch.from_numpy(seg), kv_cache=tc)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)
    step_pos = np.asarray([[9], [6]], np.int32)
    for tok in ([[7], [11]], [[3], [5]]):
        tok = np.asarray(tok, np.int32)
        jlog, jc = jmodel.apply({"params": params}, jnp.asarray(tok),
                                positions=jnp.asarray(step_pos), kv_cache=jc)
        with torch.no_grad():
            tlog, tc = tmodel(torch.from_numpy(tok).long(),
                              positions=torch.from_numpy(step_pos),
                              kv_cache=tc)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)
        step_pos = step_pos + 1
    assert tc["index"] == int(jc["index"]) == 11
    np.testing.assert_array_equal(tc["seg"].numpy(), np.asarray(jc["seg"]))
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
