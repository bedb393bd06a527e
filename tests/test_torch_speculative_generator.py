"""The port's ``SpeculativeGenerator`` against the JAX one on the CPU: the
tokens, the number of windows and the tokens generated per row must be
equal, at drafts of 1 and 4 and n-grams of 1 and 2, with stop ids, a
ragged batch, periodic prompts (drafts accepted) and images. The tokens
must also be the port's greedy ``Generator``'s, and the configurations the
slot-sparse cache cannot serve (ALiBi, paged, sampled) are refused.
Everything runs in f32 (trap C6), with one set of flax params bridged into
the port.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from merlin_tpu.generate.decode import GenerateConfig as JGenerateConfig
from merlin_tpu.generate.speculative import (
    SpeculativeGenerator as JSpeculativeGenerator)
from merlin_tpu.models.decoder import CausalLM as JCausalLM
from merlin_tpu.models.families import tiny as j_tiny
from merlin_tpu.models.mmgpt import MMGPT as JMMGPT
from merlin_tpu.models.mmgpt import MMGPTConfig as JMMGPTConfig
from merlin_tpu.models.vit import tiny_vit as j_tiny_vit

from merlin_tpu_torch.generate.decode import GenerateConfig, Generator
from merlin_tpu_torch.generate.speculative import SpeculativeGenerator
from merlin_tpu_torch.models.bridge import params_from_flax
from merlin_tpu_torch.models.decoder import CausalLM
from merlin_tpu_torch.models.families import tiny
from merlin_tpu_torch.models.mmgpt import MMGPT, MMGPTConfig
from merlin_tpu_torch.models.vit import tiny_vit

V, PAD, EOS = 128, 0, 2
PATCH, START, END = 100, 101, 102


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: np.asarray(x) + 0.05 * rng.normal(size=x.shape).astype(
            np.float32), params)


@pytest.fixture(scope="module")
def lm():
    jmodel = JCausalLM(j_tiny())
    params = _perturbed(nn.unbox(jmodel.init(
        jax.random.key(0), jnp.ones((1, 4), jnp.int32))["params"]), 0)
    tmodel = CausalLM(tiny()).eval()
    tmodel.load_state_dict(params_from_flax(params), strict=True)
    return jmodel, params, tmodel


@pytest.fixture(scope="module")
def mm():
    kw = dict(projector="conv", conv_stride=2, image_patch_id=PATCH,
              im_start_id=START, im_end_id=END)
    jmodel = JMMGPT(JMMGPTConfig(lm=j_tiny(), vit=j_tiny_vit(), **kw))
    params = _perturbed(nn.unbox(jmodel.init(
        jax.random.key(1), jnp.ones((1, 8), jnp.int32),
        images=jnp.zeros((1, 1, 16, 16, 3), jnp.float32))["params"]), 1)
    tmodel = MMGPT(MMGPTConfig(lm=tiny(), vit=tiny_vit(), **kw)).eval()
    tmodel.load_state_dict(params_from_flax(params), strict=True)
    return jmodel, params, tmodel


def _cfgs(T=20, **kw):
    kw.setdefault("eos_id", EOS)
    kw.setdefault("prompt_bucket", 8)
    return (JGenerateConfig(max_new_tokens=T, pad_id=PAD,
                            cache_dtype=jnp.float32, **kw),
            GenerateConfig(max_new_tokens=T, pad_id=PAD,
                           cache_dtype=torch.float32, **kw))


def _ragged(rng, lengths, period=0):
    """Right-padded prompts; with ``period`` each repeats one random
    segment, so the n-gram lookup finds continuations."""
    rows = []
    for n in lengths:
        seg = rng.integers(3, 99, size=period or n)
        rows.append(np.resize(seg, n))
    ids = np.full((len(rows), max(lengths)), PAD, np.int32)
    mask = np.zeros(ids.shape, bool)
    for i, r in enumerate(rows):
        ids[i, :len(r)] = r
        mask[i, :len(r)] = True
    return ids, mask


def _run_both(models, k, ngram, ids, mask, cfgs, images=None):
    jmodel, params, tmodel = models
    jcfg, cfg = cfgs
    jkw = {"images": jnp.asarray(images)} if images is not None else {}
    want = JSpeculativeGenerator(jmodel, jcfg, draft_len=k, ngram=ngram)(
        params, ids, attention_mask=mask, **jkw)
    got = SpeculativeGenerator(tmodel, cfg, draft_len=k, ngram=ngram,
                               device="cpu")(ids, attention_mask=mask,
                                             images=images)
    greedy = Generator(tmodel, cfg, device="cpu")(
        ids, attention_mask=mask, images=images)
    return got, want, greedy


def _assert_same(got, want, greedy):
    tokens, n_windows, gen = got
    np.testing.assert_array_equal(tokens, want[0])
    assert n_windows == want[1]
    np.testing.assert_array_equal(gen, want[2])
    np.testing.assert_array_equal(tokens, greedy)


@pytest.mark.parametrize("k,ngram,period", [(1, 1, 0), (4, 2, 0),
                                            (4, 1, 5), (1, 2, 4),
                                            (4, 2, 6)],
                         ids=["k1-n1", "k4-n2", "k4-n1-periodic",
                              "k1-n2-periodic", "k4-n2-periodic"])
def test_speculative_matches_jax_and_greedy(lm, k, ngram, period):
    ids, mask = _ragged(np.random.default_rng(k * 10 + ngram + period),
                        (9, 14, 5), period)
    got, want, greedy = _run_both(lm, k, ngram, ids, mask, _cfgs())
    _assert_same(got, want, greedy)
    if period:
        assert got[1] < got[2].max(), "no draft was accepted"


def test_speculative_stop_ids_match_jax(lm):
    """Rows stop at different windows on stop ids the greedy continuation
    reaches; the others keep decoding."""
    ids, mask = _ragged(np.random.default_rng(3), (9, 12, 6), 4)
    probe = Generator(lm[2], _cfgs(eos_id=-1)[1], device="cpu")(
        ids, attention_mask=mask)
    stops = (int(probe[0, 3]), int(probe[2, 6]))
    got, want, greedy = _run_both(
        lm, 4, 2, ids, mask,
        _cfgs(eos_id=stops[0], stop_token_ids=stops[1:]))
    _assert_same(got, want, greedy)
    assert got[2].min() < 20 and (got[0] == PAD).any()


def test_speculative_with_images_matches_jax(mm):
    rng = np.random.default_rng(4)
    ids = [1] + list(rng.integers(3, 99, 4))
    for _ in range(2):
        ids += [START] + [PATCH] * 4 + [END] + list(rng.integers(3, 99, 3))
    ids = np.asarray([ids], np.int32)
    images = rng.integers(0, 256, size=(1, 2, 16, 16, 3)).astype(np.uint8)
    for k in (1, 4):
        got, want, greedy = _run_both(mm, k, 2, ids, ids != PAD,
                                      _cfgs(T=12), images=images)
        _assert_same(got, want, greedy)


@pytest.mark.parametrize("cfg_kw,lm_kw,match", [
    (dict(do_sample=True), {}, "greedy"),
    (dict(kv_layout="paged"), {}, "dense"),
    ({}, dict(positional="alibi"), "ALiBi")],
    ids=["sampled", "paged", "alibi"])
def test_speculative_refuses_what_the_cache_cannot_serve(cfg_kw, lm_kw,
                                                         match):
    model = CausalLM(tiny(**lm_kw))
    with pytest.raises(ValueError, match=match):
        SpeculativeGenerator(model, GenerateConfig(**cfg_kw), device="cpu")
