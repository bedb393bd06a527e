"""The port's ``BeamSearch`` against the JAX one on the CPU, token for token
and score for score, with one set of flax params bridged into the port.

Everything runs in f32 (trap C6). Stop ids are tokens the greedy
continuation reaches, so hypotheses are banked in mid-search and rows
finish early. Cases: 2, 3 and 5 beams, several stop ids, a ragged batch
with an ``attention_mask``, a tiny MMGPT with images; the planted fault
(the cache gathered with the beam index rotated by one) must change the
answer, and equal scores must rank the lower index first, as
``jax.lax.top_k`` does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from merlin_tpu.generate.beam import BeamSearch as JBeamSearch
from merlin_tpu.generate.decode import GenerateConfig as JGenerateConfig
from merlin_tpu.models.decoder import CausalLM as JCausalLM
from merlin_tpu.models.decoder import init_kv_cache as j_init_kv_cache
from merlin_tpu.models.families import tiny as j_tiny
from merlin_tpu.models.mmgpt import MMGPT as JMMGPT
from merlin_tpu.models.mmgpt import MMGPTConfig as JMMGPTConfig
from merlin_tpu.models.vit import tiny_vit as j_tiny_vit

from merlin_tpu_torch.generate import beam as beam_mod
from merlin_tpu_torch.generate.beam import BeamSearch, _top_k
from merlin_tpu_torch.generate.decode import GenerateConfig, Generator
from merlin_tpu_torch.models.bridge import params_from_flax
from merlin_tpu_torch.models.decoder import CausalLM
from merlin_tpu_torch.models.families import tiny
from merlin_tpu_torch.models.mmgpt import MMGPT, MMGPTConfig
from merlin_tpu_torch.models.vit import tiny_vit

PAD = 0
PATCH, START, END = 100, 101, 102
SCORE_TOL = 1e-5


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


def _j_search(jmodel, params, cfg, ids, images=None, mask=None):
    """JAX ``BeamSearch.__call__``, also returning the best scores."""
    beam = JBeamSearch(jmodel, cfg)
    ids = jnp.asarray(ids, jnp.int32)
    mask = jnp.asarray(ids != PAD if mask is None else mask)
    lm_cfg = jmodel.cfg.lm if hasattr(jmodel.cfg, "lm") else jmodel.cfg
    cache = j_init_kv_cache(lm_cfg, ids.shape[0],
                            max_len=ids.shape[1] + cfg.max_new_tokens,
                            dtype=jnp.float32)
    logits, cache, lengths = beam._prefill(params, ids, images, mask, cache)
    seqs, scores = beam._loop(params, logits, cache, lengths)
    return np.asarray(seqs), np.asarray(scores)[:, 0]


def _greedy_stops(tmodel, ids, n, images=None):
    """``n`` stop ids the greedy continuations reach (the port's
    ``Generator``, which gives JAX's tokens at f32), so beams bank
    hypotheses mid-search."""
    gen = Generator(tmodel, GenerateConfig(
        max_new_tokens=6, eos_id=-1, pad_id=PAD, cache_dtype=torch.float32,
        prompt_bucket=0), device="cpu")
    toks = gen(ids, images=images)[:, 1:].T.reshape(-1).tolist()
    stops = list(dict.fromkeys(t for t in toks if t != PAD))
    assert len(stops) >= n
    return stops[:n]


def _both(models, ids, beams, new, stops, images=None, mask=None):
    jmodel, params, tmodel = models
    jcfg = JGenerateConfig(max_new_tokens=new, num_beams=beams,
                           eos_id=stops[0], pad_id=PAD,
                           stop_token_ids=tuple(stops[1:]),
                           cache_dtype=jnp.float32)
    want, want_scores = _j_search(
        jmodel, params, jcfg, ids,
        images=None if images is None else jnp.asarray(images), mask=mask)
    cfg = GenerateConfig(max_new_tokens=new, num_beams=beams,
                         eos_id=stops[0], pad_id=PAD,
                         stop_token_ids=tuple(stops[1:]),
                         cache_dtype=torch.float32)
    beam = BeamSearch(tmodel, cfg, device="cpu")
    got, scores = beam.search(ids, images=images, attention_mask=mask)
    return (got, scores), (want, want_scores), beam


@pytest.mark.parametrize("beams,new,n_stops", [(2, 6, 1), (3, 8, 1),
                                               (5, 8, 1), (3, 8, 3),
                                               (5, 10, 2)],
                         ids=["k2", "k3", "k5", "k3-3stops", "k5-2stops"])
def test_beam_matches_jax(lm, beams, new, n_stops):
    ids = np.random.default_rng(beams + n_stops).integers(
        3, 128, size=(2, 9))
    stops = _greedy_stops(lm[2], ids, n_stops)
    (got, scores), (want, want_scores), beam = _both(lm, ids, beams, new,
                                                     stops)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(scores, want_scores, atol=SCORE_TOL)
    np.testing.assert_array_equal(beam(ids), got)


def test_beam_ragged_batch_with_mask_matches_jax(lm):
    rng = np.random.default_rng(11)
    ids = rng.integers(3, 128, size=(3, 12))
    mask = np.ones_like(ids, bool)
    mask[0, 7:] = False
    mask[2, 10:] = False
    ids[~mask] = PAD
    stops = _greedy_stops(lm[2], ids, 2)
    (got, scores), (want, want_scores), _ = _both(lm, ids, 3, 8, stops,
                                                  mask=mask)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(scores, want_scores, atol=SCORE_TOL)


def _mm_prompt(rng, n_images):
    ids = [1] + list(rng.integers(3, 99, size=5))
    for _ in range(n_images):
        ids += [START] + [PATCH] * 4 + [END] + list(rng.integers(3, 99, 3))
    return np.asarray([ids])


def test_beam_with_images_matches_jax(mm):
    rng = np.random.default_rng(3)
    ids = _mm_prompt(rng, 2)
    images = rng.integers(0, 256, size=(1, 2, 16, 16, 3)).astype(np.uint8)
    stops = _greedy_stops(mm[2], ids, 2, images=images)
    (got, scores), (want, want_scores), _ = _both(mm, ids, 3, 8, stops,
                                                  images=images)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(scores, want_scores, atol=SCORE_TOL)


def test_rotated_beam_gather_changes_the_answer(lm, monkeypatch):
    """The planted fault ``chip_smoke.py`` holds the beam against: each
    beam continues from its neighbour's cache. Scores computed from the
    wrong histories must leave the JAX answer."""
    ids = np.random.default_rng(5).integers(3, 128, size=(2, 9))
    stops = _greedy_stops(lm[2], ids, 1)
    (_, scores), (want, want_scores), _ = _both(lm, ids, 5, 10, stops)
    gather = beam_mod._gather_beams

    def rotated(cache, beam_idx, batch, beams):
        return gather(cache, beam_idx.roll(1, dims=1), batch, beams)

    monkeypatch.setattr(beam_mod, "_gather_beams", rotated)
    (bad, bad_scores), _, _ = _both(lm, ids, 5, 10, stops)
    assert not (np.array_equal(bad, want)
                and np.allclose(bad_scores, want_scores, atol=SCORE_TOL))
    np.testing.assert_allclose(scores, want_scores, atol=SCORE_TOL)


def test_top_k_puts_the_lower_index_first_among_ties():
    x = torch.tensor([[1.0, 3.0, 3.0, -1e7, 3.0, -1e7, 2.0]])
    values, index = _top_k(x, 6)
    jv, ji = jax.lax.top_k(jnp.asarray(x.numpy()), 6)
    np.testing.assert_array_equal(index.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(values.numpy(), np.asarray(jv))


def test_beam_refuses_one_beam(lm):
    with pytest.raises(ValueError, match="num_beams"):
        BeamSearch(lm[2], GenerateConfig(num_beams=1), device="cpu")
