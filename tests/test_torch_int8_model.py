"""int8 in the port's model against the JAX package on the CPU, with one set
of flax params bridged by ``params_from_flax``:

  * the decoder over an int8 paged cache: the bulk prefill (the prompt
    quantized into the identity pages, attention on the dispatcher), the
    one-token step (q8 write, then B7 at s_q = 1) and the window step (q8
    window write, then B7/B8), at f32: logits to 1e-5 (summation order),
    the cache's int8 values and lengths exact, its scales to 1e-5;
  * ``DenseGeneral``: with a bias in bf16 it now rounds once, as JAX does,
    and agrees to 0 ulp (trap C7); ``weight_q8`` agrees at f32 to 1e-5 and
    at bf16 to 0 ulp;
  * ``quantize_decoder_params_int8``: the same int8 values and scales as
    JAX's, and its tree loads through ``params_from_flax`` unchanged;
  * ``CausalLM(weight_dtype="int8")`` logits against JAX's at f32 to 1e-5
    (as ``tests/test_quantized_weights.py:51-73``), for a gated-MLP and a
    biased SimpleMLP (fc1/fc2) family; a NormHead is refused;
  * a tiny MMGPT whose LM is quantized: CLIP's fc1/fc2 stay untouched, and
    its logits agree with JAX's int8-LM MMGPT.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from merlin_tpu.models import layers as jl
from merlin_tpu.models.convert import (
    quantize_decoder_params_int8 as j_quantize)
from merlin_tpu.models.decoder import CausalLM as JCausalLM
from merlin_tpu.models.decoder import init_kv_cache as j_init_kv_cache
from merlin_tpu.models.families import tiny as j_tiny
from merlin_tpu.models.mmgpt import MMGPT as JMMGPT
from merlin_tpu.models.mmgpt import MMGPTConfig as JMMGPTConfig
from merlin_tpu.models.vit import tiny_vit as j_tiny_vit

from merlin_tpu_torch.models import layers as tl
from merlin_tpu_torch.models.bridge import params_from_flax
from merlin_tpu_torch.models.convert import quantize_decoder_params_int8
from merlin_tpu_torch.models.decoder import CausalLM, init_kv_cache
from merlin_tpu_torch.models.families import tiny
from merlin_tpu_torch.models.mmgpt import MMGPT, MMGPTConfig
from merlin_tpu_torch.models.vit import tiny_vit

LOGIT_TOL = 1e-5


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


def _models(positional, **kw):
    jmodel = JCausalLM(j_tiny(positional=positional, **kw))
    params = _perturbed(nn.unbox(jmodel.init(
        jax.random.key(0), jnp.ones((1, 4), jnp.int32))["params"]), 1)
    tmodel = CausalLM(tiny(positional=positional, **kw)).eval()
    tmodel.load_state_dict(params_from_flax(params), strict=True)
    return jmodel, params, tmodel


@pytest.fixture(scope="module")
def models():
    return {"rope": _models("rope"), "alibi": _models("alibi"),
            "gqa": _models("rope", num_kv_heads=2)}


def _assert_cache_equal(tc, jc):
    """int8 values and lengths exact, f32 scales to 1e-5 (the K/V they
    were taken from differ by summation order only)."""
    np.testing.assert_array_equal(tc["lengths"].numpy(),
                                  np.asarray(jc["lengths"]))
    for tl, jl in zip(tc["layers"], jc["layers"]):
        assert set(tl) == set(jl) == {"k_pages", "v_pages", "k_scales",
                                      "v_scales"}
        for key in ("k_pages", "v_pages"):
            assert tl[key].dtype == torch.int8
            np.testing.assert_array_equal(tl[key].numpy(), np.asarray(jl[key]))
        for key in ("k_scales", "v_scales"):
            np.testing.assert_allclose(tl[key].numpy(), np.asarray(jl[key]),
                                       rtol=1e-5, atol=0)


@pytest.mark.parametrize("name", ["rope", "alibi", "gqa"])
def test_decoder_int8_pages_match_jax_f32(models, name):
    """Bulk prefill of a ragged batch, two one-token steps, then a 3-token
    window over permuted page tables."""
    jmodel, params, tmodel = models[name]
    jmulti = JCausalLM(dataclasses.replace(jmodel.cfg, paged_multi_query=True))
    tmulti = CausalLM(dataclasses.replace(tmodel.cfg,
                                          paged_multi_query=True)).eval()
    tmulti.load_state_dict(tmodel.state_dict())
    rng = np.random.default_rng(3)
    b, s = 2, 8
    ids = rng.integers(3, 120, size=(b, s)).astype(np.int32)
    seg = np.ones((b, s), np.int32)
    seg[1, 5:] = 0
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    jc = j_init_kv_cache(jmodel.cfg, b, 16, jnp.int8, layout="paged",
                         page_size=4)
    tc = init_kv_cache(tmodel.cfg, b, 16, torch.int8, layout="paged",
                       page_size=4, device="cpu")
    assert tuple(tc["layers"][0]["k_scales"].shape) == (8, 4, 128)

    def both(jm, tm, tok, positions, jc, tc):
        jlog, jc = jax.jit(jm.apply)(
            {"params": params}, jnp.asarray(tok),
            positions=jnp.asarray(positions), kv_cache=jc,
            **({"segment_ids": jnp.asarray(seg)} if tok.shape[1] == s
               else {}))
        with torch.no_grad():
            tlog, tc = tm(torch.from_numpy(tok).long(),
                          positions=torch.from_numpy(positions), kv_cache=tc,
                          **({"segment_ids": torch.from_numpy(seg)}
                             if tok.shape[1] == s else {}))
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)
        _assert_cache_equal(tc, jc)
        return jc, tc

    jc, tc = both(jmodel, tmodel, ids, pos, jc, tc)          # bulk prefill
    for tok in ([[7], [11]], [[3], [5]]):                    # token steps
        lens = tc["lengths"].numpy().astype(np.int32)[:, None]
        jc, tc = both(jmodel, tmodel, np.asarray(tok, np.int32), lens, jc, tc)
    # a window over permuted tables: the pool's pages reordered per row
    perm = np.asarray([[3, 1, 0, 2], [6, 4, 7, 5]], np.int32)
    for c in (jc, tc):
        for layer in c["layers"]:
            for key in list(layer):
                src = np.asarray(layer[key])
                moved = np.empty_like(src)
                moved[perm.reshape(-1)] = src[np.arange(8)]
                layer[key] = (torch.from_numpy(moved) if c is tc
                              else jnp.asarray(moved))
    jc = dict(jc, page_tables=jnp.asarray(perm))
    tc = dict(tc, page_tables=torch.from_numpy(perm))
    win = rng.integers(3, 120, size=(b, 3)).astype(np.int32)
    lens = tc["lengths"].numpy().astype(np.int32)[:, None]
    both(jmulti, tmulti, win, lens + np.arange(3, dtype=np.int32), jc, tc)



def _bits(x):
    """bf16 values as their 16-bit patterns (0 ulp means equal patterns)."""
    x = np.asarray(x.astype(jnp.float32) if hasattr(x, "astype") and
                   not isinstance(x, np.ndarray) else x, np.float32)
    return x.view(np.uint32) >> 16


def test_dense_general_bf16_bias_rounds_once_like_jax():
    """Trap C7: the f32 product plus the f32 bias, rounded to bf16 once.
    Rounding the product first, as the port did, misses JAX somewhere."""
    rng = np.random.default_rng(30)
    x = rng.normal(size=(4, 9, 64)).astype(np.float32)
    params = {"kernel": rng.normal(size=(64, 48)).astype(np.float32) * 0.2,
              "bias": rng.normal(size=(48,)).astype(np.float32)}
    jmod = jl.DenseGeneral((48,), use_bias=True, dtype=jnp.bfloat16)
    want = jmod.apply({"params": params}, jnp.asarray(x, jnp.bfloat16))
    tmod = tl.DenseGeneral(64, 48, use_bias=True, dtype=torch.bfloat16)
    tmod.load_state_dict(params_from_flax(params))
    xt = torch.from_numpy(x).to(torch.bfloat16)
    with torch.no_grad():
        got = tmod(xt)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(got.float().numpy()), _bits(want))
    kernel = tmod.kernel.to(torch.bfloat16)
    with torch.no_grad():
        twice = ((xt.reshape(-1, 64) @ kernel).float()
                 + tmod.bias).to(torch.bfloat16).reshape(got.shape)
    assert (_bits(twice.float().numpy()) != _bits(want)).any()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", ["in_out", "heads_in_bias"])
def test_dense_general_q8_matches_jax(shape, dtype):
    """(x @ q8) * scale (+ bias), rounded once: f32 to 1e-5, bf16 to 0 ulp.
    ``heads_in`` contracts two axes, as o_proj does."""
    rng = np.random.default_rng(31)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    if shape == "in_out":
        x = rng.normal(size=(2, 5, 32)).astype(np.float32)
        jmod = jl.DenseGeneral((4, 8), dtype=jdt, weight_q8=True)
        tmod = tl.DenseGeneral(32, (4, 8), dtype=tdt, weight_q8=True)
        kshape, oshape = (32, 4, 8), (4, 8)
    else:
        x = rng.normal(size=(2, 5, 4, 8)).astype(np.float32)
        jmod = jl.DenseGeneral((24,), axis=(-2, -1), use_bias=True, dtype=jdt,
                               weight_q8=True)
        tmod = tl.DenseGeneral((4, 8), 24, use_bias=True, dtype=tdt,
                               weight_q8=True)
        kshape, oshape = (4, 8, 24), (24,)
    params = {"kernel_q8": rng.integers(-127, 128, size=kshape).astype(
                  np.int8),
              "kernel_scale": rng.uniform(0.001, 0.02, size=oshape).astype(
                  np.float32)}
    if shape != "in_out":
        params["bias"] = rng.normal(size=oshape).astype(np.float32)
    want = jmod.apply({"params": params}, jnp.asarray(x, jdt))
    tmod.load_state_dict(params_from_flax(params), strict=True)
    assert tmod.kernel_q8.dtype == torch.int8
    with torch.no_grad():
        got = tmod(torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt
    if dtype == "f32":
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=LOGIT_TOL, rtol=LOGIT_TOL)
    else:
        np.testing.assert_array_equal(_bits(got.float().numpy()),
                                      _bits(want))


SIMPLE_MLP = dict(mlp="gelu_new", norm="ln", parallel_block=True,
                  attention_bias=True, lm_head_bias=True,
                  partial_rotary_factor=0.5)


@pytest.mark.parametrize("variant", ["gated_gqa", "simple_mlp"])
def test_int8_causal_lm_matches_jax_f32(variant):
    """The port's quantizer gives JAX's int8 tree exactly; that tree,
    bridged by ``params_from_flax`` (kernel_q8 and kernel_scale are plain
    leaves), makes the port's int8 CausalLM give JAX's logits."""
    kw = dict(num_kv_heads=2) if variant == "gated_gqa" else SIMPLE_MLP
    jmodel, params, tmodel = _models("rope", **kw)
    want_tree = j_quantize(params)
    got_sd = quantize_decoder_params_int8(tmodel.state_dict())
    want_sd = params_from_flax(want_tree)
    assert set(got_sd) == set(want_sd)
    for name, want in want_sd.items():
        assert got_sd[name].dtype == want.dtype, name
        np.testing.assert_array_equal(got_sd[name].numpy(), want.numpy(),
                                      err_msg=name)
    assert got_sd["layers_0.attn.o_proj.kernel_scale"].shape == (32,)

    qcfg = dataclasses.replace(tmodel.cfg, weight_dtype="int8")
    qmodel = CausalLM(qcfg).eval()
    qmodel.load_state_dict(want_sd, strict=True)
    jq = JCausalLM(dataclasses.replace(jmodel.cfg, weight_dtype="int8"))
    ids = np.random.default_rng(32).integers(3, 120, size=(2, 9))
    jlog, _ = jax.jit(jq.apply)({"params": want_tree},
                                jnp.asarray(ids, jnp.int32))
    with torch.no_grad():
        tlog, _ = qmodel(torch.from_numpy(ids))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                               atol=LOGIT_TOL, rtol=LOGIT_TOL)


def test_int8_weights_refuse_normhead():
    with pytest.raises(ValueError, match="NormHead"):
        CausalLM(tiny(positional="alibi", normhead=True, weight_dtype="int8"))


def test_int8_mmgpt_quantizes_the_lm_and_leaves_clip_alone():
    """The vision tower's MLP is fc1/fc2 too: with ``prefix="lm."`` only the
    LM is quantized (as JAX quantizes the "lm" subtree), and the int8-LM
    MMGPT gives JAX's logits; without a prefix an MMGPT dict is refused."""
    kw = dict(projector="conv", conv_stride=2, image_patch_id=100,
              im_start_id=101, im_end_id=102)
    jcfg = JMMGPTConfig(lm=j_tiny(), vit=j_tiny_vit(), **kw)
    jmodel = JMMGPT(jcfg)
    params = _perturbed(nn.unbox(jmodel.init(
        jax.random.key(2), jnp.ones((1, 8), jnp.int32),
        images=jnp.zeros((1, 1, 16, 16, 3), jnp.float32))["params"]), 3)
    sd = params_from_flax(params)
    vision_mlp = [n for n in sd if n.startswith("vision_tower.")
                  and (".fc1." in n or ".fc2." in n)]
    assert vision_mlp
    with pytest.raises(ValueError, match="prefix"):
        quantize_decoder_params_int8(sd)
    qsd = quantize_decoder_params_int8(sd, prefix="lm.")
    for name in vision_mlp:
        assert qsd[name] is sd[name]
    assert not any(n.startswith("vision_tower.") and "kernel_q8" in n
                   for n in qsd)
    assert "lm.layers_0.mlp.gate_proj.kernel_q8" in qsd

    jq_params = dict(params, lm=j_quantize(params["lm"]))
    jq = JMMGPT(dataclasses.replace(
        jcfg, lm=dataclasses.replace(jcfg.lm, weight_dtype="int8")))
    tq = MMGPT(MMGPTConfig(lm=tiny(weight_dtype="int8"), vit=tiny_vit(),
                           **kw)).eval()
    tq.load_state_dict(qsd, strict=True)
    ids = np.random.default_rng(33).integers(3, 90, size=(1, 12)).astype(
        np.int32)
    ids[0, 1:3 + jcfg.image_token_len] = (
        [101] + [100] * jcfg.image_token_len + [102])
    pix = np.random.default_rng(34).uniform(
        -1, 1, size=(1, 1, 16, 16, 3)).astype(np.float32)
    jlog, _ = jax.jit(jq.apply)({"params": jq_params}, jnp.asarray(ids),
                                images=jnp.asarray(pix))
    with torch.no_grad():
        tlog, _ = tq(torch.from_numpy(ids).long(),
                     images=torch.from_numpy(pix))
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                               atol=1e-4, rtol=1e-4)
