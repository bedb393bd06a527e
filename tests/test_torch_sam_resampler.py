"""SAM and the new projectors of the port against the JAX package on the
CPU, at tiny widths and f32.

  * SAM: window partition round trips (padding included); ``get_rel_pos``
    with and without a (linear, antialiased) resize, non-integer
    coordinates included; ``SAMImageEncoder`` against JAX and against HF's
    ``SamVisionEncoder``; trap C28: with rel_pos tables that are not 0 the
    port follows JAX, which departs from HF; trap C27: a SAM bundle builds
    in the port where JAX's ``build_model_tokenizer`` raises.
  * Resampler: against JAX with keys on the query grid and on a larger one
    (the bicubic pos_embed resize); a trained ``pos_embed`` survives
    conversion bit for bit; the sin-cos table when it is absent. The Qwen
    and SAM projectors against JAX.

Tolerances: converted leaves exact; a resized relative table 1e-6 (JAX
sums its resize in one einsum); outputs 1e-4 against JAX (1e-5 for a
projector alone) and the JAX package's own tolerances against HF.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from merlin_tpu.models import projectors as jp
from merlin_tpu.models import sam_vit as jsam

from merlin_tpu_torch.models import projectors as tp
from merlin_tpu_torch.models import sam_vit as tsam
from merlin_tpu_torch.models import vision_builder as tvb
from merlin_tpu_torch.models import vit as tvit
from merlin_tpu_torch.models.bridge import params_from_flax
from merlin_tpu_torch.models.convert import flat_state_dict

from test_torch_towers import _hold, _init, _pixels


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ---------------------------------------------------------------------------
# SAM
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hw,win", [((8, 8), 4), ((10, 12), 4), ((7, 5), 3)])
def test_window_partition_round_trip(hw, win):
    x = np.random.default_rng(0).normal(size=(2,) + hw + (4,)).astype(
        np.float32)
    jw, jpad = jsam.window_partition(jnp.asarray(x), win)
    tw, tpad = tsam.window_partition(torch.from_numpy(x), win)
    assert tuple(tpad) == tuple(jpad)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    back = tsam.window_unpartition(tw, win, tpad, hw)
    np.testing.assert_array_equal(back.numpy(), x)


@pytest.mark.parametrize("q,k,rows", [(4, 4, 7), (4, 4, 11), (4, 4, 3),
                                      (3, 5, 9), (6, 4, 11), (5, 3, 13)])
def test_get_rel_pos_matches_jax(q, k, rows):
    """The table at the right length, resized up or down (linear,
    antialiased on the way down), and coordinates that are not integers
    (q != k), truncated toward zero as astype(int32) does."""
    table = np.random.default_rng(1).normal(size=(rows, 6)).astype(
        np.float32)
    want = np.asarray(jsam.get_rel_pos(q, k, jnp.asarray(table)))
    got = tsam.get_rel_pos(q, k, torch.from_numpy(table)).numpy()
    assert got.shape == want.shape == (q, k, 6)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def _hf_to_official(sd):
    out = {}
    for k, v in sd.items():
        k = k.replace("neck.conv1", "neck.0").replace("neck.layer_norm1",
                                                      "neck.1")
        k = k.replace("neck.conv2", "neck.2").replace("neck.layer_norm2",
                                                      "neck.3")
        k = k.replace("layers.", "blocks.")
        k = k.replace("patch_embed.projection", "patch_embed.proj")
        k = k.replace("layer_norm1", "norm1").replace("layer_norm2", "norm2")
        out[k] = v
    return out


def _sam_hf(rel_pos_std):
    from transformers import SamVisionConfig
    from transformers.models.sam.modeling_sam import SamVisionEncoder

    torch.manual_seed(0)
    hf = SamVisionEncoder(SamVisionConfig(
        hidden_size=16, num_hidden_layers=2, num_attention_heads=2,
        image_size=32, patch_size=4, window_size=4, global_attn_indexes=[1],
        use_rel_pos=True, output_channels=8, mlp_ratio=4.0,
        layer_norm_eps=1e-6, use_abs_pos=True)).eval()
    with torch.no_grad():
        hf.pos_embed.normal_(0.0, 0.1)
        for name, p in hf.named_parameters():
            if "rel_pos" in name:
                p.normal_(0.0, rel_pos_std) if rel_pos_std else p.zero_()
    return hf


def _sam_run(hf):
    jcfg, tcfg = jsam.tiny_sam(), tsam.tiny_sam()
    sd = _hf_to_official(hf.state_dict())
    jtree = jsam.sam_params_from_torch(sd, jcfg)
    want = params_from_flax(jtree)
    got = flat_state_dict(tsam.sam_params_from_torch(sd, tcfg))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        assert torch.equal(got[name], w), name
    pixels = _pixels(2, 32)
    enc = tsam.SAMImageEncoder(tcfg)
    ours = _hold(enc, jsam.SAMImageEncoder(jcfg), jtree, pixels)
    with torch.no_grad():
        theirs = hf(torch.from_numpy(pixels.transpose(0, 3, 1, 2))
                    ).last_hidden_state
    return ours, theirs.permute(0, 2, 3, 1).reshape(2, -1, 8).numpy()


def test_sam_encoder_matches_jax_and_hf():
    """Zero relative tables (HF's init) and a non-zero position table: the
    port, JAX and HF agree (the JAX package's HF tolerance)."""
    ours, theirs = _sam_run(_sam_hf(0.0))
    assert ours.shape == (2, 64, 8)
    np.testing.assert_allclose(ours, theirs, atol=5e-4, rtol=5e-3)


def test_sam_rel_pos_w_follows_jax_not_hf():
    """Trap C28: JAX adds the W relative bias broadcast along the key rows
    (``bias_w[:, :, None, :]``); with trained (non-zero) tables that
    departs from SAM/HF. The port keeps JAX's result (held to 1e-4 inside
    ``_sam_run``), so it departs from HF too."""
    ours, theirs = _sam_run(_sam_hf(0.5))
    assert np.abs(ours - theirs).max() > 1e-1


def test_sam_tower_through_the_builder():
    tower = tvb.build_vision_tower("sam", tsam.tiny_sam())
    assert isinstance(tower, tsam.SAMImageEncoder)
    with torch.no_grad():
        out = tower(torch.ones(1, 32, 32, 3))
    assert out.shape == (1, 64, 8)
    with pytest.raises(TypeError):
        tvb.build_vision_tower("sam", tvit.tiny_vit())


# ---------------------------------------------------------------------------
# projectors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p", [16, 64], ids=["query-grid", "larger-grid"])
def test_resampler_matches_jax(p):
    """16 queries over 16 keys, and over 64 keys (the pos_embed bicubic-
    resized to the 8x8 key grid)."""
    dim, heads, c_in = 16, 2, 12
    jmod = jp.Resampler(out_features=24, num_queries=16, num_heads=heads,
                        embed_dim=dim, dtype=jnp.float32)
    x = np.random.default_rng(4).normal(size=(2, p, c_in)).astype(np.float32)
    params = _init(jmod, 3, x)
    tmod = tp.Resampler(c_in, 24, num_queries=16, num_heads=heads,
                        embed_dim=dim, dtype=torch.float32)
    got = _hold(tmod, jmod, params, x)
    assert got.shape == (2, 16, 24)
    # the pos_embed reaches the output, without a gradient
    x_t = torch.from_numpy(x)
    out = tmod(x_t).sum()
    out.backward()
    assert tmod.pos_embed.grad is None and tmod.query.grad is not None


def _resampler_sd(dim, c_in, nq, rng, pos_embed=True, post=True):
    def r(*shape):
        return torch.from_numpy(rng.normal(scale=0.1, size=shape).astype(
            np.float32))
    sd = {"attn_pool.query": r(nq, dim), "attn_pool.kv_proj.weight":
          r(dim, c_in), "attn_pool.ln_q.weight": 1 + r(dim),
          "attn_pool.ln_q.bias": r(dim), "attn_pool.ln_kv.weight": 1 + r(dim),
          "attn_pool.ln_kv.bias": r(dim),
          "attn_pool.attn.in_proj_weight": r(3 * dim, dim),
          "attn_pool.attn.in_proj_bias": r(3 * dim),
          "attn_pool.attn.out_proj.weight": r(dim, dim),
          "attn_pool.attn.out_proj.bias": r(dim)}
    if pos_embed:
        # a trained table: sin-cos plus a visible perturbation
        sd["attn_pool.pos_embed"] = torch.from_numpy(
            jp._sincos_2d_pos_embed(dim, int(math.isqrt(nq)))) + r(nq, dim)
    if post:
        sd.update({"ln_post.weight": 1 + r(dim), "ln_post.bias": r(dim),
                   "proj": r(dim, 24)})
    return sd


@pytest.mark.parametrize("pos_embed", [True, False],
                         ids=["trained-pos", "no-pos"])
def test_resampler_params_from_torch_matches_jax(pos_embed):
    dim, heads, c_in, nq = 16, 2, 12, 16
    sd = _resampler_sd(dim, c_in, nq, np.random.default_rng(5), pos_embed)
    jtree = jp.resampler_params_from_torch(sd, dim=dim, num_heads=heads)
    want = params_from_flax(jtree)
    got = flat_state_dict(tp.resampler_params_from_torch(
        sd, dim=dim, num_heads=heads))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        assert torch.equal(got[name], w), name
    if pos_embed:
        assert torch.equal(got["pos_embed"], sd["attn_pool.pos_embed"])
    else:
        np.testing.assert_array_equal(got["pos_embed"].numpy(),
                                      jp._sincos_2d_pos_embed(dim, 4))
    x = np.random.default_rng(6).normal(size=(2, 36, c_in)).astype(
        np.float32)
    jmod = jp.Resampler(out_features=24, num_queries=nq, num_heads=heads,
                        embed_dim=dim, dtype=jnp.float32)
    tmod = tp.Resampler(c_in, 24, num_queries=nq, num_heads=heads,
                        embed_dim=dim, dtype=torch.float32)
    _hold(tmod, jmod, jax.tree.map(jnp.asarray, jtree), x)


def test_resampler_without_ln_post_keeps_its_own():
    dim, heads = 16, 2
    sd = _resampler_sd(dim, 12, 16, np.random.default_rng(7), post=False)
    got = flat_state_dict(tp.resampler_params_from_torch(
        sd, dim=dim, num_heads=heads))
    assert not any(k.startswith(("ln_post", "proj")) for k in got)


@pytest.mark.parametrize("kind", ["qwen", "sam"])
def test_qwen_and_sam_projectors_match_jax(kind):
    c, out = 8, 24
    jmod = jp.build_projector(kind, out, dtype=jnp.float32)
    x = np.random.default_rng(8).normal(size=(2, 64, c)).astype(np.float32)
    params = _init(jmod, 4, x)
    tmod = tp.build_projector(kind, c, out, dtype=torch.float32)
    got = _hold(tmod, jmod, params, x, atol=1e-5)
    assert got.shape == (2, 64 if kind == "qwen" else 4, out)


def test_unknown_projector_kind_is_refused():
    with pytest.raises(ValueError, match="unknown projector kind"):
        tp.build_projector("perceiver", 8, 8)


def test_sam_bundle_builds_where_jax_raises(monkeypatch):
    """Trap C27: JAX's ``build_model_tokenizer`` raises for a SAM tower
    (its freeze mask reads ``num_layers``); the port builds the bundle at
    SAM's native 1024 px, with the SAM projector's (64 / 4)^2 tokens, and
    holds no SAM block back from training. No tokenizer is fetched: the
    loads are stubbed to fail, as offline."""
    from merlin_tpu.models import builder as j_builder
    from merlin_tpu.train.arguments import parse_args as j_parse_args
    from merlin_tpu_torch.models import builder as t_builder
    from merlin_tpu_torch.train.arguments import parse_args

    def refuse(path, **kw):
        raise OSError(f"offline test: no tokenizer for {path}")

    monkeypatch.setattr(j_builder, "load_tokenizer", refuse)
    monkeypatch.setattr(t_builder, "load_tokenizer", refuse)
    argv = ["--vision_tower", "facebook/sam-vit-base", "--projector", "sam"]
    with pytest.raises(AttributeError, match="num_layers"):
        j_builder.build_model_tokenizer(*j_parse_args(argv))
    margs, dargs, targs = parse_args(argv)
    bundle = t_builder.build_model_tokenizer(margs, dargs, targs)
    assert bundle.config.vision_kind == "sam"
    assert isinstance(bundle.model.vision_tower, tsam.SAMImageEncoder)
    assert dargs.image_size == 1024 and dargs.num_patches == 256
    assert bundle.config.image_token_len == 256
    assert bundle.trainable_mask(("vision_tower", "blocks_11", "mlp"))
