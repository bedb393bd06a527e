"""The port's vision tower and projectors against the JAX package on the CPU:
tiny CLIP tower (``tiny_vit``), the taps ``StridedConv`` and the conv/MLP
projectors, and the image-embed splice.

f32 holds to 1e-4 (summation order through two transformer layers). Trap
C4: in bf16 the taps lowering rounds each of its nine partial products
before adding them, on both sides, so the port's bf16 projector is held to
the JAX one at 2e-2 (a few bf16 ulps of outputs of magnitude ~1), and at
f32 to 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from merlin_tpu.models import projectors as jp
from merlin_tpu.models.mmgpt import splice_image_embeds as j_splice
from merlin_tpu.models.vit import CLIPVisionTower as JTower
from merlin_tpu.models.vit import tiny_vit as j_tiny_vit

from merlin_tpu_torch.models import projectors as tp
from merlin_tpu_torch.models.bridge import params_from_flax
from merlin_tpu_torch.models.mmgpt import splice_image_embeds
from merlin_tpu_torch.models.vision_builder import build_vision_tower
from merlin_tpu_torch.models.vit import tiny_vit


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _perturbed(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda p: np.asarray(p) + 0.05 * rng.normal(size=p.shape).astype(
            np.float32), params)


@pytest.mark.parametrize("select_layer,feature", [(-2, "patch"),
                                                  (-1, "cls_patch")])
def test_clip_tower_matches_jax_f32(select_layer, feature):
    jtower = JTower(j_tiny_vit(), select_layer=select_layer,
                    select_feature=feature)
    pixels = np.random.default_rng(0).normal(size=(2, 16, 16, 3)).astype(
        np.float32)
    params = _perturbed(fnn.unbox(jtower.init(
        jax.random.key(0), jnp.asarray(pixels))["params"]), 1)
    ttower = build_vision_tower("clip", tiny_vit(), select_layer=select_layer,
                                select_feature=feature)
    ttower.load_state_dict(params_from_flax(params), strict=True)
    want = np.asarray(jtower.apply({"params": params}, jnp.asarray(pixels)))
    with torch.no_grad():
        got = ttower(torch.from_numpy(pixels)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("H,W,cin,cout,s", [(8, 8, 16, 24, 2), (7, 7, 8, 8, 1),
                                            (6, 6, 4, 12, 3)])
def test_strided_conv_taps_matches_jax_f32(H, W, cin, cout, s):
    x = np.random.default_rng(3).normal(size=(2, H, W, cin)).astype(np.float32)
    jmod = jp.StridedConv(cout, stride=s, dtype=jnp.float32)
    params = _perturbed(fnn.unbox(jmod.init(jax.random.key(0),
                                            jnp.asarray(x))["params"]), 2)
    tmod = tp.StridedConv(cin, cout, stride=s, dtype=torch.float32)
    tmod.load_state_dict(params_from_flax(params), strict=True)
    want = np.asarray(jmod.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("kind,dtype,tol", [
    ("conv", "f32", 1e-5), ("conv", "bf16", 2e-2), ("mlp", "f32", 1e-5)])
def test_projectors_match_jax(kind, dtype, tol):
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    x = np.random.default_rng(4).normal(size=(2, 64, 16)).astype(np.float32)
    jmod = jp.build_projector(kind, 32, dtype=jdt)
    params = _perturbed(fnn.unbox(jmod.init(jax.random.key(0),
                                            jnp.asarray(x))["params"]), 3)
    tmod = tp.build_projector(kind, 16, 32, dtype=tdt)
    tmod.load_state_dict(params_from_flax(params), strict=True)
    want = np.asarray(jmod.apply({"params": params},
                                 jnp.asarray(x)).astype(jnp.float32))
    with torch.no_grad():
        got = tmod(torch.from_numpy(x)).float().numpy()
    assert got.shape == ((2, 16, 32) if kind == "conv" else (2, 64, 32))
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


def test_splice_matches_jax():
    rng = np.random.default_rng(5)
    embeds = rng.normal(size=(2, 10, 4)).astype(np.float32)
    mask = np.zeros((2, 10), bool)
    mask[0, 2:5] = True
    mask[1, 6:8] = True
    feats = rng.normal(size=(2, 3, 4)).astype(np.float32)
    want = np.asarray(j_splice(jnp.asarray(embeds), jnp.asarray(mask),
                               jnp.asarray(feats)))
    got = splice_image_embeds(torch.from_numpy(embeds),
                              torch.from_numpy(mask),
                              torch.from_numpy(feats)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0, 2:5], feats[0])
    np.testing.assert_array_equal(got[1, 6:8], feats[1, :2])
