"""The port's image preprocessing against the JAX package on the CPU.

Trap C1: ``jax.image.resize(..., "bicubic")`` is Keys a=-0.5 with
antialiasing when it downscales; ``F.interpolate`` is a=-0.75 without. The
port writes JAX's weights out, so it holds to 1e-5 (f32, summation order)
on downscales that are not to the target size, e.g. 40x30 -> 16.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from merlin_tpu.ops import image_ops as jops

from merlin_tpu_torch.ops import image_ops as tops

TOL = 1e-5


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _frames(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, size=shape,
                                                dtype=np.uint8)


@pytest.mark.parametrize("mode", ["resize", "pad", "none"])
@pytest.mark.parametrize("hw", [(30, 40), (40, 30), (9, 13)])
def test_preprocess_matches_jax(mode, hw):
    frames = _frames((2,) + hw + (3,))
    want = np.asarray(jops.preprocess_images(jnp.asarray(frames),
                                             image_size=16, aspect_mode=mode))
    got = tops.preprocess_images(frames, image_size=16, aspect_mode=mode,
                                 device="cpu")
    assert got.shape == (2, 16, 16, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)


def test_resize_bicubic_float_and_identity():
    x = np.random.default_rng(1).random((1, 12, 20, 3)).astype(np.float32)
    for size in [(5, 7), (24, 33), (12, 9)]:
        want = np.asarray(jops.resize_bicubic(jnp.asarray(x), size))
        got = tops.resize_bicubic(torch.from_numpy(x), size).numpy()
        np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    same = tops.resize_bicubic(torch.from_numpy(x), (12, 20)).numpy()
    np.testing.assert_array_equal(same, x)


def test_f_interpolate_is_not_jax_bicubic():
    """Documents trap C1: torch's own bicubic downscale is another function."""
    x = np.random.default_rng(2).random((1, 40, 40, 3)).astype(np.float32)
    want = np.asarray(jops.resize_bicubic(jnp.asarray(x), (16, 16)))
    theirs = F.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2),
                           size=(16, 16), mode="bicubic",
                           align_corners=False).permute(0, 2, 3, 1).numpy()
    assert np.abs(theirs - want).max() > 1e-2
    ours = tops.resize_bicubic(torch.from_numpy(x), (16, 16)).numpy()
    np.testing.assert_allclose(ours, want, atol=TOL, rtol=TOL)


def test_helpers_match_jax():
    frames = _frames((1, 6, 9, 3), seed=3)
    np.testing.assert_allclose(
        tops.expand2square(torch.from_numpy(frames)).numpy(),
        np.asarray(jops.expand2square(jnp.asarray(frames))), rtol=1e-6)
    np.testing.assert_allclose(
        tops.normalize(torch.from_numpy(frames)).numpy(),
        np.asarray(jops.normalize(jnp.asarray(frames))), atol=TOL, rtol=TOL)
    x = np.arange(1 * 7 * 9 * 2, dtype=np.float32).reshape(1, 7, 9, 2)
    np.testing.assert_array_equal(
        tops.center_crop(torch.from_numpy(x), 5).numpy(),
        np.asarray(jops.center_crop(jnp.asarray(x), 5)))
