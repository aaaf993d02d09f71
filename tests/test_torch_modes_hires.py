"""The port's hires fix, seamless tiling and tiled VAE decode against the
JAX package's UnifiedPipeline on SD_TEST, as tests/test_torch_modes.py
does for img2img and inpaint: the JAX package's draws injected at the
port's seam, images within 2e-3 absolute in [0, 1].

The hires fix runs at 128 px: 16 latents against SD_TEST's native 8, so
the low-resolution pass runs at 8 (96 px, 12 latents, would give a UNet
level of 3, which the 4-level UNet cannot halve and double back).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gyre_tpu.models import configs
from test_torch_modes import (REQUEST, check_images, init_image,  # noqa: F401
                              jax_draws, make_pipes, one_torch_thread)

HIRES = 128


@pytest.fixture(scope="module")
def pipes():
    return make_pipes(configs.SD_TEST)


@pytest.mark.parametrize("kwargs", [
    {"sampler": "k_euler_ancestral"},
    {"init_image": init_image(HIRES), "strength": 0.7}],
    ids=["txt2img_ancestral", "img2img"])
def test_hires_fix_matches_jax(pipes, jax_draws, kwargs):  # noqa: F811
    """Low- and high-resolution latents denoised together: the native-size
    noise from the "hires_lo" sub-stream, the sampler's noise of the low
    rows from "lo", the random map cross-injecting x0 both ways."""
    check_images(pipes, dict(REQUEST, height=HIRES, width=HIRES,
                             hires_fix=True, **kwargs), size=HIRES)


def test_hires_fix_runs_unchunked(pipes):
    """As in the JAX package: no chunks, so no progress until the end."""
    seen = []
    gen = pipes[1].begin(**dict(REQUEST, height=HIRES, width=HIRES,
                                hires_fix=True, chunk_steps=2,
                                progress_callback=lambda d, n:
                                seen.append(d), return_latents=True))
    with pytest.raises(StopIteration) as stop:
        next(gen)
    assert seen == [REQUEST["steps"]]
    assert stop.value.value.shape == (2, 16, 16, 4)


@pytest.mark.parametrize("tiling", [True, "x", "y"])
def test_tiling_matches_jax(pipes, jax_draws, tiling):  # noqa: F811
    check_images(pipes, dict(REQUEST, tiling=tiling))


@pytest.mark.parametrize("tx,ty", [(True, False), (False, True),
                                   (True, True)])
def test_conv2d_tiled_matches_jax_and_wraps(tx, ty):
    """layers.conv2d_tiled against the JAX package's (HWIO there, OIHW
    here), and seamless: rolling the input along a tiled axis rolls the
    output."""
    from gyre_tpu.models import layers as jlayers
    from gyre_tpu_torch.models import layers as tlayers

    r = np.random.default_rng(0)
    x = r.standard_normal((2, 7, 9, 5)).astype(np.float32)
    w = r.standard_normal((3, 3, 5, 6)).astype(np.float32)
    b = r.standard_normal(6).astype(np.float32)
    ref = np.asarray(jlayers.conv2d_tiled(
        {"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x),
        tiling_x=tx, tiling_y=ty))
    tp = {"w": torch.from_numpy(w).permute(3, 2, 0, 1),
          "b": torch.from_numpy(b)}
    out = tlayers.conv2d_tiled(tp, torch.from_numpy(x), tiling_x=tx,
                               tiling_y=ty)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5)
    dim = 2 if tx else 1
    rolled = tlayers.conv2d_tiled(tp, torch.from_numpy(x).roll(2, dim),
                                  tiling_x=tx, tiling_y=ty)
    torch.testing.assert_close(rolled.roll(-2, dim), out, rtol=1e-5,
                               atol=1e-5)


def test_tiled_decode_matches_jax(pipes):
    """Past the (lowered) threshold the VAE decodes in feathered tiles, as
    the JAX package's does."""
    jpipe, tpipe = pipes
    for p in pipes:
        p.VAE_TILE_THRESHOLD, p.VAE_TILE, p.VAE_TILE_OVERLAP = 24, 16, 4
    try:
        lat = np.random.RandomState(0).randn(1, 32, 40, 4).astype(
            np.float32)
        ref = np.asarray(jpipe.vae_decode(jnp.asarray(lat)))
        out = tpipe.vae_decode(torch.from_numpy(lat)).numpy()
        assert out.shape == ref.shape == (1, 256, 320, 3)
        assert np.abs(out - ref).max() <= 2e-3
        whole = tpipe._vae_decode_whole(torch.from_numpy(lat)).numpy()
        assert np.abs(out - whole).max() > 1e-3      # it did tile
    finally:
        for p in pipes:
            del p.VAE_TILE_THRESHOLD, p.VAE_TILE, p.VAE_TILE_OVERLAP
