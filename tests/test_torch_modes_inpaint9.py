"""The port's 9-channel inpaint, 5-channel depth2img and graft modes end to
end against the JAX package's UnifiedPipeline on SD_TEST-sized UNets with
9 and 5 input channels, as tests/test_torch_modes.py does for img2img and
inpaint: the JAX package's draws injected at the port's seam, images
within 2e-3 absolute in [0, 1].
"""

import dataclasses

import pytest

from gyre_tpu.models import configs
from test_torch_modes import (REQUEST, check_images,  # noqa: F401
                              init_image, jax_draws, make_pipes, mask_image,
                              one_torch_thread)

CFG9 = dataclasses.replace(
    configs.SD_TEST,
    unet=dataclasses.replace(configs.SD_TEST.unet, in_channels=9))
CFG5 = dataclasses.replace(
    configs.SD_TEST,
    unet=dataclasses.replace(configs.SD_TEST.unet, in_channels=5))


@pytest.fixture(scope="module")
def pipes9():
    """The 9-channel root, with SD_TEST grafted on top in the second
    pair (both pairs share no weights)."""
    return make_pipes(CFG9), make_pipes(CFG9, graft_cfg=configs.SD_TEST)


def test_inpaint9_matches_jax(pipes9, jax_draws):  # noqa: F811
    """The mask and the masked image's latents as extra channels, the
    canvas from the encoded init image plus full noise, and the outmask
    composite."""
    check_images(pipes9[0], dict(REQUEST, init_image=init_image(),
                                 mask_image=mask_image(), strength=1.0))


def test_graft_matches_jax(pipes9, jax_draws):  # noqa: F811
    """An inpaint9 root with a 4-channel top model blended in."""
    check_images(pipes9[1], dict(REQUEST, init_image=init_image(),
                                 mask_image=mask_image(), strength=1.0))


def test_graft_chunked_equals_unchunked(pipes9):
    """At the default strength 0.8 the masked request runs 4 of 5 steps."""
    from test_torch_pipeline_samplers import check_chunked

    check_chunked(pipes9[1][1], dict(
        REQUEST, steps=5, init_image=init_image(), mask_image=mask_image()),
        4)


def test_nine_channel_unet_needs_a_mask(pipes9):
    with pytest.raises(ValueError, match="mask"):
        pipes9[0][1](**dict(REQUEST, init_image=init_image()))


@pytest.fixture(scope="module")
def pipes5():
    return make_pipes(CFG5)


@pytest.mark.parametrize("depth", [False, True], ids=["blur", "depth_map"])
def test_depth2img_matches_jax(pipes5, jax_draws, depth):  # noqa: F811
    """The 5th channel: a sent depth map, or the init image's blurred
    grayscale when none is sent."""
    kw = dict(REQUEST, init_image=init_image(), strength=0.75)
    if depth:
        kw["depth_map"] = init_image(seed=5)[..., :1]
    check_images(pipes5, kw)


def test_depth2img_needs_a_depth_source(pipes5):
    with pytest.raises(ValueError, match="depth"):
        pipes5[1](**REQUEST)
