"""The port's image ops (gyre_tpu_torch/ops/images.py) against the JAX
package's (gyre_tpu/ops/images.py), in f32 on the CPU, on the same numpy
inputs from a seed. Tolerances: 1e-5 absolute for the elementwise and
convolutional ops, 1e-4 for the iterative ones (infill, tv_denoise,
guided_filter); box_sum's differences of running sums to 2 ulps of the
largest running sum.
The shuffle gets the JAX package's flow."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gyre_tpu.ops import images as J
from gyre_tpu_torch.ops import images as T

RNG = np.random.default_rng(11)
IMG = RNG.random((2, 64, 48, 3)).astype(np.float32)
RGBA = RNG.random((1, 64, 64, 4)).astype(np.float32)
MASK = (RNG.random((2, 64, 48, 1)) > 0.4).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _err(ref, got):
    return float(np.abs(np.asarray(ref, np.float32) - got.numpy()).max())


ELEMENTWISE = {
    "levels": (lambda m, x: m.levels(x, 0.1, 0.8, 0.2, 0.9), IMG),
    "invert": (lambda m, x: m.invert(x), IMG),
    "channelmap_copy": (lambda m, x: m.channelmap(x, "b", "r"), RGBA),
    "channelmap_new": (lambda m, x: m.channelmap(x, "g", "a"), IMG),
    "channelmap_one": (lambda m, x: m.channelmap(x, "one", "g"), IMG),
    "crop": (lambda m, x: m.crop(x, 5, 7, 30, 20), IMG),
    "palletize": (lambda m, x: m.palletize(x, 8), IMG),
    "quantize": (lambda m, x: m.quantize(x, 0.3), IMG),
}
CONVOLUTIONAL = {
    "directionalblur_up": (lambda m, x: m.directionalblur(x, 3.0, "up"),
                           IMG),
    "directionalblur_down": (lambda m, x: m.directionalblur(x, 2.0, "down"),
                             IMG),
    "autoscale": (lambda m, x: m.autoscale(x, 40, 72), IMG),
    "rescale_strict": (lambda m, x: m.rescale(x, 40, 72, fit="strict"), IMG),
    "rescale_contain": (lambda m, x: m.rescale(x, 40, 72, fit="contain"),
                        IMG),
    "conv3": (lambda m, x: m._conv3(x[..., :1], m._SOBEL_X), IMG),
    "sobel_magnitude": (lambda m, x: m.sobel_edges(x)[0], IMG),
    "canny_edge": (lambda m, x: m.canny_edge(x), IMG),
    "canny_edge_thresholds": (lambda m, x: m.canny_edge(x, 0.05, 0.5), IMG),
    "normalmap": (lambda m, x: m.normalmap_from_depthmap(x[..., :1], 0.2),
                  IMG),
    "frequency_blend": (lambda m, x: m.frequency_blend(x, (1.0 - x) ** 2),
                        IMG),
}
ITERATIVE = {
    "infill": (lambda m, x: m.infill(x, MASK if m is J else _t(MASK)), IMG),
    "tv_denoise": (lambda m, x: m.tv_denoise(x, 0.2, 8), IMG),
    "guided_filter_gray": (lambda m, x: m.guided_filter(
        x[..., :1], x, radius=4), IMG),
    "guided_filter_rgb": (lambda m, x: m.guided_filter(
        x, x[..., 1:2], radius=6, eps=1e-4), IMG),
}


@pytest.mark.parametrize("name,tol", [(n, 1e-5) for n in ELEMENTWISE] +
                         [(n, 1e-5) for n in CONVOLUTIONAL] +
                         [(n, 1e-4) for n in ITERATIVE])
def test_image_op_matches_jax(name, tol):
    fn, x = {**ELEMENTWISE, **CONVOLUTIONAL, **ITERATIVE}[name]
    ref = fn(J, jnp.asarray(x))
    got = fn(T, _t(x))
    assert tuple(got.shape) == tuple(ref.shape)
    assert _err(ref, got) <= tol


def test_canny_finds_edges():
    """The canny case above is not vacuous: it marks some pixels."""
    got = T.canny_edge(_t(IMG))
    assert 0.01 < float(got.mean()) < 0.9


def test_sobel_direction_matches_jax():
    """atan2 of the gradient, where the gradient's magnitude exceeds 0.1:
    an angle moves by about the gradient's rounding over its magnitude, so
    near zero it is ill-conditioned."""
    mag, theta = J.sobel_edges(jnp.asarray(IMG))
    tmag, ttheta = T.sobel_edges(_t(IMG))
    strong = np.asarray(mag) > 0.1
    assert strong.mean() > 0.5
    diff = np.abs(np.asarray(theta) - ttheta.numpy())[strong]
    assert diff.max() <= 1e-5
    assert _err(mag, tmag) <= 1e-5


@pytest.mark.parametrize("radius", [1, 3, 20])
def test_box_sum_matches_jax(radius):
    """Differences of running sums: within 2 f32 ulps of the largest
    running sum (the whole image's sum)."""
    ref = np.asarray(J.box_sum(jnp.asarray(IMG), radius))
    got = T.box_sum(_t(IMG), radius).numpy()
    prefix = IMG.sum(axis=(1, 2)).max()
    assert np.abs(ref - got).max() <= 2 * np.finfo(np.float32).eps * prefix


@pytest.mark.parametrize("seed,tile", [(0, 64), (5, 16)])
def test_shuffle_with_the_jax_flow(seed, tile):
    """The JAX shuffle draws its flow from split(PRNGKey(seed))[0]; given
    that flow, the port moves every pixel as it does."""
    key = jax.random.PRNGKey(seed)
    b, h, w, _ = IMG.shape
    flow = jax.random.normal(jax.random.split(key)[0],
                             (b, h // tile + 1, w // tile + 1, 2))
    ref = J.shuffle(jnp.asarray(IMG), key, tile)
    got = T.shuffle(_t(IMG), _t(np.asarray(flow)), tile)
    assert _err(ref, got) == 0.0
    assert _err(IMG, got) > 0.1          # it moved pixels


def test_shuffle_flow_is_seeded():
    a = T.shuffle_flow(IMG.shape, 1)
    assert a.shape == (2, 2, 1, 2)
    assert torch.equal(a, T.shuffle_flow(IMG.shape, 1))
    assert not torch.equal(a, T.shuffle_flow(IMG.shape, 2))


@pytest.mark.parametrize("fit", ["cover", "strict", "contain"])
@pytest.mark.parametrize("size", [(40, 72), (96, 30)])
def test_rescale_fits_match_jax(fit, size):
    ref = J.rescale(jnp.asarray(IMG), *size, fit=fit)
    assert _err(ref, T.rescale(_t(IMG), *size, fit=fit)) <= 1e-5
