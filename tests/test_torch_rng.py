"""The port's threefry (gyre_tpu_torch/utils/rng.py) against jax.random and
the JAX package's draws, and the port's images for a seed against the JAX
package's with no noise put in.

Tolerances: keys, bits, uniforms and randint exactly equal; a normal within
3 ulp of ``jax.random.normal`` (the port's erfinv is XLA's polynomial,
within 2 ulp of ``jax.lax.erf_inv``: the two log1p differ in the last
bit, and sqrt(2) rounds once more); images within 2e-3 absolute in [0, 1]
(f32, as tests/test_torch_pipeline.py); crop offsets exactly equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from gyre_tpu.models import configs
from gyre_tpu.models import modelset as jms
from gyre_tpu.ops import images as jimages
from gyre_tpu.pipeline import unified as junified
from gyre_tpu.utils import rng as jrng
from gyre_tpu_torch.models import modelset as tms
from gyre_tpu_torch.ops import images as timages
from gyre_tpu_torch.pipeline import clip_guidance as tcg
from gyre_tpu_torch.pipeline import unified as tunified
from gyre_tpu_torch.utils import rng as trng
from test_torch_guidance import jax_offsets
from test_torch_modes import one_torch_thread  # noqa: F401

SEEDS = [0, 1, 2 ** 31, 2 ** 32 - 1]
SHAPES = [(), (7,), (3, 4, 2), (2, 16, 16, 4)]
CFG = configs.SD_TEST
REQUEST = dict(prompt="a (red:1.2) boat at [dusk]", negative_prompt="blurry",
               height=64, width=64, steps=4, guidance_scale=7.5,
               seeds=[3, 4])


def _key(k):
    return tuple(int(v) for v in np.asarray(k))


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_match_jax(seed):
    """PRNGKey, fold_in (a negative int32 too), split, and the JAX
    package's stream and step keys."""
    jk = jax.random.PRNGKey(jnp.asarray(seed, jnp.uint32))
    tk = trng.key_for_seed(seed)
    assert _key(jk) == tk == _key(jrng.key_for_seed(seed))
    for data in (0, 1, 7, 2 ** 31 + 5, 2 ** 32 - 1):
        assert _key(jax.random.fold_in(jk, data)) == trng.fold_in(tk, data)
    q = jnp.asarray(-1178, jnp.int32)          # brownian's log sigma < 0
    assert _key(jax.random.fold_in(jk, q)) == trng.fold_in(tk, -1178)
    for num in (2, 3, 5):
        assert [_key(k) for k in jax.random.split(jk, num)] == \
            trng.split(tk, num)
    for name in ("init", "clip_cuts_rgb", "hires_lo"):
        js = jrng.stream(jk, name)
        assert _key(js) == trng.stream(tk, name)
        assert _key(jrng.step_key(js, 17)) == trng.step_key(
            trng.stream(tk, name), 17)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("seed", SEEDS)
def test_bits_uniform_normal_match_jax(seed, shape):
    jk = jax.random.fold_in(jax.random.PRNGKey(
        jnp.asarray(seed, jnp.uint32)), 3)
    tk = trng.fold_in(trng.key_for_seed(seed), 3)
    bits = trng._bits([tk], shape, "cpu")[0].numpy()
    assert np.array_equal(np.asarray(jax.random.bits(jk, shape),
                                     np.int64), bits)
    assert np.array_equal(np.asarray(jax.random.uniform(jk, shape)),
                          trng.uniform(tk, shape).numpy())
    lo = float(np.nextafter(np.float32(-1), np.float32(0)))
    u = jax.random.uniform(jk, shape, jnp.float32, lo, 1.0)
    assert np.array_equal(np.asarray(u), trng.uniform(tk, shape, "cpu", lo,
                                                      1.0).numpy())
    erf = trng.erfinv(torch.from_numpy(np.array(u))).numpy()
    assert _ulps(jax.lax.erf_inv(u), erf).max(initial=0) <= 2
    assert _ulps(jax.random.normal(jk, shape),
                 trng.normal(tk, shape).numpy()).max(initial=0) <= 3


@pytest.mark.parametrize("lo,hi", [(0, 1), (0, 10), (3, 3), (5, 2),
                                   (0, 70000), (-5, 2 ** 20), (0, 2 ** 31 - 1)])
@pytest.mark.parametrize("seed", SEEDS)
def test_randint_matches_jax(seed, lo, hi):
    jk = jax.random.PRNGKey(jnp.asarray(seed, jnp.uint32))
    tk = trng.key_for_seed(seed)
    assert int(jax.random.randint(jk, (), lo, hi)) == trng.randint(tk, lo,
                                                                   hi)
    assert np.float32(jax.random.uniform(jk)) == trng.uniform_scalar(tk)


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2 ** 32 - 1), data=st.integers(0, 2 ** 32 - 1),
       n=st.integers(1, 40))
def test_threefry_matches_jax_hypothesis(seed, data, n):
    jk = jax.random.fold_in(jax.random.PRNGKey(
        jnp.asarray(seed, jnp.uint32)), data)
    tk = trng.fold_in(trng.key_for_seed(seed), data)
    assert _key(jk) == tk
    assert np.array_equal(np.asarray(jax.random.bits(jk, (n,)), np.int64),
                          trng._bits([tk], (n,), "cpu")[0].numpy())


def test_draw_is_the_jax_package_draw():
    """``draw`` through the pipeline's keys (a seed, a seed and its
    sub-streams) and paths (names and steps) against the JAX package's
    helpers; each row from its own key alone."""
    keys = [5, (6, "lo"), (7, "hires_lo", "x")]

    def jkey(key):
        seed, *subs = key if isinstance(key, tuple) else (key,)
        k = jrng.key_for_seed(seed)
        for name in subs:
            k = jrng.stream(k, name)
        return k

    jkeys = jnp.stack([jkey(k) for k in keys])
    shape = (8, 8, 4)
    ref = np.asarray(jrng.batched_stream_normal(jkeys, "anc", 3, shape))
    got = trng.batched_stream_normal(keys, "anc", 3, shape, "cpu").numpy()
    assert _ulps(ref, got).max() <= 3
    ref = np.asarray(jrng.batched_uniform(jkeys, shape))
    assert np.array_equal(ref, trng.batched_uniform(keys, shape,
                                                    "cpu").numpy())
    alone = trng.batched_stream_normal(keys[1:2], "anc", 3, shape, "cpu")
    assert torch.equal(alone[0], torch.from_numpy(got[1]))


def test_cutout_offsets_match_jax():
    """CLIP guidance's crops at the JAX package's offsets for each seed and
    stream, with no offsets put in."""
    for stream, n, h, w, cut in (("clip_cuts_rgb", 4, 512, 512, 224),
                                 ("clip_cuts_rgb", 3, 64, 80, 24),
                                 ("clip_cuts_vae", 2, 64, 64, 28)):
        ref = jax_offsets([3, 4, 2 ** 32 - 1], stream, n, h, w, cut, 1.5)
        got = tcg.cutout_offsets([3, 4, 2 ** 32 - 1], stream, n, h, w, cut,
                                 1.5)
        assert np.array_equal(ref, got)


@pytest.mark.parametrize("seed", [0, 9])
def test_shuffle_flow_matches_jax(seed):
    """The shuffle adjustment's flow and the shuffled image, as JAX's
    ``shuffle(img, PRNGKey(seed))``."""
    img = np.random.default_rng(1).random((2, 128, 96, 3)).astype(np.float32)
    key = jax.random.split(jax.random.PRNGKey(seed))[0]
    flow = timages.shuffle_flow(img.shape, seed)
    ref = jax.random.normal(key, (2, 3, 2, 2))
    assert _ulps(ref, flow.numpy()).max() <= 3
    want = np.asarray(jimages.shuffle(jnp.asarray(img),
                                      jax.random.PRNGKey(seed)))
    got = timages.shuffle(torch.from_numpy(img), flow).numpy()
    assert np.array_equal(want, got)


@pytest.fixture(scope="module")
def pipes():
    ms = jms.random_modelset(CFG, seed=0, dtype=jnp.float32)
    tree = (jax.tree.map(np.asarray, ms.unet_params),
            jax.tree.map(np.asarray, ms.vae_params),
            [jax.tree.map(np.asarray, t) for t in ms.text_params])
    return (junified.UnifiedPipeline(ms, compute_dtype=jnp.float32),
            tunified.UnifiedPipeline(
                tms.from_jax_params(*tree, CFG, device="cpu"),
                compute_dtype=torch.float32))


@pytest.mark.parametrize("extra", [
    {"sampler": "k_dpmpp_2m"},
    {"sampler": "k_euler_ancestral"},
    {"sampler": "k_dpmpp_sde", "noise_type": "brownian"},
], ids=["dpmpp_2m", "euler_ancestral", "brownian"])
def test_seed_gives_the_jax_image(pipes, extra):
    """The same seeds give the JAX package's images, with nothing put in:
    the initial latents, the ancestral noise and the brownian noise (keyed
    by negative quantised log sigmas at the ramp's end) are threefry's."""
    jpipe, tpipe = pipes
    request = dict(REQUEST, **extra)
    ref = np.asarray(jpipe(**request))
    out = tpipe(**request).numpy()
    assert out.shape == ref.shape == (2, 64, 64, 3)
    assert np.abs(out - ref).max() <= 2e-3
    assert out.std() > 1e-2
