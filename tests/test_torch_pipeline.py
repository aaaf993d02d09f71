"""The port's txt2img pipeline (gyre_tpu_torch.pipeline.unified) against the
JAX package's UnifiedPipeline on the SD_TEST preset: 5 steps of k_dpmpp_2m,
CFG 7.5, f32, the JAX random weights carried over by the bridge and the
JAX package's initial noise injected for the same seeds (torch generators
cannot reproduce threefry; DPM++ 2M draws no other noise).

Tolerance: images agree within 2e-3 absolute in [0, 1]: f32 on both sides,
sums in another order through 5 UNet evaluations and the VAE decoder.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gyre_tpu.models import configs
from gyre_tpu.models import modelset as jms
from gyre_tpu.pipeline import modes as jmodes
from gyre_tpu.pipeline import unified as junified
from gyre_tpu.utils import rng as jrng
from gyre_tpu_torch.models import modelset as tms
from gyre_tpu_torch.pipeline import modes as tmodes
from gyre_tpu_torch.pipeline import unified as tunified
from gyre_tpu_torch.utils import rng as trng
from test_torch_modes import one_torch_thread  # noqa: F401

CFG = configs.SD_TEST
REQUEST = dict(prompt="a (red:1.2) boat at [dusk]", negative_prompt="blurry",
               height=64, width=64, steps=5, sampler="k_dpmpp_2m",
               guidance_scale=7.5, seeds=[3, 4])


@pytest.fixture(scope="module")
def pipes():
    ms = jms.random_modelset(CFG, seed=0, dtype=jnp.float32)
    tree = (jax.tree.map(np.asarray, ms.unet_params),
            jax.tree.map(np.asarray, ms.vae_params),
            [jax.tree.map(np.asarray, t) for t in ms.text_params])
    jpipe = junified.UnifiedPipeline(ms, compute_dtype=jnp.float32)
    tpipe = tunified.UnifiedPipeline(
        tms.from_jax_params(*tree, CFG, device="cpu"),
        compute_dtype=torch.float32)
    return jpipe, tpipe


def _jax_noise(seeds, shape, sigma_max, device, natural=0):
    keys = jrng.keys_for_seeds(np.asarray(seeds, np.uint32))
    x = jmodes.txt2img_initial(keys, shape, sigma_max, natural=natural)
    return torch.from_numpy(np.array(x)).to(device)


@pytest.fixture(scope="module")
def port_image(pipes):
    _, tpipe = pipes
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tmodes, "txt2img_initial", _jax_noise)
        return tpipe(**REQUEST)


def test_matches_jax_single_scan(pipes, port_image):
    jpipe, _ = pipes
    ref = np.asarray(jpipe(**REQUEST))          # one scan, no chunking
    out = port_image.numpy()
    assert out.shape == ref.shape == (2, 64, 64, 3)
    assert np.abs(out - ref).max() <= 2e-3


def test_chunked_equals_unchunked(pipes):
    _, tpipe = pipes
    whole = tpipe(**REQUEST)
    steps_seen = []
    chunked = tpipe(**REQUEST, chunk_steps=2, stop_event=threading.Event(),
                    progress_callback=lambda d, n: steps_seen.append((d, n)))
    assert torch.equal(chunked, whole)
    assert steps_seen == [(2, 5), (4, 5), (5, 5)]


def test_cancel_returns_none(pipes):
    _, tpipe = pipes
    ev = threading.Event()
    gen = tpipe.begin(**REQUEST, chunk_steps=2, stop_event=ev)
    assert next(gen) == (2, 5)
    ev.set()
    with pytest.raises(StopIteration) as stop:
        next(gen)
    assert stop.value.value is None


def test_uint8_output_and_per_sample_prompts(pipes, port_image):
    """Coalesced form: per-sample prompt lists and guidance vector give the
    rows the single-prompt call gives."""
    _, tpipe = pipes
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tmodes, "txt2img_initial", _jax_noise)
        out = tpipe(**dict(REQUEST, prompt=[REQUEST["prompt"]] * 2,
                           negative_prompt=[REQUEST["negative_prompt"]] * 2,
                           guidance_scale=[7.5, 7.5]),
                    output_dtype="uint8")
    assert out.dtype == torch.uint8 and out.shape == (2, 64, 64, 3)
    expect = (port_image * 255.0 + 0.5).clamp(0, 255).to(torch.uint8)
    assert (out.int() - expect.int()).abs().max() <= 1


def test_noise_is_per_seed():
    """Each row depends only on its own seed (batch independence)."""
    batch = trng.batched_normal([7, 9, 7], "init", (4, 4, 4), "cpu")
    alone = trng.batched_normal([9], "init", (4, 4, 4), "cpu")
    assert torch.equal(batch[1], alone[0])
    assert torch.equal(batch[0], batch[2])
    other = trng.batched_normal([7], "init_border", (4, 4, 4), "cpu")
    assert not torch.equal(batch[0], other[0])


@pytest.mark.parametrize("kwargs,match", [
    ({"hints": [{"image": np.ones((1, 64, 64, 3), np.float32)}]}, "C4"),
    ({"clip_guidance_scale": 0.5}, "C6"),
])
def test_unported_options_raise(pipes, kwargs, match):
    """An option not ported yet raises naming its ROADMAP item. Hints (C4)
    are ported since: a ControlNet as random_controlnet makes one (zero
    convs zero) gives the image without it in every bit, and only a style
    hint raises, naming C6 (the CLIP vision tower)."""
    from gyre_tpu_torch.models import controlnet as tcn

    _, tpipe = pipes
    if match == "C4":
        (hint,) = kwargs["hints"]
        hint = dict(hint, params=tcn.random_controlnet(
            CFG.unet, dtype=torch.float32, device="cpu"))
        assert torch.equal(tpipe(**dict(REQUEST, hints=[hint])),
                           tpipe(**REQUEST))
        kwargs, match = {"hints": [dict(hint, kind="style")]}, "C6"
    with pytest.raises(NotImplementedError, match=match):
        tpipe(**dict(REQUEST, **kwargs))


@pytest.mark.parametrize("kwargs", [
    {}, {"spacing": "leading"}, {"karras_rho": 7.0},
    {"karras_rho": 7.0, "sigma_min": 0.1, "sigma_max": 10.0},
    # img2img's truncated ramps, for every spacing
    {"strength": 0.6}, {"strength": 0.33, "spacing": "leading"},
    {"strength": 0.5, "karras_rho": 7.0},
    {"strength": 0.01, "uniform_lambda": True}, {"strength": 1.0}])
def test_sigma_ramps_match_jax(kwargs):
    from gyre_tpu.pipeline import schedule as jsched
    from gyre_tpu_torch.pipeline import schedule as tsched

    ref = jsched.build_sigmas(jsched.scaled_linear_schedule(), 20, **kwargs)
    out = tsched.build_sigmas(tsched.scaled_linear_schedule(), 20, **kwargs)
    np.testing.assert_allclose(out, ref, rtol=1e-12)


@pytest.mark.parametrize("params", [
    {}, {"warmup_lms": True}, {"ddim_cutoff": 1.0}])
def test_dpmpp_2m_variants_match_jax(params):
    """The sampler's update rules against the JAX package's on an analytic
    denoiser (tolerance 1e-5: f32 scan against f64 host coefficients)."""
    from gyre_tpu.pipeline import samplers as jsamp
    from gyre_tpu_torch.pipeline import samplers as tsamp

    sigmas = np.array([14.6, 6.0, 2.5, 0.9, 0.3, 0.0])
    x = np.random.default_rng(5).standard_normal((2, 3, 3, 4)).astype(
        np.float32) * 14.6

    def jden(x, s):
        return x * 0.5 / (1.0 + s)

    ref = jsamp.sample_dpmpp_2m(jden, jnp.asarray(x),
                                jnp.asarray(sigmas, jnp.float32), None,
                                jsamp.SamplerParams(**params))
    out = tsamp.sample_dpmpp_2m(jden, torch.from_numpy(x), sigmas, None,
                                tsamp.SamplerParams(**params))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_cfg_at_scale_one_equals_unguided(pipes):
    """guidance <= 1 takes the unguided path (one UNet half); at scale 1
    the guided path must give the same x0."""
    _, tpipe = pipes
    ctx_u, ctx_g = tpipe._contexts("a boat", "", 1, True, 0)
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (1, 8, 8, 4)).astype(np.float32))
    with torch.inference_mode():
        guided = tpipe._denoiser(ctx_u, ctx_g, 1.0, True)(x, 3.0)
        plain = tpipe._denoiser(ctx_u, ctx_g, 1.0, False)(x, 3.0)
    torch.testing.assert_close(guided, plain, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("size", [12, 6])
def test_natural_size_noise_is_centred(size):
    """Away from the model's native latent size the native-size noise sits
    centred in the canvas (cropped when smaller), so a seed keeps its
    subject across resolutions; the border is an independent stream."""
    x = tmodes.txt2img_initial([5], (size, size, 4), 2.0, "cpu", natural=8)
    base = trng.batched_normal([5], "init", (8, 8, 4), "cpu") * 2.0
    assert x.shape == (1, size, size, 4)
    if size > 8:
        o = (size - 8) // 2
        assert torch.equal(x[:, o:o + 8, o:o + 8], base)
        assert not torch.equal(x[:, :o], base[:, :o])
    else:
        o = (8 - size) // 2
        assert torch.equal(x, base[:, o:o + size, o:o + size])
