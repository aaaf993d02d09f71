"""The port's pipeline with the samplers that draw per-step noise or take
a second model call (the multistep, fast and adaptive ones are in
tests/test_torch_pipeline_multistep.py), against the JAX package's
UnifiedPipeline on the SD_TEST preset: 5 steps, CFG 7.5, f32,
the JAX random weights carried over by the bridge, and the JAX package's
initial noise and per-step noise injected for the same seeds, so the
tests pin the rest of the path (the port's own threefry draws:
tests/test_torch_rng.py).

Tolerance: images agree within 2e-3 absolute in [0, 1], as for DPM++ 2M
in tests/test_torch_pipeline.py: f32 on both sides, sums in another order
through the UNet evaluations and the VAE decoder. Each sampler's chunked
run (2-step chunks, the dispatcher's path) equals its one run in every
bit.
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
from gyre_tpu_torch.pipeline import samplers as tsamp
from gyre_tpu_torch.pipeline import unified as tunified
from gyre_tpu_torch.utils import rng as trng
from test_torch_modes import one_torch_thread  # noqa: F401

CFG = configs.SD_TEST
REQUEST = dict(prompt="a (red:1.2) boat at [dusk]", negative_prompt="blurry",
               height=64, width=64, steps=5, guidance_scale=7.5,
               seeds=[3, 4])
CASES = {
    "k_euler_ancestral": {},                   # default eta 1
    "k_heun": {"churn": 0.5},
    "k_dpmpp_sde": {"noise_type": "brownian"},
}


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


def _jax_initial(seeds, shape, sigma_max, device, natural=0):
    keys = jrng.keys_for_seeds(np.asarray(seeds, np.uint32))
    x = jmodes.txt2img_initial(keys, shape, sigma_max, natural=natural)
    return torch.from_numpy(np.array(x)).to(device)


def _jax_noise_fn(seeds, sigmas, shape, noise_type, device):
    """The JAX package's per-step noise for the same seeds and ramp."""
    keys = jrng.keys_for_seeds(np.asarray(seeds, np.uint32))
    fn = junified._make_noise_fn(keys, jnp.asarray(sigmas, jnp.float32),
                                 tuple(shape), noise_type)
    return lambda i, tag: torch.from_numpy(np.array(fn(i, tag))).to(device)


@pytest.fixture
def jax_noise(monkeypatch):
    monkeypatch.setattr(tmodes, "txt2img_initial", _jax_initial)
    monkeypatch.setattr(tunified, "make_noise_fn", _jax_noise_fn)


def check_single_scan(pipes, request):
    """The port's image against the JAX package's single scan."""
    jpipe, tpipe = pipes
    ref = np.asarray(jpipe(**request))           # one scan, no chunking
    out = tpipe(**request).numpy()
    assert out.shape == ref.shape == (2, 64, 64, 3)
    assert np.abs(out - ref).max() <= 2e-3


def check_chunked(tpipe, request, total):
    """2-step chunks with a stop event give the one run's image, with
    progress reported after every chunk against ``total``."""
    whole = tpipe(**request)
    seen = []
    chunked = tpipe(**request, chunk_steps=2, stop_event=threading.Event(),
                    progress_callback=lambda d, n: seen.append((d, n)))
    assert torch.equal(chunked, whole)
    assert seen[-1] == (total, total)
    assert [d for d, _ in seen[:-1]] == list(range(2, 2 * len(seen), 2))


@pytest.mark.parametrize("sampler", list(CASES))
def test_matches_jax_single_scan(pipes, jax_noise, sampler):
    check_single_scan(pipes, dict(REQUEST, sampler=sampler, **CASES[sampler]))


@pytest.mark.parametrize("sampler", list(CASES))
def test_chunked_equals_unchunked(pipes, sampler):
    check_chunked(pipes[1], dict(REQUEST, sampler=sampler, **CASES[sampler]),
                  REQUEST["steps"])


def test_brownian_noise_is_keyed_by_sigma():
    """Brownian noise is the same at the same sigma whatever the step
    count; normal noise is keyed by the step index."""
    sig_a = np.array([14.6, 8.0, 2.0, 0.0])
    sig_b = np.array([14.6, 10.0, 8.0, 2.0, 1.0, 0.0])
    shape = (4, 4, 1)
    nf_a = tunified.make_noise_fn([1, 2], sig_a, shape, "brownian", "cpu")
    nf_b = tunified.make_noise_fn([1, 2], sig_b, shape, "brownian", "cpu")
    assert torch.equal(nf_a(1, "anc"), nf_b(2, "anc"))      # sigma 8.0
    assert torch.equal(nf_a(2, "sde1"), nf_b(3, "sde1"))    # sigma 2.0
    assert not torch.equal(nf_a(1, "anc"), nf_a(2, "anc"))
    assert not torch.equal(nf_a(1, "sde1"), nf_a(1, "sde2"))
    na = tunified.make_noise_fn([1, 2], sig_a, shape, "normal", "cpu")
    nb = tunified.make_noise_fn([1, 2], sig_b, shape, "normal", "cpu")
    assert torch.equal(na(1, "anc"), nb(1, "anc"))
    assert not torch.equal(na(1, "anc"), nf_a(1, "anc"))
    with pytest.raises(ValueError, match="noise_type"):
        tunified.make_noise_fn([1], sig_a, shape, "uniform", "cpu")


def test_step_noise_is_per_seed():
    """A seed's per-step draw in a batch of 3 is its batch-1 draw, and
    draws differ across steps and streams."""
    batch = trng.batched_stream_normal([7, 9, 7], "anc", 3, (4, 4, 4), "cpu")
    alone = trng.batched_stream_normal([9], "anc", 3, (4, 4, 4), "cpu")
    assert torch.equal(batch[1], alone[0])
    assert torch.equal(batch[0], batch[2])
    for other in (trng.batched_stream_normal([9], "anc", 4, (4, 4, 4),
                                             "cpu"),
                  trng.batched_stream_normal([9], "sde1", 3, (4, 4, 4),
                                             "cpu"),
                  trng.draw([9], ("anc",), (4, 4, 4), "cpu")):
        assert not torch.equal(alone, other)


def test_knobs_reach_the_sampler(pipes, monkeypatch):
    """eta (with its default rule), churn and its range, and the
    uniform-lambda ramp of dpm_fast reach samplers.sample."""
    _, tpipe = pipes
    seen = []

    def spy(name, dn, x, sigmas, noise_fn, p, **kw):
        seen.append((name, p, sigmas.copy()))
        return x, kw["carry"]

    monkeypatch.setattr(tsamp, "sample", spy)
    base = dict(REQUEST, steps=3)
    for sampler, kw in (("k_euler_ancestral", {}), ("ddim", {}),
                        ("ddpm", {}), ("k_dpmpp_sde", {}),
                        ("ddim", {"eta": 0.5}),
                        ("k_heun", {"churn": 0.5, "churn_tmin": 0.1,
                                    "churn_tmax": 9.0}),
                        ("dpm_fast", {})):
        tpipe(**dict(base, sampler=sampler, **kw), return_latents=True)
    etas = [p.eta for _, p, _ in seen]
    assert etas == [1.0, 0.0, 1.0, 1.0, 0.5, 0.0, 0.0]
    heun = seen[5][1]
    assert (heun.churn, heun.churn_tmin, heun.churn_tmax) == (0.5, 0.1, 9.0)
    lam = -np.log(seen[6][2][:-1])
    np.testing.assert_allclose(np.diff(lam), np.diff(lam)[0], rtol=1e-9)
