"""Every sampler of the port (gyre_tpu_torch.pipeline.samplers) against the
JAX package's, on the CPU in f32.

Both run on the same inputs: an analytic denoiser written once and applied
in both frameworks (the ideal x0 of Gaussian data N(MU, S0^2) per channel,
the oracle of tests/test_sampler_oracles.py with a mean), the same sigma
ramp (f32 values), initial latents [2, 8, 8, 4] and injected noise (numpy
arrays keyed by (step, stream), made from a seed), 10 steps.

Tolerance: 1e-4 absolute on the final latents, which are of order 1: f32
tensor arithmetic on both sides, with the port's step coefficients in f64
on the host against the JAX package's f32 ones (~1e-7 relative a step).
Beyond parity: the port's chunked run equals its unchunked run in every
bit, each sampler calls the model as often as its update needs, and
dpm_adaptive accepts and rejects the same steps as the JAX package.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gyre_tpu.pipeline import samplers as jsamp
from gyre_tpu_torch.pipeline import samplers as tsamp
from gyre_tpu_torch.pipeline import schedule as tsched

SHAPE = (2, 8, 8, 4)
STEPS = 10
S0 = 1.0
MU = np.array([0.5, -0.3, 0.1, 0.0], np.float32)
TAGS = ("churn", "anc", "sde1", "sde2", "ddim")
NAMES = sorted(tsamp.SAMPLERS)
RAMPS = {"linspace": {}, "leading": {"spacing": "leading"},
         "karras": {"karras_rho": 7.0}, "uniform_lambda": {
             "uniform_lambda": True}}


def _eta(name):
    """The pipeline's default eta rule."""
    return 1.0 if ("ancestral" in name or "sde" in name
                   or name == "ddpm") else 0.0


def _denoiser(mu, calls=None):
    """The ideal x0 of N(mu, S0^2) data; works on jnp arrays and torch
    tensors alike (sigma a float or a traced scalar)."""

    def denoise(x, sigma):
        if calls is not None:
            calls.append(float(sigma))
        w = S0 ** 2 / (S0 ** 2 + sigma ** 2)
        return x * w + mu * (1.0 - w)

    return denoise


@functools.cache
def _inputs(ramp: str, seed: int = 0):
    sig = tsched.build_sigmas(tsched.scaled_linear_schedule(), STEPS,
                              **RAMPS[ramp])
    sig = sig.astype(np.float32).astype(np.float64)     # f32 values
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(SHAPE).astype(np.float32) * np.float32(sig[0])
    noise = {t: rng.standard_normal((STEPS + 1,) + SHAPE).astype(np.float32)
             for t in TAGS}
    return sig, x, noise


def _port_noise(noise):
    return lambda i, tag: torch.from_numpy(noise[tag][i])


def _port(name, ramp, params, **kw):
    sig, x, noise = _inputs(ramp)
    return tsamp.sample(name, _denoiser(torch.from_numpy(MU)),
                        torch.from_numpy(x), sig, _port_noise(noise),
                        tsamp.SamplerParams(**params), **kw)


def _jax_noise_free(name, params):
    """dpm_fast at eta 0: the JAX package still adds its ancestral noise,
    scaled by sqrt(exp(-2 t) - exp(-2 t')) with t' = -log(exp(-t)), which
    f32 rounding leaves at ~3e-4 sigma where it should be 0; the port
    adds none. Those cases give the JAX side zero noise."""
    return name == "dpm_fast" and not params.get("eta")


def _jax_zero_noise(i, tag):
    return jnp.zeros(SHAPE, jnp.float32)


@functools.cache
def _jax(name, ramp, params_items):
    """The JAX sampler's final latents, one compile per case."""
    sig, x, noise = _inputs(ramp)
    jnoise = {t: jnp.asarray(v) for t, v in noise.items()}
    if _jax_noise_free(name, dict(params_items)):
        jnoise = {t: 0 * v for t, v in jnoise.items()}
    out = jsamp.SAMPLERS[name](
        _denoiser(jnp.asarray(MU)), jnp.asarray(x),
        jnp.asarray(sig, jnp.float32), lambda i, tag: jnoise[tag][i],
        jsamp.SamplerParams(**dict(params_items)))
    return np.asarray(out)


def _cases():
    for name in NAMES:
        for ramp in RAMPS:
            yield name, ramp, {"eta": _eta(name)}
        if tsamp.SAMPLER_PROPERTIES[name]["supports_eta"]:
            for eta in (0.0, 0.7):
                yield name, "linspace", {"eta": eta}
        if tsamp.SAMPLER_PROPERTIES[name]["supports_churn"]:
            yield name, "linspace", {"churn": 0.5}
            yield name, "karras", {"churn": 0.5, "churn_tmin": 0.5,
                                   "churn_tmax": 5.0}
    yield "dpm_fast", "uniform_lambda", {"eta": 0.7}   # its ancestral form
    yield "k_dpmpp_2m", "linspace", {"eta": 0.0, "warmup_lms": True}
    yield "k_dpmpp_2m", "karras", {"eta": 0.0, "ddim_cutoff": 1.0}


def _id(case):
    name, ramp, params = case
    extra = "-".join(f"{k}={v:g}" for k, v in params.items())
    return f"{name}-{ramp}-{extra}"


@pytest.mark.parametrize("case", list(_cases()), ids=_id)
def test_sampler_matches_jax(case):
    name, ramp, params = case
    ref = _jax(name, ramp, tuple(sorted(params.items())))
    out = _port(name, ramp, params).numpy()
    assert out.shape == ref.shape == SHAPE
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)


def test_every_proto_enum_has_a_sampler():
    assert len(tsamp.SAMPLERS) == 20
    assert len(set(map(id, tsamp.SAMPLERS.values()))) == 15
    assert set(tsamp.PROTO_SAMPLERS.values()) <= set(tsamp.SAMPLERS)
    assert tsamp.PROTO_SAMPLERS == jsamp.PROTO_SAMPLERS
    assert tsamp.SAMPLER_PROPERTIES == jsamp.SAMPLER_PROPERTIES
    assert tsamp.CHUNKABLE_SAMPLERS == jsamp.CHUNKABLE_SAMPLERS
    assert tsamp.DIFFUSERS_GRID_SAMPLERS == jsamp.DIFFUSERS_GRID_SAMPLERS


def _chunked(name, ramp, params, chunk):
    """The port's run in segments of ``chunk`` steps (dpm_adaptive:
    solver iterations) with the carry, as the pipeline drives it."""
    sig, x0, noise = _inputs(ramp)
    x = torch.from_numpy(x0)
    den = _denoiser(torch.from_numpy(MU))
    p = tsamp.SamplerParams(**params)
    carry = tsamp.init_carry(name, x)
    total = STEPS
    if name == "dpm_adaptive":
        total = -(-tsamp.ADAPTIVE_MAX_STEPS // chunk) * chunk
    done = 0
    while done < total:
        seg = min(chunk, total - done)
        x, carry = tsamp.sample(name, den, x, sig, _port_noise(noise), p,
                                start=done, steps=seg, carry=carry,
                                return_carry=True)
        done += seg
        if name == "dpm_adaptive" and carry[-1]:
            break
    return x, carry


@pytest.mark.parametrize("chunk", [1, 3, 7])
@pytest.mark.parametrize("name", NAMES)
def test_chunked_equals_unchunked(name, chunk):
    params = {"eta": 0.7 if _eta(name) else 0.0}
    if tsamp.SAMPLER_PROPERTIES[name]["supports_churn"]:
        params["churn"] = 0.5
    whole = _port(name, "karras", params)
    x, _ = _chunked(name, "karras", params, chunk)
    assert torch.equal(x, whole)


@pytest.mark.parametrize("steps", [9, 10, 11])
@pytest.mark.parametrize("chunk", [1, 2, 4])
def test_dpm_fast_segments_survive_chunk_boundaries(steps, chunk):
    """dpm_fast's order-3/2/1 tail depends on n % 3; a chunk boundary
    inside a 3-call segment must carry (x_seg, eps0, eps_r1)."""
    sig = tsched.build_sigmas(tsched.scaled_linear_schedule(), steps,
                              uniform_lambda=True)
    rng = np.random.default_rng(steps)
    x = torch.from_numpy(rng.standard_normal(SHAPE).astype(np.float32)
                         * np.float32(sig[0]))
    den = _denoiser(torch.from_numpy(MU))
    p = tsamp.SamplerParams(eta=0.0)
    whole = tsamp.sample("dpm_fast", den, x, sig, None, p)  # draws nothing
    carry, xc = tsamp.init_carry("dpm_fast", x), x
    for start in range(0, steps, chunk):
        xc, carry = tsamp.sample("dpm_fast", den, xc, sig, None, p,
                                 start=start,
                                 steps=min(chunk, steps - start),
                                 carry=carry, return_carry=True)
    assert torch.equal(xc, whole)
    ref = jsamp.sample_dpm_fast(
        _denoiser(jnp.asarray(MU)), jnp.asarray(x.numpy()),
        jnp.asarray(sig, jnp.float32), _jax_zero_noise,
        jsamp.SamplerParams(eta=0.0))
    np.testing.assert_allclose(whole.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-4)


# model calls of an n-step run: one a step, two where the update takes a
# second evaluation (not on the last step, whose sigma_next is 0), two for
# PLMS's first-step corrector
NFE = {"k_euler": "n", "dpmsolverpp_1order": "n", "k_euler_ancestral": "n",
       "k_lms": "n", "ddim": "n", "ddpm": "n", "k_dpmpp_2m": "n",
       "dpmsolverpp_2order": "n", "dpmsolverpp_2m": "n",
       "dpmsolverpp_3order": "n", "dpm_fast": "n",
       "k_heun": "2n-1", "k_dpm_2": "2n-1", "k_dpm_2_ancestral": "2n-1",
       "k_dpmpp_2s_ancestral": "2n-1", "dpmsolverpp_2s_ancestral": "2n-1",
       "k_dpmpp_sde": "2n-1", "dpmsolverpp_sde": "2n-1", "plms": "n+1",
       "dpm_adaptive": "2k+1"}


@pytest.mark.parametrize("name", NAMES)
def test_model_calls(name):
    sig, x, noise = _inputs("karras")
    calls = []
    _, carry = tsamp.sample(name, _denoiser(torch.from_numpy(MU), calls),
                            torch.from_numpy(x), sig, _port_noise(noise),
                            tsamp.SamplerParams(eta=_eta(name)),
                            carry=tsamp.init_carry(name, torch.from_numpy(x)),
                            steps=(tsamp.ADAPTIVE_MAX_STEPS
                                   if name == "dpm_adaptive" else None),
                            return_carry=True)
    n = STEPS
    k = carry[3] if name == "dpm_adaptive" else 0     # solver iterations
    expect = {"n": n, "2n-1": 2 * n - 1, "n+1": n + 1,
              "2k+1": 2 * k + 1}[NFE[name]]
    assert len(calls) == expect


@pytest.mark.parametrize("ramp", ["linspace", "karras"])
def test_dpm_adaptive_takes_the_jax_steps(ramp):
    """Run both one solver iteration per segment and read the carried t:
    the same number of iterations, and the same ones accepted (t moved),
    as the JAX package."""
    sig, x0, _ = _inputs(ramp)
    jden, jsig = _denoiser(jnp.asarray(MU)), jnp.asarray(sig, jnp.float32)
    jx, jcarry, jt = jnp.asarray(x0), jsamp.init_carry(
        "dpm_adaptive", jnp.asarray(x0)), []
    while not int(jcarry[-1]):
        jx, jcarry = jsamp.sample_dpm_adaptive(
            jden, jx, jsig, None, jsamp.SamplerParams(), steps=1,
            carry=jcarry, return_carry=True)
        jt.append(float(jcarry[1]))
    tden = _denoiser(torch.from_numpy(MU))
    tx, tcarry, tt = torch.from_numpy(x0), tsamp.init_carry(
        "dpm_adaptive", None), []
    while not tcarry[-1]:
        tx, tcarry = tsamp.sample_dpm_adaptive(
            tden, tx, sig, None, tsamp.SamplerParams(), steps=1,
            carry=tcarry, return_carry=True)
        tt.append(float(tcarry[1]))
    t0 = -np.log(sig[0])

    def accepted(ts):           # an accepted step moves t on by h > 0
        return [b > a + 1e-6 for a, b in zip([t0] + ts, ts)]

    assert len(tt) == len(jt) == int(jcarry[3]) == tcarry[3]
    assert accepted(tt) == accepted(jt)
    assert 0 < sum(accepted(tt)) < len(tt)       # some steps rejected
    np.testing.assert_allclose(tt, jt, rtol=1e-5)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0,
                               atol=1e-4)
