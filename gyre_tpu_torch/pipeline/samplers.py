"""Samplers over a sigma-space denoiser, as Python loops on torch tensors.

Counterpart of gyre_tpu/pipeline/samplers.py, same calling convention:

    sample(name, denoise, x, sigmas, noise_fn, params,
           start=0, steps=None, carry=None, return_carry=False)

``denoise(x, sigma) -> x0`` is the CFG-wrapped model, ``sigmas`` the full
descending request ramp (host floats, last 0), ``start``/``steps`` a window
of GLOBAL step indices and ``carry`` the sampler's cross-step state, so a
chunked run (progress, cancellation) computes exactly what one run does.

Ported: DPM-Solver++(2M) (``k_dpmpp_2m`` and its aliases), the serving
path's sampler. Every other name of the JAX package's table is listed and
raises NotImplementedError naming itself.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class SamplerParams:
    """Knobs of the DPM++ 2M variants (eta and churn belong to samplers not
    ported yet)."""

    warmup_lms: bool = False    # midpoint warmup on the first step
    ddim_cutoff: float = 0.0    # first-order fallback below this sigma


def _t(sigma: float) -> float:
    return -math.log(max(sigma, 1e-10))


def sample_dpmpp_2m(denoise, x, sigmas, noise_fn, p: SamplerParams,
                    start=0, steps=None, carry=None, return_carry=False):
    """DPM-Solver++(2M): second-order multistep, one model call per step.
    The previous step's x0 is the carry."""
    n = len(sigmas) - 1
    steps = n if steps is None else steps
    x0_prev = carry[0] if carry is not None else torch.zeros_like(x)
    for i in range(start, start + steps):
        sigma, sigma_next = float(sigmas[i]), float(sigmas[i + 1])
        x0 = denoise(x, sigma)
        if sigma_next <= 0:
            x = x0
        else:
            t, t_next = _t(sigma), _t(sigma_next)
            h = t_next - t
            ratio = sigma_next / sigma
            if i > 0 and sigma_next > p.ddim_cutoff:
                r = (t - _t(float(sigmas[i - 1]))) / h
                x0_d = (1 + 1 / (2 * r)) * x0 - (1 / (2 * r)) * x0_prev
                x = ratio * x - math.expm1(-h) * x0_d
            elif p.warmup_lms and i == 0:
                # LMS warmup: a midpoint model evaluation replaces the
                # first-order first step
                s_mid = t + 0.5 * h
                sig_mid = math.exp(-s_mid)
                x_2 = (sig_mid / sigma) * x - math.expm1(-h * 0.5) * x0
                x = ratio * x - math.expm1(-h) * denoise(x_2, sig_mid)
            else:
                x = ratio * x - math.expm1(-h) * x0
        x0_prev = x0
    return (x, (x0_prev,)) if return_carry else x


# ------------------------------------------------------------------ registry

_NAMES = (
    "ddim", "ddpm", "plms", "k_euler", "k_euler_ancestral", "k_heun",
    "k_dpm_2", "k_dpm_2_ancestral", "k_lms", "k_dpmpp_2s_ancestral",
    "k_dpmpp_2m", "k_dpmpp_sde", "dpmsolverpp_1order", "dpmsolverpp_2order",
    "dpmsolverpp_3order", "dpm_fast", "dpm_adaptive",
    "dpmsolverpp_2s_ancestral", "dpmsolverpp_sde", "dpmsolverpp_2m")
_PORTED = {"k_dpmpp_2m": sample_dpmpp_2m,
           "dpmsolverpp_2order": sample_dpmpp_2m,
           "dpmsolverpp_2m": sample_dpmpp_2m}

# every name of the JAX package's table; None = not ported yet
SAMPLERS = {name: _PORTED.get(name) for name in _NAMES}
PORTED_SAMPLERS = frozenset(_PORTED)

# names the reference runs on the diffusers integer "leading" grid
DIFFUSERS_GRID_SAMPLERS = frozenset({
    "ddim", "ddpm", "plms", "dpmsolverpp_1order", "dpmsolverpp_2order",
    "dpmsolverpp_3order"})

# proto enum value -> sampler name (generation_pb2.DiffusionSampler)
PROTO_SAMPLERS = {
    0: "ddim", 1: "plms", 2: "k_euler", 3: "k_euler_ancestral", 4: "k_heun",
    5: "k_dpm_2", 6: "k_dpm_2_ancestral", 7: "k_lms",
    8: "k_dpmpp_2s_ancestral", 9: "k_dpmpp_2m", 10: "k_dpmpp_sde",
    500: "dpmsolverpp_1order", 501: "dpmsolverpp_2order",
    502: "dpmsolverpp_3order", 550: "dpm_fast", 551: "dpm_adaptive",
    552: "dpmsolverpp_2s_ancestral", 553: "dpmsolverpp_sde",
    554: "dpmsolverpp_2m",
}

# capability metadata for the engines API
SAMPLER_PROPERTIES = {
    name: {
        "supports_eta": name in ("ddim", "k_euler_ancestral",
                                 "k_dpm_2_ancestral", "k_dpmpp_2s_ancestral",
                                 "k_dpmpp_sde", "dpmsolverpp_2s_ancestral",
                                 "dpmsolverpp_sde"),
        "supports_churn": name in ("k_euler", "k_heun", "k_dpm_2"),
        "supports_sigma_limits": name.startswith(("k_", "dpm")),
        "supports_karras_rho": name.startswith(("k_", "dpm")),
        "supported_noise_types": ["normal", "brownian"]
        if "sde" in name else ["normal"],
    }
    for name in SAMPLERS
}


def _lookup(name: str):
    if name not in SAMPLERS:
        raise ValueError(f"unknown sampler {name!r}")
    fn = SAMPLERS[name]
    if fn is None:
        raise NotImplementedError(
            f"sampler {name!r} is not ported to gyre_tpu_torch yet (ported: "
            f"{sorted(PORTED_SAMPLERS)})")
    return fn


def init_carry(name: str, x) -> tuple:
    """Zero cross-step state for ``name``, shaped like latents x."""
    _lookup(name)
    return (torch.zeros_like(x),)


def sample(name: str, denoise, x, sigmas, noise_fn,
           p: SamplerParams | None = None, *, start=0, steps=None,
           carry=None, return_carry=False):
    return _lookup(name)(denoise, x, sigmas, noise_fn, p or SamplerParams(),
                         start=start, steps=steps, carry=carry,
                         return_carry=return_carry)
