"""Sigma-space denoiser construction: model wrapping and classifier-free
guidance.

Counterpart of gyre_tpu/pipeline/denoiser.py:

    denoise(x, sigma) -> x0 prediction        (k-diffusion style)

with c_in = 1/sqrt(sigma^2+1) and x0 = x - sigma * eps (epsilon
prediction; SD2's v-prediction is not ported yet). sigma is a host float:
the samplers step through the ramp on the host.
"""

from __future__ import annotations

import math

import torch

from . import schedule as sched


def make_denoiser(model_fn, schedule: sched.DiffusionSchedule):
    """model_fn(x_scaled, t [B]) -> eps, x NHWC [B,H,W,C]."""
    if schedule.prediction_type != "epsilon":
        raise NotImplementedError(
            f"prediction type {schedule.prediction_type!r} is not ported to "
            "gyre_tpu_torch yet")
    log_sigmas = schedule.log_sigmas

    def denoise(x, sigma: float):
        c_in = 1.0 / math.sqrt(sigma ** 2 + 1.0)
        t = torch.full((x.shape[0],), sched.sigma_to_t(log_sigmas, sigma),
                       dtype=torch.float32, device=x.device)
        return x - model_fn(x * c_in, t) * sigma

    return denoise


def cfg_model(unet_fn, context_uncond, context_cond, guidance_scale):
    """Classifier-free guidance with both halves in one batch (parallel
    CFG: [uncond B; cond B] rows through one UNet call).

    guidance_scale: a float, or a [B] tensor when coalesced requests carry
    different scales. Returns model_fn(x, t)."""
    ctx = torch.cat([context_uncond, context_cond], dim=0)
    if torch.is_tensor(guidance_scale):
        scale = guidance_scale.reshape(-1, 1, 1, 1)
    else:
        scale = float(guidance_scale)

    def fn(x, t):
        out = unet_fn(torch.cat([x, x], dim=0), torch.cat([t, t], dim=0), ctx)
        un, gu = out.chunk(2, dim=0)
        return un + scale * (gu - un)

    return fn


def plain_model(unet_fn, context):
    """No-guidance wrapping (guidance_scale <= 1)."""

    def fn(x, t):
        return unet_fn(x, t, context)

    return fn
