"""Sigma-space denoiser construction: model wrapping and classifier-free
guidance.

Counterpart of gyre_tpu/pipeline/denoiser.py:

    denoise(x, sigma) -> x0 prediction        (k-diffusion style)

with c_in = 1/sqrt(sigma^2+1) and, by the schedule's prediction type,

    epsilon:       x0 = x - sigma * model(x * c_in, t)
    v_prediction:  x0 = x * c_skip + model(x * c_in, t) * c_out,
                   c_skip = 1/(sigma^2+1), c_out = -sigma/sqrt(sigma^2+1)

(SD2's 768 models predict v). sigma is a host float: the samplers step
through the ramp on the host, and every sampler reaches the model through
this function only.
"""

from __future__ import annotations

import math

import torch

from . import schedule as sched


def make_denoiser(model_fn, schedule: sched.DiffusionSchedule,
                  prediction_type: str | None = None):
    """model_fn(x_scaled, t [B]) -> eps or v, x NHWC [B,H,W,C];
    ``prediction_type`` overrides the schedule's (a grafted model's own)."""
    pred = prediction_type or schedule.prediction_type
    if pred not in ("epsilon", "v_prediction"):
        raise ValueError(f"unknown prediction type {pred!r}")
    log_sigmas = schedule.log_sigmas

    def denoise(x, sigma: float):
        c_in = 1.0 / math.sqrt(sigma ** 2 + 1.0)
        t = torch.full((x.shape[0],), sched.sigma_to_t(log_sigmas, sigma),
                       dtype=torch.float32, device=x.device)
        out = model_fn(x * c_in, t)
        if pred == "v_prediction":
            c_skip = 1.0 / (sigma ** 2 + 1.0)
            c_out = -sigma / math.sqrt(sigma ** 2 + 1.0)
            return x * c_skip + out * c_out
        return x - out * sigma

    return denoise


def cfg_model(unet_fn, context_uncond, context_cond, guidance_scale, *,
              extra_uncond=None, extra_cond=None):
    """Classifier-free guidance with both halves in one batch (parallel
    CFG: [uncond B; cond B] rows through one UNet call).

    guidance_scale: a float, or a [B] tensor when coalesced requests carry
    different scales. ``extra_uncond``/``extra_cond``: keyword inputs of
    each half, each a dict of row tensors (SDXL's ``added_cond``), joined
    key by key in the contexts' row order. Returns model_fn(x, t)."""
    ctx = torch.cat([context_uncond, context_cond], dim=0)
    extra_uncond, extra_cond = extra_uncond or {}, extra_cond or {}
    kw = {k: {n: torch.cat([extra_uncond[k][n], v], dim=0)
              for n, v in cond.items()} for k, cond in extra_cond.items()}
    if torch.is_tensor(guidance_scale):
        scale = guidance_scale.reshape(-1, 1, 1, 1)
    else:
        scale = float(guidance_scale)

    def fn(x, t):
        out = unet_fn(torch.cat([x, x], dim=0), torch.cat([t, t], dim=0),
                      ctx, **kw)
        un, gu = out.chunk(2, dim=0)
        return un + scale * (gu - un)

    return fn


def plain_model(unet_fn, context, **extra):
    """No-guidance wrapping (guidance_scale <= 1)."""

    def fn(x, t):
        return unet_fn(x, t, context, **extra)

    return fn
