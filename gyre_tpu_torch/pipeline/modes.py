"""Generation modes as latent-state functions.

Counterpart of gyre_tpu/pipeline/modes.py. A mode is an initial latent
(txt2img's noise, or an encoded image noised to the ramp's first sigma) and
wrappers around the denoiser or the UNet:

  * inpaint (4 channels): the masked area refilled before sampling
    (``masked_area_fill``, ``shaped_noise_fill``) and the predicted x0
    pinned to the original where the mask keeps it (``make_inpaint_blend``);
  * inpaint9 / depth2img: extra UNet input channels (the mask and the
    masked image's latents, or a depth map), not sigma-scaled;
  * hires fix: a low- and a high-resolution latent denoised together with
    their x0 predictions cross-injected through a random map;
  * graft: a second model's x0 blended in through a random map as the
    schedule progresses.

Keys are request seeds, or seeds with sub-stream names (utils/rng.py); the
schedule progress u(sigma) is computed on the host, where the samplers
keep sigma.
"""

from __future__ import annotations

import math

import torch

from ..ops.resize import resize
from ..utils import rng


def txt2img_initial(seeds, shape, sigma_max: float, device,
                    natural: int = 0):
    """Pure-noise initial latents at sigma_max, [B, *shape], f32.

    When ``natural`` (the model's native latent size) is given and differs
    from the target, noise is drawn on the natural-size grid and centred in
    the canvas, so a seed renders the same subject across resolutions; the
    border draws from an independent stream."""
    h, w, c = shape
    if not natural or (h == natural and w == natural):
        return rng.batched_normal(seeds, "init", shape, device) * sigma_max
    base = rng.batched_normal(seeds, "init", (natural, natural, c), device)
    canvas = rng.batched_normal(seeds, "init_border", shape, device)
    sy, sx = max(0, (natural - h) // 2), max(0, (natural - w) // 2)
    ty, tx = max(0, (h - natural) // 2), max(0, (w - natural) // 2)
    ch, cw = min(h, natural), min(w, natural)
    canvas[:, ty:ty + ch, tx:tx + cw] = base[:, sy:sy + ch, sx:sx + cw]
    return canvas * sigma_max


def img2img_initial(init_latents, keys, sigma_start: float):
    """x = x0 + sigma * eps at the (possibly truncated) ramp's first
    sigma."""
    noise = rng.batched_stream_normal(keys, "init", 0,
                                      init_latents.shape[1:],
                                      init_latents.device)
    return init_latents.float() + noise * sigma_start


def masked_area_fill(init_latents, mask_keep, keys, mode: str = "random"):
    """The area to generate (mask_keep 0; [B,h,w,1], 1 keeps) refilled:
    "original" leaves it, "zero" zeroes it, "random" fills it with noise
    at each latent's own mean and standard deviation."""
    if mode == "original":
        return init_latents
    if mode == "zero":
        fill = torch.zeros_like(init_latents)
    elif mode == "random":
        std, mean = torch.std_mean(init_latents, dim=(1, 2, 3),
                                   keepdim=True, unbiased=False)
        noise = rng.batched_stream_normal(keys, "mask_fill", 0,
                                          init_latents.shape[1:],
                                          init_latents.device)
        fill = mean + noise.to(init_latents.dtype) * std
    else:
        raise ValueError(f"unknown masked_area_init {mode}")
    return init_latents * mask_keep + fill * (1.0 - mask_keep)


def shaped_noise_fill(init_latents, mask_keep, keys):
    """The area to generate filled with noise shaped by the image: the
    latent's amplitude spectrum with the noise's phases, renormalised to
    the kept area's mean and variance."""
    b, h, w, c = init_latents.shape
    noise = rng.batched_stream_normal(keys, "shaped_fill", 0, (h, w, c),
                                      init_latents.device)
    lat = init_latents.float()
    spec = torch.fft.rfft2(lat, dim=(1, 2))
    nspec = torch.fft.rfft2(noise, dim=(1, 2))
    phase = nspec / torch.clamp(nspec.abs(), min=1e-8)
    shaped = torch.fft.irfft2(spec.abs() * phase, s=(h, w), dim=(1, 2))
    keep = mask_keep.float()
    denom = torch.clamp(keep.sum(dim=(1, 2, 3), keepdim=True), min=1.0)
    mean = (lat * keep).sum(dim=(1, 2, 3), keepdim=True) / denom
    var = ((lat - mean) ** 2 * keep).sum(dim=(1, 2, 3), keepdim=True) / denom
    sstd, smean = torch.std_mean(shaped, dim=(1, 2, 3), keepdim=True,
                                 unbiased=False)
    shaped = (shaped - smean) / (sstd + 1e-8) * torch.sqrt(var) + mean
    out = lat * keep + shaped * (1.0 - keep)
    return out.to(init_latents.dtype)


def log_progress(sigma_max: float, sigma_min: float):
    """Schedule progress u(sigma) in [0, 1], in log-sigma space."""
    log_max = math.log(sigma_max)
    log_min = math.log(max(sigma_min, 1e-4))
    span = max(log_max - log_min, 1e-6)

    def progress(sigma: float) -> float:
        u = (log_max - math.log(max(float(sigma), 1e-6))) / span
        return min(max(u, 0.0), 1.0)

    return progress


def make_inpaint_blend(init_latents, mask_keep, sigma_max: float,
                       sigma_min: float):
    """Per-step x0 blend for 4-channel inpainting: where mask_keep exceeds
    the schedule's progress u(sigma), the predicted x0 is replaced by the
    clean original latents, and the sampler re-noises them through its
    own update. Returns wrap(denoise) and final_blend(x0), the pin of the
    fully kept pixels after the last step."""
    progress = log_progress(sigma_max, sigma_min)

    def wrap(denoise):
        def wrapped(x, sigma):
            x0 = denoise(x, sigma)
            pin = (mask_keep > progress(sigma)).to(x0.dtype)
            return init_latents.to(x0.dtype) * pin + x0 * (1.0 - pin)

        return wrapped

    def final_blend(x0):
        pin = (mask_keep >= 1.0).to(x0.dtype)
        return init_latents.to(x0.dtype) * pin + x0 * (1.0 - pin)

    return wrap, final_blend


def _ease_out_cubic(u: float) -> float:
    return 1.0 - (1.0 - u) ** 3


def make_hires_fix(keys, natural_h: int, natural_w: int, target_h: int,
                   target_w: int, end_u: float = 0.667):
    """Hires fix: a lo/hi latent pair denoised together with per-step
    cross-injection. The sampler state is [lo padded to the target; hi]
    (2B rows). Each denoise call splits it, runs the model at both sizes,
    and cross-injects the x0 predictions through one random map per
    sample: hi takes lo's upscaled structure, lo takes hi's downscaled
    centre, while the progress u is short of ``end_u`` (cubic-eased off).

    Returns (wrap, pack, unpack)."""
    oy = (target_h - natural_h) // 2
    ox = (target_w - natural_w) // 2
    rmaps = []

    def pack(lo, hi):
        pad = (0, 0, ox, target_w - natural_w - ox,
               oy, target_h - natural_h - oy)
        return torch.cat([torch.nn.functional.pad(lo, pad), hi], dim=0)

    def unpack(x):
        lo_pad, hi = x.chunk(2, dim=0)
        return lo_pad[:, oy:oy + natural_h, ox:ox + natural_w], hi

    def wrap(denoise_lo, denoise_hi, progress):
        def wrapped(x, sigma):
            lo, hi = unpack(x)
            x0_lo = denoise_lo(lo, sigma)
            x0_hi = denoise_hi(hi, sigma)
            factor = min(max(1.0 - _ease_out_cubic(progress(sigma) / end_u),
                             0.0), 1.0)
            if not rmaps:                 # per sample, fixed across steps
                rmaps.append(rng.batched_uniform(
                    keys, (target_h, target_w, 1), x.device))
            rmap_hi = rmaps[0]
            rmap_lo = rmap_hi[:, oy:oy + natural_h, ox:ox + natural_w]
            lo_up = resize(x0_lo, (target_h, target_w), "bicubic")
            x0_hi = torch.where(rmap_hi < factor, lo_up.to(x0_hi.dtype),
                                x0_hi)
            hi_dn = resize(x0_hi, (natural_h, natural_w), "bicubic")
            x0_lo = torch.where(rmap_lo < factor, hi_dn.to(x0_lo.dtype),
                                x0_lo)
            return pack(x0_lo, x0_hi)

        return wrapped

    return wrap, pack, unpack


def make_graft(keys, start_u: float = 0.1):
    """Graft two denoisers: the root model (e.g. an inpainting UNet)
    carries the structure; past ``start_u`` the top model's x0 blends in
    through an eased random map until it takes over."""
    rmaps = []

    def wrap(dn_root, dn_top, progress):
        def wrapped(x, sigma):
            x0_root = dn_root(x, sigma)
            x0_top = dn_top(x, sigma)
            factor = min(max(_ease_out_cubic(
                (progress(sigma) - start_u) / (1.0 - start_u)), 0.0), 1.0)
            if not rmaps:
                rmaps.append(rng.batched_uniform(
                    keys, tuple(x0_root.shape[1:-1]) + (1,), x.device))
            return torch.where(rmaps[0] < factor,
                               x0_top.to(x0_root.dtype), x0_root)

        return wrapped

    return wrap


def make_inpaint9_inputs(mask_keep, masked_image_latents):
    """The 9-channel inpainting UNet's input: [x (4) | mask (1) | masked
    image latents (4)], the extra channels not sigma-scaled; the mask is
    1 where the UNet regenerates."""
    mask_gen = 1.0 - mask_keep

    def wrap_model(model_fn):
        def wrapped(x, t, context, **kw):
            reps = x.shape[0] // mask_gen.shape[0]
            m = mask_gen.repeat(reps, 1, 1, 1).to(x.dtype)
            ml = masked_image_latents.repeat(reps, 1, 1, 1).to(x.dtype)
            return model_fn(torch.cat([x, m, ml], dim=-1), t, context, **kw)

        return wrapped

    return wrap_model


def make_extra_channels_wrapper(extra):
    """Unscaled extra input channels (depth2img's depth map)."""

    def wrap_model(model_fn):
        def wrapped(x, t, context, **kw):
            e = extra.repeat(x.shape[0] // extra.shape[0], 1, 1, 1)
            return model_fn(torch.cat([x, e.to(x.dtype)], dim=-1), t,
                            context, **kw)

        return wrapped

    return wrap_model
