"""CLIP guidance: steer the denoiser by the gradient of a CLIP similarity
loss on decoded views of its x0 prediction.

Counterpart of gyre_tpu/pipeline/clip_guidance.py, with its configuration
surface:

  * approx_cutouts: crops of the linear latent -> RGB preview
  * vae_cutouts:    crops of the latents, decoded through the VAE
  * no_cutouts:     "approx" | "vae": the whole image, no crops
  * guidance_base:  "guided": the gradient through the conditional stem
                    only; "mixed": through the CFG-combined prediction
  * gradient_length / threshold / maxloss: the flat-loss stop, checked on
    the host between dispatch chunks (``flatloss_check``, a copy of the
    JAX package's numpy function).

The guided step takes ``torch.autograd.grad`` of the loss through the
denoiser: the UNet, the VAE decoder and the vision tower run their kernels
(K1, K2a, K2b) in the forward pass, and their recompute backward rules
(ops/attention.py's FlashGrad, ops/fused_norm_conv.py's GnSiluConvGrad) in
the backward. The crops draw their offsets as the JAX package draws them,
from utils/rng.py's threefry keys of the streams ``clip_cuts_rgb`` and
``clip_cuts_vae`` (``cutout_offsets``), so a seed crops where it crops
there.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..models import clip as clip_mod
from ..ops.resize import resize
from ..utils import rng

# The community-standard linear latent -> RGB approximation (SD's 4
# latent channels onto R, G, B).
LATENT_RGB = ((0.298, 0.207, 0.208),
              (0.187, 0.286, 0.173),
              (-0.158, 0.189, 0.264),
              (-0.184, -0.271, -0.473))


@dataclass(frozen=True)
class ClipGuidanceConfig:
    guidance_scale: float = 0.0
    guidance_base: str = "guided"       # "guided" | "mixed"
    gradient_length: int = 15           # steps of loss history for the fit
    gradient_threshold: float = 0.01
    gradient_maxloss: float = 1.0
    vae_cutouts: int = 2
    approx_cutouts: int = 2
    no_cutouts: str | bool = False      # False | "approx" | "vae"

    @property
    def num_cutouts(self) -> int:
        return self.vae_cutouts + self.approx_cutouts


def approx_decode(latents):
    """Scaled latents [B,h,w,4] -> approximate RGB [B,h,w,3] in [0,1],
    f32."""
    m = torch.tensor(LATENT_RGB, dtype=torch.float32, device=latents.device)
    rgb = torch.einsum("bhwc,cd->bhwd", latents.float(), m)
    return (rgb * 0.5 + 0.5).clamp(0.0, 1.0)


def cutout_offsets(keys, stream: str, num_cutouts: int, h: int, w: int,
                   cut_size: int, cut_power: float = 1.0) -> np.ndarray:
    """[B, num_cutouts, 2] int (top, left) of each sample's crops, drawn as
    the JAX package draws them: crop i of a sample from its key's
    ``stream`` with i folded in, split in three; a size of (min_side -
    cut_size) * u^cut_power + cut_size (f32), clipped to [8, min_side],
    and offsets ``randint`` in [0, max(side - size, 1)). The same at every
    step of a request."""
    min_side = min(h, w)
    out = np.zeros((len(keys), num_cutouts, 2), np.int64)
    for b, key in enumerate(keys):
        base = rng.threefry_key(key, (stream,))
        for i in range(num_cutouts):
            k1, k2, k3 = rng.split(rng.fold_in(base, i), 3)
            frac = rng.uniform_scalar(k1) ** np.float32(cut_power)
            size = int((frac * np.float32(min_side - cut_size) +
                        np.float32(cut_size)).astype(np.int32))
            size = min(max(size, 8), min_side)
            out[b, i] = (rng.randint(k2, 0, max(h - size, 1)),
                         rng.randint(k3, 0, max(w - size, 1)))
    return out


def make_cutouts(images, keys, num_cutouts: int, cut_size: int,
                 stream: str, cut_power: float = 1.0):
    """Batch-independent square crops resized to cut_size (bilinear, as
    jax.image.resize): images [B,H,W,C] -> [B*num_cutouts, S, S, C]; RGB
    images and 4-channel latents alike. Every crop is
    min(2 * cut_size, min_side) wide, its offsets clamped so that it fits,
    as jax.lax.dynamic_slice clamps; the drawn size only bounds the
    offsets."""
    b, h, w, _ = images.shape
    side = min(cut_size * 2, min(h, w))
    offs = cutout_offsets(keys, stream, num_cutouts, h, w, cut_size,
                          cut_power)
    crops = []
    for i in range(b):
        for oy, ox in offs[i]:
            oy, ox = min(max(int(oy), 0), h - side), \
                min(max(int(ox), 0), w - side)
            crops.append(images[i, oy:oy + side, ox:ox + side])
    return resize(torch.stack(crops), (cut_size, cut_size), "bilinear")


def spherical_dist(x, y):
    x = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    y = y / torch.linalg.vector_norm(y, dim=-1, keepdim=True)
    return torch.arcsin(torch.linalg.vector_norm(x - y, dim=-1) / 2.0) ** 2 \
        * 4.0


def guidance_loss(x0, keys, vision_params, vision_cfg, text_embeds,
                  cfg: ClipGuidanceConfig, vae_decode=None,
                  latent_scale: float = 0.18215):
    """The CLIP loss on decoded views of the x0 prediction (scaled latents
    [B,h,w,4] f32), before the guidance_scale * 500 factor: the mean over a
    sample's views, summed over the batch (the whole-image loss: the mean
    over the batch). text_embeds: [B, proj] unit targets."""
    b = x0.shape[0]
    size = vision_cfg.image_size
    views = []
    if not cfg.num_cutouts:
        if cfg.no_cutouts == "vae" and vae_decode is not None:
            lat_size = max(size // 8, 8)
            lat = resize(x0, (lat_size, lat_size), "bilinear")
            img = vae_decode(lat / latent_scale) * 0.5 + 0.5
        else:
            img = approx_decode(x0)
        img = resize(img, (size, size), "bilinear")
        views.append(img.reshape(b, 1, size, size, 3))
    else:
        if cfg.approx_cutouts:
            rgb = resize(approx_decode(x0),
                         (x0.shape[1] * 8, x0.shape[2] * 8), "bilinear")
            cuts = make_cutouts(rgb, keys, cfg.approx_cutouts, size,
                                "clip_cuts_rgb")
            views.append(cuts.reshape(b, cfg.approx_cutouts, size, size,
                                      3))
        if cfg.vae_cutouts and vae_decode is not None:
            lat_cuts = make_cutouts(x0, keys, cfg.vae_cutouts,
                                    max(size // 8, 8), "clip_cuts_vae")
            dec = vae_decode(lat_cuts / latent_scale) * 0.5 + 0.5
            dec = resize(dec, (size, size), "bilinear")
            views.append(dec.reshape(b, cfg.vae_cutouts, size, size, 3))
    cuts = torch.cat(views, dim=1)                   # [B, n_views, S, S, 3]
    n_views = cuts.shape[1]
    cuts = cuts.clamp(0.0, 1.0).reshape(b * n_views, size, size, 3)
    out = clip_mod.vision_apply(vision_params, vision_cfg,
                                clip_mod.preprocess_image(cuts))
    emb = out["image_embeds"].reshape(b, n_views, -1)
    dists = spherical_dist(emb, text_embeds[:, None, :])   # [B, n_views]
    if not cfg.num_cutouts:
        return dists.mean()
    return dists.mean(dim=1).sum()


def make_clip_guided_denoiser(denoise, vision_params, vision_cfg,
                              text_embeds, keys, *,
                              config: ClipGuidanceConfig, cond_stem=None,
                              vae_decode=None):
    """denoise(x, sigma) -> x0, steered: x0 - grad * sigma^2 * scale * 500,
    grad the loss's gradient with respect to x through ``cond_stem`` (a
    cond-only denoiser, under "guided") or through ``denoise`` itself
    ("mixed", one forward for both the prediction and the gradient). The
    graph is built under enable_grad on a copy of x made outside inference
    mode, whatever the caller's grad mode."""
    grad_stem = (cond_stem if config.guidance_base == "guided" and
                 cond_stem is not None else denoise)
    scale = config.guidance_scale * 500.0

    def loss_of(x0):
        return guidance_loss(x0, keys, vision_params, vision_cfg,
                             text_embeds, config, vae_decode=vae_decode)

    def wrapped(x, sigma: float):
        with torch.inference_mode(False), torch.enable_grad():
            xv = x.detach().clone().requires_grad_()
            pred = grad_stem(xv, sigma)
            (grad,) = torch.autograd.grad(loss_of(pred), xv)
        if grad_stem is denoise:
            x0 = pred.detach()
        else:
            del pred
            x0 = denoise(x, sigma)
        sig2 = float(np.float32(sigma) ** 2)
        return x0 - grad * sig2 * scale

    return wrapped


def flatloss_check(losses, cfg: ClipGuidanceConfig,
                   samples_per_window: int | None = None) -> bool:
    """Host-side flat-loss detection between dispatch chunks: least-squares
    line over the recent loss history; flat once |slope| < threshold and
    intercept < maxloss (reference _has_flatloss,
    clipguided.py:152-173). `samples_per_window` overrides the window
    length when losses are recorded per-chunk rather than per-step."""
    window = samples_per_window or cfg.gradient_length
    window = max(window, 2)
    if len(losses) <= window:
        return False
    x = np.linspace(0, 1, window)
    a = np.vstack([x, np.ones(window)]).T
    y = np.asarray(losses[-window:], np.float64)
    try:
        m, c = np.linalg.lstsq(a, y, rcond=None)[0]
    except np.linalg.LinAlgError:
        return False
    return bool(abs(m) < cfg.gradient_threshold and
                c < cfg.gradient_maxloss)
