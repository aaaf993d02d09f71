"""The latent diffusion upscalers: SD x4 (``DiffusionUpscaler``) and the
sd-x2 latent upscaler (``LatentUpscalerX2``).

Counterpart of gyre_tpu/pipeline/diffusion_upscaler.py, through the port's
denoiser and samplers:

  * x4: a 7-channel UNet ([latents(4) | low-res RGB(3)]) conditioned on
    the text and on the noise level through its class embedding; the
    low-res image is noise-augmented at that level (sigma from
    ``alphas_cumprod[noise_level]``); Karras sigmas (rho 7); a 3-level VAE
    decodes latents at the input's size to 4x its pixels;
  * x2: the input VAE-encoded (the mean, scaled), its latents upsampled 2x
    (nearest: a repeat) as 4 extra channels of the k-UNet
    (models/kunet.py), which predicts eps from c_in = 1/sqrt(sigma^2 + 1)
    scaled latents and c_noise = 0.25 * ln(sigma); the SD VAE decodes.

Both guide with CFG (both halves in one model call). Importing the module
registers the presets ``upscaler-x4``, ``upscaler-x4-test``,
``upscaler-x2`` and ``upscaler-x2-test`` in models.configs.PRESETS, as
the JAX module does.

Noise: every draw goes through ``utils.rng`` with the JAX package's stream
names ("init" and "lowres_aug" at step 0, the sampler's by global step),
so a seed draws the JAX package's noise.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models import clip as clip_mod
from ..models import configs
from ..models import kunet as kunet_mod
from ..models import unet as unet_mod
from ..models import vae as vae_mod
from ..models.modelset import ModelSet, random_modelset
from ..utils import rng
from . import denoiser, prompts, samplers
from . import schedule as sched

UNET_X4 = configs.UNetConfig(
    in_channels=7,
    block_out_channels=(64, 128, 256, 256),
    num_heads=(8, 8, 8, 8),
    cross_attention_dim=768,
    class_embed=True,
)
VAE_X4 = configs.VAEConfig(block_out_channels=(128, 256, 512),
                           scaling_factor=0.08333)
X4_CONFIG = configs.ModelSetConfig(
    unet=UNET_X4, vae=VAE_X4, text_encoders=(configs.CLIP_VIT_L,),
    sample_size=128)
X4_TEST_CONFIG = configs.ModelSetConfig(
    unet=dataclasses.replace(UNET_X4, block_out_channels=(16, 32, 64, 64),
                             num_heads=(4, 4, 4, 4), cross_attention_dim=64,
                             time_embed_dim=64, norm_groups=8),
    vae=configs.VAEConfig(block_out_channels=(16, 32, 64), norm_groups=8,
                          scaling_factor=0.08333),
    text_encoders=(configs.CLIP_TEST,), sample_size=16)

X2_CONFIG = configs.ModelSetConfig(
    unet=kunet_mod.X2_DEFAULT, text_encoders=(configs.CLIP_VIT_L,),
    sample_size=128)
X2_TEST_CONFIG = configs.ModelSetConfig(
    unet=dataclasses.replace(kunet_mod.X2_TEST, cross_attention_dim=64),
    vae=configs.VAEConfig(block_out_channels=(16, 32, 64, 64),
                          norm_groups=8),
    text_encoders=(configs.CLIP_TEST,), sample_size=16)

configs.PRESETS["upscaler-x4"] = X4_CONFIG
configs.PRESETS["upscaler-x4-test"] = X4_TEST_CONFIG
configs.PRESETS["upscaler-x2"] = X2_CONFIG
configs.PRESETS["upscaler-x2-test"] = X2_TEST_CONFIG


class _Upscaler:
    """What the two upscalers share: the ModelSet, the compute dtype, the
    prompt contexts and the per-seed noise."""

    PRESET = ""

    def __init__(self, modelset: ModelSet, compute_dtype=torch.float32):
        self.ms = modelset
        self.compute_dtype = compute_dtype

    @classmethod
    def random(cls, test: bool = True, seed: int = 0,
               compute_dtype=torch.float32, device="cuda"):
        name = cls.PRESET + ("-test" if test else "")
        return cls(random_modelset(configs.PRESETS[name], seed=seed,
                                   dtype=compute_dtype, device=device,
                                   engine_id=cls.PRESET),
                   compute_dtype=compute_dtype)

    def _context(self, prompt: str, b: int):
        """[b, 77, D] last hidden states of the prompt's first chunk."""
        ms = self.ms
        ids, _, _ = prompts.tokenize_weighted(
            ms.tokenizer, prompts.WeightedPrompt.parse(prompt or ""))
        ids = torch.from_numpy(ids[:1]).to(ms.device)
        ctx = clip_mod.apply(ms.text_params[0], ms.config.text_encoders[0],
                             ids, dtype=self.compute_dtype)["last"]
        return ctx.expand(b, -1, -1)

    def _setup(self, image, seeds, prompt: str):
        img = torch.as_tensor(image).to(self.ms.device, torch.float32)
        b = img.shape[0]
        seeds = list(seeds) if seeds is not None else list(range(b))
        return img, b, seeds, self._context("", b), self._context(prompt, b)

    def _sample(self, sampler, dn, seeds, sigmas, shape):
        dev = self.ms.device
        x = rng.batched_stream_normal(seeds, "init", 0, shape, dev) * \
            float(sigmas[0])

        def noise_fn(i, tag):
            return rng.batched_stream_normal(seeds, tag, i, shape, dev)

        return samplers.sample(sampler, dn, x, sigmas, noise_fn,
                               samplers.SamplerParams())

    def _decode(self, x0):
        vcfg = self.ms.config.vae
        z = (x0 / vcfg.scaling_factor).to(self.compute_dtype)
        out = vae_mod.decode(self.ms.vae_params, vcfg, z)
        return torch.clamp(out.float() * 0.5 + 0.5, 0.0, 1.0)


class DiffusionUpscaler(_Upscaler):
    """Text-guided 4x latent upscaler."""

    PRESET = "upscaler-x4"

    @torch.inference_mode()
    def __call__(self, image, *, prompt: str = "", steps: int = 20,
                 seeds=None, guidance_scale: float = 7.5,
                 noise_level: int = 20, sampler: str = "k_dpmpp_2m"):
        """image [B,H,W,3] in [0, 1] -> [B,4H,4W,3] f32."""
        ms = self.ms
        cdt = self.compute_dtype
        img, b, seeds, ctx_u, ctx_g = self._setup(image, seeds, prompt)
        sigmas = sched.build_sigmas(ms.schedule, steps, karras_rho=7.0)

        # the conditioning image noise-augmented at noise_level
        aug = rng.batched_stream_normal(seeds, "lowres_aug", 0,
                                        tuple(img.shape[1:]), ms.device)
        ac = ms.schedule.alphas_cumprod[noise_level]
        low_res = (img * 2 - 1) + aug * float(np.sqrt((1 - ac) / ac))
        levels = torch.full((b,), float(noise_level), device=ms.device)

        def model_fn(x, t, context, **_):
            reps = x.shape[0] // b
            x7 = torch.cat([x.to(cdt), low_res.repeat(reps, 1, 1, 1).to(cdt)],
                           dim=-1)
            return unet_mod.apply(ms.unet_params, ms.config.unet, x7, t,
                                  context.to(cdt),
                                  class_labels=levels.repeat(reps)).float()

        dn = denoiser.make_denoiser(
            denoiser.cfg_model(model_fn, ctx_u, ctx_g, float(guidance_scale)),
            ms.schedule)
        x0 = self._sample(sampler, dn, seeds, sigmas,
                          tuple(img.shape[1:3]) + (4,))
        return self._decode(x0)


class LatentUpscalerX2(_Upscaler):
    """Text-guided 2x latent upscaler (k-upscaler conditioning)."""

    PRESET = "upscaler-x2"

    @torch.inference_mode()
    def __call__(self, image, *, prompt: str = "", steps: int = 30,
                 seeds=None, guidance_scale: float = 7.5,
                 sampler: str = "k_euler"):
        """image [B,H,W,3] in [0, 1] -> [B,2H,2W,3] f32, by 2x latent
        diffusion."""
        ms = self.ms
        cdt = self.compute_dtype
        img, b, seeds, ctx_u, ctx_g = self._setup(image, seeds, prompt)
        sigmas = sched.build_sigmas(ms.schedule, steps, karras_rho=7.0)

        mean, _ = vae_mod.encode(ms.vae_params, ms.config.vae,
                                 (img * 2 - 1).to(cdt))
        lat = mean.float() * ms.config.vae.scaling_factor
        cond = lat.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)

        def model_fn(x, t, context, **_):
            reps = x.shape[0] // b
            x8 = torch.cat([x.to(cdt), cond.repeat(reps, 1, 1, 1).to(cdt)],
                           dim=-1)
            return kunet_mod.apply(ms.unet_params, ms.config.unet, x8, t,
                                   context.to(cdt)).float()

        model = denoiser.cfg_model(model_fn, ctx_u, ctx_g,
                                   float(guidance_scale))

        def dn(x, sigma: float):
            # eps prediction in sigma space, conditioned on c_noise (f32,
            # as the JAX package computes it)
            sig = np.float32(sigma)
            c_in = float(np.float32(1.0) / np.sqrt(sig * sig + np.float32(1)))
            c_noise = float(np.float32(0.25) *
                            np.log(max(sig, np.float32(1e-8))))
            t = torch.full((x.shape[0],), c_noise, device=x.device)
            return x - model(x * c_in, t) * float(sig)

        x0 = self._sample(sampler, dn, seeds, sigmas,
                          tuple(cond.shape[1:]))
        return self._decode(x0)

