"""UnifiedPipeline: the generation engine, txt2img slice.

Counterpart of gyre_tpu/pipeline/unified.py. A request runs: prompt
encoding (CLIP, weighted and chunked prompts), initial noise from per-seed
generators, the sampler over the CFG-wrapped UNet (parallel CFG: both
halves in one UNet call), the VAE decode and, on request, quantisation to
uint8 on the device.

``begin()`` returns the chunk-granular generator the shared coalescing
dispatcher (gyre_tpu.manager.scheduler) drives: with ``chunk_steps`` and a
``stop_event`` or ``progress_callback`` it yields (steps_done, steps_total)
after every chunk and returns None when the stop event is set. The
sampler's carry makes a chunked run compute exactly what one run does.

Device work runs under ``torch.inference_mode()`` in the helpers below;
the generator yields outside them. Not ported yet, and raising when asked
for: img2img, inpaint, depth2img, hints, hires fix, grafting, CLIP
guidance, tiling, token merging, sequential CFG, brownian noise and the
tiled VAE decode of outputs past 1280 px.
"""

from __future__ import annotations

import torch

from .. import set_matmul_precision
from ..models import clip as clip_mod
from ..models import unet as unet_mod
from ..models import vae as vae_mod
from . import denoiser, modes, prompts, samplers
from . import schedule as sched


class UnifiedPipeline:
    """Bundles one engine's models and serves generation requests."""

    # latent size above which the JAX package decodes in tiles
    VAE_TILE_THRESHOLD = 160

    def __init__(self, modelset, compute_dtype=torch.bfloat16):
        set_matmul_precision()
        self.ms = modelset
        self.compute_dtype = compute_dtype
        self.device = modelset.device

    @property
    def schedule(self) -> sched.DiffusionSchedule:
        return self.ms.schedule

    # ------------------------------------------------------------ prompts

    def _encode_ids(self, ids, clip_layer: int):
        cfg = self.ms.config.text_encoders[0]
        params = self.ms.text_params[0]
        out = clip_mod.apply(params, cfg, ids, dtype=self.compute_dtype)
        return clip_mod.hidden_for_layer(params, cfg, out, clip_layer)

    def chunk_count(self, *prompt_texts: str) -> int:
        n = 1
        for text in prompt_texts:
            if text:
                p = prompts.WeightedPrompt.parse(text)
                n = max(n, prompts.tokenize_weighted(self.ms.tokenizer,
                                                     p)[2])
        return n

    def encode_prompt_list(self, texts, pad_to_chunks: int,
                           clip_layer: int | None = None):
        """[B, T, D] contexts for a list of prompts, one tower call."""
        layer = clip_layer if clip_layer else self.ms.config.clip_layer
        parsed = [prompts.WeightedPrompt.parse(t or "") for t in texts]
        return prompts.encode_weighted_prompts_batch(
            lambda ids: self._encode_ids(ids, layer), self.ms.tokenizer,
            parsed, pad_to_chunks=pad_to_chunks, device=self.device)

    @torch.inference_mode()
    def _contexts(self, prompt, negative_prompt, batch: int, guided: bool,
                  clip_layer: int):
        """(ctx_uncond, ctx_cond), each [B, T, D]. Prompts may be per-sample
        lists (coalesced requests)."""
        pos = list(prompt) if isinstance(prompt, (list, tuple)) \
            else [prompt] * batch
        neg = list(negative_prompt) \
            if isinstance(negative_prompt, (list, tuple)) \
            else [negative_prompt] * batch
        if len(pos) != batch or len(neg) != batch:
            raise ValueError(
                f"per-sample prompt lists ({len(pos)} prompts, {len(neg)} "
                f"negatives) must be row-aligned with {batch} seeds")
        chunks = self.chunk_count(*(pos + neg))
        # encode each distinct text once
        texts = list(dict.fromkeys(pos + (neg if guided else [])))
        enc = self.encode_prompt_list(texts, chunks, clip_layer)
        row = {t: i for i, t in enumerate(texts)}
        ctx_g = enc[[row[t] for t in pos]]
        ctx_u = enc[[row[t] for t in neg]] if guided else ctx_g
        return ctx_u, ctx_g

    # ---------------------------------------------------------------- VAE

    @torch.inference_mode()
    def vae_decode(self, latents):
        """scaled latents [B,h,w,4] -> images [B,8h,8w,3] f32 in [0,1]."""
        if max(latents.shape[1:3]) > self.VAE_TILE_THRESHOLD:
            raise NotImplementedError(
                "tiled VAE decode (outputs past 1280 px) is not ported to "
                "gyre_tpu_torch yet")
        cfg = self.ms.config.vae
        z = (latents / cfg.scaling_factor).to(self.compute_dtype)
        img = vae_mod.decode(self.ms.vae_params, cfg, z)
        return (img.float() * 0.5 + 0.5).clamp(0.0, 1.0)

    # ------------------------------------------------------------- denoise

    def _denoiser(self, ctx_u, ctx_g, guidance_scale, guided: bool):
        ucfg = self.ms.config.unet
        cdt = self.compute_dtype

        def raw_unet(x, t, context):
            return unet_mod.apply(self.ms.unet_params, ucfg, x.to(cdt), t,
                                  context.to(cdt)).float()

        if guided:
            model = denoiser.cfg_model(raw_unet, ctx_u, ctx_g, guidance_scale)
        else:
            model = denoiser.plain_model(raw_unet, ctx_g)
        return denoiser.make_denoiser(model, self.schedule)

    @torch.inference_mode()
    def _initial(self, seeds, lh: int, lw: int, sigma_max: float):
        shape = (lh, lw, self.ms.config.unet.out_channels)
        return modes.txt2img_initial(seeds, shape, sigma_max, self.device,
                                     natural=self.ms.config.sample_size)

    @torch.inference_mode()
    def _run_steps(self, sampler, dn, x, sigmas, params, start, steps,
                   carry):
        return samplers.sample(sampler, dn, x, sigmas, None, params,
                               start=start, steps=steps, carry=carry,
                               return_carry=True)

    @torch.inference_mode()
    def _to_uint8(self, images):
        return (images * 255.0 + 0.5).clamp(0, 255).to(torch.uint8)

    # ------------------------------------------------------------ generate

    def __call__(self, **kwargs):
        """Run generation; returns images [B,H,W,3] (f32 in [0,1], or uint8
        with output_dtype="uint8") on the pipeline's device, or None when
        cancelled."""
        gen = self._generate(**kwargs)
        while True:
            try:
                next(gen)
            except StopIteration as e:
                return e.value

    def begin(self, **kwargs):
        """Chunk-granular stepper for the dispatcher: a generator yielding
        (steps_done, steps_total) after every chunk; its StopIteration
        value is the images, or None on cancel."""
        return self._generate(**kwargs)

    def _generate(self, *,
                  prompt="",
                  negative_prompt="",
                  height: int = 512,
                  width: int = 512,
                  steps: int = 50,
                  sampler: str = "k_dpmpp_2m",
                  seeds=(0,),
                  guidance_scale=7.5,
                  eta: float | None = None,
                  warmup_lms: bool = False,
                  ddim_cutoff: float = 0.0,
                  karras_rho: float | None = None,
                  sigma_min: float | None = None,
                  sigma_max: float | None = None,
                  clip_layer: int = 0,
                  noise_type: str = "normal",
                  progress_callback=None,
                  stop_event=None,
                  chunk_steps: int = 0,
                  return_latents: bool = False,
                  output_dtype: str | None = None):
        if noise_type != "normal":
            raise NotImplementedError(
                f"noise_type {noise_type!r} is not ported to gyre_tpu_torch "
                "yet")
        factor = 8
        if height % factor or width % factor:
            raise ValueError(f"height and width must be multiples of "
                             f"{factor}, got {height}x{width}")
        lh, lw = height // factor, width // factor
        seeds = list(seeds)
        batch = len(seeds)

        sigmas = sched.build_sigmas(
            self.schedule, steps, karras_rho=karras_rho,
            sigma_min=sigma_min, sigma_max=sigma_max,
            spacing=("leading"
                     if sampler in samplers.DIFFUSERS_GRID_SAMPLERS
                     else "linspace"))
        n_steps = len(sigmas) - 1
        # eta is part of the request surface; DPM++ 2M has none, and the
        # JAX package ignores it for this sampler too
        params = samplers.SamplerParams(warmup_lms=bool(warmup_lms),
                                        ddim_cutoff=float(ddim_cutoff))

        gs = torch.as_tensor(guidance_scale, dtype=torch.float32).reshape(-1)
        guided = bool((gs > 1.0).any())
        if gs.numel() > 1:
            gs_arg = gs.expand(batch).to(self.device)
        else:
            gs_arg = float(gs[0])

        ctx_u, ctx_g = self._contexts(prompt, negative_prompt, batch, guided,
                                      clip_layer)
        dn = self._denoiser(ctx_u, ctx_g, gs_arg, guided)
        x = self._initial(seeds, lh, lw, float(sigmas[0]))
        carry = samplers.init_carry(sampler, x)

        chunked = bool(chunk_steps) and chunk_steps < n_steps and (
            progress_callback is not None or stop_event is not None)
        seg_len = chunk_steps if chunked else n_steps
        done = 0
        while done < n_steps:
            seg = min(seg_len, n_steps - done)
            x, carry = self._run_steps(sampler, dn, x, sigmas, params, done,
                                       seg, carry)
            done += seg
            if progress_callback is not None:
                progress_callback(done, n_steps)
            if chunked:
                if stop_event is not None and stop_event.is_set():
                    return None
                yield done, n_steps

        if return_latents:
            return x
        images = self.vae_decode(x)
        if output_dtype == "uint8":
            images = self._to_uint8(images)
        return images
