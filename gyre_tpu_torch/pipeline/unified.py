"""UnifiedPipeline: the generation engine.

Counterpart of gyre_tpu/pipeline/unified.py. A request runs: prompt
encoding (CLIP, weighted and chunked prompts), the initial latents of its
mode, any of the protocol's samplers over the CFG-wrapped UNet (parallel
CFG: both halves in one UNet call; ``cfg_sequential``: two calls of one
half each, forced off under a cfg_only hint; ``tome_ratio``: token merging
in the engine's UNet, not a grafted one's, as in the JAX package) with its
per-step noise
(``make_noise_fn``), the VAE decode (in overlapping tiles past
``VAE_TILE_THRESHOLD`` latents) and, on request, quantisation to uint8 on
the device.

Model families, as the ModelSet's config has them: SD1.x; SD2 (OpenCLIP-H
at its penultimate layer, linear projections, v-prediction at 768²); SDXL
(CLIP-L and OpenCLIP-bigG contexts concatenated along the feature axis,
the pooled text of the last tower and the size time ids as the UNet's
``added_cond``, ``_added_cond``) and its refiner (bigG alone, 5 time ids
with an aesthetic score).

Modes, chosen by the request as in the JAX package: txt2img; img2img (an
init image, VAE-encoded, noised to the last round(steps * strength) steps
of the ramp); inpaint (a mask: on a 4-channel UNet the masked area is
refilled and the kept area pinned every step, then composited in image
space with its histogram matched; on the 9-channel inpainting UNet the
mask and the masked image's latents are extra input channels); depth2img
(the 5-channel UNet, with a depth map, or the init image's blurred
grayscale); the hires fix (a low-resolution pass at the model's native
size cross-injected into the target size); graft (a second engine's UNet
blended in, ``graft_ms``); and seamless tiling on either axis.

``begin()`` returns the chunk-granular generator the shared coalescing
dispatcher (manager/scheduler.py) drives: with ``chunk_steps`` and a
``stop_event`` or ``progress_callback`` it yields (steps_done, steps_total)
after every chunk and returns None when the stop event is set. The
sampler's carry makes a chunked run compute exactly what one run does;
dpm_adaptive's chunks bound its solver iterations, and its progress counts
against ceil(128 / chunk) chunks until the solver reaches sigma_min. The
hires fix runs unchunked, as in the JAX package.

Device work runs under ``torch.no_grad()`` in the helpers below (not
inference mode: a CLIP-guided step saves the request's tensors, and the
weights it shares with every request, for its backward); the generator
yields outside them. ``SD_DEBUG_LATENTS`` dumps the latents
at init (modes with an init image), after each chunk and at the end
(utils/latent_debug.py).

Hints (``hints``: ControlNets and T2I adapters, ``_HintStack``) condition
the engine's UNet: a ControlNet's residuals are added to the skips and the
mid block, an adapter's features to the down path. Their embeddings and
features are computed once a request, outside the step loop. A hint's
priority maps, as in the JAX package, to ``soft_injection`` (logspace
weights over the residuals or levels) and ``cfg_only`` (the ControlNet
runs on the guided CFG half only, the unguided half gets zeros). Under the
hires fix the low-resolution pass gets the hint at its own size, where the
JAX package fails on the shapes (ROADMAP queue 3). A style hint runs the
CLIP vision tower and the style adapter once a request and appends its
tokens to the conditional context (zeros to the unconditional one).

CLIP guidance (``clip_guidance_scale``, pipeline/clip_guidance.py) steers
each step by the gradient of a CLIP loss through the denoiser, against the
engine's ``clip:`` model (``clip_source``, set by the manager) or, without
one, a random vision tower with a warning. Under "guided" the gradient
goes through a cond-only stem of the UNet, under "mixed" through the
CFG-combined prediction. A chunked guided request evaluates the unguided
loss after each chunk but the last and stops guiding once the loss is
flat (the JAX package's window rule); dpm_adaptive runs unchunked when
guided, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import set_matmul_precision
from ..models import clip as clip_mod
from ..models import controlnet as cn_mod
from ..models import t2i_adapter as t2i_mod
from ..models import unet as unet_mod
from ..models import vae as vae_mod
from ..ops import images as I
from ..ops.resize import resize
from ..utils import rng
from ..utils.latent_debug import log_latents
from . import clip_guidance as cg
from . import denoiser, modes, prompts, samplers
from . import schedule as sched


def make_noise_fn(seeds, sigmas, shape, noise_type: str, device):
    """The samplers' per-step noise: ``noise_fn(i, tag)`` -> [B, *shape]
    f32 on ``device``, row b from seeds[b] (a seed, or a key of
    utils/rng.py) alone. "normal" keys a draw by the GLOBAL step index i
    (a chunked run draws what one run draws); "brownian" keys it by the
    step's quantised log sigma, int(log(max(sigma, 1e-6)) * 256) in f32
    as the JAX package computes it, so a request draws the same noise at
    the same sigma whatever its step count."""
    if noise_type not in ("normal", "brownian"):
        raise ValueError(f"unknown noise_type {noise_type!r}")

    def noise_fn(i, tag):
        key = i
        if noise_type == "brownian":
            s = np.maximum(np.float32(sigmas[i]), np.float32(1e-6))
            key = int(np.log(s) * np.float32(256.0))
        return rng.batched_stream_normal(seeds, tag, key, shape, device)

    return noise_fn


def _prompt_rows(prompt, negative_prompt, batch: int):
    """(prompts, negative prompts), one of each a row; either may be a
    per-sample list (coalesced requests) or one text for every row."""
    pos = list(prompt) if isinstance(prompt, (list, tuple)) \
        else [prompt] * batch
    neg = list(negative_prompt) \
        if isinstance(negative_prompt, (list, tuple)) \
        else [negative_prompt] * batch
    if len(pos) != batch or len(neg) != batch:
        raise ValueError(
            f"per-sample prompt lists ({len(pos)} prompts, {len(neg)} "
            f"negatives) must be row-aligned with {batch} seeds")
    return pos, neg


def _tiling_axes(tiling) -> tuple[bool, bool]:
    """The request's tiling as (x, y): a bool for both axes, or "x", "y",
    "xy", "both" or "true"."""
    if isinstance(tiling, str):
        return (tiling in ("x", "xy", "both", "true"),
                tiling in ("y", "xy", "both", "true"))
    return bool(tiling), bool(tiling)


class _HintStack:
    """A request's hints, set up once a request: each ControlNet's
    conditioning embedding, layer weights and masks, and the summed T2I
    adapter features (those of cfg_only hints apart), at the request's
    latent size and, made at first use, at any other size the UNet is
    called at (the hires fix's low-resolution pass: the hint image resized
    to it, lanczos3). ``wrap(raw_unet)`` is the hinted UNet."""

    def __init__(self, hints, batch: int, guided: bool, ucfg, cdt, device,
                 lh: int, lw: int):
        self.ucfg, self.cdt, self.guided = ucfg, cdt, guided
        self.hints = []
        for hint in hints:
            img = hint["image"]
            if not torch.is_tensor(img):
                img = torch.from_numpy(np.array(img, dtype=np.float32))
            img = img.to(device, torch.float32)
            mask = hint.get("mask")
            if mask is not None:
                if not torch.is_tensor(mask):
                    mask = torch.from_numpy(np.array(mask, dtype=np.float32))
                mask = mask.to(device, torch.float32)
                if mask.ndim == 3:
                    mask = mask[None]
                mask = mask[:1, :, :, :1]      # [1,H,W,1], every row
            self.hints.append(dict(
                hint, image=img.expand(batch, *img.shape[1:]), mask=mask,
                kind=hint.get("kind", "controlnet"),
                soft=bool(hint.get("soft_injection")),
                cfg_only=bool(hint.get("cfg_only")) and guided,
                scale=float(hint.get("scale", 1.0))))
        self.size = (lh, lw)
        self._features = {}
        self.features(lh, lw)

    @torch.no_grad()
    def features(self, lh: int, lw: int):
        """(controlnets, adapter states, cfg_only adapter states) at latent
        size (lh, lw)."""
        if (lh, lw) in self._features:
            return self._features[(lh, lw)]
        cdt = self.cdt
        controlnets, states, states_g = [], None, None
        for hint in self.hints:
            img = hint["image"]
            if (lh, lw) != self.size:
                img = resize(img, (lh * 8, lw * 8), "lanczos3")
            mask = hint["mask"]
            if hint["kind"] == "controlnet":
                down_rs, mid_r = cn_mod.residual_resolutions(self.ucfg, lh,
                                                             lw)
                n_res = len(down_rs)
                # 13 weights for SD's 12 down residuals + mid: logspace
                # under soft injection, the mid's always 1
                lw_np = (np.logspace(-1, 0, n_res + 1) if hint["soft"]
                         else np.ones(n_res + 1))
                controlnets.append({
                    "params": hint["params"], "scale": hint["scale"],
                    "cfg_only": hint["cfg_only"],
                    "emb": cn_mod.embed_condition(hint["params"],
                                                  img.to(cdt)),
                    "lw": [float(np.float32(v)) for v in lw_np],
                    "masks": None if mask is None else [
                        resize(mask, hw, "bilinear")
                        for hw in down_rs + [mid_r]]})
                continue
            feats = t2i_mod.apply(hint["params"], img.to(cdt))
            # soft injection: logspace level weights; cfg_only drops the
            # first level to 0.25
            lw_np = np.ones(len(feats))
            if hint["soft"]:
                lw_np = np.logspace(-0.25, 0, len(feats))
                if hint["cfg_only"]:
                    lw_np[0] = 0.25
            feats = [f * (hint["scale"] * float(lw_np[i]))
                     for i, f in enumerate(feats)]
            if mask is not None:
                feats = [f * resize(mask, f.shape[1:3], "bilinear").to(
                    f.dtype) for f in feats]
            if hint["cfg_only"]:
                states_g = feats if states_g is None else [
                    a + f for a, f in zip(states_g, feats)]
            else:
                states = feats if states is None else [
                    a + f for a, f in zip(states, feats)]
        self._features[(lh, lw)] = controlnets, states, states_g
        return self._features[(lh, lw)]

    def wrap(self, raw_unet):
        """raw_unet(x, t, context, **conditioning) -> the hinted UNet;
        x's rows are [unguided B; guided B] when the request is guided."""
        cdt, ucfg = self.cdt, self.ucfg

        def hinted(x, t, context, **cond):
            controlnets, states, states_g = self.features(*x.shape[1:3])
            down_res = mid_res = None
            for cn in controlnets:
                bh = cn["emb"].shape[0]
                # cfg_only: the ControlNet on the guided half only, zeros
                # for the unguided half
                cfg_only = cn["cfg_only"] and x.shape[0] == 2 * bh
                xin, tin, cin = ((x[bh:], t[bh:], context[bh:]) if cfg_only
                                 else (x, t, context))
                ce = cn["emb"].repeat(xin.shape[0] // bh, 1, 1, 1)
                d, m = cn_mod.apply(cn["params"], ucfg, xin.to(cdt), tin,
                                    cin.to(cdt), ce,
                                    conditioning_scale=cn["scale"])

                def post(r, i, n=len(d)):
                    r = r * cn["lw"][min(i, n)]
                    if cn["masks"] is not None:
                        r = r * cn["masks"][i]
                    if cfg_only:
                        r = torch.cat([torch.zeros_like(r), r], dim=0)
                    return r

                d = [post(r, i) for i, r in enumerate(d)]
                m = post(m, len(d))
                down_res = d if down_res is None else [
                    a + b for a, b in zip(down_res, d)]
                mid_res = m if mid_res is None else mid_res + m
            ast = None
            if states is not None:
                ast = [a.repeat(x.shape[0] // a.shape[0], 1, 1, 1)
                       for a in states]
            if states_g is not None:
                gst = [torch.cat([torch.zeros_like(a), a], dim=0)
                       if self.guided and x.shape[0] == 2 * a.shape[0]
                       else a.repeat(x.shape[0] // a.shape[0], 1, 1, 1)
                       for a in states_g]
                ast = gst if ast is None else [a + g for a, g in
                                               zip(ast, gst)]
            return raw_unet(x, t, context, down_residuals=down_res,
                            mid_residual=mid_res, adapter_states=ast,
                            **cond)

        return hinted


class _ClipGuide:
    """A request's CLIP guidance: ``denoise`` is the steered denoiser, the
    unguided one once the flat-loss stop has tripped; ``chunk_loss``
    records the unguided loss after a chunk and checks the stop (one loss
    a chunk, over a window of about gradient_length steps' worth of
    chunks)."""

    def __init__(self, ccfg, dn, vision, vcfg, target, keys, stem,
                 vae_decode):
        self.ccfg, self.keys = ccfg, keys
        self.vision, self.vcfg, self.target = vision, vcfg, target
        self.vae_decode = vae_decode
        self.steer = cg.make_clip_guided_denoiser(
            dn, vision, vcfg, target, keys, config=ccfg, cond_stem=stem,
            vae_decode=vae_decode)
        self.dn, self.flat, self.losses = dn, False, []

    def denoise(self, x, sigma: float):
        return (self.dn if self.flat else self.steer)(x, sigma)

    @torch.no_grad()
    def chunk_loss(self, x, sigma_end: float, chunk: int):
        if self.flat:
            return
        x0 = self.dn(x, max(sigma_end, 1e-4))
        loss = cg.guidance_loss(x0, self.keys, self.vision, self.vcfg,
                                     self.target, self.ccfg,
                                     vae_decode=self.vae_decode)
        self.losses.append(float(loss) / len(self.keys))
        window = max(2, -(-self.ccfg.gradient_length // max(chunk, 1)) + 1)
        self.flat = cg.flatloss_check(self.losses, self.ccfg,
                                           samples_per_window=window)


class UnifiedPipeline:
    """Bundles one engine's models and serves generation requests.
    ``graft_ms``: a second engine's ModelSet, grafted on top of this one's
    in every request (the engine's ``graft:`` parameter)."""

    # latents past which the VAE decodes in overlapping tiles of VAE_TILE
    # latents, VAE_TILE_OVERLAP of them feathered at each seam (the JAX
    # package's values; tests lower them on both pipelines)
    VAE_TILE_THRESHOLD = 160
    VAE_TILE = 96
    VAE_TILE_OVERLAP = 16

    def __init__(self, modelset, compute_dtype=torch.bfloat16,
                 graft_ms=None):
        set_matmul_precision()
        self.ms = modelset
        self.compute_dtype = compute_dtype
        self.device = modelset.device
        self.graft_ms = graft_ms
        self._graft_pipe = (UnifiedPipeline(graft_ms, compute_dtype)
                            if graft_ms is not None else None)
        # set by the manager for an engine with a `clip:` model: a callable
        # returning (text_params, text_cfg, vision_params, vision_cfg)
        self.clip_source = None
        # the CLIP towers once loaded; one dict, shared by derived views
        self._clip: dict = {}

    def derive(self, new_modelset) -> "UnifiedPipeline":
        """A view of this pipeline over other weights of the same
        architecture (LoRA/TI folded in), sharing everything else."""
        import copy

        view = copy.copy(self)
        view.ms = new_modelset
        return view

    @property
    def schedule(self) -> sched.DiffusionSchedule:
        return self.ms.schedule

    # ---------------------------------------------------------------- CLIP

    def clip_vision(self):
        """(params, CLIPVisionConfig) of the vision tower for guidance and
        style hints: the engine's CLIP model (``clip_source``), loaded at
        first use, or else a random tower (logged): CLIP_VISION_L, or
        CLIP_VISION_TEST below 768 wide, projecting to the width of the
        engine's first text tower, in the compute dtype. The towers are
        kept for every later request, guided ones too, so they are made
        outside inference mode whatever the caller's grad mode."""
        c = self._clip
        if "vision" in c:
            return c["vision"], c["vision_cfg"]
        with torch.inference_mode(False), torch.no_grad():
            if self.clip_source is not None:
                (c["text"], c["text_cfg"], c["vision"],
                 c["vision_cfg"]) = self.clip_source()
            else:
                import dataclasses
                import logging

                logging.getLogger(__name__).warning(
                    "engine %s has no `clip:` model configured: CLIP "
                    "guidance and style hints use a RANDOM vision tower. "
                    "Configure a clip model (e.g. clip: \"@clip-common\").",
                    self.ms.id)
                text_dim = self.ms.config.text_encoders[0].hidden_size
                base = (clip_mod.CLIP_VISION_L if text_dim >= 768
                        else clip_mod.CLIP_VISION_TEST)
                cfg = dataclasses.replace(base, projection_dim=text_dim)
                c["vision"] = clip_mod.random_vision(
                    cfg, 0, self.compute_dtype, self.device)
                c["vision_cfg"] = cfg
        return c["vision"], c["vision_cfg"]

    @torch.no_grad()
    def clip_text_target(self, text: str, batch: int):
        """[batch, proj] unit text embedding, the guidance's target: the
        CLIP model's projected pooled text or, without one, the engine's
        first text tower's pooled output; the prompt's first chunk."""
        self.clip_vision()
        ids = prompts.tokenize_weighted(
            self.ms.tokenizer, prompts.WeightedPrompt.parse(text or ""))[0]
        if "text" in self._clip:
            params, cfg = self._clip["text"], self._clip["text_cfg"]
        else:
            params, cfg = self.ms.text_params[0], \
                self.ms.config.text_encoders[0]
        pooled = clip_mod.apply(params, cfg, torch.from_numpy(ids[:1]).to(
            self.device))["pooled"].float()
        pooled = pooled / torch.linalg.vector_norm(pooled, dim=-1,
                                                   keepdim=True)
        return pooled.expand(batch, -1)

    @torch.no_grad()
    def _style_contexts(self, hints, batch: int, ctx_u, ctx_g):
        """(ctx_u, ctx_g) with each style hint's tokens appended to the
        conditional context and zeros to the unconditional one: the hint
        image resized to the vision tower's size (bilinear), through the
        tower and the style adapter, times the hint's scale."""
        vision, vcfg = self.clip_vision()
        size = vcfg.image_size
        for hint in hints:
            img = self._image(hint["image"])
            img = resize(img.expand(batch, *img.shape[1:]), (size, size),
                         "bilinear")
            tokens = clip_mod.vision_apply(
                vision, vcfg, clip_mod.preprocess_image(img))["tokens"]
            style = t2i_mod.style_apply(hint["params"], tokens) * float(
                hint.get("scale", 1.0))
            ctx_g = torch.cat([ctx_g, style.to(ctx_g.dtype)], dim=1)
            ctx_u = torch.cat([ctx_u, torch.zeros_like(style).to(
                ctx_u.dtype)], dim=1)
        return ctx_u, ctx_g

    # ------------------------------------------------------------ prompts

    def _encode_ids(self, ids, clip_layer: int, tower: int):
        cfg = self.ms.config.text_encoders[tower]
        params = self.ms.text_params[tower]
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
        """[B, T, D] contexts for a list of prompts, one call a tower; with
        two towers (SDXL) each tower's contexts, padded to the same chunks,
        concatenated along the feature axis. A falsy ``clip_layer`` takes
        the config's (-1 for SD1.x, -2 for SD2 and SDXL)."""
        layer = clip_layer if clip_layer else self.ms.config.clip_layer
        parsed = [prompts.WeightedPrompt.parse(t or "") for t in texts]
        parts = [prompts.encode_weighted_prompts_batch(
            lambda ids, i=i: self._encode_ids(ids, layer, i),
            self.ms.tokenizer, parsed, pad_to_chunks=pad_to_chunks,
            device=self.device)
            for i in range(len(self.ms.config.text_encoders))]
        return torch.cat(parts, dim=-1) if len(parts) > 1 else parts[0]

    def encode_pooled_batch(self, texts):
        """[B, D] pooled text of the last tower (SDXL's ``text_embeds``:
        the projected EOS row), one call for the whole list, each prompt's
        first chunk unweighted, as the JAX package takes it."""
        ids = np.stack([prompts.tokenize_weighted(
            self.ms.tokenizer, prompts.WeightedPrompt.parse(t or ""))[0][0]
            for t in texts])
        tower = len(self.ms.config.text_encoders) - 1
        return clip_mod.apply(
            self.ms.text_params[tower], self.ms.config.text_encoders[tower],
            torch.from_numpy(ids).to(self.device),
            dtype=self.compute_dtype)["pooled"]

    @torch.no_grad()
    def _contexts(self, prompt, negative_prompt, batch: int, guided: bool,
                  clip_layer: int):
        """(ctx_uncond, ctx_cond), each [B, T, D]. Prompts may be
        per-sample lists (coalesced requests)."""
        pos, neg = _prompt_rows(prompt, negative_prompt, batch)
        chunks = self.chunk_count(*(pos + neg))
        # encode each distinct text once
        texts = list(dict.fromkeys(pos + (neg if guided else [])))
        enc = self.encode_prompt_list(texts, chunks, clip_layer)
        row = {t: i for i, t in enumerate(texts)}
        ctx_g = enc[[row[t] for t in pos]]
        ctx_u = enc[[row[t] for t in neg]] if guided else ctx_g
        return ctx_u, ctx_g

    @torch.no_grad()
    def _added_cond(self, prompt, negative_prompt, batch: int, guided: bool,
                    height: int, width: int):
        """SDXL's "text_time" conditioning of each CFG half, (added_u,
        added_g) {"text_embeds", "time_ids"} with one row a sample, or
        (None, None) for a UNet without it. The time ids are the request's
        size in pixels: [h, w, 0, 0, h, w] (original size, crop, target
        size) for the base; the refiner's 5 take an aesthetic score in the
        target's place, 6.0 guided and 2.5 unguided. The pooled text comes
        from one call over every distinct prompt and negative prompt, so
        coalesced rows keep their own."""
        ucfg = self.ms.config.unet
        if not ucfg.addition_embed_dim:
            return None, None
        if ucfg.addition_time_ids == 5:
            ids_g = [height, width, 0, 0, 6.0]
            ids_u = [height, width, 0, 0, 2.5]
        else:
            ids_g = ids_u = [height, width, 0, 0, height,
                             width][:ucfg.addition_time_ids]
        pos, neg = _prompt_rows(prompt, negative_prompt, batch)
        pos = [t or "" for t in pos]
        neg = [t or "" for t in neg]
        texts = list(dict.fromkeys(pos + (neg if guided else [])))
        pooled = self.encode_pooled_batch(texts).float()
        row = {t: i for i, t in enumerate(texts)}

        def half(rows, ids):
            return {"text_embeds": pooled[[row[t] for t in rows]],
                    "time_ids": torch.tensor([ids] * batch,
                                             dtype=torch.float32,
                                             device=self.device)}

        added_g = half(pos, ids_g)
        return (half(neg, ids_u) if guided else added_g), added_g

    @torch.no_grad()
    def _graft_contexts(self, prompt, negative_prompt, batch: int,
                        guided: bool):
        """The grafted model's (ctx_uncond, ctx_cond): its own towers on
        the request's first prompt, padded to the chunks of the request's
        prompts."""
        pos, neg = _prompt_rows(prompt, negative_prompt, batch)
        enc = self._graft_pipe.encode_prompt_list(
            [pos[0]] + ([neg[0] or ""] if guided else []),
            self.chunk_count(*(pos + neg)))
        ctx_g = enc[:1].expand(batch, -1, -1)
        return (enc[1:].expand(batch, -1, -1) if guided else ctx_g), ctx_g

    # ---------------------------------------------------------------- VAE

    @torch.no_grad()
    def vae_encode(self, images, keys):
        """images [B,H,W,3] in [0,1] -> scaled latents [B,H/8,W/8,4] f32,
        the posterior sampled with each key's "vae" noise."""
        cfg = self.ms.config.vae
        x = images.to(self.compute_dtype) * 2.0 - 1.0
        mean, logvar = vae_mod.encode(self.ms.vae_params, cfg, x)
        noise = rng.batched_stream_normal(keys, "vae", 0, mean.shape[1:],
                                          self.device)
        z = vae_mod.sample_posterior(mean, logvar, noise.to(mean.dtype))
        return (z * cfg.scaling_factor).float()

    @torch.no_grad()
    def vae_decode(self, latents):
        """scaled latents [B,h,w,4] -> images [B,8h,8w,3] f32 in [0,1];
        past VAE_TILE_THRESHOLD latents in overlapping tiles."""
        if max(latents.shape[1:3]) > self.VAE_TILE_THRESHOLD:
            return self._vae_decode_tiled(latents)
        return self._vae_decode_whole(latents)

    def _vae_decode_whole(self, latents):
        cfg = self.ms.config.vae
        z = (latents / cfg.scaling_factor).to(self.compute_dtype)
        img = vae_mod.decode(self.ms.vae_params, cfg, z)
        return (img.float() * 0.5 + 0.5).clamp(0.0, 1.0)

    def _vae_decode_tiled(self, latents):
        """Decode in VAE_TILE-latent tiles every VAE_TILE - 2 *
        VAE_TILE_OVERLAP latents (the last tile flush with the edge), each
        tile weighted by a ramp that rises over its outer VAE_TILE_OVERLAP
        latents, and the weighted sum normalised; accumulated on the
        device."""
        t, ov, factor = self.VAE_TILE, self.VAE_TILE_OVERLAP, 8
        b, lh, lw, _ = latents.shape
        step = t - 2 * ov
        out = torch.zeros((b, lh * factor, lw * factor, 3),
                          dtype=torch.float32, device=latents.device)
        weight = torch.zeros((1, lh * factor, lw * factor, 1),
                             dtype=torch.float32, device=latents.device)
        ramp = np.minimum(np.arange(t * factor) + 1,
                          np.arange(t * factor)[::-1] + 1)
        ramp = np.minimum(ramp / (ov * factor), 1.0).astype(np.float32)
        feather = torch.from_numpy(
            (ramp[:, None] * ramp[None, :])[None, :, :, None]).to(
                latents.device)
        ys = sorted({min(y, lh - t) for y in range(0, max(lh - ov, 1), step)})
        xs = sorted({min(x, lw - t) for x in range(0, max(lw - ov, 1), step)})
        n = t * factor
        for y in ys:
            for x in xs:
                dec = self._vae_decode_whole(latents[:, y:y + t, x:x + t])
                oy, ox = y * factor, x * factor
                out[:, oy:oy + n, ox:ox + n] += dec * feather
                weight[:, oy:oy + n, ox:ox + n] += feather
        return out / torch.clamp(weight, min=1e-6)

    # ------------------------------------------------------------- denoise

    def _denoiser(self, ctx_u, ctx_g, guidance_scale, guided: bool,
                  tiling=(False, False), wrap_model=None, ms=None,
                  hints: _HintStack | None = None, added=(None, None),
                  cfg_parallel: bool = True, tome_ratio: float = 0.0):
        """denoise(x, sigma) -> x0 through ``ms``'s UNet (this engine's by
        default), conditioned by ``hints`` and by ``added`` (SDXL's
        (added_u, added_g), or Nones), its input built by ``wrap_model``
        (inpaint9, depth2img) and CFG-guided when ``guided``, both halves
        in one call unless not ``cfg_parallel``; its self-attentions merge
        ``tome_ratio`` of their tokens (ToMe)."""
        ms = ms or self.ms
        ucfg = ms.config.unet
        cdt = self.compute_dtype

        def raw_unet(x, t, context, **cond):
            return unet_mod.apply(ms.unet_params, ucfg, x.to(cdt), t,
                                  context.to(cdt), tiling=tiling,
                                  tome_ratio=tome_ratio, **cond).float()

        model_fn = raw_unet if hints is None else hints.wrap(raw_unet)
        if wrap_model:
            model_fn = wrap_model(model_fn)
        added_u, added_g = added
        extra_u = {} if added_u is None else {"added_cond": added_u}
        extra_g = {} if added_g is None else {"added_cond": added_g}
        if guided:
            model = denoiser.cfg_model(model_fn, ctx_u, ctx_g, guidance_scale,
                                       parallel=cfg_parallel,
                                       extra_uncond=extra_u,
                                       extra_cond=extra_g)
        else:
            model = denoiser.plain_model(model_fn, ctx_g, **extra_g)
        # this engine's sigma ramp; a grafted model's own prediction type
        return denoiser.make_denoiser(
            model, self.schedule,
            prediction_type=ms.schedule.prediction_type)

    def _clip_guide(self, dn, scale, cutouts, options, prompt, keys,
                    guided, ctx_u, ctx_g, gs_arg, tiling_xy, wrap_model,
                    hint_stack, added, tome_ratio):
        """The request's _ClipGuide over denoiser ``dn``: its config (the
        legacy ``cutouts`` count split between the two cutout families
        unless the options name one), the vision tower, the text target
        of the first prompt, the VAE decoder for VAE cutouts and, under
        "guided" CFG, the cond-only stem of the engine's UNet."""
        copts = dict(options or {})
        if not {"approx_cutouts", "vae_cutouts", "no_cutouts"} & set(copts):
            copts["approx_cutouts"] = int(cutouts) // 2
            copts["vae_cutouts"] = int(cutouts) - int(cutouts) // 2
        ccfg = cg.ClipGuidanceConfig(guidance_scale=float(scale), **copts)
        vision, vcfg = self.clip_vision()
        first = prompt[0] if isinstance(prompt, (list, tuple)) else prompt
        target = self.clip_text_target(first or "", len(keys))
        vae_decode = None
        if ccfg.vae_cutouts or ccfg.no_cutouts == "vae":
            ms, cdt = self.ms, self.compute_dtype

            def vae_decode(z):
                return vae_mod.decode(ms.vae_params, ms.config.vae,
                                      z.to(cdt)).float()
        stem = None
        if guided and ccfg.guidance_base == "guided":
            stem = self._denoiser(ctx_u, ctx_g, gs_arg, False, tiling_xy,
                                  wrap_model, hints=hint_stack, added=added,
                                  tome_ratio=tome_ratio)
        return _ClipGuide(ccfg, dn, vision, vcfg, target, keys, stem,
                          vae_decode)

    @torch.no_grad()
    def _initial(self, seeds, lh: int, lw: int, sigma_max: float):
        shape = (lh, lw, self.ms.config.unet.out_channels)
        return modes.txt2img_initial(seeds, shape, sigma_max, self.device,
                                     natural=self.ms.config.sample_size)

    @torch.no_grad()
    def _run_steps(self, sampler, dn, x, sigmas, noise_fn, params, start,
                   steps, carry):
        return samplers.sample(sampler, dn, x, sigmas, noise_fn, params,
                               start=start, steps=steps, carry=carry,
                               return_carry=True, first=start == 0)

    @torch.no_grad()
    def _to_uint8(self, images):
        return (images * 255.0 + 0.5).clamp(0, 255).to(torch.uint8)

    def _image(self, a):
        """A request's image (numpy or tensor, [B,H,W,C]) as f32 on the
        pipeline's device."""
        if not torch.is_tensor(a):
            a = torch.from_numpy(np.array(a, dtype=np.float32))
        return a.to(self.device, torch.float32)

    @torch.no_grad()
    def _mode_inputs(self, mode, keys, batch, height, width, strength,
                     init, mask_image, depth_map, masked_area_init):
        """(init_latents, mask_keep, extra channels) of a request, f32 on
        the device; ``init`` is its init image on the device, or None."""
        factor = 8
        lh, lw = height // factor, width // factor
        init_latents = torch.zeros((batch, lh, lw, 4), device=self.device)
        mask_keep = torch.ones((batch, lh, lw, 1), device=self.device)
        extra = None
        if init is not None:
            init_latents = self.vae_encode(init, keys)
        if mask_image is not None:
            # latent-resolution mask by an 8x8 box downscale; 1 keeps
            m = self._image(mask_image).reshape(batch, lh, factor, lw,
                                                factor, -1).mean(dim=(2, 4))
            mask_keep = 1.0 - m[..., :1]
            hard_keep = (mask_keep > 0.5).float()
            if mode == "inpaint":
                if strength >= 1.0 and masked_area_init == "shaped":
                    init_latents = modes.shaped_noise_fill(
                        init_latents, hard_keep, keys)
                elif masked_area_init in ("zero", "random"):
                    init_latents = modes.masked_area_fill(
                        init_latents, hard_keep, keys, masked_area_init)
            else:
                # inpaint9: the masked image's latents are extra channels,
                # encoded with the init image's "vae" noise; the canvas
                # starts from the encoded init image plus full noise
                masked = init * resize(hard_keep, (height, width), "nearest")
                extra = self.vae_encode(masked, keys)
                mask_keep = hard_keep
        if mode == "depth2img":
            # the 5th channel: a latent-size depth map in [-1, 1]
            if depth_map is None and init is not None:
                depth_map = I.normalise(I.gaussian_blur(
                    I.to_grayscale(init), 2.0))
            if depth_map is None:
                raise ValueError("depth2img engine needs a depth_map or "
                                 "init image")
            d = resize(self._image(depth_map)[..., :1], (lh, lw), "bilinear")
            dmin = d.amin(dim=(1, 2, 3), keepdim=True)
            dmax = d.amax(dim=(1, 2, 3), keepdim=True)
            extra = 2.0 * (d - dmin) / torch.clamp(dmax - dmin, min=1e-6) \
                - 1.0
        return init_latents, mask_keep, extra

    @torch.no_grad()
    def _composite(self, images, init, mask_keep, height, width):
        """The image-space outmask: generated pixels histogram-matched to
        the init image (unless it is near constant), and every pixel the
        upsampled mask keeps fully taken from the init image."""
        mk = resize(mask_keep, (height, width), "bilinear")
        hard = (mk >= 1.0).float()
        gen = images
        if float(init.std(unbiased=False)) > 0.02:
            gen = I.match_histograms(images, init)
        return init * hard + gen * (1 - hard)

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
                  init_image=None,          # [B,H,W,3] in [0,1]
                  mask_image=None,          # [B,H,W,1], 1 = regenerate
                  strength: float = 0.8,
                  eta: float | None = None,
                  churn: float = 0.0,
                  churn_tmin: float = 0.0,
                  churn_tmax: float = 0.0,
                  warmup_lms: bool = False,
                  ddim_cutoff: float = 0.0,
                  karras_rho: float | None = None,
                  sigma_min: float | None = None,
                  sigma_max: float | None = None,
                  masked_area_init: str = "shaped",
                  tiling: bool | str = False,
                  depth_map=None,           # [B,H,W,1], depth2img UNets
                  hires_fix: bool | None = None,
                  hires_oos_fraction: float = 0.25,
                  hints=None,
                  clip_guidance_scale: float = 0.0,
                  clip_cutouts: int = 4,
                  clip_guidance_options: dict | None = None,
                  cfg_sequential: bool = False,
                  tome_ratio: float = 0.0,
                  clip_layer: int = 0,
                  noise_type: str = "normal",
                  progress_callback=None,
                  stop_event=None,
                  chunk_steps: int = 0,
                  return_latents: bool = False,
                  output_dtype: str | None = None):
        ms = self.ms
        ucfg = ms.config.unet
        factor = 8
        if height % factor or width % factor:
            raise ValueError(f"height and width must be multiples of "
                             f"{factor}, got {height}x{width}")
        lh, lw = height // factor, width // factor
        keys = list(seeds)
        batch = len(keys)

        mode = "txt2img"
        if init_image is not None:
            mode = "img2img"
        if mask_image is not None:
            mode = "inpaint9" if ucfg.in_channels == 9 else "inpaint"
        elif ucfg.in_channels == 5:
            mode = "depth2img"
        if ucfg.in_channels == 9 and mode != "inpaint9":
            raise ValueError("a 9-channel inpainting UNet needs an init "
                             "image and a mask")
        if mode == "inpaint9" and init_image is None:
            raise ValueError("inpainting on a 9-channel UNet needs an init "
                             "image")

        full_strength = mode == "txt2img" or init_image is None or (
            mask_image is not None and strength >= 1.0)
        sigmas = sched.build_sigmas(
            self.schedule, steps,
            strength=1.0 if full_strength else min(strength, 1.0),
            karras_rho=karras_rho, sigma_min=sigma_min, sigma_max=sigma_max,
            uniform_lambda=(sampler == "dpm_fast"),
            spacing=("leading"
                     if sampler in samplers.DIFFUSERS_GRID_SAMPLERS
                     else "linspace"))
        n_steps = len(sigmas) - 1
        # the last sigma before 0, the end of the blend's progress
        sigma_last = max(float(sigmas[-2]), 1e-3)
        # default eta: 1 for the ancestral, SDE and ddpm samplers, else 0
        if eta is None:
            eta = 1.0 if ("ancestral" in sampler or "sde" in sampler
                          or sampler == "ddpm") else 0.0
        params = samplers.SamplerParams(
            eta=float(eta), churn=float(churn),
            churn_tmin=float(churn_tmin), churn_tmax=float(churn_tmax),
            warmup_lms=bool(warmup_lms), ddim_cutoff=float(ddim_cutoff))

        gs = torch.as_tensor(guidance_scale, dtype=torch.float32).reshape(-1)
        guided = bool((gs > 1.0).any())
        if gs.numel() > 1:
            gs_arg = gs.expand(batch).to(self.device)
        else:
            gs_arg = float(gs[0])

        ctx_u, ctx_g = self._contexts(prompt, negative_prompt, batch, guided,
                                      clip_layer)
        # style hints extend the contexts; the others condition the UNet
        style = [h for h in hints or [] if h.get("kind") == "style"]
        hints = [h for h in hints or [] if h.get("kind") != "style"]
        if style:
            ctx_u, ctx_g = self._style_contexts(style, batch, ctx_u, ctx_g)
        added = self._added_cond(prompt, negative_prompt, batch, guided,
                                 height, width)
        init = None if init_image is None else self._image(init_image)
        init_latents, mask_keep, extra = self._mode_inputs(
            mode, keys, batch, height, width, strength, init, mask_image,
            depth_map, masked_area_init)
        tiling_xy = _tiling_axes(tiling)
        hint_stack = (_HintStack(hints, batch, guided, ucfg,
                                 self.compute_dtype, self.device, lh, lw)
                      if hints else None)
        # cfg_only hints need both CFG halves in one call
        if hint_stack is not None and any(h["cfg_only"]
                                          for h in hint_stack.hints):
            cfg_sequential = False
        if mode != "txt2img":
            log_latents("init", init_latents)

        wrap_model = None
        if mode == "inpaint9":
            wrap_model = modes.make_inpaint9_inputs(mask_keep, extra)
        elif mode == "depth2img":
            wrap_model = modes.make_extra_channels_wrapper(extra)
        dn_base = self._denoiser(ctx_u, ctx_g, gs_arg, guided, tiling_xy,
                                 wrap_model, hints=hint_stack, added=added,
                                 cfg_parallel=not cfg_sequential,
                                 tome_ratio=float(tome_ratio))
        if self._graft_pipe is not None:
            # the top model under its own prediction type, without SDXL's
            # added conditioning (as in the JAX package)
            gms = self._graft_pipe.ms
            gctx_u, gctx_g = self._graft_contexts(
                prompt, negative_prompt, batch, guided)
            dn_top = self._denoiser(gctx_u, gctx_g, gs_arg, guided,
                                    tiling_xy, ms=gms,
                                    cfg_parallel=not cfg_sequential)
            dn_base = modes.make_graft(keys)(
                dn_base, dn_top, modes.log_progress(float(sigmas[0]),
                                                    sigma_last))
        guide = None
        if clip_guidance_scale > 0:
            guide = self._clip_guide(
                dn_base, clip_guidance_scale, clip_cutouts,
                clip_guidance_options, prompt, keys, guided, ctx_u, ctx_g,
                gs_arg, tiling_xy, wrap_model, hint_stack, added,
                float(tome_ratio))
            dn_base = guide.denoise
        dn, final_blend = dn_base, None
        if mode == "inpaint":
            wrap, final_blend = modes.make_inpaint_blend(
                init_latents, mask_keep, float(sigmas[0]), sigma_last)
            dn = wrap(dn_base)

        # hires fix: past the model's native size, a native-size pass
        # cross-injected into the target size (not with inpaint9)
        hires = None
        natural = ms.config.sample_size
        if hires_fix and max(lh, lw) > natural and mode != "inpaint9":
            mult = 2 ** (ucfg.levels - 1)        # the UNet's size divisor
            area = float(natural * natural) * (1.0 + hires_oos_fraction)
            nh = int(round((area * lh / lw) ** 0.5 / mult)) * mult
            nw = int(round(area / max(nh, 1) / mult)) * mult
            nh, nw = min(max(nh, mult), lh), min(max(nw, mult), lw)
            if (nh, nw) != (lh, lw):
                hires = (nh, nw)

        shape = (lh, lw, ucfg.out_channels)
        unpack = None
        if hires is not None:
            nh, nw = hires
            hwrap, pack, unpack = modes.make_hires_fix(keys, nh, nw, lh, lw)
            # the per-step inpaint blend applies at the target size only
            dn = hwrap(dn_base, dn, modes.log_progress(float(sigmas[0]),
                                                       sigma_last))
            with torch.no_grad():
                if mode == "txt2img":
                    hi = modes.txt2img_initial(keys, shape, float(sigmas[0]),
                                               self.device)
                    lo = modes.txt2img_initial(
                        rng.substream(keys, "hires_lo"), (nh, nw, shape[-1]),
                        float(sigmas[0]), self.device)
                else:
                    hi = modes.img2img_initial(init_latents, keys,
                                               float(sigmas[0]))
                    lo = modes.img2img_initial(
                        resize(init_latents, (nh, nw), "bicubic"), keys,
                        float(sigmas[0]))
                x = pack(lo, hi)
            noise_keys = rng.substream(keys, "lo") + keys
        else:
            if mode == "txt2img":
                x = self._initial(keys, lh, lw, float(sigmas[0]))
            else:
                with torch.no_grad():
                    x = modes.img2img_initial(init_latents, keys,
                                              float(sigmas[0]))
            noise_keys = keys
        carry = samplers.init_carry(sampler, x)
        noise_fn = make_noise_fn(noise_keys, sigmas, shape, noise_type,
                                 self.device)

        adaptive = sampler == "dpm_adaptive"
        chunked = bool(chunk_steps) and chunk_steps < n_steps and (
            hires is None) and (progress_callback is not None or
                                stop_event is not None) and not (
            adaptive and guide is not None)
        seg_len = chunk_steps if chunked else n_steps
        loop_total = n_steps
        if adaptive:
            # segments bound solver iterations; the loop ends when the
            # carried `finished` flag is set
            seg_len = seg_len if chunked else samplers.ADAPTIVE_MAX_STEPS
            loop_total = -(-samplers.ADAPTIVE_MAX_STEPS // seg_len) * seg_len
        done = 0
        while done < loop_total:
            seg = min(seg_len, loop_total - done)
            x, carry = self._run_steps(sampler, dn, x, sigmas, noise_fn,
                                       params, done, seg, carry)
            done += seg
            if adaptive and carry[-1]:
                done = loop_total               # the solver reached the end
            if chunked and guide is not None and done < n_steps:
                guide.chunk_loss(x, float(sigmas[done]), chunk_steps)
            if progress_callback is not None:
                progress_callback(done, loop_total)
            if chunked:
                log_latents(f"chunk:{done}", x)
                if stop_event is not None and stop_event.is_set():
                    return None
                yield done, loop_total

        if unpack is not None:
            x = unpack(x)[1]
        if final_blend is not None:
            with torch.no_grad():
                x = final_blend(x)
        log_latents("final", x)
        if return_latents:
            return x
        images = self.vae_decode(x)
        if mask_image is not None and init is not None:
            images = self._composite(images, init, mask_keep, height, width)
        if output_dtype == "uint8":
            images = self._to_uint8(images)
        return images
