"""Safety checker: a CLIP-based concept scorer (the published
StableDiffusionSafetyChecker's scoring; its diffusers weights load
directly).

Counterpart of gyre_tpu/pipeline/safety.py. An image is flagged when the
cosine of its CLIP image embedding with any concept embedding exceeds that
concept's threshold; when any "special care" concept fires, every
threshold is tightened by 0.01. The vision tower runs in the weights'
dtype (K1 on the card); the pooled output, the projection, the norms, the
cosines and the thresholds are f32, so bf16 rounding stays inside the
tower, and each image is scored on its own.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..models import clip as clip_mod
from ..ops.resize import resize


def _unit(x):
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=1e-8)


@dataclass
class SafetyChecker:
    vision_params: dict
    vision_cfg: clip_mod.CLIPVisionConfig
    concept_embeds: torch.Tensor            # [n_concepts, proj] f32
    concept_thresholds: torch.Tensor        # [n_concepts] f32
    special_embeds: torch.Tensor | None = None
    special_thresholds: torch.Tensor | None = None
    trained: bool = False                   # True only for loaded weights

    @classmethod
    def random(cls, seed: int = 0, cfg=None, n_concepts: int = 17,
               dtype=torch.float32, device="cuda") -> "SafetyChecker":
        """A random-weight checker (CLIP_VISION_TEST by default): keeps the
        scoring path runnable without weights, and is never used to flag
        or block (``trained`` is False; its flags would be noise)."""
        cfg = cfg or clip_mod.CLIP_VISION_TEST
        params = clip_mod.random_vision(cfg, seed, dtype, device)
        gen = torch.Generator(device="cpu").manual_seed(int(seed) + 1)
        concepts = _unit(torch.randn((n_concepts, cfg.projection_dim),
                                     generator=gen))
        return cls(params, cfg, concepts.to(device),
                   torch.full((n_concepts,), 0.95, device=device))

    @classmethod
    def from_state_dict(cls, state: dict, dtype=torch.bfloat16,
                        device="cuda") -> "SafetyChecker":
        """diffusers StableDiffusionSafetyChecker weights: the CLIP vision
        tower (strict, models/load.py), visual_projection, the concept and
        special-care embeddings and their thresholds."""
        from ..models.load import load_clip_vision_params

        names = ("concept_embeds", "concept_embeds_weights",
                 "special_care_embeds", "special_care_embeds_weights")
        if "concept_embeds" not in state or \
                "concept_embeds_weights" not in state:
            raise KeyError("state dict lacks concept_embeds / "
                           "concept_embeds_weights: not a safety checker")
        params, cfg = load_clip_vision_params(
            {k: v for k, v in state.items() if k not in names}, dtype,
            device)

        def arr(name):
            return torch.as_tensor(state[name]).float().to(device) \
                if name in state else None

        return cls(params, cfg, arr("concept_embeds"),
                   arr("concept_embeds_weights"),
                   special_embeds=arr("special_care_embeds"),
                   special_thresholds=arr("special_care_embeds_weights"),
                   trained=True)

    @classmethod
    def load(cls, path: str, dtype=torch.bfloat16,
             device="cuda") -> "SafetyChecker":
        from ..models.load import read_state_dict

        return cls.from_state_dict(read_state_dict(path), dtype, device)

    def state_dict(self) -> dict[str, torch.Tensor]:
        """The checker in diffusers' layout (f32 CPU tensors): what
        from_state_dict reads."""
        from ..models.load import export_clip_vision_state

        out = export_clip_vision_state(self.vision_params, self.vision_cfg,
                                       "safety")
        for name, t in (("concept_embeds", self.concept_embeds),
                        ("concept_embeds_weights", self.concept_thresholds),
                        ("special_care_embeds", self.special_embeds),
                        ("special_care_embeds_weights",
                         self.special_thresholds)):
            if t is not None:
                out[name] = t.detach().float().cpu().contiguous()
        return out

    @torch.no_grad()
    def embed(self, images):
        """images [B,H,W,3] in [0,1] -> unit CLIP image embeddings [B, proj]
        f32: resized to the tower's size (jax.image.resize's antialiased
        bilinear), preprocessed, through the tower."""
        dev = self.concept_embeds.device
        imgs = torch.as_tensor(images).to(dev, torch.float32)
        size = self.vision_cfg.image_size
        imgs = resize(imgs, (size, size), "bilinear")
        out = clip_mod.vision_apply(self.vision_params, self.vision_cfg,
                                    clip_mod.preprocess_image(imgs))
        return _unit(out["image_embeds"])

    @torch.no_grad()
    def scores(self, images):
        """[B, n_concepts] f32: each concept's cosine minus its threshold,
        plus 0.01 for an image where any special-care concept fires."""
        emb = self.embed(images)
        adjustment = torch.zeros((emb.shape[0], 1), device=emb.device)
        if self.special_embeds is not None and \
                self.special_thresholds is not None:
            special = emb @ _unit(self.special_embeds).T - \
                self.special_thresholds[None]
            adjustment = (special > 0).any(dim=-1, keepdim=True).float() * \
                0.01
        return emb @ _unit(self.concept_embeds).T - \
            self.concept_thresholds[None] + adjustment

    def check(self, images) -> np.ndarray:
        """images [B,H,W,3] float in [0,1] -> bool[B] flags."""
        return (self.scores(images) > 0).any(dim=-1).cpu().numpy()
