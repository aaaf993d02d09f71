"""CLIP guidance: for now only the linear latent -> RGB preview.

Counterpart of gyre_tpu/pipeline/clip_guidance.py:40-70. The guidance
itself (the CLIP loss's gradient through the denoiser) is ROADMAP C7.
"""

from __future__ import annotations

import torch

# The community-standard linear latent -> RGB approximation (SD's 4
# latent channels onto R, G, B).
LATENT_RGB = ((0.298, 0.207, 0.208),
              (0.187, 0.286, 0.173),
              (-0.158, 0.189, 0.264),
              (-0.184, -0.271, -0.473))


def approx_decode(latents):
    """Scaled latents [B,h,w,4] -> approximate RGB [B,h,w,3] in [0,1],
    f32."""
    m = torch.tensor(LATENT_RGB, dtype=torch.float32, device=latents.device)
    rgb = torch.einsum("bhwc,cd->bhwd", latents.float(), m)
    return (rgb * 0.5 + 0.5).clamp(0.0, 1.0)
