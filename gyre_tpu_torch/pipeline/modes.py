"""Generation modes as latent-state functions.

Counterpart of gyre_tpu/pipeline/modes.py; the slice ports txt2img's
initial latents. img2img, inpaint, hires fix and grafting are not ported
yet.
"""

from __future__ import annotations

import torch

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
