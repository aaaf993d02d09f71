"""Tagged latent dumps.

Counterpart of gyre_tpu/utils/latent_debug.py. With
``SD_DEBUG_LATENTS="init,chunk,final"`` (or "all") the pipeline logs its
latents at those stages (``chunk:<steps done>`` after each chunk) as
VisualRecords: the log ring keeps the record and ``/log/<key>`` serves its
image, the linear latent -> RGB preview (no VAE decode). Unset, a dump
costs one environment lookup.
"""

from __future__ import annotations

import logging
import os

logger = logging.getLogger("gyre_tpu_torch.latents")


def enabled_tags() -> set[str]:
    raw = os.environ.get("SD_DEBUG_LATENTS", "")
    return {t.strip() for t in raw.split(",") if t.strip()}


def log_latents(tag: str, latents):
    """Scaled latents [B,h,w,4] -> one VisualRecord, when ``tag`` (its
    part before a colon, or "all") is enabled."""
    tags = enabled_tags()
    if not tags or ("all" not in tags and tag.split(":")[0] not in tags and
                    tag not in tags):
        return
    try:
        from ..pipeline.clip_guidance import approx_decode
        from .logview import VisualRecord

        rgb = approx_decode(latents).cpu().numpy()
        logger.info(VisualRecord(f"latents:{tag}", *list(rgb)))
    except Exception as e:  # noqa: BLE001 - a debug aid never fails a request
        logger.debug("latent dump %s failed: %s", tag, e)
