"""Model mixing: weighted merges over parameter trees.

Counterpart of gyre_tpu/manager/mixing.py (reference gyre/manager.py:
1296-1443: weighted_sum / sigmoid / inv_sigmoid / difference merges over
state dicts, incl. the inpaint-unet conv_in channel-mismatch special case),
as plain torch ops on the trees' device, in f32.

Params trees merge leaf by leaf; unmatched leaves keep the base model's
weights; a 9-channel inpaint conv_in mixes only the first 4 input channels
(the noise-latent slice) like the reference. The port's convs are OIHW, so
that slice is dimension 1 (the JAX package's HWIO has it at 2).
"""

from __future__ import annotations

import logging
import math

import torch

logger = logging.getLogger(__name__)


def _sigmoid_weight(alpha: float) -> float:
    # reference sigmoid merge: smooth remapping of the mix factor
    return 1.0 / (1.0 + math.exp(-8.0 * (alpha - 0.5)))


def _inv_sigmoid_weight(alpha: float) -> float:
    alpha = min(max(alpha, 1e-6), 1 - 1e-6)
    return 0.5 + math.log(alpha / (1.0 - alpha)) / 8.0


def _in_channel_mismatch(a, b) -> bool:
    """Two OIHW conv weights that differ only in input channels."""
    return (a.ndim == 4 and b.ndim == 4 and a.shape[0] == b.shape[0] and
            a.shape[2:] == b.shape[2:] and a.shape[1] != b.shape[1])


def _mix_leaves(a, b, alpha: float):
    """Mix leaf b into a with weight alpha."""
    if a.shape == b.shape:
        return (a.float() * (1 - alpha) + b.float() * alpha).to(a.dtype)
    if _in_channel_mismatch(a, b):
        n = min(a.shape[1], b.shape[1])
        mixed = (a[:, :n].float() * (1 - alpha) +
                 b[:, :n].float() * alpha).to(a.dtype)
        return torch.cat([mixed, a[:, n:]], dim=1) if a.shape[1] > n \
            else mixed
    logger.warning("mix: shape mismatch %s vs %s; keeping base",
                   tuple(a.shape), tuple(b.shape))
    return a


def mix_trees(base, other, alpha: float, algorithm: str = "weighted_sum"):
    """-> new tree = merge(base, other)."""
    if algorithm == "sigmoid":
        alpha = _sigmoid_weight(alpha)
    elif algorithm == "inv_sigmoid":
        alpha = _inv_sigmoid_weight(alpha)
    elif algorithm not in ("weighted_sum", "difference", "add_difference"):
        raise ValueError(f"unknown mix algorithm {algorithm!r}")

    def walk(a, b):
        if isinstance(a, dict):
            return {k: walk(a[k], b[k]) if isinstance(b, dict) and k in b
                    else a[k] for k in a}
        if isinstance(a, list):
            return [walk(x, y) for x, y in zip(a, b)] if \
                isinstance(b, list) and len(a) == len(b) else a
        return _mix_leaves(a, b, alpha)

    return walk(base, other)


def add_difference(base, a, b, alpha: float = 1.0):
    """base + alpha*(a - b): the reference's difference merge used to
    synthesize inpaint variants of finetunes
    (config/templates/stable-diffusion-v1.yaml:30-70 semantics)."""

    def walk(x, y, z):
        if isinstance(x, dict):
            return {k: walk(x[k], y[k], z[k]) if isinstance(y, dict) and
                    k in y and k in z else x[k] for k in x}
        if isinstance(x, list):
            if isinstance(y, list) and len(x) == len(y) == len(z):
                return [walk(i, j, k) for i, j, k in zip(x, y, z)]
            return x
        if x.shape == y.shape == z.shape:
            return (x.float() + alpha * (y.float() - z.float())).to(x.dtype)
        if x.ndim == 4 and y.ndim == 4 and x.shape[1] != y.shape[1]:
            n = min(x.shape[1], y.shape[1], z.shape[1])
            mixed = (x[:, :n].float() + alpha * (
                y[:, :n].float() - z[:, :n].float())).to(x.dtype)
            return torch.cat([mixed, x[:, n:]], dim=1) if x.shape[1] > n \
                else mixed
        return x

    return walk(base, a, b)


def mix_modelsets(modelsets_with_weights: list[tuple], algorithm: str,
                  engine_id: str = "mixed"):
    """[(ModelSet, weight)] -> mixed ModelSet. Weights are normalized;
    trees merge pairwise left-to-right (the reference mixes ModelSets with
    unet/text_encoder fuzzy keys — here the whole tree merges); the VAE,
    tokenizer and schedule are the first model's. Leaves mix in f32 and
    are rounded to the base model's dtype."""
    from ..models import unet as unet_mod
    from ..models.modelset import ModelSet, round_f32_leaves

    if not modelsets_with_weights:
        raise ValueError("mix needs at least one model")
    total = sum(w for _, w in modelsets_with_weights)
    base_ms, base_w = modelsets_with_weights[0]
    unet = base_ms.unet_params
    texts = list(base_ms.text_params)
    acc_w = base_w / total
    for ms, w in modelsets_with_weights[1:]:
        frac = (w / total) / max(acc_w + w / total, 1e-8)
        unet = mix_trees(unet, ms.unet_params, frac, algorithm)
        texts = [mix_trees(t, o, frac, algorithm)
                 for t, o in zip(texts, ms.text_params)]
        acc_w += w / total
    # the fused convs' f32 leaves hold the model dtype's values
    unet = round_f32_leaves(unet, unet_mod.param_specs(base_ms.config.unet),
                            base_ms.unet_params["conv_in"]["w"].dtype)
    return ModelSet(config=base_ms.config, unet_params=unet,
                    vae_params=base_ms.vae_params, text_params=texts,
                    tokenizer=base_ms.tokenizer, schedule=base_ms.schedule,
                    device=base_ms.device, id=engine_id)
