"""T2I-Adapter on torch tensors: a conditioning pyramid whose features are
added to the UNet's down path, one map per level.

Counterpart of gyre_tpu/models/t2i_adapter.py (full and light channel
ladders; the same params tree, a level's ``proj`` present only where the
channels change, conv weights OIHW). It is x- and t-independent, so it runs
once a request, outside the step loop; it is plain convs, ReLU and 2x2
means, no kernel of the port, as in the JAX package. The style adapter
needs the CLIP vision tower, which is not ported yet (ROADMAP C6): its
functions raise.
"""

from __future__ import annotations

import torch

from . import layers as L

Params = dict

FULL_CHANNELS = (320, 640, 1280, 1280)
LIGHT_CHANNELS = (320, 640, 1280, 1280)


def param_specs(channels=FULL_CHANNELS, cond_channels: int = 3,
                n_res_blocks: int = 2, downscale: int = 8,
                bias: bool = True) -> Params:
    def conv(k, ci, co):
        p = L.conv_spec(k, k, ci, co)
        if not bias:
            del p["b"]
        return p

    p: Params = {"conv_in": conv(3, cond_channels * downscale * downscale,
                                 channels[0]),
                 "levels": []}
    c_prev = channels[0]
    for c in channels:
        level: Params = {"blocks": [{"conv1": conv(3, c, c),
                                     "conv2": conv(3, c, c)}
                                    for _ in range(n_res_blocks)]}
        if c != c_prev:
            level["proj"] = conv(1, c_prev, c)
        p["levels"].append(level)
        c_prev = c
    return p


def random_t2i_adapter(channels=FULL_CHANNELS, seed: int = 0,
                       dtype=torch.bfloat16, device="cuda",
                       cond_channels: int = 3, n_res_blocks: int = 2,
                       downscale: int = 8) -> Params:
    """Random weights as models/modelset.py makes them."""
    from .modelset import random_tree

    p = random_tree(param_specs(channels, cond_channels, n_res_blocks,
                                downscale), seed, dtype, device)
    p["downscale"] = downscale
    return p


# ---------------------------------------------------------- checkpoints


def _key_map(n_res: int):
    """Params path -> TencentARC full-adapter key: ``conv_in``,
    ``body.{k}.block1/block2`` and ``body.{k}.in_conv`` on a level's first
    block, k flattening (level, block) with ``n_res`` blocks a level."""
    def keys(path) -> tuple[str, ...]:
        *mod, leaf = path
        leaf = "weight" if leaf == "w" else "bias"
        if mod[0] == "conv_in":
            return (f"conv_in.{leaf}",)
        if mod[2] == "proj":
            return (f"body.{mod[1] * n_res}.in_conv.{leaf}",)
        k = mod[1] * n_res + mod[3]
        return (f"body.{k}.block{mod[4][-1]}.{leaf}",)

    return keys


def _specs_of_state(state: dict):
    """(spec tree, blocks a level) of a checkpoint, as the JAX loader
    reads it: 2 blocks a level, downscale 8."""
    n_body = 0
    while f"body.{n_body}.block1.weight" in state:
        n_body += 1
    n_res = 2
    channels = tuple(int(state[f"body.{lvl * n_res}.block1.weight"].shape[0])
                     for lvl in range(n_body // n_res))
    ds = 8
    return param_specs(
        channels, int(state["conv_in.weight"].shape[1]) // (ds * ds), n_res,
        ds, bias="conv_in.bias" in state), n_res


def load_params(state: dict, dtype=torch.bfloat16, device="cuda") -> Params:
    """TencentARC full-adapter checkpoint (``t2iadapter_*``) -> params,
    through models/modelset.py's strict converter."""
    from .load import load_tree

    specs, n_res = _specs_of_state(state)
    p = load_tree(specs, state, _key_map(n_res), "t2i_adapter", dtype,
                  device)
    p["downscale"] = 8
    return p


def export_state(params: Params) -> dict:
    """Inverse of load_params: {key: f32 CPU tensor}."""
    from .load import export_tree

    levels = params["levels"]
    specs = param_specs(
        tuple(lvl["blocks"][0]["conv1"]["w"].shape[0] for lvl in levels),
        params["conv_in"]["w"].shape[1] // (params["downscale"] ** 2),
        len(levels[0]["blocks"]), params["downscale"],
        bias="b" in params["conv_in"])
    return export_tree(params, specs, _key_map(len(levels[0]["blocks"])))


# ------------------------------------------------------------------ apply


def _resblock(p, x):
    h = L.conv2d(p["conv1"], torch.relu(x))
    h = L.conv2d(p["conv2"], torch.relu(h))
    return x + h


def _pixel_unshuffle(x, factor):
    b, h, w, c = x.shape
    x = x.reshape(b, h // factor, factor, w // factor, factor, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(
        b, h // factor, w // factor, factor * factor * c)


def apply(params: Params, cond_image) -> list:
    """cond image [B,H,W,C] -> one feature map a UNet down level (latent
    resolution, then halved a level)."""
    h = _pixel_unshuffle(cond_image, params["downscale"])
    h = L.conv2d(params["conv_in"], h)
    feats = []
    for lvl, level in enumerate(params["levels"]):
        if lvl > 0:
            h = L.avg_pool_2x(h)
        if "proj" in level:
            h = L.conv2d(level["proj"], h)
        for blk in level["blocks"]:
            h = _resblock(blk, h)
        feats.append(h)
    return feats


def coadapter_fuse(feature_sets: list, weights: list | None = None) -> list:
    """CoAdapter fuser: several adapters' per-level features summed with
    scalar weights."""
    weights = weights or [1.0] * len(feature_sets)
    out = None
    for feats, w in zip(feature_sets, weights):
        scaled = [f * w for f in feats]
        out = scaled if out is None else [a + b for a, b in zip(out, scaled)]
    return out


# ------------------------------------------------------------ style adapter


def _style_unported(*_, **__):
    raise NotImplementedError(
        "the style adapter needs the CLIP vision tower, not ported to "
        "gyre_tpu_torch yet (ROADMAP C6)")


style_init = style_apply = load_style_params = _style_unported
