"""T2I-Adapter on torch tensors: a conditioning pyramid whose features are
added to the UNet's down path, one map per level.

Counterpart of gyre_tpu/models/t2i_adapter.py (full and light channel
ladders; the same params tree, a level's ``proj`` present only where the
channels change, conv weights OIHW). It is x- and t-independent, so it runs
once a request, outside the step loop; it is plain convs, ReLU and 2x2
means, no kernel of the port, as in the JAX package.

The style adapter (TencentARC's StyleAdapter) is a transformer over the
CLIP vision tower's tokens and its own learned style tokens; its attention
runs K1 on the card ([B, 257 + 8, 8, 128] at its published widths) and it
returns the style tokens projected to the UNet's context width, which the
pipeline appends to the conditional context.
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


def style_specs(context_dim: int = 768, vision_dim: int = 1024,
                n_tokens: int = 8, n_layers: int = 3) -> Params:
    """The style adapter's spec tree, the published checkpoint's widths by
    default: learned style tokens, a width-space transformer (fused qkv,
    QuickGELU MLP), ln_pre / ln_post and a raw [width, context] projection
    (used as ``tokens @ proj``, as the JAX package and the checkpoint hold
    it)."""
    w = vision_dim
    std = w ** -0.5
    return {
        "style_embedding": L.Spec("normal", (1, n_tokens, w), std),
        "ln_pre": L.norm_spec(w),
        "ln_post": L.norm_spec(w),
        "proj": L.Spec("normal", (w, context_dim), std),
        "blocks": [{"ln1": L.norm_spec(w),
                    "qkv": L.linear_spec(w, 3 * w),
                    "out": L.linear_spec(w, w),
                    "ln2": L.norm_spec(w),
                    "fc1": L.linear_spec(w, 4 * w),
                    "fc2": L.linear_spec(4 * w, w)}
                   for _ in range(n_layers)],
    }


def style_dims(tree, *, state: bool = False) -> dict:
    """style_specs' arguments of a params tree or a checkpoint."""
    n = len(tree["blocks"]) if not state else 0
    while state and f"transformer_layes.{n}.ln_1.weight" in tree:
        n += 1
    emb, proj = tree["style_embedding"], tree["proj"]
    return dict(context_dim=int(proj.shape[1]), vision_dim=int(emb.shape[2]),
                n_tokens=int(emb.shape[1]), n_layers=n)


def random_style(seed: int = 0, dtype=torch.bfloat16, device="cuda",
                 **dims) -> Params:
    """Random style-adapter weights (style_specs' widths by ``dims``) as
    models/modelset.py makes them."""
    from .modelset import random_tree

    return random_tree(style_specs(**dims), seed, dtype, device)


def style_apply(params: Params, vision_tokens, heads: int = 8):
    """vision_tokens [B, N, width] -> style tokens [B, n_tokens, context],
    in the adapter's dtype."""
    emb = params["style_embedding"]
    b, n_tok = vision_tokens.shape[0], emb.shape[1]
    x = torch.cat([vision_tokens.to(emb.dtype),
                   emb.expand(b, -1, -1)], dim=1)
    x = L.layer_norm(params["ln_pre"], x)
    d = x.shape[-1]
    hd = d // heads
    for blk in params["blocks"]:
        h = L.layer_norm(blk["ln1"], x)
        q, k, v = (t.reshape(b, -1, heads, hd)
                   for t in L.linear(blk["qkv"], h).chunk(3, dim=-1))
        o = L.attention(q, k, v).reshape(b, -1, d)
        x = x + L.linear(blk["out"], o)
        h = L.layer_norm(blk["ln2"], x)
        x = x + L.linear(blk["fc2"], L.quick_gelu(L.linear(blk["fc1"], h)))
    style = L.layer_norm(params["ln_post"], x[:, -n_tok:])
    return style @ params["proj"].to(style.dtype)


def _style_keys(path) -> tuple[str, ...]:
    """A style-adapter leaf's key in TencentARC's checkpoint
    (``transformer_layes`` as the published file spells it)."""
    if path[0] in ("style_embedding", "proj"):
        return (path[0],)
    *mod, leaf = path
    if mod[0] in ("ln_pre", "ln_post"):
        return (f"{mod[0]}.{'weight' if leaf == 'scale' else 'bias'}",)
    pre = f"transformer_layes.{mod[1]}"
    if mod[2] == "qkv":
        return (f"{pre}.attn.in_proj_{'weight' if leaf == 'w' else 'bias'}",)
    name = {"ln1": "ln_1", "ln2": "ln_2", "out": "attn.out_proj",
            "fc1": "mlp.c_fc", "fc2": "mlp.c_proj"}[mod[2]]
    return (f"{pre}.{name}.{'bias' if leaf in ('b', 'bias') else 'weight'}",)


def load_style_params(state: dict, dtype=torch.bfloat16,
                      device="cuda") -> Params:
    """TencentARC style-adapter checkpoint (``t2iadapter_style_*``,
    ``coadapter-style``) -> params; strict: a missing or misshapen key
    raises, and so does a key left unread."""
    from .load import load_tree_strict

    return load_tree_strict(style_specs(**style_dims(state, state=True)),
                            state, _style_keys, "style adapter", dtype,
                            device)


def export_style_state(params: Params) -> dict:
    """Inverse of load_style_params: {key: f32 CPU tensor}."""
    from .load import export_tree

    return export_tree(params, style_specs(**style_dims(params)),
                       _style_keys)
