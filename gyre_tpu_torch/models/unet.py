"""Stable Diffusion conditional UNet (SD1.x, SD2.x, SDXL) on torch tensors.

Counterpart of gyre_tpu/models/unet.py, same params tree and NHWC layout.
Every resnet's GN -> SiLU -> conv3x3 (both convs, eps 1e-5) goes through the
fused kernels K2a/K2b, and every self- and cross-attention through the flash
kernel K1. Under seamless tiling the convs pad circularly on the tiled
axes, so the resnets take the plain GroupNorm -> SiLU -> conv path, as in
the JAX package, and only the attentions run a kernel.

The UNetConfig picks the family: 1x1-conv or linear (SD2, SDXL)
``proj_in``/``proj_out``, levels without attention and the transformer
depth and heads of each level (SDXL), SDXL's "text_time" conditioning
(``added_cond``: the pooled text and the size/crop time ids, through
``add_embed`` into the time embedding), the x4 upscaler's class
conditioning (``class_embed``: the noise level's sinusoid through
lin1 -> SiLU -> lin2, added to the time embedding) and diffusers'
"scale_shift" time conditioning (``time_scale_shift``: each resnet's time
projection is 2 * C_out wide and modulates its second GroupNorm, FiLM
style; that resnet's second conv then runs plain, as in the JAX package,
while its first stays on K2a + K2b). ControlNet residuals
(``down_residuals``, ``mid_residual``) and T2I-adapter features
(``adapter_states``) are added as in the JAX package, and ``tome_ratio``
merges the self-attentions' tokens (ops/tome.py; the merged attention is
still K1's). Under tensor parallelism (parallel/mesh.py) the attentions
and GEGLU feed-forwards whose weights are split run shard by shard, each
shard's K1 at its own heads.
"""

from __future__ import annotations

import torch

from ..ops import tome
from . import layers as L
from .configs import UNetConfig

Params = dict
_EPS = 1e-5


# ------------------------------------------------------------ param specs


def _resnet_specs(c_in, c_out, temb_dim, scale_shift=False):
    p = {
        "norm1": L.fused_norm_spec(c_in),
        "conv1": L.fused_conv_spec(c_in, c_out),
        "norm2": L.fused_norm_spec(c_out),
        "conv2": L.fused_conv_spec(c_out, c_out),
        "time_emb": L.linear_spec(temb_dim,
                                  c_out * (2 if scale_shift else 1)),
    }
    if c_in != c_out:
        p["shortcut"] = L.conv_spec(1, 1, c_in, c_out)
    return p


def _attn_specs(dim, ctx_dim):
    return {"q": L.linear_spec(dim, dim, bias=False),
            "k": L.linear_spec(ctx_dim, dim, bias=False),
            "v": L.linear_spec(ctx_dim, dim, bias=False),
            "out": L.linear_spec(dim, dim)}


def _transformer_specs(dim, ctx_dim, n_layers, linear_proj):
    def proj():
        return (L.linear_spec(dim, dim) if linear_proj
                else L.conv_spec(1, 1, dim, dim))

    return {
        "norm": L.norm_spec(dim),
        "blocks": [{
            "ln1": L.norm_spec(dim), "attn1": _attn_specs(dim, dim),
            "ln2": L.norm_spec(dim), "attn2": _attn_specs(dim, ctx_dim),
            "ln3": L.norm_spec(dim),
            "ff1": L.linear_spec(dim, dim * 8),    # GEGLU (4d pairs)
            "ff2": L.linear_spec(dim * 4, dim),
        } for _ in range(n_layers)],
        "proj_in": proj(),
        "proj_out": proj(),
    }


def param_specs(cfg: UNetConfig) -> Params:
    ch0 = cfg.block_out_channels[0]
    ted = cfg.time_embed_dim
    p: Params = {
        "conv_in": L.conv_spec(3, 3, cfg.in_channels, ch0),
        "time_embed": {"lin1": L.linear_spec(ch0, ted),
                       "lin2": L.linear_spec(ted, ted)},
        "norm_out": L.norm_spec(ch0),
        "conv_out": L.conv_spec(3, 3, ch0, cfg.out_channels),
    }
    if cfg.addition_embed_dim:
        add_in = cfg.addition_embed_dim + \
            cfg.addition_time_dim * cfg.addition_time_ids
        p["add_embed"] = {"lin1": L.linear_spec(add_in, ted),
                          "lin2": L.linear_spec(ted, ted)}
    if cfg.class_embed:
        p["class_embed"] = {"lin1": L.linear_spec(ch0, ted),
                            "lin2": L.linear_spec(ted, ted)}
    ss = cfg.time_scale_shift
    down = []
    c_prev = ch0
    for lvl, c_out in enumerate(cfg.block_out_channels):
        blk: Params = {"resnets": [], "attns": []}
        for i in range(cfg.layers_per_block):
            blk["resnets"].append(
                _resnet_specs(c_prev if i == 0 else c_out, c_out, ted, ss))
            if cfg.attn_levels[lvl]:
                blk["attns"].append(_transformer_specs(
                    c_out, cfg.cross_attention_dim,
                    cfg.transformer_layers[lvl], cfg.linear_projection))
        if lvl < cfg.levels - 1:
            blk["downsample"] = L.conv_spec(3, 3, c_out, c_out)
        down.append(blk)
        c_prev = c_out
    p["down"] = down

    c_mid = cfg.block_out_channels[-1]
    p["mid"] = {"res1": _resnet_specs(c_mid, c_mid, ted, ss),
                "res2": _resnet_specs(c_mid, c_mid, ted, ss)}
    if cfg.mid_attn:
        p["mid"]["attn"] = _transformer_specs(
            c_mid, cfg.cross_attention_dim, cfg.mid_transformer_layers,
            cfg.linear_projection)

    up = []
    rev = list(reversed(cfg.block_out_channels))
    for i, c_out in enumerate(rev):
        lvl = cfg.levels - 1 - i
        c_skip_base = rev[min(i + 1, cfg.levels - 1)]
        c_prev_blk = rev[max(i - 1, 0)] if i > 0 else c_mid
        blk = {"resnets": [], "attns": []}
        for j in range(cfg.layers_per_block + 1):
            res_skip = c_skip_base if j == cfg.layers_per_block else c_out
            res_in = (c_prev_blk if j == 0 else c_out) + res_skip
            blk["resnets"].append(_resnet_specs(res_in, c_out, ted, ss))
            if cfg.attn_levels[lvl]:
                blk["attns"].append(_transformer_specs(
                    c_out, cfg.cross_attention_dim,
                    cfg.transformer_layers[lvl], cfg.linear_projection))
        if i < cfg.levels - 1:
            blk["upsample"] = L.conv_spec(3, 3, c_out, c_out)
        up.append(blk)
    p["up"] = up
    return p


# ------------------------------------------------------------------ blocks


def _oihw(conv_p: Params) -> Params:
    """A fused conv's HWIO weight as the OIHW conv the plain path takes."""
    return {"w": conv_p["w"].permute(3, 2, 0, 1), "b": conv_p["b"]}


def _resnet(p, x, temb, groups, tiling=(False, False)):
    te = L.linear(p["time_emb"], L.silu(temb))[:, None, None, :]
    tx, ty = tiling
    if any(tiling):
        h = L.conv2d_tiled(_oihw(p["conv1"]),
                           L.silu(L.group_norm(p["norm1"], x, groups)),
                           tiling_x=tx, tiling_y=ty)
    else:
        h = L.gn_silu_conv3x3(p["norm1"], p["conv1"], x, groups, _EPS)
    if te.shape[-1] == 2 * h.shape[-1]:
        # scale_shift: GroupNorm, then h * (1 + scale) + shift, SiLU and a
        # plain conv2
        scale, shift = te.chunk(2, dim=-1)
        h = L.group_norm(p["norm2"], h, groups) * (1.0 + scale) + shift
        h = L.conv2d_tiled(_oihw(p["conv2"]), L.silu(h), tiling_x=tx,
                           tiling_y=ty)
    elif any(tiling):
        # the time embedding is added before the second GroupNorm
        h = L.conv2d_tiled(_oihw(p["conv2"]),
                           L.silu(L.group_norm(p["norm2"], h + te, groups)),
                           tiling_x=tx, tiling_y=ty)
    else:
        h = L.gn_silu_conv3x3(p["norm2"], p["conv2"], h + te, groups, _EPS)
    if "shortcut" in p:
        x = L.conv2d(p["shortcut"], x)
    return x + h


def _attn(p, x, ctx, heads):
    """x [B,T,C]; ctx [B,S,Cc], or x itself for self-attention. Weights
    split over tp devices (``L.Shards``) run each shard's whole heads on
    its device (``L.tp_attention``)."""
    if isinstance(p["q"]["w"], L.Shards):
        return L.tp_attention(p, x, ctx, heads)
    b, t, c = x.shape
    d = c // heads
    s = ctx.shape[1]
    q = L.linear(p["q"], x).reshape(b, t, heads, d)
    k = L.linear(p["k"], ctx).reshape(b, s, heads, d)
    v = L.linear(p["v"], ctx).reshape(b, s, heads, d)
    o = L.attention(q, k, v).reshape(b, t, c)
    return L.linear(p["out"], o)


def _tblock(p, x, ctx, heads, tome_ratio: float = 0.0):
    h = L.layer_norm(p["ln1"], x)
    if tome_ratio > 0:
        x = x + tome.tome_self_attention(
            lambda t: _attn(p["attn1"], t, t, heads), h, tome_ratio)
    else:
        x = x + _attn(p["attn1"], h, h, heads)
    h = L.layer_norm(p["ln2"], x)
    x = x + _attn(p["attn2"], h, ctx, heads)
    h = L.layer_norm(p["ln3"], x)
    if isinstance(p["ff1"]["w"], L.Shards):
        return x + L.tp_mlp(p["ff1"], p["ff2"], h, L.geglu)
    return x + L.linear(p["ff2"], L.geglu(p["ff1"], h))


def _transformer(p, x, ctx, heads, groups, linear_proj, tome_ratio=0.0):
    """Spatial transformer over an NHWC feature map: 1x1 conv projections
    (SD1.x) or linear ones on [B, HW, C] (SD2, SDXL)."""
    b, h, w, c = x.shape
    res = x
    x = L.group_norm(p["norm"], x, groups, eps=1e-6)
    if linear_proj:
        x = L.linear(p["proj_in"], x.reshape(b, h * w, c))
    else:
        x = L.conv2d(p["proj_in"], x).reshape(b, h * w, c)
    for blk in p["blocks"]:
        x = _tblock(blk, x, ctx, heads, tome_ratio)
    if linear_proj:
        x = L.linear(p["proj_out"], x).reshape(b, h, w, c)
    else:
        x = L.conv2d(p["proj_out"], x.reshape(b, h, w, c))
    return x + res


# ------------------------------------------------------------------- apply


def apply(params: Params, cfg: UNetConfig, x, timesteps, context, *,
          added_cond: dict | None = None, class_labels=None,
          down_residuals: list | None = None, mid_residual=None,
          adapter_states: list | None = None,
          tiling: tuple[bool, bool] = (False, False),
          tome_ratio: float = 0.0):
    """Predict noise (or v): x [B,H,W,Cin], timesteps [B], context
    [B,S,D]; ``added_cond`` (SDXL) {"text_embeds": [B, pooled dim],
    "time_ids": [B, n ids]}, its embedding added to the time embedding
    (skipped when None, as in the JAX package); ``tiling`` = (tiling_x,
    tiling_y) makes the image seamless on those axes. ``down_residuals``
    (one a skip) and ``mid_residual`` are a ControlNet's, added to the
    skips after the down path and after the mid block's last resnet;
    ``adapter_states`` (one a level, or None) a T2I adapter's, added after
    a level's last resnet, before its skip is pushed. ``class_labels`` [B]
    (the x4 upscaler's noise level) go through ``class_embed`` when the
    config has it; ``tome_ratio`` merges that fraction of each
    self-attention's source tokens (ops/tome.py)."""
    dtype = x.dtype
    groups = cfg.norm_groups
    lp = cfg.linear_projection
    temb = L.timestep_embedding(timesteps, cfg.block_out_channels[0])
    temb = L.linear(params["time_embed"]["lin2"],
                    L.silu(L.linear(params["time_embed"]["lin1"],
                                    temb.to(dtype))))
    if cfg.addition_embed_dim and added_cond is not None:
        # each time id's sinusoid, after the pooled text (f32), through
        # lin1 -> SiLU -> lin2
        tids = L.timestep_embedding(added_cond["time_ids"].reshape(-1),
                                    cfg.addition_time_dim)
        aug = torch.cat([added_cond["text_embeds"].float(),
                         tids.reshape(x.shape[0], -1)], dim=-1)
        temb = temb + L.linear(params["add_embed"]["lin2"], L.silu(
            L.linear(params["add_embed"]["lin1"], aug.to(dtype))))
    if cfg.class_embed and class_labels is not None:
        cemb = L.timestep_embedding(class_labels, cfg.block_out_channels[0])
        temb = temb + L.linear(params["class_embed"]["lin2"], L.silu(
            L.linear(params["class_embed"]["lin1"], cemb.to(dtype))))

    tx, ty = tiling
    h = L.conv2d_tiled(params["conv_in"], x, tiling_x=tx, tiling_y=ty)
    skips = [h]
    for lvl, blk in enumerate(params["down"]):
        for i, res in enumerate(blk["resnets"]):
            h = _resnet(res, h, temb, groups, tiling)
            if blk["attns"]:
                h = _transformer(blk["attns"][i], h, context,
                                 cfg.num_heads[lvl], groups, lp, tome_ratio)
            if (adapter_states is not None and
                    i == len(blk["resnets"]) - 1 and
                    lvl < len(adapter_states) and
                    adapter_states[lvl] is not None):
                h = h + adapter_states[lvl].to(dtype)
            skips.append(h)
        if "downsample" in blk:
            h = L.conv2d(blk["downsample"], h, stride=2, padding=1)
            skips.append(h)
    if down_residuals is not None:
        skips = [s + r.to(dtype) for s, r in zip(skips, down_residuals)]

    mid = params["mid"]
    h = _resnet(mid["res1"], h, temb, groups, tiling)
    if "attn" in mid:
        h = _transformer(mid["attn"], h, context,
                         cfg.num_heads[cfg.levels - 1], groups, lp,
                         tome_ratio)
    h = _resnet(mid["res2"], h, temb, groups, tiling)
    if mid_residual is not None:
        h = h + mid_residual.to(dtype)

    for i, blk in enumerate(params["up"]):
        lvl = cfg.levels - 1 - i
        for j, res in enumerate(blk["resnets"]):
            h = torch.cat([h, skips.pop()], dim=-1)
            h = _resnet(res, h, temb, groups, tiling)
            if blk["attns"]:
                h = _transformer(blk["attns"][j], h, context,
                                 cfg.num_heads[lvl], groups, lp, tome_ratio)
        if "upsample" in blk:
            h = L.conv2d_tiled(blk["upsample"], L.upsample_nearest_2x(h),
                               tiling_x=tx, tiling_y=ty)

    h = L.silu(L.group_norm(params["norm_out"], h, groups))
    return L.conv2d_tiled(params["conv_out"], h, tiling_x=tx, tiling_y=ty)
