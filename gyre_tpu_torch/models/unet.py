"""Stable Diffusion conditional UNet (SD1.x) on torch tensors.

Counterpart of gyre_tpu/models/unet.py, same params tree and NHWC layout.
Every resnet's GN -> SiLU -> conv3x3 (both convs, eps 1e-5) goes through the
fused kernels K2a/K2b, and every self- and cross-attention through the flash
kernel K1. Not ported yet, and raising when asked for: SD2/SDXL features
(linear projections, added/class conditioning, scale-shift time
conditioning), ControlNet/T2I-Adapter residuals, seamless tiling and token
merging.
"""

from __future__ import annotations

import torch

from gyre_tpu.models.configs import UNetConfig

from . import layers as L

Params = dict
_EPS = 1e-5


def _check_config(cfg: UNetConfig):
    unported = [name for name, on in (
        ("linear_projection", cfg.linear_projection),
        ("addition_embed_dim", cfg.addition_embed_dim),
        ("class_embed", cfg.class_embed),
        ("time_scale_shift", cfg.time_scale_shift)) if on]
    if unported:
        raise NotImplementedError(
            f"UNet config features not ported to gyre_tpu_torch yet: "
            f"{unported}")


# ------------------------------------------------------------ param specs


def _resnet_specs(c_in, c_out, temb_dim):
    p = {
        "norm1": L.norm_spec(c_in),
        "conv1": L.fused_conv_spec(c_in, c_out),
        "norm2": L.norm_spec(c_out),
        "conv2": L.fused_conv_spec(c_out, c_out),
        "time_emb": L.linear_spec(temb_dim, c_out),
    }
    if c_in != c_out:
        p["shortcut"] = L.conv_spec(1, 1, c_in, c_out)
    return p


def _attn_specs(dim, ctx_dim):
    return {"q": L.linear_spec(dim, dim, bias=False),
            "k": L.linear_spec(ctx_dim, dim, bias=False),
            "v": L.linear_spec(ctx_dim, dim, bias=False),
            "out": L.linear_spec(dim, dim)}


def _transformer_specs(dim, ctx_dim, n_layers):
    return {
        "norm": L.norm_spec(dim),
        "blocks": [{
            "ln1": L.norm_spec(dim), "attn1": _attn_specs(dim, dim),
            "ln2": L.norm_spec(dim), "attn2": _attn_specs(dim, ctx_dim),
            "ln3": L.norm_spec(dim),
            "ff1": L.linear_spec(dim, dim * 8),    # GEGLU (4d pairs)
            "ff2": L.linear_spec(dim * 4, dim),
        } for _ in range(n_layers)],
        "proj_in": L.conv_spec(1, 1, dim, dim),
        "proj_out": L.conv_spec(1, 1, dim, dim),
    }


def param_specs(cfg: UNetConfig) -> Params:
    _check_config(cfg)
    ch0 = cfg.block_out_channels[0]
    ted = cfg.time_embed_dim
    p: Params = {
        "conv_in": L.conv_spec(3, 3, cfg.in_channels, ch0),
        "time_embed": {"lin1": L.linear_spec(ch0, ted),
                       "lin2": L.linear_spec(ted, ted)},
        "norm_out": L.norm_spec(ch0),
        "conv_out": L.conv_spec(3, 3, ch0, cfg.out_channels),
    }
    down = []
    c_prev = ch0
    for lvl, c_out in enumerate(cfg.block_out_channels):
        blk: Params = {"resnets": [], "attns": []}
        for i in range(cfg.layers_per_block):
            blk["resnets"].append(
                _resnet_specs(c_prev if i == 0 else c_out, c_out, ted))
            if cfg.attn_levels[lvl]:
                blk["attns"].append(_transformer_specs(
                    c_out, cfg.cross_attention_dim,
                    cfg.transformer_layers[lvl]))
        if lvl < cfg.levels - 1:
            blk["downsample"] = L.conv_spec(3, 3, c_out, c_out)
        down.append(blk)
        c_prev = c_out
    p["down"] = down

    c_mid = cfg.block_out_channels[-1]
    p["mid"] = {"res1": _resnet_specs(c_mid, c_mid, ted),
                "res2": _resnet_specs(c_mid, c_mid, ted)}
    if cfg.mid_attn:
        p["mid"]["attn"] = _transformer_specs(
            c_mid, cfg.cross_attention_dim, cfg.mid_transformer_layers)

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
            blk["resnets"].append(_resnet_specs(res_in, c_out, ted))
            if cfg.attn_levels[lvl]:
                blk["attns"].append(_transformer_specs(
                    c_out, cfg.cross_attention_dim,
                    cfg.transformer_layers[lvl]))
        if i < cfg.levels - 1:
            blk["upsample"] = L.conv_spec(3, 3, c_out, c_out)
        up.append(blk)
    p["up"] = up
    return p


# ------------------------------------------------------------------ blocks


def _resnet(p, x, temb, groups):
    h = L.gn_silu_conv3x3(p["norm1"], p["conv1"], x, groups, _EPS)
    te = L.linear(p["time_emb"], L.silu(temb))
    # the time embedding is added before the second GroupNorm
    h = h + te[:, None, None, :]
    h = L.gn_silu_conv3x3(p["norm2"], p["conv2"], h, groups, _EPS)
    if "shortcut" in p:
        x = L.conv2d(p["shortcut"], x)
    return x + h


def _attn(p, x, ctx, heads):
    """x [B,T,C]; ctx [B,S,Cc], or x itself for self-attention."""
    b, t, c = x.shape
    d = c // heads
    s = ctx.shape[1]
    q = L.linear(p["q"], x).reshape(b, t, heads, d)
    k = L.linear(p["k"], ctx).reshape(b, s, heads, d)
    v = L.linear(p["v"], ctx).reshape(b, s, heads, d)
    o = L.attention(q, k, v).reshape(b, t, c)
    return L.linear(p["out"], o)


def _tblock(p, x, ctx, heads):
    h = L.layer_norm(p["ln1"], x)
    x = x + _attn(p["attn1"], h, h, heads)
    h = L.layer_norm(p["ln2"], x)
    x = x + _attn(p["attn2"], h, ctx, heads)
    h = L.layer_norm(p["ln3"], x)
    return x + L.linear(p["ff2"], L.geglu(p["ff1"], h))


def _transformer(p, x, ctx, heads, groups):
    """Spatial transformer over an NHWC feature map (1x1 conv projections,
    the SD1.x layout)."""
    b, h, w, c = x.shape
    res = x
    x = L.group_norm(p["norm"], x, groups, eps=1e-6)
    x = L.conv2d(p["proj_in"], x).reshape(b, h * w, c)
    for blk in p["blocks"]:
        x = _tblock(blk, x, ctx, heads)
    x = L.conv2d(p["proj_out"], x.reshape(b, h, w, c))
    return x + res


# ------------------------------------------------------------------- apply


def apply(params: Params, cfg: UNetConfig, x, timesteps, context, *,
          added_cond: dict | None = None, class_labels=None,
          down_residuals: list | None = None, mid_residual=None,
          adapter_states: list | None = None,
          tiling: tuple[bool, bool] = (False, False),
          tome_ratio: float = 0.0):
    """Predict noise: x [B,H,W,Cin], timesteps [B], context [B,S,D].

    The conditioning arguments of the JAX package's signature are kept;
    those not ported yet raise."""
    _check_config(cfg)
    unported = [name for name, on in (
        ("added_cond", added_cond is not None),
        ("class_labels", class_labels is not None),
        ("down_residuals", down_residuals is not None),
        ("mid_residual", mid_residual is not None),
        ("adapter_states", adapter_states is not None),
        ("tiling", any(tiling)), ("tome_ratio", tome_ratio > 0)) if on]
    if unported:
        raise NotImplementedError(
            f"UNet inputs not ported to gyre_tpu_torch yet: {unported}")
    dtype = x.dtype
    groups = cfg.norm_groups
    temb = L.timestep_embedding(timesteps, cfg.block_out_channels[0])
    temb = L.linear(params["time_embed"]["lin2"],
                    L.silu(L.linear(params["time_embed"]["lin1"],
                                    temb.to(dtype))))

    h = L.conv2d(params["conv_in"], x)
    skips = [h]
    for lvl, blk in enumerate(params["down"]):
        for i, res in enumerate(blk["resnets"]):
            h = _resnet(res, h, temb, groups)
            if blk["attns"]:
                h = _transformer(blk["attns"][i], h, context,
                                 cfg.num_heads[lvl], groups)
            skips.append(h)
        if "downsample" in blk:
            h = L.conv2d(blk["downsample"], h, stride=2, padding=1)
            skips.append(h)

    mid = params["mid"]
    h = _resnet(mid["res1"], h, temb, groups)
    if "attn" in mid:
        h = _transformer(mid["attn"], h, context,
                         cfg.num_heads[cfg.levels - 1], groups)
    h = _resnet(mid["res2"], h, temb, groups)

    for i, blk in enumerate(params["up"]):
        lvl = cfg.levels - 1 - i
        for j, res in enumerate(blk["resnets"]):
            h = torch.cat([h, skips.pop()], dim=-1)
            h = _resnet(res, h, temb, groups)
            if blk["attns"]:
                h = _transformer(blk["attns"][j], h, context,
                                 cfg.num_heads[lvl], groups)
        if "upsample" in blk:
            h = L.conv2d(blk["upsample"], L.upsample_nearest_2x(h))

    h = L.silu(L.group_norm(params["norm_out"], h, groups))
    return L.conv2d(params["conv_out"], h)
