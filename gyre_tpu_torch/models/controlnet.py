"""ControlNet on torch tensors: the UNet's down path twinned, a
conditioning embedding of the hint image and zero convs, giving one
residual per UNet skip and one for the mid block.

Counterpart of gyre_tpu/models/controlnet.py, same params tree and NHWC
layout. Its resnets and transformers are the UNet's (models/unet.py), so
each resnet runs the fused kernels K2a + K2b and each attention the flash
kernel K1 on the card; the conditioning embedding and the zero convs are
plain convs, as in the JAX package. Its transformers take the UNet
config's projection layout (SD2 ControlNets are linear). As in the JAX
package it has no ``add_embed``: on an SDXL UNet it runs without the
pooled text and time ids, which diffusers' SDXL ControlNets embed (ROADMAP
queue 3).
"""

from __future__ import annotations

import torch

from . import layers as L
from .configs import UNetConfig
from .unet import _check_config, _resnet, _resnet_specs, _transformer, \
    _transformer_specs

Params = dict

# conditioning-embedding channel ladder (diffusers-compatible), over an RGB
# hint image
COND_CHANNELS = (16, 32, 96, 256)
HINT_CHANNELS = 3


def param_specs(cfg: UNetConfig) -> Params:
    _check_config(cfg)
    ch0 = cfg.block_out_channels[0]
    ted = cfg.time_embed_dim
    ce = {"conv_in": L.conv_spec(3, 3, HINT_CHANNELS, COND_CHANNELS[0]),
          "blocks": []}
    c_prev = COND_CHANNELS[0]
    for c_out in COND_CHANNELS[1:]:
        ce["blocks"].append({"conv1": L.conv_spec(3, 3, c_prev, c_prev),
                             "conv2": L.conv_spec(3, 3, c_prev, c_out)})
        c_prev = c_out
    ce["conv_out"] = L.conv_spec(3, 3, c_prev, ch0)
    p: Params = {
        "conv_in": L.conv_spec(3, 3, cfg.in_channels, ch0),
        "time_embed": {"lin1": L.linear_spec(ch0, ted),
                       "lin2": L.linear_spec(ted, ted)},
        "cond_embed": ce,
    }
    down = []
    zero_convs = [L.conv_spec(1, 1, ch0, ch0)]
    c_prev = ch0
    for lvl, c_out in enumerate(cfg.block_out_channels):
        blk: Params = {"resnets": [], "attns": []}
        for i in range(cfg.layers_per_block):
            blk["resnets"].append(
                _resnet_specs(c_prev if i == 0 else c_out, c_out, ted))
            if cfg.attn_levels[lvl]:
                blk["attns"].append(_transformer_specs(
                    c_out, cfg.cross_attention_dim,
                    cfg.transformer_layers[lvl], cfg.linear_projection))
            zero_convs.append(L.conv_spec(1, 1, c_out, c_out))
        if lvl < cfg.levels - 1:
            blk["downsample"] = L.conv_spec(3, 3, c_out, c_out)
            zero_convs.append(L.conv_spec(1, 1, c_out, c_out))
        down.append(blk)
        c_prev = c_out
    p["down"] = down
    p["zero_convs"] = zero_convs
    c_mid = cfg.block_out_channels[-1]
    p["mid"] = {"res1": _resnet_specs(c_mid, c_mid, ted),
                "res2": _resnet_specs(c_mid, c_mid, ted)}
    if cfg.mid_attn:
        p["mid"]["attn"] = _transformer_specs(
            c_mid, cfg.cross_attention_dim, cfg.mid_transformer_layers,
            cfg.linear_projection)
    p["mid_zero"] = L.conv_spec(1, 1, c_mid, c_mid)
    return p


def random_controlnet(cfg: UNetConfig, seed: int = 0, dtype=torch.bfloat16,
                      device="cuda") -> Params:
    """Random weights as models/modelset.py makes them, with the zero
    convs and the conditioning embedding's output conv zero (the JAX
    package's init): such a ControlNet adds exactly zero."""
    from .modelset import random_tree

    p = random_tree(param_specs(cfg), seed, dtype, device)
    with torch.inference_mode():
        for zc in p["zero_convs"] + [p["mid_zero"],
                                     p["cond_embed"]["conv_out"]]:
            zc["w"].zero_()
    return p


def residual_resolutions(cfg: UNetConfig, h: int, w: int):
    """Spatial dims of each down residual and of the mid residual at latent
    size (h, w): conv_in, layers_per_block resnets a level, the stride-2
    downsample on all but the last level."""
    down = [(h, w)]
    ch, cw = h, w
    for lvl in range(cfg.levels):
        down.extend([(ch, cw)] * cfg.layers_per_block)
        if lvl < cfg.levels - 1:
            ch, cw = (ch - 1) // 2 + 1, (cw - 1) // 2 + 1
            down.append((ch, cw))
    return down, (ch, cw)


def embed_condition(params: Params, cond_image):
    """cond image [B,H,W,3] (pixel res) -> [B,H/8,W/8,ch0]."""
    ce = params["cond_embed"]
    h = L.silu(L.conv2d(ce["conv_in"], cond_image))
    for blk in ce["blocks"]:
        h = L.silu(L.conv2d(blk["conv1"], h))
        h = L.silu(L.conv2d(blk["conv2"], h, stride=2, padding=1))
    return L.conv2d(ce["conv_out"], h)


def apply(params: Params, cfg: UNetConfig, x, timesteps, context,
          cond_embedding, conditioning_scale: float = 1.0):
    """-> (down residuals, one per UNet skip, mid residual), f32: the zero
    convs' outputs times ``conditioning_scale``. ``cond_embedding`` is
    embed_condition's output (x-independent: computed once a request)."""
    dtype = x.dtype
    groups = cfg.norm_groups
    temb = L.timestep_embedding(timesteps, cfg.block_out_channels[0])
    temb = L.linear(params["time_embed"]["lin2"],
                    L.silu(L.linear(params["time_embed"]["lin1"],
                                    temb.to(dtype))))

    h = L.conv2d(params["conv_in"], x) + cond_embedding.to(dtype)
    feats = [h]
    for lvl, blk in enumerate(params["down"]):
        for i, res in enumerate(blk["resnets"]):
            h = _resnet(res, h, temb, groups)
            if blk["attns"]:
                h = _transformer(blk["attns"][i], h, context,
                                 cfg.num_heads[lvl], groups,
                                 cfg.linear_projection)
            feats.append(h)
        if "downsample" in blk:
            h = L.conv2d(blk["downsample"], h, stride=2, padding=1)
            feats.append(h)

    mid = params["mid"]
    h = _resnet(mid["res1"], h, temb, groups)
    if "attn" in mid:
        h = _transformer(mid["attn"], h, context,
                         cfg.num_heads[cfg.levels - 1], groups,
                         cfg.linear_projection)
    h = _resnet(mid["res2"], h, temb, groups)

    scale = float(conditioning_scale)
    down_res = [L.conv2d(zc, f).float() * scale
                for zc, f in zip(params["zero_convs"], feats)]
    mid_res = L.conv2d(params["mid_zero"], h).float() * scale
    return down_res, mid_res
