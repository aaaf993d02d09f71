"""AutoencoderKL (the SD VAE) on torch tensors.

Counterpart of gyre_tpu/models/vae.py. In the encoder and the decoder every
resnet's GN -> SiLU -> conv3x3 (eps 1e-6) goes through the fused kernels
K2a/K2b and the mid block's single-head attention (d = 512 at full width)
through the flash kernel K1. ``encode`` returns the gaussian posterior's
(mean, logvar), so the caller samples it with its own per-seed noise
(``sample_posterior``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import layers as L
from .configs import VAEConfig

Params = dict
_EPS = 1e-6


def _resnet_specs(c_in, c_out):
    p = {
        "norm1": L.fused_norm_spec(c_in),
        "conv1": L.fused_conv_spec(c_in, c_out),
        "norm2": L.fused_norm_spec(c_out),
        "conv2": L.fused_conv_spec(c_out, c_out),
    }
    if c_in != c_out:
        p["shortcut"] = L.conv_spec(1, 1, c_in, c_out)
    return p


def _attn_specs(c):
    return {"norm": L.norm_spec(c),
            **{n: L.linear_spec(c, c) for n in ("q", "k", "v", "out")}}


def param_specs(cfg: VAEConfig) -> Params:
    chs = cfg.block_out_channels
    lc = cfg.latent_channels
    enc: Params = {"conv_in": L.conv_spec(3, 3, cfg.in_channels, chs[0])}
    blocks = []
    c_prev = chs[0]
    for lvl, c_out in enumerate(chs):
        blk = {"resnets": [_resnet_specs(c_prev if i == 0 else c_out, c_out)
                           for i in range(cfg.layers_per_block)]}
        if lvl < len(chs) - 1:
            blk["downsample"] = L.conv_spec(3, 3, c_out, c_out)
        blocks.append(blk)
        c_prev = c_out
    enc["down"] = blocks
    enc["mid"] = {"res1": _resnet_specs(chs[-1], chs[-1]),
                  "attn": _attn_specs(chs[-1]),
                  "res2": _resnet_specs(chs[-1], chs[-1])}
    enc["norm_out"] = L.norm_spec(chs[-1])
    enc["conv_out"] = L.conv_spec(3, 3, chs[-1], 2 * lc)

    dec: Params = {"conv_in": L.conv_spec(3, 3, lc, chs[-1])}
    dec["mid"] = {
        "res1": _resnet_specs(chs[-1], chs[-1]),
        "attn": _attn_specs(chs[-1]),
        "res2": _resnet_specs(chs[-1], chs[-1]),
    }
    blocks = []
    c_prev = chs[-1]
    for i, c_out in enumerate(reversed(chs)):
        blk = {"resnets": [_resnet_specs(c_prev if j == 0 else c_out, c_out)
                           for j in range(cfg.layers_per_block + 1)]}
        if i < len(chs) - 1:
            blk["upsample"] = L.conv_spec(3, 3, c_out, c_out)
        blocks.append(blk)
        c_prev = c_out
    dec["up"] = blocks
    dec["norm_out"] = L.norm_spec(chs[0])
    dec["conv_out"] = L.conv_spec(3, 3, chs[0], cfg.out_channels)
    return {"encoder": enc, "decoder": dec,
            "quant_conv": L.conv_spec(1, 1, 2 * lc, 2 * lc),
            "post_quant_conv": L.conv_spec(1, 1, lc, lc)}


def _resnet(p, x, groups):
    h = L.gn_silu_conv3x3(p["norm1"], p["conv1"], x, groups, _EPS)
    h = L.gn_silu_conv3x3(p["norm2"], p["conv2"], h, groups, _EPS)
    if "shortcut" in p:
        x = L.conv2d(p["shortcut"], x)
    return x + h


def _attn(p, x, groups):
    b, h, w, c = x.shape
    res = x
    x = L.group_norm(p["norm"], x, groups, eps=_EPS).reshape(b, h * w, c)
    q = L.linear(p["q"], x)[:, :, None, :]
    k = L.linear(p["k"], x)[:, :, None, :]
    v = L.linear(p["v"], x)[:, :, None, :]
    o = L.attention(q, k, v).reshape(b, h * w, c)
    return L.linear(p["out"], o).reshape(b, h, w, c) + res


def encode(params: Params, cfg: VAEConfig, x):
    """x [B,H,W,3] in [-1,1] -> (mean, logvar), each [B,H/8,W/8,latent];
    logvar clipped to [-30, 20]."""
    p = params["encoder"]
    g = cfg.norm_groups
    h = L.conv2d(p["conv_in"], x)
    for blk in p["down"]:
        for res in blk["resnets"]:
            h = _resnet(res, h, g)
        if "downsample" in blk:
            # diffusers pads (0,1,0,1) before the stride-2 VALID conv
            h = L.conv2d(blk["downsample"], F.pad(h, (0, 0, 0, 1, 0, 1)),
                         stride=2, padding=0)
    h = _resnet(p["mid"]["res1"], h, g)
    h = _attn(p["mid"]["attn"], h, g)
    h = _resnet(p["mid"]["res2"], h, g)
    h = L.silu(L.group_norm(p["norm_out"], h, g, eps=_EPS))
    h = L.conv2d(params["quant_conv"], L.conv2d(p["conv_out"], h))
    mean, logvar = h.chunk(2, dim=-1)
    return mean, logvar.clamp(-30.0, 20.0)


def sample_posterior(mean, logvar, noise):
    return mean + torch.exp(0.5 * logvar) * noise


def decode(params: Params, cfg: VAEConfig, z):
    """z [B,h,w,latent] (already un-scaled) -> [B,8h,8w,3] in [-1,1]."""
    p = params["decoder"]
    g = cfg.norm_groups
    z = L.conv2d(params["post_quant_conv"], z)
    h = L.conv2d(p["conv_in"], z)
    h = _resnet(p["mid"]["res1"], h, g)
    h = _attn(p["mid"]["attn"], h, g)
    h = _resnet(p["mid"]["res2"], h, g)
    for blk in p["up"]:
        for res in blk["resnets"]:
            h = _resnet(res, h, g)
        if "upsample" in blk:
            h = L.conv2d(blk["upsample"], L.upsample_nearest_2x(h))
    h = L.silu(L.group_norm(p["norm_out"], h, g, eps=_EPS))
    return L.conv2d(p["conv_out"], h)
