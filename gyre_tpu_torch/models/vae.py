"""AutoencoderKL decoder (the SD VAE) on torch tensors.

Counterpart of gyre_tpu/models/vae.py, ``decode`` only. Every resnet's
GN -> SiLU -> conv3x3 (eps 1e-6) goes through the fused kernels K2a/K2b and
the mid-block single-head attention (d = 512 at full width) through the
flash kernel K1. The encoder (img2img, inpaint) is not ported yet: its
params, with ``quant_conv``, are not part of the port's tree
(modelset.NOT_PORTED).
"""

from __future__ import annotations

from gyre_tpu.models.configs import VAEConfig

from . import layers as L

Params = dict
_EPS = 1e-6


def _resnet_specs(c_in, c_out):
    p = {
        "norm1": L.norm_spec(c_in),
        "conv1": L.fused_conv_spec(c_in, c_out),
        "norm2": L.norm_spec(c_out),
        "conv2": L.fused_conv_spec(c_out, c_out),
    }
    if c_in != c_out:
        p["shortcut"] = L.conv_spec(1, 1, c_in, c_out)
    return p


def param_specs(cfg: VAEConfig) -> Params:
    chs = cfg.block_out_channels
    lc = cfg.latent_channels
    dec: Params = {"conv_in": L.conv_spec(3, 3, lc, chs[-1])}
    dec["mid"] = {
        "res1": _resnet_specs(chs[-1], chs[-1]),
        "attn": {"norm": L.norm_spec(chs[-1]),
                 **{n: L.linear_spec(chs[-1], chs[-1])
                    for n in ("q", "k", "v", "out")}},
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
    return {"decoder": dec, "post_quant_conv": L.conv_spec(1, 1, lc, lc)}


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
