"""Fused GroupNorm -> SiLU -> 3x3 conv: the hand-written kernels K2a + K2b
and their plain versions.

Counterpart of gyre_tpu/ops/fused_norm_conv.py (+ ops/fusion.py). The same
two passes as the TPU fusion:

  K2a ``gn_affine`` (csrc/gn_stats.cu): per-(batch, group) statistics
      folded with the GroupNorm scale and bias into a, b [B, C] f32.
  K2b ``affine_silu_conv3x3`` (csrc/gn_silu_conv3x3.cu): y = silu(x*a+b)
      applied while the conv gathers its input, 3x3 SAME conv, + bias.

``gn_silu_conv3x3`` chains the two. Every resnet's GN -> SiLU -> conv3x3 in
the UNet and the VAE decoder goes through it, at every shape; the JAX
package's TPU gate (fusion off by default) is not carried over.

Layout: x NHWC [B,H,W,C]; w HWIO [3,3,C,Co], the layout K2b reads (the
models keep these weights in it); bias [Co]. Each public function takes its
plain version for CPU tensors and its kernel for CUDA tensors, which must
be contiguous bf16 with C and Co multiples of 8; anything else raises.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import _build

# pixels each K2a pass-1 block sums; enough blocks to fill the card at
# batch 1 without making the pass-2 combine long
_GN_MIN_PIXELS = 32
_GN_TARGET_BLOCKS = 528   # 4 blocks of 128 threads per SM on 132 SMs


# ------------------------------------------------------------ plain versions


def gn_affine_plain(x, gn_scale, gn_bias, groups: int, eps: float):
    """Folded GroupNorm affine in f32 (the JAX package's gn_affine, with
    the two-pass variance of torch.var_mean)."""
    b, c = x.shape[0], x.shape[-1]
    xg = x.float().reshape(b, -1, groups, c // groups)
    var, mean = torch.var_mean(xg, dim=(1, 3), unbiased=False)
    inv = torch.rsqrt(var + eps)                                  # [B, G]
    a = inv.repeat_interleave(c // groups, dim=1) * gn_scale.float()[None]
    bb = gn_bias.float()[None] - mean.repeat_interleave(c // groups, dim=1) * a
    return a, bb


def _conv3x3_nhwc(y, w, conv_bias):
    """3x3 SAME conv of NHWC y with HWIO w (plain; through F.conv2d)."""
    out = F.conv2d(y.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1).to(y.dtype),
                   conv_bias.to(y.dtype), padding=1)
    return out.permute(0, 2, 3, 1).contiguous()


def affine_silu_conv3x3_plain(x, a, b, w, conv_bias):
    """silu(x*a+b) in f32, rounded to x's dtype, then the 3x3 conv."""
    y = x.float() * a[:, None, None, :] + b[:, None, None, :]
    return _conv3x3_nhwc(F.silu(y).to(x.dtype), w, conv_bias)


def gn_silu_conv3x3_plain(x, gn_scale, gn_bias, w, conv_bias, *,
                          groups: int = 32, eps: float = 1e-6):
    """The unfused chain: GroupNorm (f32 statistics) -> SiLU -> conv3x3, as
    the JAX package's gn_silu_conv3x3_reference."""
    b, c = x.shape[0], x.shape[-1]
    xg = x.float().reshape(b, -1, groups, c // groups)
    var, mean = torch.var_mean(xg, dim=(1, 3), keepdim=True, unbiased=False)
    y = ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    y = (y * gn_scale.float() + gn_bias.float()).to(x.dtype)
    return _conv3x3_nhwc(F.silu(y), w, conv_bias)


# ------------------------------------------------------------------ kernels


def gn_affine(x, gn_scale, gn_bias, groups: int, eps: float):
    """K2a: x [B,H,W,C] -> (a, b) [B,C] f32 with x*a+b == GN(x)*scale+bias."""
    if x.device.type == "cpu":
        return gn_affine_plain(x, gn_scale, gn_bias, groups, eps)
    _build.require(x, "gn_affine x", torch.bfloat16)
    if x.dim() != 4:
        raise ValueError(f"gn_affine x must be [B,H,W,C], got "
                         f"{tuple(x.shape)}")
    bsz, h, w, c = x.shape
    if c % groups:
        raise ValueError(f"gn_affine: {c} channels do not split into "
                         f"{groups} groups")
    scale = gn_scale.float().contiguous()
    bias = gn_bias.float().contiguous()
    _build.require(scale, "gn_affine scale", torch.float32, (c,))
    _build.require(bias, "gn_affine bias", torch.float32, (c,))
    hw = h * w
    splits = max(1, min(-(-hw // _GN_MIN_PIXELS),
                        _GN_TARGET_BLOCKS // bsz))
    pix = -(-hw // splits)
    splits = -(-hw // pix)
    a = torch.empty((bsz, c), dtype=torch.float32, device=x.device)
    b = torch.empty_like(a)
    part = torch.empty((bsz, splits, c, 2), dtype=torch.float32,
                       device=x.device)
    lib = _build.library("gn_stats")
    with torch.cuda.device(x.device):
        rc = lib.gyre_gn_stats(
            x.data_ptr(), scale.data_ptr(), bias.data_ptr(), a.data_ptr(),
            b.data_ptr(), part.data_ptr(), bsz, hw, c, groups, pix,
            float(eps), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "gn_stats")
    _build.launches["gn_stats"] += 1
    return a, b


def affine_silu_conv3x3(x, a, b, w, conv_bias):
    """K2b: silu(x*a+b) -> 3x3 SAME conv (HWIO w) + bias, NHWC."""
    if x.device.type == "cpu":
        return affine_silu_conv3x3_plain(x, a, b, w, conv_bias)
    _build.require(x, "conv x", torch.bfloat16)
    if x.dim() != 4:
        raise ValueError(f"conv x must be [B,H,W,C], got {tuple(x.shape)}")
    bsz, h, wd, c = x.shape
    if w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, c):
        raise ValueError(f"conv weight must be HWIO [3,3,{c},Co], got "
                         f"{tuple(w.shape)}")
    co = w.shape[-1]
    if c % 8 or co % 8:
        raise ValueError(f"fused conv needs C and Co multiples of 8, got "
                         f"C={c} Co={co}")
    _build.require(w, "conv weight", torch.bfloat16)
    _build.require(a, "affine a", torch.float32, (bsz, c))
    _build.require(b, "affine b", torch.float32, (bsz, c))
    bias = conv_bias.float().contiguous()
    _build.require(bias, "conv bias", torch.float32, (co,))
    out = torch.empty((bsz, h, wd, co), dtype=torch.bfloat16,
                      device=x.device)
    lib = _build.library("gn_silu_conv3x3")
    with torch.cuda.device(x.device):
        rc = lib.gyre_gn_silu_conv3x3(
            x.data_ptr(), a.data_ptr(), b.data_ptr(), w.data_ptr(),
            bias.data_ptr(), out.data_ptr(), bsz, h, wd, c, co,
            torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "gn_silu_conv3x3")
    _build.launches["gn_silu_conv3x3"] += 1
    return out


def gn_silu_conv3x3(x, gn_scale, gn_bias, w, conv_bias, *, groups: int = 32,
                    eps: float = 1e-6):
    """silu(group_norm(x)*scale+bias) -> 3x3 stride-1 SAME conv.

    CUDA tensors: K2a then K2b. CPU tensors: the plain chain."""
    if x.device.type == "cpu":
        return gn_silu_conv3x3_plain(x, gn_scale, gn_bias, w, conv_bias,
                                     groups=groups, eps=eps)
    a, b = gn_affine(x, gn_scale, gn_bias, groups, eps)
    return affine_silu_conv3x3(x, a, b, w, conv_bias)
