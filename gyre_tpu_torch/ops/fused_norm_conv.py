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
plain version for CPU tensors and its kernel for CUDA tensors: x and w
contiguous bf16 with C and Co multiples of 8, the GroupNorm scale and bias
and the conv bias contiguous f32 (the models keep these leaves in f32, so
no call casts them); anything else raises.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from .. import _build

# K2a's launch (csrc/gn_stats.cu), a rule fit to kernel_sweep.py's table of
# every (slabs, cluster, threads) at chip_smoke.py's shapes on the H100
# (PERF.md). From _GN_BIG vectors of 16 bytes (32 MiB) on, bandwidth decides:
# about 8 clusters of 9 blocks of 1024 threads. Below, the launch floor
# does: 96-192 blocks of 256 threads at ~16 vectors a thread, in slabs of
# at least 32 channels.
_GN_MAX_SLAB = 512
_GN_MAX_CLUSTER = 16
_GN_BIG = 1 << 21
_GN_BIG_CLUSTERS, _GN_BIG_CLUSTER = 8, 9
_GN_BLOCKS = (96, 192)
_GN_VECTORS_PER_THREAD = 16
_GN_MIN_SLAB = 32


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


def gn_slabs(c: int, groups: int) -> list[int]:
    """The slab counts K2a takes for c channels in groups: whole groups, a
    multiple of 8 channels and at most _GN_MAX_SLAB a slab; ascending."""
    if c % groups:
        raise ValueError(f"gn_affine: {c} channels do not split into "
                         f"{groups} groups")
    return [s for s in range(1, groups + 1)
            if groups % s == 0 and (c // s) % 8 == 0
            and c // s <= _GN_MAX_SLAB]


@functools.lru_cache(maxsize=256)
def gn_launch(bsz: int, hw: int, c: int,
              groups: int) -> tuple[int, int, int]:
    """K2a's launch for x [bsz, hw pixels, c]: (slabs, cluster size,
    threads of a block). Each cluster owns one batch row's slab of whole
    groups and its blocks split the pixels."""
    slabs = gn_slabs(c, groups)
    if not slabs:
        raise ValueError(f"gn_affine: {c} channels in {groups} groups have "
                         f"no slab of whole groups that is a multiple of 8 "
                         f"channels and at most {_GN_MAX_SLAB}")
    vectors = bsz * hw * c // 8
    if vectors >= _GN_BIG:
        s = next((n for n in slabs if bsz * n >= _GN_BIG_CLUSTERS),
                 slabs[-1])
        cluster = -(-_GN_BIG_CLUSTERS * _GN_BIG_CLUSTER // (bsz * s))
        return s, max(1, min(cluster, _GN_MAX_CLUSTER)), 1024
    want = max(_GN_BLOCKS[0], min(_GN_BLOCKS[1], -(-vectors // (
        256 * _GN_VECTORS_PER_THREAD))))
    wide = [n for n in slabs if c // n >= min(_GN_MIN_SLAB, c)]
    s = wide[-1] if wide else slabs[0]
    rows = 256 // (c // s // 8)
    cluster = min(round(want / (bsz * s)), _GN_MAX_CLUSTER, -(-hw // rows))
    return s, max(1, cluster), 256


def gn_affine(x, gn_scale, gn_bias, groups: int, eps: float):
    """K2a: x [B,H,W,C] -> (a, b) [B,C] f32 with x*a+b == GN(x)*scale+bias.
    On the card a and b are views of one [2,B,C] tensor."""
    if x.device.type == "cpu":
        return gn_affine_plain(x, gn_scale, gn_bias, groups, eps)
    _build.require(x, "gn_affine x", torch.bfloat16)
    if x.dim() != 4:
        raise ValueError(f"gn_affine x must be [B,H,W,C], got "
                         f"{tuple(x.shape)}")
    bsz, h, w, c = x.shape
    slabs, cluster, threads = gn_launch(bsz, h * w, c, groups)
    _build.require(gn_scale, "gn_affine scale", torch.float32, (c,))
    _build.require(gn_bias, "gn_affine bias", torch.float32, (c,))
    ab = torch.empty((2, bsz, c), dtype=torch.float32, device=x.device)
    lib = _build.library("gn_stats")
    with torch.cuda.device(x.device):
        rc = lib.gyre_gn_stats(
            x.data_ptr(), gn_scale.data_ptr(), gn_bias.data_ptr(),
            ab.data_ptr(), bsz, h * w, c, groups, slabs, cluster, threads,
            float(eps), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "gn_stats")
    _build.launches["gn_stats"] += 1
    return ab[0], ab[1]


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
    _build.require(conv_bias, "conv bias", torch.float32, (co,))
    out = torch.empty((bsz, h, wd, co), dtype=torch.bfloat16,
                      device=x.device)
    lib = _build.library("gn_silu_conv3x3")
    with torch.cuda.device(x.device):
        rc = lib.gyre_gn_silu_conv3x3(
            x.data_ptr(), a.data_ptr(), b.data_ptr(), w.data_ptr(),
            conv_bias.data_ptr(), out.data_ptr(), bsz, h, wd, c, co,
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
