"""InSPyReNet salient-object segmentation (background removal) on torch.

Counterpart of gyre_tpu/models/inspyrenet.py: a Swin-B trunk feeding a
saliency pyramid (PAA context modules a level, a PAA decoder at 1/8, SICA
refiners at 1/4, 1/2 and 1/1, Laplacian image-pyramid reconstruction
between levels), the reference's direct single pass (threshold None).
``InSPyReNet`` is an ``nn.Module`` whose parameter names follow the JAX
package's params tree, so ``models/modelset.py::inspyrenet_from_jax``
fills it; the decoder's convs are ``ConvF``s, whose weights the JAX
package also holds OIHW.

  * The trunk runs NHWC, its products in the model's dtype (bf16 on the
    card) and its residual stream in f32 (24 blocks in a bf16 stream
    drift to ~1.5e-2 of the f32 logits, ~1e-2 in an f32 one). Each block
    pads to a window multiple after its first norm (unlike SwinIR, which
    pads the image), and a shifted block fills the logits that cross a
    region of the shifted, padded canvas with -1e9; the window helpers are
    models/swinir.py's. Patch merging pads odd sizes; the stride-4 patch
    conv follows a pad to a multiple of 4.
  * The decoder keeps the reference's NCHW tensor semantics, which its
    reshapes depend on: the H/W self-attention views a map as (B, -1,
    axis) and SICA views an NCHW map as (B, HW, C) without a transpose,
    both logical reshapes of NCHW shapes (torch's reshape is logical
    whatever the memory format). BatchNorms are folded into the convs at
    load.
  * The one-channel maps (the decoder's and each SICA's last conv, the
    thresholds, the pyramid) and every softmax run in f32.
  * ``_resize`` upsamples only (asserted): bilinear as ``jax.image.resize``
    (ops/resize.py), or with aligned corners on the JAX package's own
    linspace grid.
"""

from __future__ import annotations

import dataclasses
import re

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.resize import resize
from .layers import (conv_nhwc, f32, gelu, identity_bn, linspace,
                     load_state, nchw, nhwc, random_init)
from .swinir import (cross_region, init_rpb, lin, ln, rel_pos_index,
                     window_attention, window_partition, window_reverse)


@dataclasses.dataclass(frozen=True)
class SwinBConfig:
    embed_dim: int = 128
    depths: tuple = (2, 2, 18, 2)
    heads: tuple = (4, 8, 16, 32)
    window: int = 12
    mlp_ratio: int = 4


SWIN_B = SwinBConfig()
SWIN_TEST = SwinBConfig(embed_dim=16, depths=(1, 1, 2, 1),
                        heads=(2, 2, 2, 2), window=4)

IMAGE_MEAN = (0.485, 0.456, 0.406)
IMAGE_STD = (0.229, 0.224, 0.225)

# checkpoint keys that are buffers, not weights
_BUFFER_TOKENS = ("relative_position_index", "attn_mask",
                  "num_batches_tracked")
# the published decoder convs without a BatchNorm
_NO_BN = ("decoder.conv5", "conv_out4")


# ----------------------------------------------------------- swin trunk


class _Block(nn.Module):
    def __init__(self, dim: int, heads: int, window: int, ratio: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim)
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)
        self.rel_bias = nn.Parameter(torch.zeros((2 * window - 1) ** 2,
                                                 heads))
        self.norm2 = nn.LayerNorm(dim)
        self.fc1 = nn.Linear(dim, dim * ratio)
        self.fc2 = nn.Linear(dim * ratio, dim)

    def forward(self, x, heads, window, shift, rel_idx):
        """x: the f32 residual stream; the products in the model's dtype."""
        dt = self.qkv.weight.dtype
        b, h, w, c = x.shape
        pad_b, pad_r = (window - h % window) % window, \
            (window - w % window) % window
        xn = F.pad(ln(self.norm1, x).to(dt), (0, 0, 0, pad_r, 0, pad_b))
        hp, wp = h + pad_b, w + pad_r
        if shift:
            xn = torch.roll(xn, (-shift, -shift), dims=(1, 2))
        wins = window_partition(xn, window)
        n, t, _ = wins.shape
        qkv = lin(self.qkv, wins).reshape(n, t, 3, heads, c // heads)
        # unshifted, the padded canvas is one region: nothing is masked
        cross = cross_region(hp, wp, window, shift, x.device) if shift \
            else None
        out = window_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                               self.rel_bias, rel_idx, cross=cross,
                               fill=-1e9)
        out = window_reverse(lin(self.proj, out), window, hp, wp)
        if shift:
            out = torch.roll(out, (shift, shift), dims=(1, 2))
        x = x + out[:, :h, :w].float()
        return x + lin(self.fc2, gelu(lin(self.fc1, ln(self.norm2, x).to(
            dt)))).float()


class _Merge(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.norm = nn.LayerNorm(4 * dim)
        self.reduction = nn.Linear(4 * dim, 2 * dim, bias=False)

    def forward(self, x):
        b, h, w, c = x.shape
        x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
        x = torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2],
                       x[:, 1::2, 1::2]], dim=-1)
        dt = self.reduction.weight.dtype
        return lin(self.reduction, ln(self.norm, x).to(dt)).float()


class _Stage(nn.Module):
    def __init__(self, cfg: SwinBConfig, i: int):
        super().__init__()
        dim = cfg.embed_dim * 2 ** i
        self.blocks = nn.ModuleList(
            _Block(dim, cfg.heads[i], cfg.window, cfg.mlp_ratio)
            for _ in range(cfg.depths[i]))
        if i < len(cfg.depths) - 1:
            self.merge = _Merge(dim)


class SwinB(nn.Module):
    def __init__(self, cfg: SwinBConfig):
        super().__init__()
        self.cfg = cfg
        e = cfg.embed_dim
        self.patch_conv = nn.Conv2d(3, e, 4, stride=4)
        self.patch_norm = nn.LayerNorm(e)
        self.stages = nn.ModuleList(_Stage(cfg, i)
                                    for i in range(len(cfg.depths)))
        self.out_norms = nn.ModuleList(nn.LayerNorm(e * 2 ** i)
                                       for i in range(len(cfg.depths)))
        self.register_buffer("rel_idx", torch.from_numpy(
            rel_pos_index(cfg.window)), persistent=False)

    def forward(self, x):
        """x [B,H,W,3] (normalised, the model's dtype) -> 5 NHWC maps in
        that dtype: 1/4 (the embedding), then each stage's at 1/4, 1/8,
        1/16, 1/32."""
        cfg = self.cfg
        dt = x.dtype
        h, w = x.shape[1:3]
        x = F.pad(x, (0, 0, 0, (4 - w % 4) % 4, 0, (4 - h % 4) % 4))
        x = ln(self.patch_norm, conv_nhwc(self.patch_conv, x, stride=4,
                                          padding=0).float())
        outs = [x.to(dt)]
        for i, stage in enumerate(self.stages):
            for j, blk in enumerate(stage.blocks):
                x = blk(x, cfg.heads[i], cfg.window,
                        (cfg.window // 2) if j % 2 else 0, self.rel_idx)
            outs.append(ln(self.out_norms[i], x).to(dt))
            if hasattr(stage, "merge"):
                x = stage.merge(x)
        return outs


# ------------------------------------------------------- decoder (NCHW)


class ConvF(nn.Module):
    """An NCHW conv with torch-"same" padding (a BatchNorm folded in); its
    weight OIHW in the JAX package's params too."""

    def __init__(self, c_in: int, c_out: int, kh: int, kw: int | None = None):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(c_out, c_in, kh, kw or kh))
        self.bias = nn.Parameter(torch.zeros(c_out))

    def forward(self, x, dilation: int = 1, exact: bool = False):
        """In x's dtype, or in f32 when ``exact`` (the one-channel maps)."""
        kh, kw = self.weight.shape[2:]
        dt = torch.float32 if exact else x.dtype
        x = x.to(dt)
        if x.is_cuda and not exact:
            x = x.contiguous(memory_format=torch.channels_last)
        return F.conv2d(x, self.weight.to(dt), self.bias.to(dt),
                        padding=(dilation * (kh - 1) // 2,
                                 dilation * (kw - 1) // 2),
                        dilation=dilation)


def _resize(x, size, align_corners: bool = False):
    """NCHW x to ``size``, up only: bilinear as jax.image.resize, or with
    aligned corners on the JAX package's grid (linspace(0, n - 1))."""
    b, c, h, w = x.shape
    if (h, w) == tuple(size):
        return x
    assert size[0] >= h and size[1] >= w, (x.shape, size)
    if not align_corners:
        return nchw(resize(nhwc(x), tuple(size), "bilinear"))

    def grid(n_out, n_in):
        pos = linspace(n_in - 1.0, n_out, x.device)
        i0 = pos.floor().long().clamp(0, n_in - 1)
        return i0, (i0 + 1).clamp(0, n_in - 1), pos - i0

    y0, y1, wy = grid(size[0], h)
    x0, x1, wx = grid(size[1], w)
    wy, wx = wy[None, None, :, None], wx[None, None, None, :]
    rows0, rows1 = x[:, :, y0], x[:, :, y1]
    g = rows0[..., x0] * (1 - wy) * (1 - wx) + rows1[..., x0] * wy * (1 - wx) \
        + rows0[..., x1] * (1 - wy) * wx + rows1[..., x1] * wy * wx
    return g.to(x.dtype)


class _Attn(nn.Module):
    """The reference's SelfAttention: 1x1 q/k/v convs, attention over the
    trailing axis of the map viewed as (B, -1, axis), gamma-gated."""

    def __init__(self, c: int):
        super().__init__()
        self.query = ConvF(c, max(c // 8, 1), 1)
        self.key = ConvF(c, max(c // 8, 1), 1)
        self.value = ConvF(c, c, 1)
        self.gamma = nn.Parameter(torch.zeros(1))

    def forward(self, x, mode: str):
        b, c, h, w = x.shape
        axis = {"h": h, "w": w}[mode]
        q = self.query(x).reshape(b, -1, axis)
        k = self.key(x).reshape(b, -1, axis)
        v = self.value(x).reshape(b, -1, axis)
        attn = torch.softmax(torch.einsum("bcq,bck->bqk", q.float(),
                                          k.float()), -1).to(x.dtype)
        out = torch.einsum("bck,bqk->bcq", v, attn).reshape(b, c, h, w)
        return self.gamma.to(x.dtype) * out + x


class _PAAKernel(nn.Module):
    def __init__(self, ci: int, co: int, r: int):
        super().__init__()
        self.conv0 = ConvF(ci, co, 1)
        self.conv1 = ConvF(co, co, 1, r)
        self.conv2 = ConvF(co, co, r, 1)
        self.conv3 = ConvF(co, co, 3)
        self.Hattn, self.Wattn = _Attn(co), _Attn(co)

    def forward(self, x, receptive: int):
        x = self.conv2(self.conv1(self.conv0(x)))
        return self.conv3(self.Hattn(x, "h") + self.Wattn(x, "w"),
                          dilation=receptive)


class _PAAe(nn.Module):
    def __init__(self, ci: int, co: int):
        super().__init__()
        self.branch0 = ConvF(ci, co, 1)
        self.branch1 = _PAAKernel(ci, co, 3)
        self.branch2 = _PAAKernel(ci, co, 5)
        self.branch3 = _PAAKernel(ci, co, 7)
        self.conv_cat = ConvF(4 * co, co, 3)
        self.conv_res = ConvF(ci, co, 1)

    def forward(self, x):
        cat = torch.cat([self.branch0(x), self.branch1(x, 3),
                         self.branch2(x, 5), self.branch3(x, 7)], dim=1)
        return F.relu(self.conv_cat(cat) + self.conv_res(x))


class _PAAd(nn.Module):
    def __init__(self, depth: int):
        super().__init__()
        self.conv1 = ConvF(depth * 3, depth, 3)
        for i in range(2, 5):
            setattr(self, f"conv{i}", ConvF(depth, depth, 3))
        self.conv5 = ConvF(depth, 1, 3)
        self.Hattn, self.Wattn = _Attn(depth), _Attn(depth)

    def forward(self, fs):
        """fs = [f3, f4, f5]: f4 and f5 upsampled to f3, concatenated
        reversed -> (features, the 1/8 saliency logits in f32)."""
        size = fs[0].shape[-2:]
        ups = [fs[0]] + [_resize(f, size, align_corners=True)
                         for f in fs[1:]]
        fx = self.conv1(torch.cat(ups[::-1], dim=1))
        fx = self.conv2(self.Hattn(fx, "h") + self.Wattn(fx, "w"))
        fx = self.conv4(self.conv3(fx))
        return fx, self.conv5(fx, exact=True)


def _seq(convs, t):
    return F.relu(convs[1](F.relu(convs[0](t))))


class _SICA(nn.Module):
    def __init__(self, ci: int, depth: int, lmap_in: bool):
        super().__init__()
        self.conv_query = nn.ModuleList([ConvF(ci, depth, 3),
                                         ConvF(depth, depth, 3)])
        self.conv_key = nn.ModuleList([ConvF(ci, depth, 1),
                                       ConvF(depth, depth, 1)])
        self.conv_value = nn.ModuleList([ConvF(ci, depth, 1),
                                         ConvF(depth, depth, 1)])
        self.conv_out1 = ConvF(depth, depth, 3)
        self.conv_out2 = ConvF(ci + depth, depth, 3)
        self.conv_out3 = ConvF(depth, depth, 3)
        self.conv_out4 = ConvF(depth, 1, 1)
        self.threshold = nn.Parameter(torch.full((1,), 0.5))
        if lmap_in:
            self.lthreshold = nn.Parameter(torch.full((1,), 0.5))

    def forward(self, x, smap, lmap=None):
        b, c, h, w = x.shape
        depth = self.conv_out1.weight.shape[1]
        th = self.threshold.float()
        pr = torch.sigmoid(_resize(smap, (h, w))) - th
        probs = [pr.clamp(0, 1), (-pr).clamp(0, 1), th - pr.abs()]
        if lmap is not None:
            lp = torch.sigmoid(_resize(lmap, (h, w))) - \
                self.lthreshold.float()
            probs += [lp.clamp(0, 1), (-lp).clamp(0, 1)]
        prob = torch.cat(probs, dim=1)                  # [B,ctx,H,W] f32
        ctx = prob.shape[1]
        # the reference views the NCHW map as (B, HW, C) without a
        # transpose; the published checkpoints were trained so
        f = x.reshape(b, h * w, c)
        context = torch.einsum("bcn,bnd->bcd",
                               prob.reshape(b, ctx, h * w).to(x.dtype), f)
        context = context.transpose(1, 2)[..., None]    # [B,C,ctx,1]
        query = _seq(self.conv_query, x).reshape(b, depth, h * w)
        key = _seq(self.conv_key, context).reshape(b, depth, ctx)
        value = _seq(self.conv_value, context).reshape(b, depth, ctx)
        sim = torch.softmax(torch.einsum("bdn,bdc->bnc", query.float(),
                                         key.float()) * depth ** -0.5, -1)
        refined = torch.einsum("bnc,bdc->bdn", sim.to(x.dtype), value)
        refined = F.relu(self.conv_out1(refined.reshape(b, depth, h, w)))
        x = F.relu(self.conv_out2(torch.cat([x, refined], dim=1)))
        x = F.relu(self.conv_out3(x))
        return x, self.conv_out4(x, exact=True)


def gauss_kernel(ksize: int = 7, sigma: float = 1.0) -> np.ndarray:
    """cv2.getGaussianKernel(ksize, sigma)'s outer product, f32: the
    normalised exp(-x^2 / (2 sigma^2)) at x = i - (ksize - 1) / 2, in
    float64."""
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2.0
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    k = (k / k.sum())[:, None]
    return np.outer(k, k).astype(np.float32)


def _pyr_expand(x, kernel):
    """A one-channel NCHW f32 map to twice its size: zeros between its
    pixels, reflect-padded, times 4 x the Gaussian."""
    b, c, h, w = x.shape
    up = x.new_zeros((b, c, 2 * h, 2 * w))
    up[:, :, ::2, ::2] = x
    pad = kernel.shape[-1] // 2
    up = F.pad(up, (pad, pad, pad, pad), mode="reflect")
    return F.conv2d(up, kernel.expand(c, 1, -1, -1), groups=c)


def _pyr_reconstruct(x, lap, kernel):
    ex = _pyr_expand(x, kernel)
    if lap.shape != ex.shape:
        lap = _resize(lap, ex.shape[-2:], align_corners=True)
    return ex + lap


class InSPyReNet(nn.Module):
    """``forward`` is ``inspyrenet.apply``: images [B,H,W,3] in [0,1] ->
    the saliency [B,H,W,1] in [0,1] f32 (min-max normalised a image), or
    its logits with ``return_logits``."""

    def __init__(self, cfg: SwinBConfig = SWIN_B, depth: int = 64):
        super().__init__()
        self.cfg, self.depth = cfg, depth
        e = cfg.embed_dim
        self.backbone = SwinB(cfg)
        self.contexts = nn.ModuleList(_PAAe(ci, depth) for ci in
                                      (e, e, 2 * e, 4 * e, 8 * e))
        self.decoder = _PAAd(depth)
        self.attention0 = _SICA(depth, depth, True)
        self.attention1 = _SICA(depth * 2, depth, True)
        self.attention2 = _SICA(depth * 2, depth, False)
        self.register_buffer("kernel", self._kernel(), persistent=False)

    @staticmethod
    def _kernel(device=None):
        """The pyramid's expansion kernel, 4 x the 7x7 Gaussian, f32."""
        return torch.from_numpy(gauss_kernel() * 4.0)[None, None].to(device)

    @property
    def dtype(self):
        return self.backbone.patch_conv.weight.dtype

    def to_compute(self, dtype, device):
        self.to(device=device, dtype=dtype, memory_format=torch.channels_last)
        self.kernel = self._kernel(device)
        return self

    def forward(self, images, return_logits: bool = False):
        b, h, w, _ = images.shape
        mean = torch.tensor(IMAGE_MEAN, device=images.device)
        std = torch.tensor(IMAGE_STD, device=images.device)
        x = ((images.float() - mean) / std).to(self.dtype)
        feats = [nchw(t) for t in self.backbone(x)]
        x1, x2, x3, x4, x5 = [ctx(t) for ctx, t in zip(self.contexts, feats)]
        f3, d3 = self.decoder([x3, x4, x5])
        f3 = _resize(f3, (h // 4, w // 4))
        f2, p2 = self.attention2(torch.cat([x2, f3], dim=1), d3)
        d2 = _pyr_reconstruct(d3, p2, self.kernel)
        x1 = _resize(x1, (h // 2, w // 2))
        f2 = _resize(f2, (h // 2, w // 2))
        f1, p1 = self.attention1(torch.cat([x1, f2], dim=1), d2, p2)
        d1 = _pyr_reconstruct(d2, p1, self.kernel)
        f1 = _resize(f1, (h, w))
        _, p0 = self.attention0(f1, d1, p1)
        d0 = _resize(_pyr_reconstruct(d1, p0, self.kernel), (h, w))
        if return_logits:
            return nhwc(d0)
        pred = torch.sigmoid(d0)
        lo = pred.amin(dim=(1, 2, 3), keepdim=True)
        hi = pred.amax(dim=(1, 2, 3), keepdim=True)
        return nhwc((pred - lo) / (hi - lo + 1e-8))


def random_inspyrenet(cfg: SwinBConfig = SWIN_TEST, depth: int = 64,
                      seed: int = 0, dtype=torch.float32,
                      device="cuda") -> InSPyReNet:
    """Random weights (random_init; the bias tables ~ N(0, 0.02^2), the
    thresholds 0.5, each gamma uniform in +-1 so that every H/W attention
    adds to its map). A SICA's context sums its map over every pixel; the
    published model's BatchNorms after the key and value convs hold that
    sum's scale. Here each of those two convs reads it as such a
    BatchNorm fit at 384² would: its weight over the pixel count of its
    level there (else the logits reach ~5e3 at full width and the
    saliency saturates)."""
    with torch.device(device):
        model = InSPyReNet(cfg, depth)
    model = init_rpb(random_init(model, seed), seed, ("rel_bias",))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("threshold"):
                p.fill_(0.5)
        for sica, level in ((model.attention2, 4), (model.attention1, 2),
                            (model.attention0, 1)):
            for convs in (sica.conv_key, sica.conv_value):
                convs[0].weight /= (384 // level) ** 2
    return model.to_compute(dtype, torch.device(device))


# ----------------------------------------------------------------- loader


def _keys(model: InSPyReNet):
    """(module or parameter name, published key prefix, kind) of every
    parameter owner: kind "plain" (weight and bias as they are), "convf"
    (a Conv2d wrapper's .conv and .bn, folded) or "param"."""
    bk = model.backbone
    yield "backbone.patch_conv", "backbone.patch_embed.proj", "plain"
    yield "backbone.patch_norm", "backbone.patch_embed.norm", "plain"
    for si, stage in enumerate(bk.stages):
        for bi in range(len(stage.blocks)):
            pre = f"backbone.stages.{si}.blocks.{bi}"
            key = f"backbone.layers.{si}.blocks.{bi}"
            for mine, theirs in (("norm1", "norm1"), ("qkv", "attn.qkv"),
                                 ("proj", "attn.proj"), ("norm2", "norm2"),
                                 ("fc1", "mlp.fc1"), ("fc2", "mlp.fc2")):
                yield f"{pre}.{mine}", f"{key}.{theirs}", "plain"
            yield f"{pre}.rel_bias", \
                f"{key}.attn.relative_position_bias_table", "param"
        if hasattr(stage, "merge"):
            for part in ("norm", "reduction"):
                yield f"backbone.stages.{si}.merge.{part}", \
                    f"backbone.layers.{si}.downsample.{part}", "plain"
    for i in range(len(bk.out_norms)):
        yield f"backbone.out_norms.{i}", f"backbone.norm{i}", "plain"
    for name, mod in model.named_modules():
        if name.startswith("backbone") or not name:
            continue
        key = re.sub(r"attn\.(query|key|value)$", r"attn.\1_conv", name)
        key = re.sub(r"^contexts\.(\d+)",
                     lambda m: f"context{int(m.group(1)) + 1}", key)
        if isinstance(mod, ConvF):
            yield name, key, "convf"
        for pname in ("gamma", "threshold", "lthreshold"):
            if hasattr(mod, pname) and isinstance(getattr(mod, pname),
                                                  nn.Parameter):
                yield f"{name}.{pname}", f"{key}.{pname}", "param"


def _config(state) -> tuple[SwinBConfig, int]:
    embed = int(state["backbone.patch_embed.proj.weight"].shape[0])
    depths = []
    while f"backbone.layers.{len(depths)}.blocks.0.norm1.weight" in state:
        i, d = len(depths), 0
        while f"backbone.layers.{i}.blocks.{d}.norm1.weight" in state:
            d += 1
        depths.append(d)
    tables = [state[f"backbone.layers.{i}.blocks.0.attn."
                    "relative_position_bias_table"].shape
              for i in range(len(depths))]
    window = (int(round(tables[0][0] ** 0.5)) + 1) // 2
    cfg = SwinBConfig(embed_dim=embed, depths=tuple(depths),
                      heads=tuple(int(t[1]) for t in tables), window=window)
    return cfg, int(state["context1.branch0.conv.weight"].shape[0])


def load_inspyrenet(state: dict, dtype=torch.float32, device="cuda"
                    ) -> tuple[InSPyReNet, SwinBConfig]:
    """A published InSPyReNet-SwinB checkpoint (``backbone.*`` Swin-B,
    ``context{1..5}``, ``decoder``, ``attention{0,1,2}``, each conv a
    ``.conv`` + ``.bn`` wrapper) -> (model, its trunk config), each
    BatchNorm folded into its conv as the JAX package folds. Strict: a
    missing or misshapen key raises, and so does one left unread
    (buffers excepted)."""
    cfg, depth = _config(state)
    with torch.device(device):
        model = InSPyReNet(cfg, depth)
    params = dict(model.named_parameters())
    values, used = {}, set()

    def take(key):
        used.add(key)
        return f32(state[key])

    for mine, key, kind in _keys(model):
        if kind == "param":
            values[mine] = key
        elif kind == "plain":
            for leaf in ("weight", "bias"):
                if f"{mine}.{leaf}" in params:
                    values[f"{mine}.{leaf}"] = f"{key}.{leaf}"
        else:
            w = take(f"{key}.conv.weight")
            b = take(f"{key}.conv.bias") if f"{key}.conv.bias" in state \
                else np.zeros(w.shape[0], np.float32)
            if f"{key}.bn.weight" in state:
                rv = take(f"{key}.bn.running_var")
                s = take(f"{key}.bn.weight") / np.sqrt(rv + np.float32(1e-5))
                w, b = w * s[:, None, None, None], \
                    (b - take(f"{key}.bn.running_mean")) * s + \
                    take(f"{key}.bn.bias")
            values[f"{mine}.weight"], values[f"{mine}.bias"] = w, b

    load_state(model, lambda p: take(values[p]) if isinstance(values[p], str)
               else values[p], "inspyrenet")
    left = sorted(k for k in state if k not in used and
                  not any(tok in k for tok in _BUFFER_TOKENS))
    if left:
        raise KeyError(f"inspyrenet loader left {len(left)} keys "
                       "unconsumed: " + ", ".join(left[:8]))
    return model.to_compute(dtype, torch.device(device)), cfg


def state_dict_inspyrenet(model: InSPyReNet) -> dict:
    """The model in the published layout (f32 numpy): each decoder conv a
    bias-free ``.conv`` with its shift in an identity ``.bn`` after it,
    but the one-channel heads (decoder.conv5, conv_out4), which keep their
    bias on the conv; ``load_inspyrenet`` and the JAX package's loader
    read it back."""
    params = {n: p.detach().float().cpu().numpy()
              for n, p in model.named_parameters()}
    out = {}
    for mine, key, kind in _keys(model):
        if kind == "param":
            out[key] = params[mine]
        elif kind == "plain":
            for leaf in ("weight", "bias"):
                if f"{mine}.{leaf}" in params:
                    out[f"{key}.{leaf}"] = params[f"{mine}.{leaf}"]
        else:
            w, b = params[f"{mine}.weight"], params[f"{mine}.bias"]
            out[f"{key}.conv.weight"] = w
            if key.endswith(_NO_BN):
                out[f"{key}.conv.bias"] = b
            else:
                bn = identity_bn(w.shape[0])
                bn["bias"] = b
                out.update({f"{key}.bn.{k}": v for k, v in bn.items()})
    return out

