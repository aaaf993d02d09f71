"""BAE surface-normal estimation (the normal engine).

Counterpart of gyre_tpu/models/baenormal.py, as an ``nn.Module`` whose
parameter names follow the JAX package's params tree
(``encoder.blocks.3.0.dw.weight`` is its
``encoder["blocks"][3][0]["dw"]["w"]``):

  * the encoder: tf_efficientnet_b5_ap's MBConv stages (expand, depthwise,
    squeeze-excite, project; swish), BatchNorms (eps 1e-3) folded into the
    convs at load, every conv padded as TF's (and XLA's) "SAME": at stride
    2 the odd pixel goes bottom and right, padded apart
    (``layers.conv_nchw``), since torch's ``padding="same"`` refuses stride
    2; the five skip maps the decoder reads;
  * the UpSampleBN decoder: align-corners bilinear upsampling with the JAX
    package's arithmetic (``resize_align_corners``), two 3x3 convs with
    leaky ReLU a level, and the test-mode refinement: pixel-wise MLP heads
    at 1/4, 1/2 and 1/1 over the upsampled features and the previous
    estimate, each normalised to a unit normal and a positive kappa;
  * ``forward``: the unit normal resized to the image as
    ``jax.image.resize`` does and shifted to [0, 1].

The encoder and the decoder's up-blocks run in the model's dtype (bf16 on
the card); the refinement heads and every normalisation in f32.
``load_baenormal`` reads the published NNET checkpoint
(``encoder.original_model.*`` gen-efficientnet names, ``decoder.*``);
``state_dict_baenormal`` writes a model in that layout.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.resize import resize
from .layers import (conv1x1_f32, conv_nchw, f32, fold_bn, identity_bn,
                     linspace, load_state, nchw, nhwc, random_init)


@dataclasses.dataclass(frozen=True)
class EffNetConfig:
    stem: int = 48
    # per stage: (channels, repeats, kernel, stride, expand)
    stages: tuple = ((24, 3, 3, 1, 1), (40, 5, 3, 2, 6), (64, 5, 5, 2, 6),
                     (128, 7, 3, 2, 6), (176, 7, 5, 1, 6),
                     (304, 9, 5, 2, 6), (512, 3, 3, 1, 6))
    head: int = 2048
    se_ratio: float = 0.25


EFFNET_B5 = EffNetConfig()
EFFNET_TEST = EffNetConfig(
    stem=8, stages=((8, 1, 3, 1, 1), (8, 1, 3, 2, 6), (8, 1, 5, 2, 6),
                    (16, 1, 3, 2, 6), (16, 1, 5, 1, 6), (24, 1, 5, 2, 6),
                    (32, 1, 3, 1, 6)), head=64)
# the published B5's stride a stage (the checkpoint does not hold it)
_B5_STRIDES = (1, 2, 2, 2, 1, 2, 1)


class _MBConv(nn.Module):
    def __init__(self, c_in: int, c_out: int, k: int, stride: int,
                 expand: int, se_ratio: float):
        super().__init__()
        mid = c_in * expand
        se = max(1, int(c_in * se_ratio))
        self.stride = stride
        self.expand = nn.Conv2d(c_in, mid, 1) if expand != 1 else None
        self.dw = nn.Conv2d(mid, mid, k, groups=mid)
        self.se_reduce = nn.Conv2d(mid, se, 1)
        self.se_expand = nn.Conv2d(se, mid, 1)
        self.project = nn.Conv2d(mid, c_out, 1)

    def forward(self, x):
        inp = x
        if self.expand is not None:
            x = F.silu(conv_nchw(self.expand, x))
        x = F.silu(conv_nchw(self.dw, x, stride=self.stride))
        se = x.float().mean(dim=(2, 3), keepdim=True).to(x.dtype)
        se = torch.sigmoid(conv_nchw(self.se_expand, F.silu(
            conv_nchw(self.se_reduce, se))))
        x = conv_nchw(self.project, x * se)
        if self.stride == 1 and inp.shape[1] == x.shape[1]:
            x = x + inp
        return x


class _Encoder(nn.Module):
    def __init__(self, cfg: EffNetConfig):
        super().__init__()
        self.stem = nn.Conv2d(3, cfg.stem, 3)
        stages, c_prev = [], cfg.stem
        for c, reps, k, stride, expand in cfg.stages:
            blocks = []
            for i in range(reps):
                blocks.append(_MBConv(c_prev, c, k, stride if i == 0 else 1,
                                      expand, cfg.se_ratio))
                c_prev = c
            stages.append(nn.ModuleList(blocks))
        self.blocks = nn.ModuleList(stages)
        self.head = nn.Conv2d(cfg.stages[-1][0], cfg.head, 1)

    def forward(self, x):
        """x [B,3,H,W] (ImageNet-normalised) -> the five skip maps: stages
        0, 1, 2 and 4 (1/2 to 1/16) and the conv head (1/32)."""
        x = F.silu(conv_nchw(self.stem, x, stride=2))
        feats = []
        for stage in self.blocks:
            for blk in stage:
                x = blk(x)
            feats.append(x)
        head = F.silu(conv_nchw(self.head, x))
        return [feats[0], feats[1], feats[2], feats[4], head]


def resize_align_corners(x, size):
    """Bilinear NHWC resize with aligned corners, the JAX package's
    arithmetic: positions ``jnp.linspace(0, n - 1, m)``, neighbours floor
    and floor + 1 (clipped), weights the fractions."""
    b, h, w, c = x.shape
    if (h, w) == tuple(size):
        return x
    dev = x.device

    def grid(n_out, n_in):
        if n_out == 1:
            return torch.zeros(1, device=dev)
        return linspace(n_in - 1.0, n_out, dev)

    ys, xs = grid(size[0], h), grid(size[1], w)
    y0 = torch.clamp(torch.floor(ys).long(), 0, h - 1)
    y1 = torch.clamp(y0 + 1, 0, h - 1)
    x0 = torch.clamp(torch.floor(xs).long(), 0, w - 1)
    x1 = torch.clamp(x0 + 1, 0, w - 1)
    wy = (ys - y0)[None, :, None, None].to(x.dtype)
    wx = (xs - x0)[None, None, :, None].to(x.dtype)
    r0, r1 = x[:, y0], x[:, y1]
    return (r0[:, :, x0] * (1 - wy) * (1 - wx) + r1[:, :, x0] * wy * (1 - wx)
            + r0[:, :, x1] * (1 - wy) * wx + r1[:, :, x1] * wy * wx)


class _UpBN(nn.Module):
    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.conv1 = nn.Conv2d(c_in, c_out, 3)
        self.conv2 = nn.Conv2d(c_out, c_out, 3)

    def forward(self, x, skip):
        x = nchw(resize_align_corners(nhwc(x), skip.shape[2:]))
        x = torch.cat([x, skip], dim=1)
        x = F.leaky_relu(conv_nchw(self.conv1, x), 0.01)
        return F.leaky_relu(conv_nchw(self.conv2, x), 0.01)


def _mlp_head(c_in: int):
    return nn.ModuleList([nn.Conv2d(c_in, 128, 1), nn.Conv2d(128, 128, 1),
                          nn.Conv2d(128, 128, 1), nn.Conv2d(128, 4, 1)])


def norm_normalize(out):
    """(nx, ny, nz, kappa) -> a unit normal and kappa = elu + 1.01, f32."""
    out = out.float()
    n, kappa = out[..., :3], out[..., 3:]
    length = torch.sqrt((n ** 2).sum(dim=-1, keepdim=True)) + 1e-10
    return torch.cat([n / length, F.elu(kappa) + 1.0 + 0.01], dim=-1)


class _Decoder(nn.Module):
    def __init__(self, cfg: EffNetConfig):
        super().__init__()
        chans = [s[0] for s in cfg.stages]
        h = cfg.head
        d = h // 2
        self.conv2 = nn.Conv2d(h, h, 1)
        self.up1 = _UpBN(h + chans[4], d)
        self.up2 = _UpBN(d + chans[2], d // 2)
        self.up3 = _UpBN(d // 2 + chans[1], d // 4)
        self.up4 = _UpBN(d // 4 + chans[0], d // 8)
        self.out_res8 = nn.Conv2d(d // 2, 4, 3)
        self.out_res4 = _mlp_head(d // 2 + 4)
        self.out_res2 = _mlp_head(d // 4 + 4)
        self.out_res1 = _mlp_head(d // 8 + 4)

    @staticmethod
    def _refine(head, feat, prev):
        """The MLP head over the feature map (NCHW) and the previous
        estimate (NHWC, f32), both upsampled 2x with aligned corners; f32."""
        size = (feat.shape[2] * 2, feat.shape[3] * 2)
        x = torch.cat([resize_align_corners(nhwc(feat).float(), size),
                       resize_align_corners(prev, size)], dim=-1)
        for conv in head[:-1]:
            x = F.relu(conv1x1_f32(conv, x))
        return norm_normalize(conv1x1_f32(head[-1], x))

    def forward(self, feats):
        """The five skip maps -> the four estimates (1/8 to 1/1), NHWC."""
        f0, f1, f2, f3, f4 = feats
        x_d1 = self.up1(conv_nchw(self.conv2, f4), f3)
        x_d2 = self.up2(x_d1, f2)
        x_d3 = self.up3(x_d2, f1)
        x_d4 = self.up4(x_d3, f0)
        out8 = norm_normalize(nhwc(conv_nchw(self.out_res8, x_d2)))
        out4 = self._refine(self.out_res4, x_d2, out8)
        out2 = self._refine(self.out_res2, x_d3, out4)
        out1 = self._refine(self.out_res1, x_d4, out2)
        return [out8, out4, out2, out1]


IMAGE_MEAN = (0.485, 0.456, 0.406)
IMAGE_STD = (0.229, 0.224, 0.225)


class BAENormal(nn.Module):
    """The normal estimator; ``forward`` is ``apply``."""

    def __init__(self, cfg: EffNetConfig = EFFNET_B5):
        super().__init__()
        self.cfg = cfg
        self.encoder = _Encoder(cfg)
        self.decoder = _Decoder(cfg)

    @property
    def dtype(self):
        return self.encoder.stem.weight.dtype

    def to_compute(self, dtype, device):
        self.to(device=device, dtype=dtype, memory_format=torch.channels_last)
        for head in (self.decoder.out_res4, self.decoder.out_res2,
                     self.decoder.out_res1):
            head.float()
        return self

    def estimates(self, images):
        """images [B,H,W,3] in [0,1] -> the decoder's four estimates."""
        mean = torch.tensor(IMAGE_MEAN, device=images.device)
        std = torch.tensor(IMAGE_STD, device=images.device)
        x = nchw(((images.float() - mean) / std).to(self.dtype))
        return self.decoder(self.encoder(x))

    def forward(self, images):
        """images [B,H,W,3] in [0,1] -> normal map [B,H,W,3] in [0,1], f32."""
        b, h, w, _ = images.shape
        n = self.estimates(images)[-1][..., :3]
        n = n / torch.sqrt((n ** 2).sum(dim=-1, keepdim=True) + 1e-12)
        n = resize(n, (h, w), "bilinear")
        return torch.clamp(n * 0.5 + 0.5, 0.0, 1.0)


def random_baenormal(cfg: EffNetConfig = EFFNET_TEST, seed: int = 0,
                     dtype=torch.float32, device="cuda") -> BAENormal:
    with torch.device(device):
        model = BAENormal(cfg)
    return random_init(model, seed).to_compute(dtype, torch.device(device))


# ----------------------------------------------------------------- loader

_ENC = "encoder.original_model."


def _keys(model: BAENormal):
    """(conv, published key prefix, its BatchNorm prefix or None, that
    BatchNorm's eps, the published conv has a bias) of every conv."""
    e = model.encoder
    yield e.stem, _ENC + "conv_stem", _ENC + "bn1", 1e-3, False
    for si, stage in enumerate(e.blocks):
        for bi, blk in enumerate(stage):
            pre = f"{_ENC}blocks.{si}.{bi}"
            if blk.expand is not None:
                yield blk.expand, f"{pre}.conv_pw", f"{pre}.bn1", 1e-3, False
                yield blk.dw, f"{pre}.conv_dw", f"{pre}.bn2", 1e-3, False
                proj, bn = f"{pre}.conv_pwl", f"{pre}.bn3"
            else:           # stage 0's DepthwiseSeparableConv
                yield blk.dw, f"{pre}.conv_dw", f"{pre}.bn1", 1e-3, False
                proj, bn = f"{pre}.conv_pw", f"{pre}.bn2"
            yield blk.se_reduce, f"{pre}.se.conv_reduce", None, 0, True
            yield blk.se_expand, f"{pre}.se.conv_expand", None, 0, True
            yield blk.project, proj, bn, 1e-3, False
    yield e.head, _ENC + "conv_head", _ENC + "bn2", 1e-3, False
    d = model.decoder
    yield d.conv2, "decoder.conv2", None, 0, True
    for i in range(1, 5):
        up, pre = getattr(d, f"up{i}"), f"decoder.up{i}._net"
        yield up.conv1, f"{pre}.0", f"{pre}.1", 1e-5, True
        yield up.conv2, f"{pre}.3", f"{pre}.4", 1e-5, True
    yield d.out_res8, "decoder.out_conv_res8", None, 0, True
    for name in ("res4", "res2", "res1"):
        for j, conv in zip((0, 2, 4, 6), getattr(d, f"out_{name}")):
            yield conv, f"decoder.out_conv_{name}.{j}", None, 0, True


def _config(state) -> EffNetConfig:
    """The encoder's plan from the checkpoint's shapes (strides as the
    published B5's)."""
    stages, si = [], 0
    while f"{_ENC}blocks.{si}.0.conv_dw.weight" in state:
        bi = 0
        while f"{_ENC}blocks.{si}.{bi}.conv_dw.weight" in state:
            bi += 1
        last = f"{_ENC}blocks.{si}.{bi - 1}"
        expand = f"{last}.conv_pwl.weight" in state
        proj = f"{last}.conv_pwl" if expand else f"{last}.conv_pw"
        stages.append((int(np.shape(state[f"{proj}.weight"])[0]), bi,
                       int(np.shape(state[f"{last}.conv_dw.weight"])[-1]),
                       _B5_STRIDES[si] if si < 7 else 1, 6 if expand else 1))
        si += 1
    return EffNetConfig(
        stem=int(np.shape(state[_ENC + "conv_stem.weight"])[0]),
        stages=tuple(stages),
        head=int(np.shape(state[_ENC + "conv_head.weight"])[0]))


def load_baenormal(state: dict, dtype=torch.float32, device="cuda"):
    """The published BAE checkpoint (the NNET state dict, gen-efficientnet
    encoder names, the UpSampleBN decoder; its 1x1 conv1d heads) -> (model,
    its config), BatchNorms folded into the convs before them."""
    cfg = _config(state)
    with torch.device(device):
        model = BAENormal(cfg)
    names = {id(m): n for n, m in model.named_modules()}
    values = {}
    for conv, key, bn, eps, _ in _keys(model):
        w = f32(state[f"{key}.weight"])
        if w.ndim == 3:                         # conv1d [out, in, 1]
            w = w[..., None]
        b = f32(state.get(f"{key}.bias", np.zeros(w.shape[0], np.float32)))
        w, b = fold_bn(w, b, state, bn, eps)
        pre = names[id(conv)]
        values[f"{pre}.weight"], values[f"{pre}.bias"] = w, b
    model = load_state(model, lambda p: values[p], "baenormal")
    return model.to_compute(dtype, torch.device(device)), cfg


def state_dict_baenormal(model: BAENormal) -> dict:
    """The model in the published layout (f32 numpy): an encoder conv
    without a bias and its shift in the identity BatchNorm after it, the
    heads as conv1d."""
    out: dict = {}
    for conv, key, bn, eps, has_bias in _keys(model):
        w = conv.weight.detach().float().cpu().numpy()
        b = conv.bias.detach().float().cpu().numpy()
        if key.startswith("decoder.out_conv_res") and key[-1].isdigit() \
                and not key.endswith("res8"):
            w = w[..., 0]
        out[f"{key}.weight"] = w
        if has_bias:
            out[f"{key}.bias"] = b
        if bn is not None:
            ident = identity_bn(w.shape[0], eps)
            if not has_bias:
                ident["bias"] = b
            out.update({f"{bn}.{k}": v for k, v in ident.items()})
    return out
