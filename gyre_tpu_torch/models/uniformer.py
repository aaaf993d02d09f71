"""UniFormer + UPerHead semantic segmentation (the segmentation engine).

Counterpart of gyre_tpu/models/uniformer.py, the upernet_global_small
configuration of the ControlNet segmentation annotator, as an
``nn.Module`` whose parameter names follow the JAX package's params tree
(``backbone.stages.2.0.qkv.weight`` is its
``backbone["stages"][2][0]["qkv"]["w"]``):

  * the backbone (its residual stream in f32 between the convs): two
    convolutional stages (CBlock: a depthwise position
    conv, a 1x1 / 5x5 depthwise / 1x1 mixer and a conv MLP, their
    BatchNorms folded into the next conv at load) and two global
    self-attention stages (SABlock: LayerNorm in f32, a fused qkv whose
    attention runs through ``layers.attention``, on the card K1), patch
    embeds with a channel-last LayerNorm, a LayerNorm after each stage;
  * mmseg's UPerHead: PSP pooling over the last stage on the JAX
    package's bins (``adaptive_pool``: segment i of k spans floor(i n /
    k) to ceil((i + 1) n / k)), bilinear resizes as ``jax.image.resize``
    does (ops/resize.py), the FPN, a 3x3 bottleneck and the 1x1 class
    conv (BatchNorms folded at load);
  * ``forward``: the class logits in f32, resized to the image, argmax
    (the first of equal maxima), the ADE20K palette.

The trunk runs in the model's dtype: bf16 on the card, where K1 takes
nothing else. ``load_uniformer`` reads the mmseg checkpoint
(``backbone.*`` and ``decode_head.*``; ``auxiliary_head.*`` is ignored, as
in the JAX package); ``state_dict_uniformer`` writes a model in that
layout (BatchNorms as identities).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.resize import resize
from .layers import (attention, conv1x1_f32, conv_nchw, f32, identity_bn,
                     load_state, nchw, nhwc, random_init)


@dataclasses.dataclass(frozen=True)
class UniFormerConfig:
    layers: tuple = (3, 4, 8, 3)          # upernet_global_small
    embed_dim: tuple = (64, 128, 320, 512)
    head_dim: int = 64
    mlp_ratio: int = 4
    num_classes: int = 150
    fpn_channels: int = 512
    pool_scales: tuple = (1, 2, 3, 6)


UNIFORMER_SMALL = UniFormerConfig()
UNIFORMER_TEST = UniFormerConfig(
    layers=(1, 1, 1, 1), embed_dim=(8, 16, 24, 32), head_dim=8,
    num_classes=16, fpn_channels=16)


# the 150-class ADE20K palette (mmseg's get_palette("ade"))
_ADE_PALETTE = [
    (120, 120, 120), (180, 120, 120), (6, 230, 230), (80, 50, 50),
    (4, 200, 3), (120, 120, 80), (140, 140, 140), (204, 5, 255),
    (230, 230, 230), (4, 250, 7), (224, 5, 255), (235, 255, 7),
    (150, 5, 61), (120, 120, 70), (8, 255, 51), (255, 6, 82),
    (143, 255, 140), (204, 255, 4), (255, 51, 7), (204, 70, 3),
    (0, 102, 200), (61, 230, 250), (255, 6, 51), (11, 102, 255),
    (255, 7, 71), (255, 9, 224), (9, 7, 230), (220, 220, 220),
    (255, 9, 92), (112, 9, 255), (8, 255, 214), (7, 255, 224),
    (255, 184, 6), (10, 255, 71), (255, 41, 10), (7, 255, 255),
    (224, 255, 8), (102, 8, 255), (255, 61, 6), (255, 194, 7),
    (255, 122, 8), (0, 255, 20), (255, 8, 41), (255, 5, 153),
    (6, 51, 255), (235, 12, 255), (160, 150, 20), (0, 163, 255),
    (140, 140, 140), (250, 10, 15), (20, 255, 0), (31, 255, 0),
    (255, 31, 0), (255, 224, 0), (153, 255, 0), (0, 0, 255),
    (255, 71, 0), (0, 235, 255), (0, 173, 255), (31, 0, 255),
    (11, 200, 200), (255, 82, 0), (0, 255, 245), (0, 61, 255),
    (0, 255, 112), (0, 255, 133), (255, 0, 0), (255, 163, 0),
    (255, 102, 0), (194, 255, 0), (0, 143, 255), (51, 255, 0),
    (0, 82, 255), (0, 255, 41), (0, 255, 173), (10, 0, 255),
    (173, 255, 0), (0, 255, 153), (255, 92, 0), (255, 0, 255),
    (255, 0, 245), (255, 0, 102), (255, 173, 0), (255, 0, 20),
    (255, 184, 184), (0, 31, 255), (0, 255, 61), (0, 71, 255),
    (255, 0, 204), (0, 255, 194), (0, 255, 82), (0, 10, 255),
    (0, 112, 255), (51, 0, 255), (0, 194, 255), (0, 122, 255),
    (0, 255, 163), (255, 153, 0), (0, 255, 10), (255, 112, 0),
    (143, 255, 0), (82, 0, 255), (163, 255, 0), (255, 235, 0),
    (8, 184, 170), (133, 0, 255), (0, 255, 92), (184, 0, 255),
    (255, 0, 31), (0, 184, 255), (0, 214, 255), (255, 0, 112),
    (92, 255, 0), (0, 224, 255), (112, 224, 255), (70, 184, 160),
    (163, 0, 255), (153, 0, 255), (71, 255, 0), (255, 0, 163),
    (255, 204, 0), (255, 0, 143), (0, 255, 235), (133, 255, 0),
    (255, 0, 235), (245, 0, 255), (255, 0, 122), (255, 245, 0),
    (10, 190, 212), (214, 255, 0), (0, 204, 255), (20, 0, 255),
    (255, 255, 0), (0, 153, 255), (0, 41, 255), (0, 255, 204),
    (41, 0, 255), (41, 255, 0), (173, 0, 255), (0, 245, 255),
    (71, 0, 255), (122, 0, 255), (0, 255, 184), (0, 92, 255),
    (184, 255, 0), (0, 133, 255), (255, 214, 0), (25, 194, 194),
    (102, 255, 0), (92, 0, 255),
]


def ade_palette(n: int = 150) -> np.ndarray:
    """[n, 3] colors in [0, 1]; past 150, a fixed generated fill."""
    pal = list(_ADE_PALETTE)
    rng = np.random.RandomState(37)
    while len(pal) < n:
        pal.append(tuple(int(v) for v in rng.randint(0, 255, 3)))
    return np.asarray(pal[:n], np.float32) / 255.0


def _ln(norm: nn.LayerNorm, x):
    """LayerNorm over the last axis, in f32 (x's dtype out)."""
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight.float(),
                        norm.bias.float(), norm.eps).to(x.dtype)


def _ln_nchw(norm, x):
    return nchw(_ln(norm, nhwc(x)))


class _CBlock(nn.Module):
    def __init__(self, dim: int, ratio: int):
        super().__init__()
        self.pos = nn.Conv2d(dim, dim, 3, groups=dim)
        self.conv1 = nn.Conv2d(dim, dim, 1)
        self.attn = nn.Conv2d(dim, dim, 5, groups=dim)
        self.conv2 = nn.Conv2d(dim, dim, 1)
        self.fc1 = nn.Conv2d(dim, dim * ratio, 1)
        self.fc2 = nn.Conv2d(dim * ratio, dim, 1)

    def forward(self, x):
        """x: the f32 residual stream; the convs in the weights' dtype."""
        d = self.pos.weight.dtype
        x = x + conv_nchw(self.pos, x.to(d)).float()
        h = conv_nchw(self.attn, conv_nchw(self.conv1, x.to(d)))
        x = x + conv_nchw(self.conv2, h).float()
        return x + conv_nchw(self.fc2, F.gelu(conv_nchw(
            self.fc1, x.to(d)))).float()


class _SABlock(nn.Module):
    def __init__(self, dim: int, ratio: int, heads: int):
        super().__init__()
        self.heads = heads
        self.pos = nn.Conv2d(dim, dim, 3, groups=dim)
        self.ln1 = nn.LayerNorm(dim)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.ln2 = nn.LayerNorm(dim)
        self.fc1 = nn.Linear(dim, dim * ratio)
        self.fc2 = nn.Linear(dim * ratio, dim)

    def forward(self, x):
        """x: the f32 residual stream; LayerNorms in f32, the convs,
        linears and attention in the weights' dtype."""
        d = self.pos.weight.dtype
        b, c, h, w = x.shape
        x = x + conv_nchw(self.pos, x.to(d)).float()
        t = nhwc(x).reshape(b, h * w, c)
        qkv = self.qkv(_ln(self.ln1, t).to(d)).reshape(
            b, h * w, 3, self.heads, c // self.heads)
        o = attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2])
        t = t + self.proj(o.reshape(b, h * w, c)).float()
        t = t + self.fc2(F.gelu(self.fc1(_ln(self.ln2, t).to(d)))).float()
        return nchw(t.reshape(b, h, w, c))


class _Patch(nn.Module):
    def __init__(self, c_in: int, dim: int, patch: int):
        super().__init__()
        self.proj = nn.Conv2d(c_in, dim, patch, stride=patch)
        self.norm = nn.LayerNorm(dim)


class _Backbone(nn.Module):
    def __init__(self, cfg: UniFormerConfig):
        super().__init__()
        patches, stages, c_prev = [], [], 3
        for si, (depth, dim) in enumerate(zip(cfg.layers, cfg.embed_dim)):
            patches.append(_Patch(c_prev, dim, 4 if si == 0 else 2))
            heads = dim // cfg.head_dim
            stages.append(nn.ModuleList(
                _CBlock(dim, cfg.mlp_ratio) if si < 2 else
                _SABlock(dim, cfg.mlp_ratio, heads) for _ in range(depth)))
            c_prev = dim
        self.patch = nn.ModuleList(patches)
        self.stages = nn.ModuleList(stages)
        self.norms = nn.ModuleList(nn.LayerNorm(d) for d in cfg.embed_dim)

    def forward(self, x):
        """x [B,3,H,W] -> the four stages' normalised outputs, NCHW in the
        weights' dtype. Between the convs the residual stream is f32."""
        outs = []
        for patch, blocks, norm in zip(self.patch, self.stages, self.norms):
            d = patch.proj.weight.dtype
            x = conv_nchw(patch.proj, x.to(d), stride=patch.proj.stride[0],
                          padding="VALID")
            x = _ln_nchw(patch.norm, x.float())
            for blk in blocks:
                x = blk(x)
            outs.append(_ln_nchw(norm, x).to(d))
        return outs


def adaptive_pool(x, k: int):
    """AdaptiveAvgPool2d(k) over NHWC on the JAX package's bins: segment i
    of k covers floor(i n / k) to ceil((i + 1) n / k)."""
    _, h, w, _ = x.shape
    rows = []
    for i in range(k):
        r = x[:, int(np.floor(i * h / k)):int(np.ceil((i + 1) * h / k))]
        rows.append(torch.stack([
            r[:, :, int(np.floor(j * w / k)):int(np.ceil((j + 1) * w / k))]
            .mean(dim=(1, 2)) for j in range(k)], dim=1))
    return torch.stack(rows, dim=1)


class _Head(nn.Module):
    def __init__(self, cfg: UniFormerConfig):
        super().__init__()
        f, dims = cfg.fpn_channels, cfg.embed_dim
        self.pool_scales = cfg.pool_scales
        self.psp = nn.ModuleList(nn.Conv2d(dims[-1], f, 1)
                                 for _ in cfg.pool_scales)
        self.bottleneck = nn.Conv2d(dims[-1] + f * len(cfg.pool_scales), f, 3)
        self.laterals = nn.ModuleList(nn.Conv2d(d, f, 1) for d in dims[:-1])
        self.fpn = nn.ModuleList(nn.Conv2d(f, f, 3) for _ in dims[:-1])
        self.fpn_bottleneck = nn.Conv2d(f * len(dims), f, 3)
        self.seg = nn.Conv2d(f, cfg.num_classes, 1)

    @staticmethod
    def _up(x, size):
        """NCHW x resized bilinearly as jax.image.resize does."""
        return nchw(resize(nhwc(x), tuple(size), "bilinear"))

    def forward(self, feats):
        """The four stage maps (NCHW) -> class logits NHWC, f32."""
        top = feats[-1]
        size = top.shape[2:]
        psp = [top]
        for scale, conv in zip(self.pool_scales, self.psp):
            p = nchw(adaptive_pool(nhwc(top), scale))
            psp.append(self._up(F.relu(conv_nchw(conv, p)), size))
        top = F.relu(conv_nchw(self.bottleneck, torch.cat(psp, dim=1)))
        lats = [F.relu(conv_nchw(conv, f))
                for conv, f in zip(self.laterals, feats[:-1])] + [top]
        for i in range(len(lats) - 1, 0, -1):
            lats[i - 1] = lats[i - 1] + self._up(lats[i],
                                                 lats[i - 1].shape[2:])
        outs = [F.relu(conv_nchw(conv, lat))
                for conv, lat in zip(self.fpn, lats[:-1])] + [lats[-1]]
        outs = [self._up(o, outs[0].shape[2:]) for o in outs]
        x = F.relu(conv_nchw(self.fpn_bottleneck, torch.cat(outs, dim=1)))
        return conv1x1_f32(self.seg, nhwc(x))


IMAGE_MEAN = (0.485, 0.456, 0.406)
IMAGE_STD = (0.229, 0.224, 0.225)


class UniFormer(nn.Module):
    """The segmentation model; ``forward`` is ``apply``."""

    def __init__(self, cfg: UniFormerConfig = UNIFORMER_SMALL):
        super().__init__()
        self.cfg = cfg
        self.backbone = _Backbone(cfg)
        self.head = _Head(cfg)

    @property
    def dtype(self):
        return self.backbone.patch[0].proj.weight.dtype

    def to_compute(self, dtype, device):
        self.to(device=device, dtype=dtype, memory_format=torch.channels_last)
        self.head.seg.float()
        return self

    def logits(self, images):
        """images [B,H,W,3] in [0,1] -> class logits [B,H,W,classes], f32
        (at the head's 1/4 size, resized to the image)."""
        b, h, w, _ = images.shape
        mean = torch.tensor(IMAGE_MEAN, device=images.device)
        std = torch.tensor(IMAGE_STD, device=images.device)
        x = nchw(((images.float() - mean) / std).to(self.dtype))
        return resize(self.head(self.backbone(x)), (h, w), "bilinear")

    def forward(self, images):
        """images [B,H,W,3] in [0,1] -> the ADE-palette render [B,H,W,3]."""
        classes = self.logits(images).argmax(dim=-1)
        pal = torch.from_numpy(ade_palette(self.cfg.num_classes))
        return pal.to(classes.device)[classes]


def random_uniformer(cfg: UniFormerConfig = UNIFORMER_TEST, seed: int = 0,
                     dtype=torch.float32, device="cuda") -> UniFormer:
    with torch.device(device):
        model = UniFormer(cfg)
    return random_init(model, seed).to_compute(dtype, torch.device(device))


# ----------------------------------------------------------------- loader


def _keys(model: UniFormer):
    """(module, published key prefix, its BatchNorm: (prefix, "before" |
    "after") or None) of every UniFormer parameter owner."""
    bb = model.backbone
    for si in range(4):
        pe = f"backbone.patch_embed{si + 1}"
        yield bb.patch[si].proj, f"{pe}.proj", None
        yield bb.patch[si].norm, f"{pe}.norm", None
        for bi, blk in enumerate(bb.stages[si]):
            pre = f"backbone.blocks{si + 1}.{bi}"
            yield blk.pos, f"{pre}.pos_embed", None
            if isinstance(blk, _CBlock):
                yield blk.conv1, f"{pre}.conv1", (f"{pre}.norm1", "before")
                yield blk.attn, f"{pre}.attn", None
                yield blk.conv2, f"{pre}.conv2", None
                yield blk.fc1, f"{pre}.mlp.fc1", (f"{pre}.norm2", "before")
                yield blk.fc2, f"{pre}.mlp.fc2", None
            else:
                yield blk.ln1, f"{pre}.norm1", None
                yield blk.qkv, f"{pre}.attn.qkv", None
                yield blk.proj, f"{pre}.attn.proj", None
                yield blk.ln2, f"{pre}.norm2", None
                yield blk.fc1, f"{pre}.mlp.fc1", None
                yield blk.fc2, f"{pre}.mlp.fc2", None
        yield bb.norms[si], f"backbone.norm{si + 1}", None
    hd, dh = model.head, "decode_head"

    def module(conv, pre):
        return conv, f"{pre}.conv", (f"{pre}.bn", "after")

    for i, conv in enumerate(hd.psp):
        yield module(conv, f"{dh}.psp_modules.{i}.1")
    yield module(hd.bottleneck, f"{dh}.bottleneck")
    for i, conv in enumerate(hd.laterals):
        yield module(conv, f"{dh}.lateral_convs.{i}")
    for i, conv in enumerate(hd.fpn):
        yield module(conv, f"{dh}.fpn_convs.{i}")
    yield module(hd.fpn_bottleneck, f"{dh}.fpn_bottleneck")
    yield hd.seg, f"{dh}.conv_seg", None


def _bn(state, pre, eps=1e-5):
    """(scale, shift) of an inference BatchNorm, numpy f32."""
    s = f32(state[f"{pre}.weight"]) / np.sqrt(
        f32(state[f"{pre}.running_var"]) + np.float32(eps))
    return s, f32(state[f"{pre}.bias"]) - f32(state[f"{pre}.running_mean"]) * s


def _config(state, head_dim: int) -> UniFormerConfig:
    dims, layers = [], []
    for si in range(1, 5):
        dims.append(int(np.shape(
            state[f"backbone.patch_embed{si}.proj.weight"])[0]))
        d = 0
        while f"backbone.blocks{si}.{d}.pos_embed.weight" in state:
            d += 1
        layers.append(d)
    return UniFormerConfig(
        layers=tuple(layers), embed_dim=tuple(dims), head_dim=head_dim,
        num_classes=int(np.shape(state["decode_head.conv_seg.weight"])[0]),
        fpn_channels=int(np.shape(
            state["decode_head.fpn_bottleneck.conv.weight"])[0]))


def load_uniformer(state: dict, dtype=torch.float32, device="cuda",
                   head_dim: int = 64):
    """An upernet_global_small-style mmseg checkpoint (``backbone.*``
    UniFormer, ``decode_head.*`` UPerHead; a "state_dict." prefix
    dropped) -> (model, its config). A CBlock's BatchNorms fold into the
    conv after them, the head's into the conv before."""
    if any(k.startswith("state_dict.") for k in state):
        state = {k[len("state_dict."):]: v for k, v in state.items()}
    cfg = _config(state, head_dim)
    with torch.device(device):
        model = UniFormer(cfg)
    names = {id(m): n for n, m in model.named_modules()}
    values = {}
    for mod, key, bn in _keys(model):
        w = f32(state[f"{key}.weight"])
        b = f32(state.get(f"{key}.bias", np.zeros(w.shape[0], np.float32)))
        if bn is not None and bn[1] == "before":   # conv(bn(x)), 1x1
            s, t = _bn(state, bn[0])
            b = b + np.einsum("oihw,i->o", w, t)
            w = w * s[None, :, None, None]
        elif bn is not None and f"{bn[0]}.weight" in state:
            s, t = _bn(state, bn[0])
            w, b = w * s[:, None, None, None], b * s + t
        pre = names[id(mod)]
        values[f"{pre}.weight"], values[f"{pre}.bias"] = w, b
    model = load_state(model, lambda p: values[p], "uniformer")
    return model.to_compute(dtype, torch.device(device)), cfg


def state_dict_uniformer(model: UniFormer) -> dict:
    """The model in the mmseg layout (f32 numpy): each head conv without a
    bias and its shift in an identity BatchNorm after it, an identity
    BatchNorm before each CBlock conv1 and fc1."""
    out: dict = {}
    for mod, key, bn in _keys(model):
        w = mod.weight.detach().float().cpu().numpy()
        b = mod.bias.detach().float().cpu().numpy()
        out[f"{key}.weight"] = w
        if bn is None:
            out[f"{key}.bias"] = b
            continue
        ident = identity_bn(w.shape[0] if bn[1] == "after" else w.shape[1])
        if bn[1] == "after":
            ident["bias"] = b
        else:
            out[f"{key}.bias"] = b
        out.update({f"{bn[0]}.{k}": v for k, v in ident.items()})
    return out
