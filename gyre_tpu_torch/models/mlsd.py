"""M-LSD line-segment detection (MobileV2_MLSD_Large, the mlsd hinter).

Counterpart of gyre_tpu/models/mlsd.py, as an ``nn.Module`` whose
parameter names follow the JAX package's params tree
(``blocks.4.dw.weight`` is its ``blocks[4]["dw"]["w"]``; the tree's
``stride`` and ``res`` entries are the module's plan):

  * the trimmed MobileNetV2 backbone (BatchNorms folded at load, ReLU6),
    its stride-2 convs padded (0, 1) x (0, 1) and run VALID as the
    published TFLite-style net does, FPN taps after blocks 0, 2, 5, 9 and
    12, the BlockTypeA/B/C decoder with 2x bilinear upsampling on aligned
    corners (the JAX package's gather arithmetic), the 16-channel map;
  * ``detect_from_map``: the sigmoid centre heat (channel 7), 3x3
    max-pool NMS (``nms_heat``), then ``decode``: the ``top_k`` strongest
    by a stable descending sort
    (equal scores in index order, as ``lax.top_k``), their displacements
    (channels 8-11), score and length thresholds, the segments over the
    grid (a product with the f32 reciprocal, as XLA compiles a division by
    a constant);
  * ``render_segments``: a distance-to-segment rasteriser, white lines on
    black, in chunks of segments.

The input is resized to 512² as ``jax.image.resize`` does (ops/resize.py).
The trunk runs in the model's dtype (bf16 on the card); the last 1x1 conv
(centre heat and displacements) and the decode in f32. ``load_mlsd``
reads ``mlsd_large_512_fp32.pth`` strictly (every key but BatchNorm
``num_batches_tracked`` consumed); ``state_dict_mlsd`` writes a model in
that layout.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.resize import resize
from .layers import (conv1x1_f32, conv_nchw, f32, fold_bn, identity_bn,
                     linspace, load_state, nchw, nhwc, random_init)

# the inverted-residual plan (t, c, n, s): the published net stops after
# the 96-channel stage
_IR_PLAN = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2),
            (6, 64, 4, 2), (6, 96, 3, 1))
_FPN_BLOCKS = (0, 2, 5, 9, 12)   # features 1, 3, 6, 10, 13
_BLOCK_A = (("a15", 15, 64, 96), ("a17", 17, 32, 64), ("a19", 19, 24, 64),
            ("a21", 21, 16, 64))
_BLOCK_B = (("b16", 16), ("b18", 18), ("b20", 20), ("b22", 22))
_TLITE = ((0, 1), (0, 1))        # a stride-2 conv's padding

INPUT_SIZE = 512                  # the published checkpoint's resolution


def relu6(x):
    return torch.clamp(x, 0.0, 6.0)


class _IR(nn.Module):
    def __init__(self, c_in: int, c_out: int, stride: int, t: int):
        super().__init__()
        hidden = c_in * t
        self.stride, self.res = stride, stride == 1 and c_in == c_out
        self.expand = nn.Conv2d(c_in, hidden, 1) if t != 1 else None
        self.dw = nn.Conv2d(hidden, hidden, 3, groups=hidden)
        self.proj = nn.Conv2d(hidden, c_out, 1)

    def forward(self, x):
        h = x if self.expand is None else relu6(conv_nchw(self.expand, x))
        h = relu6(conv_nchw(self.dw, h, stride=self.stride,
                            padding=_TLITE if self.stride == 2 else "SAME"))
        h = conv_nchw(self.proj, h)
        return x + h if self.res else h


class _Pair(nn.Module):
    def __init__(self, c1_in, c1_out, k1, c2_in, c2_out, k2):
        super().__init__()
        self.conv1 = nn.Conv2d(c1_in, c1_out, k1)
        self.conv2 = nn.Conv2d(c2_in, c2_out, k2)


class _BlockC(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(64, 64, 3)
        self.conv2 = nn.Conv2d(64, 64, 3)
        self.conv3 = nn.Conv2d(64, 16, 1)


def upsample_align_corners(x, factor: int = 2):
    """NHWC bilinear upsampling on aligned corners, the JAX package's
    arithmetic: rows, then columns."""
    b, h, w, c = x.shape

    def axis(n_in, n_out):
        pos = linspace(n_in - 1.0, n_out, x.device)
        lo = torch.floor(pos).long()
        hi = torch.clamp(lo + 1, max=n_in - 1)
        return lo, hi, (pos - lo).to(x.dtype)

    y0, y1, fy = axis(h, h * factor)
    x0, x1, fx = axis(w, w * factor)
    xy = x[:, y0] * (1.0 - fy)[None, :, None, None] + \
        x[:, y1] * fy[None, :, None, None]
    return xy[:, :, x0] * (1.0 - fx)[None, None, :, None] + \
        xy[:, :, x1] * fx[None, None, :, None]


class MLSD(nn.Module):
    """MobileV2_MLSD_Large; ``forward`` is ``apply``."""

    def __init__(self):
        super().__init__()
        self.stem = nn.Conv2d(4, 32, 3)
        blocks, c_prev = [], 32
        for t, c, n, s in _IR_PLAN:
            for i in range(n):
                blocks.append(_IR(c_prev, c, s if i == 0 else 1, t))
                c_prev = c
        self.blocks = nn.ModuleList(blocks)
        for name, _, ci1, ci2 in _BLOCK_A:
            setattr(self, name, _Pair(ci2, 64, 1, ci1, 64, 1))
        for name, _ in _BLOCK_B:
            setattr(self, name, _Pair(128, 128, 3, 128, 64, 3))
        self.c23 = _BlockC()

    @property
    def dtype(self):
        return self.stem.weight.dtype

    def to_compute(self, dtype, device):
        self.to(device=device, dtype=dtype, memory_format=torch.channels_last)
        self.c23.conv3.float()
        return self

    @staticmethod
    def _block_a(p, a, b, upscale=True):
        b = F.relu(conv_nchw(p.conv1, b))
        a = F.relu(conv_nchw(p.conv2, a))
        if upscale:
            b = nchw(upsample_align_corners(nhwc(b), 2))
        return torch.cat([a, b], dim=1)

    @staticmethod
    def _block_b(p, x):
        x = F.relu(conv_nchw(p.conv1, x)) + x
        return F.relu(conv_nchw(p.conv2, x))

    def tp_map(self, x):
        """x [B,H,W,4] (RGB * 2 - 1 and a ones channel) -> the 16-channel
        map [B,H/2,W/2,16], f32."""
        f = relu6(conv_nchw(self.stem, nchw(x.to(self.dtype)), stride=2,
                            padding=_TLITE))
        taps = []
        for i, blk in enumerate(self.blocks):
            f = blk(f)
            if i in _FPN_BLOCKS:
                taps.append(f)
        c1, c2, c3, c4, c5 = taps
        h = self._block_b(self.b16, self._block_a(self.a15, c4, c5, False))
        h = self._block_b(self.b18, self._block_a(self.a17, c3, h))
        h = self._block_b(self.b20, self._block_a(self.a19, c2, h))
        h = self._block_b(self.b22, self._block_a(self.a21, c1, h))
        c = self.c23
        h = F.relu(conv_nchw(c.conv1, h, padding=5, dilation=5))
        h = F.relu(conv_nchw(c.conv2, h))
        return conv1x1_f32(c.conv3, nhwc(h))

    def detect(self, images, top_k: int = 200, score_thr: float = 0.10,
               dist_thr: float = 0.10, input_size: int = INPUT_SIZE):
        """images [B,H,W,3] in [0,1] -> (segments [B,K,4] (x1,y1,x2,y2) in
        0..1, valid [B,K] 0/1, scores [B,K])."""
        b = images.shape[0]
        x = resize(images.float(), (input_size, input_size), "bilinear")
        x = x * 2.0 - 1.0
        x = torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)
        return detect_from_map(self.tp_map(x), top_k, score_thr, dist_thr)

    def forward(self, images):
        """images [B,H,W,3] in [0,1] -> line map [B,H,W,3] (white on
        black), f32."""
        segs, valid, _ = self.detect(images)
        lines = render_segments(segs, valid, images.shape[1],
                                images.shape[2])
        return lines.repeat(1, 1, 1, 3)


def nms_heat(center, ksize: int = 3):
    """sigmoid, then keep the local maxima of a ksize² window (0
    elsewhere): center [B,h,w] f32."""
    heat = torch.sigmoid(center)
    hmax = F.max_pool2d(heat[:, None], ksize, 1, (ksize - 1) // 2)[:, 0]
    return torch.where(hmax == heat, heat, torch.zeros_like(heat))


def detect_from_map(tp, top_k: int = 200, score_thr: float = 0.10,
                    dist_thr: float = 0.10):
    """The published decode of the 16-channel map tp [B,gh,gw,16]: the NMS'd
    centre heat of channel 7, the displacements of channels 8-11."""
    return decode(nms_heat(tp[..., 7]), tp[..., 8:12], top_k, score_thr,
                  dist_thr)


def decode(heat, disp, top_k: int = 200, score_thr: float = 0.10,
           dist_thr: float = 0.10):
    """NMS'd heat [B,gh,gw] and displacements [B,gh,gw,4] -> (segments
    [B,K,4] (x1,y1,x2,y2) normalised by the grid, valid [B,K], scores
    [B,K]): the ``top_k`` strongest peaks, those over ``score_thr`` and
    longer than ``dist_thr`` grid pixels valid."""
    b, gh, gw = heat.shape
    scores, idx = torch.sort(heat.reshape(b, gh * gw), dim=-1,
                             descending=True, stable=True)
    scores, idx = scores[:, :top_k], idx[:, :top_k]
    yy = (idx // gw).float()
    xx = (idx % gw).float()
    d = torch.gather(disp.reshape(b, gh * gw, 4), 1,
                     idx[..., None].expand(b, idx.shape[1], 4))
    x1, y1 = xx + d[..., 0], yy + d[..., 1]
    x2, y2 = xx + d[..., 2], yy + d[..., 3]
    length = torch.sqrt((x2 - x1) ** 2 + (y2 - y1) ** 2)
    valid = ((scores > score_thr) & (length > dist_thr)).float()
    rw, rh = (float(np.float32(1.0) / np.float32(n)) for n in (gw, gh))
    segs = torch.stack([x1 * rw, y1 * rh, x2 * rw, y2 * rh], dim=-1)
    return torch.clamp(segs, 0.0, 1.0), valid, scores


def render_segments(segments, valid, height: int, width: int,
                    chunk: int = 25):
    """segments [B,K,4] in 0..1, valid [B,K] -> [B,H,W,1]: a ~1 px stroke
    at each valid segment, ``chunk`` segments at a time."""
    b, k, _ = segments.shape
    dev = segments.device
    half_w = 1.0 / max(height, width)
    yy = linspace(1.0, height, dev)[None, None, :, None]
    xx = linspace(1.0, width, dev)[None, None, None, :]
    acc = torch.zeros((b, height, width), device=dev)
    for s in range(0, k, chunk):
        seg, ok = segments[:, s:s + chunk], valid[:, s:s + chunk]
        x1, y1 = seg[..., 0][..., None, None], seg[..., 1][..., None, None]
        x2, y2 = seg[..., 2][..., None, None], seg[..., 3][..., None, None]
        dx, dy = x2 - x1, y2 - y1
        len2 = torch.clamp(dx * dx + dy * dy, min=1e-8)
        t = torch.clamp(((xx - x1) * dx + (yy - y1) * dy) / len2, 0.0, 1.0)
        dist2 = (xx - x1 - t * dx) ** 2 + (yy - y1 - t * dy) ** 2
        hit = ((dist2 < half_w * half_w).float() *
               ok[..., None, None]).amax(dim=1)
        acc = torch.maximum(acc, hit)
    return acc[..., None]


def random_mlsd(seed: int = 0, dtype=torch.float32, device="cuda") -> MLSD:
    with torch.device(device):
        model = MLSD()
    return random_init(model, seed).to_compute(dtype, torch.device(device))


# ------------------------------------------------------------------- load


def _keys(model: MLSD):
    """(conv, published prefix, its BatchNorm prefix or None, the
    published conv has a bias) of every M-LSD conv."""
    yield model.stem, "backbone.features.0.0", "backbone.features.0.1", False
    for fi, blk in enumerate(model.blocks, start=1):
        pre = f"backbone.features.{fi}.conv"
        if blk.expand is None:
            yield blk.dw, f"{pre}.0.0", f"{pre}.0.1", False
            yield blk.proj, f"{pre}.1", f"{pre}.2", False
        else:
            yield blk.expand, f"{pre}.0.0", f"{pre}.0.1", False
            yield blk.dw, f"{pre}.1.0", f"{pre}.1.1", False
            yield blk.proj, f"{pre}.2", f"{pre}.3", False
    for name, idx in [(n, i) for n, i, *_ in _BLOCK_A] + list(_BLOCK_B):
        p = getattr(model, name)
        yield p.conv1, f"block{idx}.conv1.0", f"block{idx}.conv1.1", True
        yield p.conv2, f"block{idx}.conv2.0", f"block{idx}.conv2.1", True
    yield model.c23.conv1, "block23.conv1.0", "block23.conv1.1", True
    yield model.c23.conv2, "block23.conv2.0", "block23.conv2.1", True
    yield model.c23.conv3, "block23.conv3", None, True


def load_mlsd(state: dict, dtype=torch.float32, device="cuda") -> MLSD:
    """``mlsd_large_512_fp32.pth`` -> the model, BatchNorms folded.
    Strict: a key left over (but ``num_batches_tracked``) raises."""
    with torch.device(device):
        model = MLSD()
    names = {id(m): n for n, m in model.named_modules()}
    values, used = {}, set()
    for conv, key, bn, _ in _keys(model):
        w = f32(state[f"{key}.weight"])
        b = f32(state.get(f"{key}.bias", np.zeros(w.shape[0], np.float32)))
        used.update({f"{key}.weight", f"{key}.bias"})
        if bn is not None:
            used.update(f"{bn}.{k}" for k in ("weight", "bias",
                                              "running_mean", "running_var"))
            w, b = fold_bn(w, b, state, bn)
        pre = names[id(conv)]
        values[f"{pre}.weight"], values[f"{pre}.bias"] = w, b
    left = [k for k in state if k not in used
            and not k.endswith("num_batches_tracked")]
    if left:
        raise KeyError(f"unconsumed M-LSD checkpoint keys: {left[:8]}"
                       f"{'...' if len(left) > 8 else ''}")
    return load_state(model, lambda p: values[p], "mlsd").to_compute(
        dtype, torch.device(device))


def state_dict_mlsd(model: MLSD) -> dict:
    """The model in the published layout (f32 numpy): a conv that has no
    bias there puts its shift in the identity BatchNorm after it."""
    out: dict = {}
    for conv, key, bn, has_bias in _keys(model):
        b = conv.bias.detach().float().cpu().numpy()
        out[f"{key}.weight"] = conv.weight.detach().float().cpu().numpy()
        if has_bias:
            out[f"{key}.bias"] = b
        if bn is not None:
            ident = identity_bn(b.shape[0])
            if not has_bias:
                ident["bias"] = b
            out.update({f"{bn}.{k}": v for k, v in ident.items()})
    return out
