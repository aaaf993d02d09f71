"""ESRGAN / Real-ESRGAN (RRDBNet) super-resolution on torch.

Counterpart of gyre_tpu/models/esrgan.py. ``RRDBNet`` is an ``nn.Module``
whose parameter names are both the JAX package's params tree
(``body[3]["rdb2"]["conv4"]["w"]``) and the BasicSR checkpoint's keys
(``body.3.rdb2.conv4.weight``), so ``models/modelset.py::esrgan_from_jax``
and ``load_esrgan`` fill it the same way. Activations NHWC, convs by
cuDNN in the model's dtype (bf16 on the card in the manager); the trunk's
residual stream (69 residual adds over 23 blocks) is carried in f32,
which holds bf16 to ~1e-2 of the f32 image where a bf16 stream drifts to
~3e-2. The output is clamped to [0, 1].

``load_esrgan`` reads the ``conv_first`` naming only, as the JAX loader
does (its docstring also names the old ``model.0.weight`` naming, which
its code does not read), and is strict: a missing or misshapen key
raises, and so does one it leaves unread.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from .layers import (conv_nhwc, export_keyed, load_keyed, random_init,
                     state_shape, upsample_nearest_2x)
from .swinir import lrelu


class _RDB(nn.Module):
    def __init__(self, nf: int, gc: int):
        super().__init__()
        for i in range(5):
            self.add_module(f"conv{i + 1}", nn.Conv2d(
                nf + i * gc, gc if i < 4 else nf, 3))

    def forward(self, x):
        """x: the f32 residual stream; the convs in the model's dtype."""
        feats = [x.to(self.conv1.weight.dtype)]
        for i in range(1, 5):
            feats.append(lrelu(conv_nhwc(getattr(self, f"conv{i}"),
                                         torch.cat(feats, -1))))
        return x + conv_nhwc(self.conv5, torch.cat(feats, -1)).float() * 0.2


class _RRDB(nn.Module):
    def __init__(self, nf: int, gc: int):
        super().__init__()
        self.rdb1, self.rdb2, self.rdb3 = (_RDB(nf, gc) for _ in range(3))

    def forward(self, x):
        return x + self.rdb3(self.rdb2(self.rdb1(x))) * 0.2


class RRDBNet(nn.Module):
    """``forward`` is ``esrgan.apply``: x [B,H,W,3] in [0,1] -> [B, scale*H,
    scale*W, 3] in the model's dtype."""

    def __init__(self, num_blocks: int = 23, nf: int = 64, gc: int = 32,
                 in_ch: int = 3, out_ch: int = 3):
        super().__init__()
        self.conv_first = nn.Conv2d(in_ch, nf, 3)
        self.body = nn.ModuleList(_RRDB(nf, gc) for _ in range(num_blocks))
        self.conv_body = nn.Conv2d(nf, nf, 3)
        self.conv_up1 = nn.Conv2d(nf, nf, 3)
        self.conv_up2 = nn.Conv2d(nf, nf, 3)
        self.conv_hr = nn.Conv2d(nf, nf, 3)
        self.conv_last = nn.Conv2d(nf, out_ch, 3)

    @property
    def dtype(self):
        return self.conv_first.weight.dtype

    def to_compute(self, dtype, device):
        return self.to(device=device, dtype=dtype,
                       memory_format=torch.channels_last)

    def forward(self, x, scale: int = 4):
        dt = self.dtype
        feat = conv_nhwc(self.conv_first, x.to(dt)).float()
        body = feat
        for blk in self.body:
            body = blk(body)
        feat = (feat + conv_nhwc(self.conv_body, body.to(dt)).float()).to(dt)
        if scale >= 2:
            feat = lrelu(conv_nhwc(self.conv_up1, upsample_nearest_2x(feat)))
        if scale >= 4:
            feat = lrelu(conv_nhwc(self.conv_up2, upsample_nearest_2x(feat)))
        out = conv_nhwc(self.conv_last, lrelu(conv_nhwc(self.conv_hr, feat)))
        return out.clamp(0.0, 1.0)


def random_esrgan(num_blocks: int = 23, seed: int = 0, dtype=torch.float32,
                  device="cuda", nf: int = 64, gc: int = 32) -> RRDBNet:
    """Real-ESRGAN x4plus's shape (23 blocks, nf 64, gc 32) at random."""
    with torch.device(device):
        model = RRDBNet(num_blocks, nf, gc)
    return random_init(model, seed).to_compute(dtype, torch.device(device))


def _keys(model: RRDBNet):
    for name, mod in model.named_modules():
        if isinstance(mod, nn.Conv2d):
            yield name, name


def load_esrgan(state: dict, dtype=torch.float32, device="cuda") -> RRDBNet:
    """A BasicSR RRDBNet checkpoint (``conv_first``, ``body.N.rdbM.convK``,
    ``conv_body``, ``conv_up1/2``, ``conv_hr``, ``conv_last``) -> the
    model; its blocks, widths and channels from the shapes."""
    n = 0
    while f"body.{n}.rdb1.conv1.weight" in state:
        n += 1
    nf, in_ch = state_shape(state, "conv_first.weight")[:2]
    gc = state_shape(state, "body.0.rdb1.conv1.weight")[0] if n else 32
    with torch.device(device):
        model = RRDBNet(n, nf, gc, in_ch,
                        state_shape(state, "conv_last.weight")[0])
    load_keyed(model, state, _keys(model), "esrgan")
    return model.to_compute(dtype, torch.device(device))


def state_dict_esrgan(model: RRDBNet) -> dict:
    """The model in the BasicSR layout (f32 numpy): ``load_esrgan`` and the
    JAX package's ``load_params`` read it back."""
    return export_keyed(model, _keys(model))
