"""Edge and line-art hinters: HED, informative drawings and DexiNed.

Counterpart of gyre_tpu/models/hinters.py's published models (its toy
depth, saliency and segmentation nets are not ported: no engine runs
them). Each is an ``nn.Module`` whose parameter names follow the JAX
package's params tree (``stages.2.1.weight`` is its
``stages[2][1]["w"]``, in torch's layout), so ``models/modelset.py``'s
bridges fill it from the JAX params:

  * ``HED``: VGG-16's five conv stages (2x2 average pools between them),
    a 1x1 side output a stage resized to the input bilinearly as
    ``jax.image.resize`` does (ops/resize.py), a 1x1 fusion and a
    sigmoid;
  * ``Drawings`` (informative drawings, the line-art generator):
    reflection-padded 7x7 stem, two stride-2 convs, residual blocks with
    affine-free InstanceNorm (statistics in f32), two transposed convs
    (stride 2, padding 1, output padding 1) and a 7x7 sigmoid head;
  * ``DexiNed``: the dense-inception edge detector with BatchNorm folded
    into its convs at load, its maxpool padded with -inf, its dense
    layers' (2, 0) conv padding and its transposed-conv up-blocks; the
    fused map min-max normalised per image.

The trunks run in the model's dtype (bf16 on the card, channels-last
NCHW); the side outputs, the fusion and the sigmoid in f32. Loaders read
the published checkpoints (``load_hed``, ``load_drawings``,
``load_dexined``, as lenient as the JAX package's: a missing bias or
BatchNorm is taken as none), and ``state_dict_*`` write a model back in
that layout (BatchNorms as identities).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.resize import resize
from .layers import (conv1x1_f32, conv_nchw, f32, fold_bn, identity_bn,
                     load_state, nchw, nhwc, random_init)

_VGG_STAGES = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
_HED_MEAN = (104.0, 117.0, 123.0)


def _put(out: dict, pre: str, conv, bias: bool = True, bn: str | None = None,
         eps: float = 1e-5):
    out[f"{pre}.weight"] = conv.weight.detach().float().cpu().numpy()
    if bias and conv.bias is not None:
        out[f"{pre}.bias"] = conv.bias.detach().float().cpu().numpy()
    if bn is not None:
        for k, v in identity_bn(conv.weight.shape[0], eps).items():
            out[f"{bn}.{k}"] = v


# -------------------------------------------------------------------- HED


class HED(nn.Module):
    """Holistically-nested edge detection over VGG-16; ``forward`` is
    ``hed_apply``."""

    def __init__(self):
        super().__init__()
        stages, c_prev = [], 3
        for c_out, n in _VGG_STAGES:
            convs = []
            for _ in range(n):
                convs.append(nn.Conv2d(c_prev, c_out, 3))
                c_prev = c_out
            stages.append(nn.ModuleList(convs))
        self.stages = nn.ModuleList(stages)
        self.sides = nn.ModuleList(nn.Conv2d(c, 1, 1) for c, _ in _VGG_STAGES)
        self.fuse = nn.Conv2d(len(_VGG_STAGES), 1, 1, bias=False)

    @property
    def dtype(self):
        return self.stages[0][0].weight.dtype

    def to_compute(self, dtype, device):
        self.to(device=device, dtype=dtype, memory_format=torch.channels_last)
        self.fuse.float()
        return self

    def forward(self, images):
        """images [B,H,W,3] in [0,1] -> soft edges [B,H,W,1] in [0,1], f32."""
        b, h, w, _ = images.shape
        mean = torch.tensor(_HED_MEAN, device=images.device)
        x = nchw((images.float() * 255.0 - mean).to(self.dtype))
        sides = []
        for i, (stage, side) in enumerate(zip(self.stages, self.sides)):
            if i:
                x = F.avg_pool2d(x, 2)
            for conv in stage:
                x = F.relu(conv_nchw(conv, x))
            s = nhwc(conv_nchw(side, x)).float()
            sides.append(resize(s, (h, w), "bilinear"))
        return torch.sigmoid(conv1x1_f32(self.fuse, torch.cat(sides, -1)))


def random_hed(seed: int = 0, dtype=torch.float32, device="cuda") -> HED:
    with torch.device(device):
        model = HED()
    return random_init(model, seed).to_compute(dtype, torch.device(device))


def _hed_keys(model: HED):
    """(module, published prefix) of every HED conv."""
    for i, stage in enumerate(model.stages):
        for j, conv in enumerate(stage):
            yield conv, f"conv{i + 1}_{j + 1}"
        yield model.sides[i], f"score_dsn{i + 1}"
    yield model.fuse, "score_final"


def load_hed(state: dict, dtype=torch.float32, device="cuda") -> HED:
    """The published HED checkpoint (caffe-style ``conv1_1`` ...
    ``score_dsn1`` ... ``score_final`` keys, the ControlNet annotator's)
    -> the model; a missing bias is zero, as in the JAX package."""
    with torch.device(device):
        model = HED()
    values = {}
    names = {id(m): n for n, m in model.named_modules()}
    for conv, key in _hed_keys(model):
        pre = names[id(conv)]
        values[f"{pre}.weight"] = state[f"{key}.weight"]
        if conv.bias is not None:
            values[f"{pre}.bias"] = state.get(
                f"{key}.bias", np.zeros(conv.weight.shape[0], np.float32))
    return load_state(model, lambda p: values[p], "hed").to_compute(
        dtype, torch.device(device))


def state_dict_hed(model: HED) -> dict:
    """The model in the published layout (f32 numpy): ``load_hed`` and
    the JAX package's ``load_hed_params`` read it back."""
    out: dict = {}
    for conv, key in _hed_keys(model):
        _put(out, key, conv)
    return out


# ---------------------------------------------------- informative drawings


def _instance_norm(x):
    """Affine-free InstanceNorm over NCHW, statistics in f32."""
    return F.instance_norm(x.float(), eps=1e-5).to(x.dtype)


def _reflect(x, pad: int):
    return F.pad(x, (pad, pad, pad, pad), mode="reflect")


class _ResBlock(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.conv1, self.conv2 = nn.Conv2d(c, c, 3), nn.Conv2d(c, c, 3)


class Drawings(nn.Module):
    """The informative-drawings line-art generator; ``forward`` is
    ``drawings_apply``."""

    def __init__(self, n_blocks: int = 9, base: int = 64):
        super().__init__()
        self.stem = nn.Conv2d(3, base, 7)
        self.down = nn.ModuleList([nn.Conv2d(base, base * 2, 3),
                                   nn.Conv2d(base * 2, base * 4, 3)])
        self.blocks = nn.ModuleList(_ResBlock(base * 4)
                                    for _ in range(n_blocks))
        self.up = nn.ModuleList([nn.ConvTranspose2d(base * 4, base * 2, 3),
                                 nn.ConvTranspose2d(base * 2, base, 3)])
        self.head = nn.Conv2d(base, 1, 7)

    @property
    def dtype(self):
        return self.stem.weight.dtype

    def to_compute(self, dtype, device):
        return self.to(device=device, dtype=dtype,
                       memory_format=torch.channels_last)

    def forward(self, images):
        """images [B,H,W,3] in [0,1] -> line art [B,H,W,1] in [0,1], f32."""
        x = nchw(images.to(self.dtype))
        x = F.relu(_instance_norm(conv_nchw(self.stem, _reflect(x, 3),
                                            padding="VALID")))
        for conv in self.down:
            x = F.relu(_instance_norm(conv_nchw(conv, x, stride=2,
                                                padding=1)))
        for blk in self.blocks:
            h = conv_nchw(blk.conv1, _reflect(x, 1), padding="VALID")
            h = F.relu(_instance_norm(h))
            h = conv_nchw(blk.conv2, _reflect(h, 1), padding="VALID")
            x = x + _instance_norm(h)
        for conv in self.up:
            x = F.conv_transpose2d(
                x.contiguous(memory_format=torch.channels_last),
                conv.weight.to(x.dtype), conv.bias.to(x.dtype), stride=2,
                padding=1, output_padding=1)
            x = F.relu(_instance_norm(x))
        x = conv_nchw(self.head, _reflect(x, 3), padding="VALID")
        return torch.sigmoid(nhwc(x).float())


def random_drawings(seed: int = 0, n_blocks: int = 9, base: int = 64,
                    dtype=torch.float32, device="cuda") -> Drawings:
    with torch.device(device):
        model = Drawings(n_blocks, base)
    return random_init(model, seed).to_compute(dtype, torch.device(device))


def _drawings_keys(model: Drawings):
    yield model.stem, "model0.1"
    yield model.down[0], "model1.0"
    yield model.down[1], "model1.3"
    for k, blk in enumerate(model.blocks):
        yield blk.conv1, f"model2.{k}.conv_block.1"
        yield blk.conv2, f"model2.{k}.conv_block.5"
    yield model.up[0], "model3.0"
    yield model.up[1], "model3.3"
    yield model.head, "model4.1"


def load_drawings(state: dict, dtype=torch.float32,
                  device="cuda") -> Drawings:
    """The published informative-drawings checkpoint (``model0.1`` /
    ``model1.{0,3}`` / ``model2.{k}.conv_block.{1,5}`` / ``model3.{0,3}``
    (transposed convs) / ``model4.1``) -> the model; the block count and
    base width from the keys."""
    n_blocks = 0
    while f"model2.{n_blocks}.conv_block.1.weight" in state:
        n_blocks += 1
    base = int(np.shape(state["model0.1.weight"])[0])
    with torch.device(device):
        model = Drawings(n_blocks, base)
    names = {id(m): n for n, m in model.named_modules()}
    values = {}
    for conv, key in _drawings_keys(model):
        pre = names[id(conv)]
        values[f"{pre}.weight"] = state[f"{key}.weight"]
        values[f"{pre}.bias"] = state.get(
            f"{key}.bias", np.zeros(conv.bias.shape[0], np.float32))
    return load_state(model, lambda p: values[p], "drawings").to_compute(
        dtype, torch.device(device))


def state_dict_drawings(model: Drawings) -> dict:
    out: dict = {}
    for conv, key in _drawings_keys(model):
        _put(out, key, conv)
    return out


# --------------------------------------------------------------- DexiNed

_DEXI_DENSE = ((2, 128, 256), (3, 256, 512), (3, 512, 512), (3, 512, 256))
_DEXI_UP = ((64, 1), (128, 1), (256, 2), (512, 3), (512, 4), (256, 4))
_DEXI_SIDES = (1, 2, 3, 5)          # the published names: no side_4
_DEXI_PRE = ((2, 128, 256), (3, 128, 256), (4, 256, 512), (5, 512, 512),
             (6, 512, 256))


class _DenseLayer(nn.Module):
    def __init__(self, ci: int, co: int):
        super().__init__()
        self.conv1, self.conv2 = nn.Conv2d(ci, co, 3), nn.Conv2d(co, co, 3)


class _UpStage(nn.Module):
    def __init__(self, ci: int, co: int, k: int):
        super().__init__()
        self.proj = nn.Conv2d(ci, co, 1)
        self.deconv = nn.ConvTranspose2d(co, co, k)


class DexiNed(nn.Module):
    """DexiNed with its BatchNorms folded; ``forward`` is
    ``dexined_apply``."""

    def __init__(self):
        super().__init__()
        self.block1 = nn.ModuleList([nn.Conv2d(3, 32, 3),
                                     nn.Conv2d(32, 64, 3)])
        self.block2 = nn.ModuleList([nn.Conv2d(64, 128, 3),
                                     nn.Conv2d(128, 128, 3)])
        self.side = nn.ModuleList([nn.Conv2d(64, 128, 1),
                                   nn.Conv2d(128, 256, 1),
                                   nn.Conv2d(256, 512, 1),
                                   nn.Conv2d(512, 512, 1)])
        self.pre = nn.ModuleDict({str(i): nn.Conv2d(ci, co, 1)
                                  for i, ci, co in _DEXI_PRE})
        self.dense = nn.ModuleList(
            nn.ModuleList(_DenseLayer(ci if i == 0 else co, co)
                          for i in range(n)) for n, ci, co in _DEXI_DENSE)
        ups = []
        for ci, scale in _DEXI_UP:
            stages = []
            for i in range(scale):
                co = 1 if i == scale - 1 else 16
                stages.append(_UpStage(ci, co, 2 ** scale))
                ci = co
            ups.append(nn.ModuleList(stages))
        self.up = nn.ModuleList(ups)
        self.fuse = nn.Conv2d(6, 1, 1)

    @property
    def dtype(self):
        return self.block1[0].weight.dtype

    def to_compute(self, dtype, device):
        self.to(device=device, dtype=dtype, memory_format=torch.channels_last)
        self.fuse.float()
        return self

    @staticmethod
    def _maxpool(x):
        return F.max_pool2d(x, 3, 2, padding=1)

    @staticmethod
    def _dense(blk, x, skip):
        # the published padding: conv1 2, conv2 0 (same size overall)
        for layer in blk:
            h = F.relu(conv_nchw(layer.conv1, F.relu(x), padding=2))
            x = 0.5 * (conv_nchw(layer.conv2, h, padding="VALID") + skip)
        return x

    @staticmethod
    def _up(stages, x):
        for st in stages:
            x = F.relu(conv_nchw(st.proj, x))
            k = st.deconv.weight.shape[-1]
            x = F.conv_transpose2d(
                x.contiguous(memory_format=torch.channels_last),
                st.deconv.weight.to(x.dtype), st.deconv.bias.to(x.dtype),
                stride=2, padding=(k - 2) // 2)
        return x

    def forward(self, images):
        """images [B,H,W,3] in [0,1] -> soft edges [B,H,W,1] in [0,1]
        (the fused head, min-max normalised per image), f32."""
        b, h, w, _ = images.shape
        x = nchw((images.float() * 255.0).to(self.dtype))
        b1 = F.relu(conv_nchw(self.block1[0], x, stride=2, padding=1))
        b1 = F.relu(conv_nchw(self.block1[1], b1))
        b1_side = conv_nchw(self.side[0], b1, stride=2)

        b2 = conv_nchw(self.block2[1], F.relu(conv_nchw(self.block2[0], b1)))
        b2_down = self._maxpool(b2)
        b2_add = b2_down + b1_side
        b2_side = conv_nchw(self.side[1], b2_add, stride=2)

        b3 = self._dense(self.dense[0], b2_add,
                         conv_nchw(self.pre["3"], b2_down))
        b3_down = self._maxpool(b3)
        b3_add = b3_down + b2_side
        b3_side = conv_nchw(self.side[2], b3_add, stride=2)

        b2_half = conv_nchw(self.pre["2"], b2_down, stride=2)
        b4 = self._dense(self.dense[1], b3_add,
                         conv_nchw(self.pre["4"], b3_down + b2_half))
        b4_down = self._maxpool(b4)
        b4_add = b4_down + b3_side
        b4_side = conv_nchw(self.side[3], b4_add)

        b5 = self._dense(self.dense[2], b4_add,
                         conv_nchw(self.pre["5"], b4_down)) + b4_side
        b6 = self._dense(self.dense[3], b5, conv_nchw(self.pre["6"], b5))

        sides = []
        for blk, stages in zip((b1, b2, b3, b4, b5, b6), self.up):
            o = nhwc(self._up(stages, blk)).float()
            if o.shape[1:3] != (h, w):
                o = resize(o, (h, w), "bilinear")
            sides.append(o)
        e = torch.sigmoid(conv1x1_f32(self.fuse, torch.cat(sides, -1)))
        lo = e.amin(dim=(1, 2, 3), keepdim=True)
        hi = e.amax(dim=(1, 2, 3), keepdim=True)
        return (e - lo) / torch.clamp(hi - lo, min=1e-6)


def random_dexined(seed: int = 0, dtype=torch.float32,
                   device="cuda") -> DexiNed:
    with torch.device(device):
        model = DexiNed()
    return random_init(model, seed).to_compute(dtype, torch.device(device))


def _dexined_keys(model: DexiNed):
    """(module, published conv prefix, its BatchNorm prefix or None, is a
    transposed conv) of every DexiNed conv."""
    for bi, blk in ((1, model.block1), (2, model.block2)):
        for j, conv in enumerate(blk, start=1):
            yield conv, f"block_{bi}.conv{j}", f"block_{bi}.bn{j}", False
    for conv, i in zip(model.side, _DEXI_SIDES):
        yield conv, f"side_{i}.conv", f"side_{i}.bn", False
    for i, conv in model.pre.items():
        yield conv, f"pre_dense_{i}.conv", f"pre_dense_{i}.bn", False
    for bi, blk in zip((3, 4, 5, 6), model.dense):
        for li, layer in enumerate(blk, start=1):
            pre = f"dblock_{bi}.denselayer{li}"
            yield layer.conv1, f"{pre}.conv1", f"{pre}.norm1", False
            yield layer.conv2, f"{pre}.conv2", f"{pre}.norm2", False
    for ui, stages in enumerate(model.up, start=1):
        for i, st in enumerate(stages):
            yield st.proj, f"up_block_{ui}.features.{i * 3}", None, False
            yield (st.deconv, f"up_block_{ui}.features.{i * 3 + 2}", None,
                   True)
    yield model.fuse, "block_cat.conv", "block_cat.bn", False


def load_dexined(state: dict, dtype=torch.float32,
                 device="cuda") -> DexiNed:
    """The published DexiNed checkpoint (the original repository's and
    kornia's module names: ``block_1.conv1``, ``dblock_3.denselayer1``,
    ``side_1.conv``, ``pre_dense_3.conv``, ``up_block_1.features.N``,
    ``block_cat.conv``) -> the model, each BatchNorm folded into its conv.
    A key it lacks raises KeyError (the JAX package's engine then
    random-inits; the port's raises)."""
    with torch.device(device):
        model = DexiNed()
    names = {id(m): n for n, m in model.named_modules()}
    values = {}
    for conv, key, bn, transposed in _dexined_keys(model):
        w = f32(state[f"{key}.weight"])
        n_out = w.shape[1] if transposed else w.shape[0]
        b = f32(state.get(f"{key}.bias", np.zeros(n_out, np.float32)))
        if not transposed:
            w, b = fold_bn(w, b, state, bn)
        pre = names[id(conv)]
        values[f"{pre}.weight"], values[f"{pre}.bias"] = w, b
    return load_state(model, lambda p: values[p], "dexined").to_compute(
        dtype, torch.device(device))


def state_dict_dexined(model: DexiNed) -> dict:
    """The model in the published layout, each BatchNorm an identity (the
    fusion conv has none there)."""
    out: dict = {}
    for conv, key, bn, _ in _dexined_keys(model):
        _put(out, key, conv, bn=None if key == "block_cat.conv" else bn)
    return out
