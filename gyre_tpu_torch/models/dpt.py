"""DPT (Dense Prediction Transformer) monocular depth: MiDaS v3 DPT-Large.

Counterpart of gyre_tpu/models/dpt.py, as an ``nn.Module`` whose parameter
names follow the JAX package's params tree (``blocks.3.q.weight`` is its
``blocks[3]["q"]["w"]``, in torch's layout). It is made of:

  * the ViT backbone (patch conv, class token, position embedding resized
    bilinearly for a grid other than the native one, pre-norm blocks with
    LayerNorm at eps 1e-12 computed in f32, exact GELU), its
    self-attention through ``ops/attention.py::attention`` (on the card,
    K1) and the token maps of the tapped blocks;
  * the neck: readout projection (the class token concatenated onto every
    token, linear, GELU), reassembly to four resolutions (a 1x1 conv, then
    a stride-4 or stride-2 transposed conv, nothing, or a stride-2 3x3
    conv), 3x3 convs to the fusion width, and four fusion blocks (ReLU ->
    conv residual units, upsampled 2x with aligned corners, a 1x1 conv);
  * the head (3x3 conv, 2x upsample, 3x3 conv, ReLU, 1x1 conv, ReLU), its
    last two convs in f32 whatever the trunk's dtype, and
    ``apply_features``' taps for ZoeDepth;
  * ``estimate_depth``: an image to the normalised inverse-depth hint map,
    min-max normalised per image in f32 (a bf16 range would collapse a
    nearly flat map).

Every conv pads as the JAX package's "SAME" (for a stride-2 conv over an
even size that is one row and column at the end, where torch's
``padding=1`` puts one at each side), and ``resize_bilinear`` follows its
index and clip rule, ``align_corners`` included, rather than
``F.interpolate``.

``load_dpt`` reads both published layouts, transformers'
(``Intel/dpt-large``: ``dpt.encoder.layer.N``, ``neck``, ``head.head``)
and MiDaS's (``pretrained.model.blocks.N`` with packed qkv, ``scratch``),
strictly: a leftover, missing or misshapen key raises.
``state_dict_hf`` writes a model in the transformers layout.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import attention
from .layers import conv_nchw, load_state, nchw, nhwc, state_shape


@dataclass(frozen=True)
class DPTConfig:
    hidden: int = 1024
    layers: int = 24
    heads: int = 16
    mlp: int = 4096
    patch: int = 16
    hooks: tuple = (5, 11, 17, 23)      # encoder layers tapped by the neck
    neck_ch: tuple = (256, 512, 1024, 1024)
    fusion: int = 256
    grid: int = 24                      # native pos-embed grid (384/16)


DPT_LARGE = DPTConfig()
DPT_TEST = DPTConfig(hidden=32, layers=4, heads=2, mlp=64, patch=16,
                     hooks=(0, 1, 2, 3), neck_ch=(16, 24, 32, 32),
                     fusion=24, grid=4)


def resize_bilinear(x, size, align_corners: bool = False):
    """[B,H,W,C] bilinear resize by the JAX package's rule: sample
    positions (i + 0.5) * H / h - 0.5 clipped to [0, H - 1] (or spaced
    evenly from 0 to H - 1 with ``align_corners``), the two neighbours
    floor and floor + 1 (clipped), lerped by the fraction."""
    _, in_h, in_w, _ = x.shape
    h, w = size
    if (in_h, in_w) == (h, w):
        return x
    dev = x.device

    def positions(n_in, n_out):
        if align_corners:       # jnp.linspace's arithmetic
            step = torch.arange(n_out - 1, dtype=torch.float32,
                                device=dev) / max(n_out - 1, 1)
            return torch.cat([(n_in - 1.0) * step, torch.full(
                (1,), float(n_in - 1 if n_out > 1 else 0), device=dev)])
        pos = (torch.arange(n_out, device=dev, dtype=torch.float32) + 0.5) \
            * (n_in / n_out) - 0.5
        return pos.clamp(0, n_in - 1)

    ys, xs = positions(in_h, h), positions(in_w, w)
    y0, x0 = ys.floor().long(), xs.floor().long()
    y1 = (y0 + 1).clamp(max=in_h - 1)
    x1 = (x0 + 1).clamp(max=in_w - 1)
    wy = (ys - y0)[None, :, None, None].to(x.dtype)
    wx = (xs - x0)[None, None, :, None].to(x.dtype)
    r0, r1 = x[:, y0], x[:, y1]
    top = r0[:, :, x0] * (1 - wx) + r0[:, :, x1] * wx
    bot = r1[:, :, x0] * (1 - wx) + r1[:, :, x1] * wx
    return top * (1 - wy) + bot * wy


def _resize_nchw(x, size, align_corners: bool = False):
    return nchw(resize_bilinear(nhwc(x), size, align_corners))


class _Block(nn.Module):
    def __init__(self, cfg: DPTConfig):
        super().__init__()
        h = cfg.hidden
        self.heads = cfg.heads
        self.ln1 = nn.LayerNorm(h, eps=1e-12)
        self.q, self.k, self.v = nn.Linear(h, h), nn.Linear(h, h), \
            nn.Linear(h, h)
        self.proj = nn.Linear(h, h)
        self.ln2 = nn.LayerNorm(h, eps=1e-12)
        self.fc1, self.fc2 = nn.Linear(h, cfg.mlp), nn.Linear(cfg.mlp, h)

    @staticmethod
    def _ln(norm: nn.LayerNorm, x):
        return F.layer_norm(x.float(), norm.normalized_shape,
                            norm.weight.float(), norm.bias.float(),
                            norm.eps).to(x.dtype)

    def forward(self, x):
        b, n, h = x.shape
        y = self._ln(self.ln1, x)
        q, k, v = (lin(y).view(b, n, self.heads, h // self.heads)
                   for lin in (self.q, self.k, self.v))
        x = x + self.proj(attention(q, k, v).reshape(b, n, h))
        return x + self.fc2(F.gelu(self.fc1(self._ln(self.ln2, x))))


class _Reassemble(nn.Module):
    def __init__(self, hidden: int, ch: int, level: int):
        super().__init__()
        self.level = level
        self.proj = nn.Conv2d(hidden, ch, 1)
        if level in (0, 1):
            s = 4 if level == 0 else 2
            self.resize = nn.ConvTranspose2d(ch, ch, s, stride=s)
        elif level == 3:
            self.resize = nn.Conv2d(ch, ch, 3)

    def forward(self, x):
        x = conv_nchw(self.proj, x)
        if self.level in (0, 1):
            return F.conv_transpose2d(x, self.resize.weight.to(x.dtype),
                                      self.resize.bias.to(x.dtype),
                                      stride=self.resize.stride)
        if self.level == 3:
            return conv_nchw(self.resize, x, stride=2)
        return x


class _Fusion(nn.Module):
    def __init__(self, f: int):
        super().__init__()
        self.proj = nn.Conv2d(f, f, 1)
        self.r1c1, self.r1c2 = nn.Conv2d(f, f, 3), nn.Conv2d(f, f, 3)
        self.r2c1, self.r2c2 = nn.Conv2d(f, f, 3), nn.Conv2d(f, f, 3)

    @staticmethod
    def _unit(c1, c2, x):
        return x + conv_nchw(c2, F.relu(conv_nchw(c1, F.relu(x))))

    def forward(self, fused, lateral):
        if fused is None:
            fused = lateral
        else:
            if fused.shape[2:] != lateral.shape[2:]:
                lateral = _resize_nchw(lateral, fused.shape[2:])
            fused = fused + self._unit(self.r1c1, self.r1c2, lateral)
        fused = self._unit(self.r2c1, self.r2c2, fused)
        fused = _resize_nchw(fused, (fused.shape[2] * 2, fused.shape[3] * 2),
                             align_corners=True)
        return conv_nchw(self.proj, fused)


class _Head(nn.Module):
    def __init__(self, f: int):
        super().__init__()
        self.c0 = nn.Conv2d(f, f // 2, 3)
        self.c2 = nn.Conv2d(f // 2, 32, 3)
        self.c4 = nn.Conv2d(32, 1, 1)


class DPT(nn.Module):
    """DPT over a ViT backbone; ``forward`` is ``apply``."""

    def __init__(self, cfg: DPTConfig = DPT_LARGE):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden
        self.cls = nn.Parameter(torch.zeros(1, 1, h))
        self.pos = nn.Parameter(torch.zeros(1, cfg.grid * cfg.grid + 1, h))
        self.patch = nn.Conv2d(3, h, cfg.patch, stride=cfg.patch)
        self.blocks = nn.ModuleList(_Block(cfg) for _ in range(cfg.layers))
        self.readout = nn.ModuleList(nn.Linear(2 * h, h) for _ in range(4))
        self.reassemble = nn.ModuleList(
            _Reassemble(h, ch, i) for i, ch in enumerate(cfg.neck_ch))
        self.convs = nn.ModuleList(nn.Conv2d(ch, cfg.fusion, 3, bias=False)
                                   for ch in cfg.neck_ch)
        self.fusion = nn.ModuleList(_Fusion(cfg.fusion) for _ in range(4))
        self.head = _Head(cfg.fusion)

    @property
    def dtype(self):
        return self.patch.weight.dtype

    def to_compute(self, dtype, device):
        """The model in ``dtype`` on ``device``, its head kept in f32, the
        conv weights channels-last (as _conv runs them)."""
        self.to(device=device, dtype=dtype,
                memory_format=torch.channels_last)
        self.head.float()
        return self

    def backbone(self, x):
        """Normalised image [B,H,W,3] -> the tapped blocks' token maps
        (class token first)."""
        cfg = self.cfg
        b, hh, ww, _ = x.shape
        gh, gw = hh // cfg.patch, ww // cfg.patch
        tok = F.conv2d(nchw(x.to(self.dtype)), self.patch.weight,
                       self.patch.bias, stride=cfg.patch)
        tok = tok.flatten(2).transpose(1, 2)
        seq = torch.cat([self.cls.expand(b, 1, cfg.hidden).to(tok.dtype),
                         tok], dim=1)
        pos = self.pos
        if (gh, gw) != (cfg.grid, cfg.grid):
            grid = pos[:, 1:].reshape(1, cfg.grid, cfg.grid, cfg.hidden)
            grid = resize_bilinear(grid, (gh, gw))
            pos = torch.cat([pos[:, :1], grid.reshape(1, gh * gw,
                                                      cfg.hidden)], dim=1)
        seq = seq + pos
        taps = []
        for i, block in enumerate(self.blocks):
            seq = block(seq)
            if i in cfg.hooks:
                taps.append(seq)
        return taps

    def neck(self, taps, gh: int, gw: int):
        """Token maps -> (fusion outputs coarse to fine, the four
        laterals), NCHW."""
        feats = []
        for i, seq in enumerate(taps):
            cls, tokens = seq[:, :1], seq[:, 1:]
            t = F.gelu(self.readout[i](
                torch.cat([tokens, cls.expand_as(tokens)], dim=-1)))
            fmap = nchw(t.reshape(t.shape[0], gh, gw, t.shape[-1]))
            fmap = self.reassemble[i](fmap)
            feats.append(conv_nchw(self.convs[i], fmap))
        fused, out = None, []
        for block, lateral in zip(self.fusion, feats[::-1]):
            fused = block(fused, lateral)
            out.append(fused)
        return out, feats

    def apply_features(self, x):
        """Normalised image [B,H,W,3] -> the feature surface ZoeDepth reads,
        NHWC: rel_depth (the head's output), out_conv (the head's 32-channel
        activation), l4_rn (the coarsest lateral) and r4..r1 (the fusion
        outputs, coarse to fine); those after the head's first conv in
        f32."""
        cfg = self.cfg
        taps = self.backbone(x)
        fused, laterals = self.neck(taps, x.shape[1] // cfg.patch,
                                    x.shape[2] // cfg.patch)
        hd = self.head
        # the first conv in the trunk's dtype (cuDNN runs an f32 3x3 conv
        # at 192² as an FFT, a matrix-vector product a frequency bin: ~100
        # ms on the card), the last two in f32
        y = conv_nchw(hd.c0, fused[-1])
        y = _resize_nchw(y, (y.shape[2] * 2, y.shape[3] * 2),
                         align_corners=True)
        out_conv = F.relu(conv_nchw(hd.c2, y.float()))
        y = F.relu(conv_nchw(hd.c4, out_conv))
        return {"rel_depth": nhwc(y), "out_conv": nhwc(out_conv),
                "l4_rn": nhwc(laterals[3]),
                "r4": nhwc(fused[0]), "r3": nhwc(fused[1]),
                "r2": nhwc(fused[2]), "r1": nhwc(fused[3])}

    def forward(self, x):
        """Normalised image [B,H,W,3] (H, W multiples of the patch) ->
        relative inverse depth [B,H/2,W/2,1], f32."""
        return self.apply_features(x)["rel_depth"]


def estimate_depth(model: DPT, image, size: int = 384):
    """Image [B,H,W,3] in [0,1] -> inverse-depth hint [B,H,W,1] in [0,1]:
    resized to size², normalised to [-1, 1], the depth resized back and
    min-max normalised per image, in f32."""
    _, h, w, _ = image.shape
    x = resize_bilinear(image.float(), (size, size))
    d = resize_bilinear(model((x - 0.5) / 0.5).float(), (h, w))
    lo = d.amin(dim=(1, 2, 3), keepdim=True)
    hi = d.amax(dim=(1, 2, 3), keepdim=True)
    return (d - lo) / torch.clamp(hi - lo, min=1e-6)


def random_dpt(cfg: DPTConfig = DPT_TEST, seed: int = 0,
               dtype=torch.float32, device="cuda") -> DPT:
    """Random weights from a generator seeded ``seed``: linear and conv
    weights and biases uniform in +-1/sqrt(fan_in), norm scales 1, the
    class token 0, the position embedding N(0, 0.02^2), and the head's
    last biases lifted so that its two ReLUs pass a varying map (as the
    JAX package's init does)."""
    model = DPT(cfg)
    gen = torch.Generator().manual_seed(int(seed))
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name == "cls" or name.endswith(("ln1.bias", "ln2.bias")):
                p.zero_()
            elif name.endswith(("ln1.weight", "ln2.weight")):
                p.fill_(1.0)
            elif name == "pos":
                p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
            else:
                # (a transposed conv's in and out channels are equal here)
                w = model.get_submodule(name.rsplit(".", 1)[0]).weight
                lim = (w.shape[1] * int(np.prod(w.shape[2:]))) ** -0.5
                p.copy_((torch.rand(p.shape, generator=gen) * 2 - 1) * lim)
        model.head.c2.bias.abs_().add_(0.05)
        model.head.c4.bias.fill_(0.2)
    return model.to_compute(dtype, device)


# ------------------------------------------------------------------ load

_HF_BLOCK = {"ln1": "layernorm_before", "q": "attention.attention.query",
             "k": "attention.attention.key",
             "v": "attention.attention.value",
             "proj": "attention.output.dense", "ln2": "layernorm_after",
             "fc1": "intermediate.dense", "fc2": "output.dense"}
_HF_FUSION = {"proj": "projection",
              "r1c1": "residual_layer1.convolution1",
              "r1c2": "residual_layer1.convolution2",
              "r2c1": "residual_layer2.convolution1",
              "r2c2": "residual_layer2.convolution2"}
_MIDAS_BLOCK = {"ln1": "norm1", "proj": "attn.proj", "ln2": "norm2",
                "fc1": "mlp.fc1", "fc2": "mlp.fc2"}
_MIDAS_FUSION = {"proj": "out_conv", "r1c1": "resConfUnit1.conv1",
                 "r1c2": "resConfUnit1.conv2", "r2c1": "resConfUnit2.conv1",
                 "r2c2": "resConfUnit2.conv2"}


def hf_key(name: str) -> str:
    """A DPT parameter's key in the transformers layout."""
    part = name.split(".")
    kind = part[-1]
    if name == "cls":
        return "dpt.embeddings.cls_token"
    if name == "pos":
        return "dpt.embeddings.position_embeddings"
    if part[0] == "patch":
        return f"dpt.embeddings.patch_embeddings.projection.{kind}"
    if part[0] == "blocks":
        return f"dpt.encoder.layer.{part[1]}.{_HF_BLOCK[part[2]]}.{kind}"
    if part[0] == "readout":
        return f"neck.reassemble_stage.readout_projects.{part[1]}.0.{kind}"
    if part[0] == "reassemble":
        sub = "projection" if part[2] == "proj" else "resize"
        return f"neck.reassemble_stage.layers.{part[1]}.{sub}.{kind}"
    if part[0] == "convs":
        return f"neck.convs.{part[1]}.{kind}"
    if part[0] == "fusion":
        return f"neck.fusion_stage.layers.{part[1]}.{_HF_FUSION[part[2]]}" \
            f".{kind}"
    return f"head.head.{part[1][1:]}.{kind}"


def midas_key(name: str) -> str:
    """A DPT parameter's key in the MiDaS layout (q, k and v are slices
    of one packed ``attn.qkv``)."""
    part = name.split(".")
    kind = part[-1]
    if name == "cls":
        return "pretrained.model.cls_token"
    if name == "pos":
        return "pretrained.model.pos_embed"
    if part[0] == "patch":
        return f"pretrained.model.patch_embed.proj.{kind}"
    if part[0] == "blocks":
        sub = "attn.qkv" if part[2] in "qkv" else _MIDAS_BLOCK[part[2]]
        return f"pretrained.model.blocks.{part[1]}.{sub}.{kind}"
    if part[0] == "readout":
        return f"pretrained.act_postprocess{int(part[1]) + 1}.0.project.0." \
            f"{kind}"
    if part[0] == "reassemble":
        idx = 3 if part[2] == "proj" else 4
        return f"pretrained.act_postprocess{int(part[1]) + 1}.{idx}.{kind}"
    if part[0] == "convs":
        return f"scratch.layer{int(part[1]) + 1}_rn.{kind}"
    if part[0] == "fusion":
        return f"scratch.refinenet{4 - int(part[1])}." \
            f"{_MIDAS_FUSION[part[2]]}.{kind}"
    return f"scratch.output_conv.{part[1][1:]}.{kind}"


def _default_hooks(layers: int) -> tuple:
    """The published taps: every layers/4-th block's output."""
    q = layers // 4
    return tuple(q * (k + 1) - 1 for k in range(4))


def _config(state, midas: bool) -> DPTConfig:
    key = midas_key if midas else hf_key
    pos = state_shape(state, key("pos"))
    hidden = pos[-1]
    blocks = "pretrained.model.blocks." if midas else "dpt.encoder.layer."
    layers = 1 + max(int(k[len(blocks):].split(".")[0]) for k in state
                     if k.startswith(blocks))
    return DPTConfig(
        hidden=hidden, layers=layers, heads=max(1, hidden // 64),
        mlp=state_shape(state, key("blocks.0.fc1.weight"))[0],
        patch=state_shape(state, key("patch.weight"))[-1],
        hooks=_default_hooks(layers),
        neck_ch=tuple(state_shape(state, key(f"reassemble.{i}.proj.weight"))[0]
                      for i in range(4)),
        fusion=state_shape(state, key("convs.0.weight"))[0],
        grid=int(round((pos[1] - 1) ** 0.5)))


def load_dpt(state: dict, dtype=torch.float32, device="cuda"
             ) -> tuple[DPT, DPTConfig]:
    """A transformers- or MiDaS-layout state dict -> (model, its config).
    Strict: every key is read but the ViT's final norm and pooler, which
    the depth head never sees."""
    midas = any(k.startswith("pretrained.model.") for k in state)
    cfg = _config(state, midas)
    used: set[str] = set()

    def fetch(name):
        if not midas:
            key = hf_key(name)
            used.add(key)
            return state[key]
        key = midas_key(name)
        used.add(key)
        t = state[key]
        part = name.split(".")
        if part[0] == "blocks" and part[2] in ("q", "k", "v"):
            j = "qkv".index(part[2])
            t = t[j * cfg.hidden:(j + 1) * cfg.hidden]
        return t

    model = load_state(DPT(cfg), fetch, "dpt")
    ignore = ("pretrained.model.norm.",) if midas else \
        ("dpt.layernorm.", "dpt.pooler.")
    left = sorted(k for k in state if k not in used and
                  not k.startswith(ignore))
    if left:
        raise KeyError(f"unconsumed checkpoint keys: {left[:8]}"
                       f"{'...' if len(left) > 8 else ''}")
    return model.to_compute(dtype, device), cfg


def state_dict_hf(model: DPT) -> dict:
    """The model's parameters under their transformers-layout keys (f32
    CPU tensors): ``load_dpt`` reads them back."""
    return {hf_key(n): p.detach().float().cpu().contiguous()
            for n, p in model.named_parameters()}
