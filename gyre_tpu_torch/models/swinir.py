"""SwinIR super-resolution on torch, from the published BasicSR
checkpoints.

Counterpart of gyre_tpu/models/swinir.py. Every released variant: classical
SR (``pixelshuffle``, 1conv, 180 wide), real-world SR M (``nearest+conv``),
real-world SR L (``nearest+conv``, 3conv, 240 wide, 9 groups) and
lightweight SR (``pixelshuffledirect``). ``SwinIR`` is an ``nn.Module``
whose parameter names follow the JAX package's params tree
(``groups.0.blocks.1.qkv.weight`` is its ``groups[0]["blocks"][1]["qkv"]
["w"]``, in torch's layout), so ``models/modelset.py::swinir_from_jax``
fills it from the JAX params.

Activations are NHWC, as in the JAX package; a window's attention folds
the windows into the batch axis, its logits, relative-position bias, mask
and softmax in f32, the probabilities cast to the values' dtype for the
second product. A shifted window masks the logits that cross a region
boundary with -1e9 (a fill, not a bias). The window helpers here
(``window_partition``, ``window_reverse``, ``rel_pos_index``,
``shift_regions``, ``window_attention``) also serve models/hat.py and
models/inspyrenet.py.

``load_swinir`` derives the architecture from the checkpoint's shapes and
key pattern and is strict: a missing or misshapen key raises, and so does
one it leaves unread (the recomputable buffers of ``BUFFER_TOKENS``
excepted); ``state_dict_swinir`` writes a model back in that layout.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import (conv_nhwc, export_keyed, f32, gelu, load_keyed,
                     random_init, state_shape, unwrap_basicsr,
                     upsample_nearest_2x)

# checkpoint keys that are recomputable buffers, not weights
BUFFER_TOKENS = ("attn_mask", "relative_position_index", "mean")


@dataclass(frozen=True)
class SwinIRConfig:
    embed_dim: int = 180
    depths: tuple[int, ...] = (6, 6, 6, 6, 6, 6)
    heads: tuple[int, ...] = (6, 6, 6, 6, 6, 6)
    window: int = 8
    mlp_ratio: float = 2.0
    scale: int = 4
    # pixelshuffle | pixelshuffledirect | nearest+conv | "" (denoise)
    upsampler: str = "nearest+conv"
    resi: str = "1conv"              # 1conv | 3conv
    num_feat: int = 64
    patch_norm: bool = True
    img_range: float = 1.0
    mean: tuple[float, ...] = (0.4488, 0.4371, 0.4040)
    in_ch: int = 3
    out_ch: int = 3


# published model presets (BasicSR releases)
SWINIR_M_REAL = SwinIRConfig()
SWINIR_L_REAL = SwinIRConfig(embed_dim=240, depths=(6,) * 9, heads=(8,) * 9,
                             resi="3conv")
SWINIR_CLASSICAL = SwinIRConfig(upsampler="pixelshuffle")
SWINIR_TEST = SwinIRConfig(embed_dim=16, depths=(2, 2), heads=(2, 2),
                           window=4, num_feat=8)


# ---------------------------------------------------------- window helpers


def window_partition(x, w: int):
    """[B,H,W,C] -> [B*nW, w*w, C], windows row-major per batch row."""
    b, h, ww, c = x.shape
    x = x.reshape(b, h // w, w, ww // w, w, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, w * w, c)


def window_reverse(wins, w: int, h: int, ww: int):
    b = wins.shape[0] // ((h // w) * (ww // w))
    x = wins.reshape(b, h // w, ww // w, w, w, -1)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(b, h, ww, -1)


def rel_pos_index(w: int) -> np.ndarray:
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(w),
                                  indexing="ij")).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    rel = rel.transpose(1, 2, 0) + (w - 1)
    return (rel[..., 0] * (2 * w - 1) + rel[..., 1]).astype(np.int64)


@functools.lru_cache(maxsize=64)
def shift_regions(h: int, w: int, window: int, shift: int) -> np.ndarray:
    """[nW, w*w] region id of each token of a shifted (h, w) canvas's
    windows: the 3x3 regions cut at -window and -shift on each axis."""
    img = np.zeros((1, h, w, 1), np.int64)
    cnt = 0
    for hs in (slice(0, h - window), slice(h - window, h - shift),
               slice(h - shift, h)):
        for ws in (slice(0, w - window), slice(w - window, w - shift),
                   slice(w - shift, w)):
            img[:, hs, ws] = cnt
            cnt += 1
    t = torch.from_numpy(img)
    return window_partition(t, window)[..., 0].numpy()


def cross_region(h: int, w: int, window: int, shift: int, device):
    """[nW, t, t] bool: True where a shifted window's query and key lie in
    different regions."""
    reg = torch.from_numpy(shift_regions(h, w, window, shift)).to(device)
    return reg[:, None, :] != reg[:, :, None]


def window_attention(q, k, v, rpb, rel_idx, *, cross=None,
                     fill: float | None = None, add: float | None = None):
    """Windowed multi-head attention: q [n, tq, H, d], k and v [n, tk, H, d]
    -> [n, tq, H*d]. Logits (scaled by d^-0.5) plus the relative-position
    bias ``rpb[rel_idx]`` in f32; where ``cross`` ([nW, tq, tk], windows
    repeated over the batch) is True, the logit is replaced by ``fill`` or
    gets ``add`` added; the softmax in f32, its probabilities in v's dtype
    for the second product."""
    n, tq, heads, d = q.shape
    tk = k.shape[1]
    logits = torch.einsum("nqhd,nkhd->nhqk", q.float(), k.float()) * \
        (d ** -0.5)
    bias = rpb[rel_idx.reshape(-1)].reshape(tq, tk, heads).permute(2, 0, 1)
    logits = logits + bias.float()[None]
    if cross is not None:
        nw = cross.shape[0]
        logits = logits.reshape(n // nw, nw, heads, tq, tk)
        if fill is not None:
            logits = logits.masked_fill(cross[None, :, None], fill)
        else:
            logits = logits + torch.where(
                cross, add, 0.0).to(logits.dtype)[None, :, None]
        logits = logits.reshape(n, heads, tq, tk)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("nhqk,nkhd->nqhd", probs, v).reshape(n, tq,
                                                             heads * d)


def ln(norm: nn.LayerNorm, x):
    """LayerNorm over the last axis in f32, x's dtype out."""
    return F.layer_norm(x.float(), norm.normalized_shape, norm.weight.float(),
                        norm.bias.float(), norm.eps).to(x.dtype)


def lin(mod: nn.Linear, x):
    return F.linear(x, mod.weight.to(x.dtype),
                    None if mod.bias is None else mod.bias.to(x.dtype))


def pixel_shuffle(x, r: int):
    """torch PixelShuffle in NHWC: channel k = c*r*r + i*r + j moves to
    spatial offset (i, j) of channel c."""
    b, h, w, c = x.shape
    co = c // (r * r)
    x = x.reshape(b, h, w, co, r, r).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, h * r, w * r, co)


def pad_reflect(x, pad_h: int, pad_w: int):
    """NHWC x reflect-padded at the bottom and right."""
    if not (pad_h or pad_w):
        return x
    return F.pad(x.permute(0, 3, 1, 2), (0, pad_w, 0, pad_h),
                 mode="reflect").permute(0, 2, 3, 1)


def lrelu(x, slope: float = 0.2):
    return F.leaky_relu(x, slope)


def init_rpb(model: nn.Module, seed: int, names=("rpb",)):
    """Every relative-position bias table of ``model`` (a parameter named
    one of ``names``) ~ N(0, 0.02^2), as the JAX package draws them
    (random_init would treat one as a weight)."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.rsplit(".", 1)[-1] in names:
                gen = torch.Generator(device=p.device).manual_seed(
                    seed + sum(map(ord, name)))
                p.copy_(torch.randn(p.shape, generator=gen,
                                    device=p.device) * 0.02)
    return model


# ----------------------------------------------------------------- model


class _Block(nn.Module):
    def __init__(self, dim: int, heads: int, window: int, hidden: int):
        super().__init__()
        self.ln1 = nn.LayerNorm(dim)
        self.qkv = nn.Linear(dim, dim * 3)
        self.proj = nn.Linear(dim, dim)
        self.rpb = nn.Parameter(torch.zeros((2 * window - 1) ** 2, heads))
        self.ln2 = nn.LayerNorm(dim)
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x, heads, window, shift, rel_idx):
        b, h, w, c = x.shape
        xn = ln(self.ln1, x)
        if shift:
            xn = torch.roll(xn, (-shift, -shift), dims=(1, 2))
        wins = window_partition(xn, window)
        n, t, _ = wins.shape
        qkv = lin(self.qkv, wins).reshape(n, t, 3, heads, c // heads)
        cross = cross_region(h, w, window, shift, x.device) if shift \
            else None
        out = window_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                               self.rpb, rel_idx, cross=cross, fill=-1e9)
        out = window_reverse(lin(self.proj, out), window, h, w)
        if shift:
            out = torch.roll(out, (shift, shift), dims=(1, 2))
        x = x + out
        return x + lin(self.fc2, gelu(lin(self.fc1, ln(self.ln2, x))))


class _Conv3(nn.Module):
    """The 3conv residual: conv3 -> lrelu -> conv1 -> lrelu -> conv3."""

    def __init__(self, d: int):
        super().__init__()
        self.c0 = nn.Conv2d(d, d // 4, 3)
        self.c1 = nn.Conv2d(d // 4, d // 4, 1)
        self.c2 = nn.Conv2d(d // 4, d, 3)

    def forward(self, x):
        return conv_nhwc(self.c2, lrelu(conv_nhwc(
            self.c1, lrelu(conv_nhwc(self.c0, x)))))


def _resi(cfg: SwinIRConfig):
    d = cfg.embed_dim
    return _Conv3(d) if cfg.resi == "3conv" else nn.Conv2d(d, d, 3)


def _resi_conv(mod, x):
    return mod(x) if isinstance(mod, _Conv3) else conv_nhwc(mod, x)


class _Group(nn.Module):
    def __init__(self, cfg: SwinIRConfig, depth: int, heads: int):
        super().__init__()
        hidden = int(cfg.embed_dim * cfg.mlp_ratio)
        self.blocks = nn.ModuleList(
            _Block(cfg.embed_dim, heads, cfg.window, hidden)
            for _ in range(depth))
        self.conv = _resi(cfg)


def upsample_convs(scale: int, nf: int):
    """The pixel-shuffle up path's convs: x3 for a scale divisible by 3,
    else x2 steps."""
    ups, s = [], scale
    while s > 1:
        r = 3 if s % 3 == 0 else 2
        ups.append(nn.Conv2d(nf, nf * r * r, 3))
        s //= r
    return nn.ModuleList(ups)


def pixel_shuffle_up(convs, feat, scale: int):
    s = scale
    for conv in convs:
        r = 3 if s % 3 == 0 else 2
        feat = pixel_shuffle(conv_nhwc(conv, feat), r)
        s //= r
    return feat


class SwinIR(nn.Module):
    """``forward`` is ``swinir.apply``: x [B,H,W,3] in [0,1] -> [B,sH,sW,3]
    in the model's dtype (f32 in the manager)."""

    def __init__(self, cfg: SwinIRConfig = SWINIR_M_REAL):
        super().__init__()
        self.cfg = cfg
        d, nf = cfg.embed_dim, cfg.num_feat
        self.conv_first = nn.Conv2d(cfg.in_ch, d, 3)
        self.groups = nn.ModuleList(
            _Group(cfg, depth, cfg.heads[gi])
            for gi, depth in enumerate(cfg.depths))
        self.norm = nn.LayerNorm(d)
        self.conv_body = _resi(cfg)
        if cfg.patch_norm:
            self.patch_norm = nn.LayerNorm(d)
        if cfg.upsampler in ("pixelshuffle", "nearest+conv"):
            self.conv_before_upsample = nn.Conv2d(d, nf, 3)
        if cfg.upsampler == "pixelshuffle":
            self.upsample = upsample_convs(cfg.scale, nf)
            self.conv_last = nn.Conv2d(nf, cfg.out_ch, 3)
        elif cfg.upsampler == "pixelshuffledirect":
            self.upsample = nn.ModuleList(
                [nn.Conv2d(d, cfg.out_ch * cfg.scale ** 2, 3)])
        elif cfg.upsampler == "nearest+conv":
            self.conv_up1 = nn.Conv2d(nf, nf, 3)
            if cfg.scale == 4:
                self.conv_up2 = nn.Conv2d(nf, nf, 3)
            self.conv_hr = nn.Conv2d(nf, nf, 3)
            self.conv_last = nn.Conv2d(nf, cfg.out_ch, 3)
        else:   # denoise / artifact removal: residual conv_last
            self.conv_last = nn.Conv2d(d, cfg.out_ch, 3)
        self.register_buffer("rel_idx", torch.from_numpy(
            rel_pos_index(cfg.window)), persistent=False)

    @property
    def dtype(self):
        return self.conv_first.weight.dtype

    def to_compute(self, dtype, device):
        return self.to(device=device, dtype=dtype,
                       memory_format=torch.channels_last)

    def _features(self, x):
        cfg = self.cfg
        if cfg.patch_norm:
            x = ln(self.patch_norm, x)
        for gi, group in enumerate(self.groups):
            g_in = x
            for i, blk in enumerate(group.blocks):
                x = blk(x, cfg.heads[gi], cfg.window,
                        (cfg.window // 2) if i % 2 else 0, self.rel_idx)
            x = _resi_conv(group.conv, x) + g_in
        return ln(self.norm, x)

    def forward(self, x, scale: int | None = None):
        cfg = self.cfg
        scale = cfg.scale if scale is None else scale
        _, h0, w0, _ = x.shape
        x = pad_reflect(x.to(self.dtype), (cfg.window - h0 % cfg.window) %
                        cfg.window, (cfg.window - w0 % cfg.window) %
                        cfg.window)
        mean = torch.tensor(cfg.mean, dtype=x.dtype, device=x.device)
        x = (x - mean) * cfg.img_range
        feat = conv_nhwc(self.conv_first, x)
        feat = _resi_conv(self.conv_body, self._features(feat)) + feat
        if cfg.upsampler == "pixelshuffle":
            # conv_before_upsample's LeakyReLU has the default 0.01 slope
            feat = lrelu(conv_nhwc(self.conv_before_upsample, feat), 0.01)
            out = conv_nhwc(self.conv_last,
                            pixel_shuffle_up(self.upsample, feat, cfg.scale))
        elif cfg.upsampler == "pixelshuffledirect":
            out = pixel_shuffle(conv_nhwc(self.upsample[0], feat), cfg.scale)
        elif cfg.upsampler == "nearest+conv":
            feat = lrelu(conv_nhwc(self.conv_before_upsample, feat), 0.01)
            feat = lrelu(conv_nhwc(self.conv_up1, upsample_nearest_2x(feat)))
            if cfg.scale == 4:
                feat = lrelu(conv_nhwc(self.conv_up2,
                                       upsample_nearest_2x(feat)))
            out = conv_nhwc(self.conv_last,
                            lrelu(conv_nhwc(self.conv_hr, feat)))
        else:   # denoise: global residual at input resolution
            out = x + conv_nhwc(self.conv_last, feat)
        out = out / cfg.img_range + mean
        return out[:, :h0 * scale, :w0 * scale].clamp(0.0, 1.0)


def random_swinir(cfg: SwinIRConfig = SWINIR_TEST, seed: int = 0,
                  dtype=torch.float32, device="cuda") -> SwinIR:
    with torch.device(device):
        model = SwinIR(cfg)
    model = init_rpb(random_init(model, seed), seed)
    return model.to_compute(dtype, torch.device(device))


# ----------------------------------------------------------------- loading


def img_mean(state, in_ch: int) -> tuple:
    if "mean" in state and int(np.prod(state_shape(state, "mean"))) == 3:
        return tuple(float(v) for v in f32(state["mean"]).reshape(-1))
    return (0.4488, 0.4371, 0.4040) if in_ch == 3 else (0.0,)


def swin_groups(state) -> tuple[list[int], list[int], int, float]:
    """(depths, heads, window, mlp_ratio) of a BasicSR residual-group
    stack (SwinIR, HAT)."""
    embed = state_shape(state, "conv_first.weight")[0]
    depths, heads = [], []
    g = 0
    while f"layers.{g}.residual_group.blocks.0.norm1.weight" in state:
        d = 0
        while f"layers.{g}.residual_group.blocks.{d}.norm1.weight" in state:
            d += 1
        depths.append(d)
        rpb = state_shape(state, f"layers.{g}.residual_group.blocks.0.attn."
                            "relative_position_bias_table")
        heads.append(int(rpb[1]))
        g += 1
    window = (int(round(rpb[0] ** 0.5)) + 1) // 2
    fc1 = state_shape(state, "layers.0.residual_group.blocks.0.mlp.fc1.weight")
    return depths, heads, window, fc1[0] / embed


def pixel_shuffle_scale(state, num_feat: int) -> int:
    scale, i = 1, 0
    while f"upsample.{i}.weight" in state:
        r2 = state_shape(state, f"upsample.{i}.weight")[0] // num_feat
        scale *= int(round(r2 ** 0.5))
        i += 2
    return scale


def derive_config(state: dict) -> SwinIRConfig:
    """SwinIRConfig from a BasicSR checkpoint's shapes and key pattern."""
    embed_dim, in_ch = state_shape(state, "conv_first.weight")[:2]
    depths, heads, window, mlp_ratio = swin_groups(state)
    if "conv_up1.weight" in state:
        upsampler = "nearest+conv"
        scale = 4 if "conv_up2.weight" in state else 2
        num_feat = state_shape(state, "conv_up1.weight")[0]
        out_ch = state_shape(state, "conv_last.weight")[0]
    elif "conv_before_upsample.0.weight" in state:
        upsampler = "pixelshuffle"
        num_feat = state_shape(state, "conv_before_upsample.0.weight")[0]
        out_ch = state_shape(state, "conv_last.weight")[0]
        scale = pixel_shuffle_scale(state, num_feat)
    elif "upsample.0.weight" in state:
        upsampler, num_feat, out_ch = "pixelshuffledirect", embed_dim, 3
        scale = int(round((state_shape(state, "upsample.0.weight")[0] /
                           out_ch) ** 0.5))
    else:
        upsampler, scale, num_feat = "", 1, embed_dim
        out_ch = state_shape(state, "conv_last.weight")[0]
    return SwinIRConfig(
        embed_dim=embed_dim, depths=tuple(depths), heads=tuple(heads),
        window=window, mlp_ratio=mlp_ratio, scale=scale, upsampler=upsampler,
        resi="3conv" if "layers.0.conv.0.weight" in state else "1conv",
        num_feat=num_feat, patch_norm="patch_embed.norm.weight" in state,
        mean=img_mean(state, in_ch), in_ch=in_ch, out_ch=out_ch)


def _resi_keys(mod, pre: str, key: str):
    if isinstance(mod, _Conv3):
        for i, c in enumerate(("c0", "c1", "c2")):
            yield f"{pre}.{c}", f"{key}.{2 * i}"
    else:
        yield pre, key


def block_keys(pre: str, key: str):
    """(module prefix, published prefix) of a Swin block's parameter
    owners; the bias table is a bare parameter."""
    for mine, theirs in (("ln1", "norm1"), ("qkv", "attn.qkv"),
                         ("proj", "attn.proj"), ("ln2", "norm2"),
                         ("fc1", "mlp.fc1"), ("fc2", "mlp.fc2")):
        yield f"{pre}.{mine}", f"{key}.{theirs}"


def _keys(model: SwinIR):
    """(module prefix, published prefix) of every parameter owner; the
    bias tables ("rpb") map parameter to key."""
    cfg = model.cfg
    yield "conv_first", "conv_first"
    if cfg.patch_norm:
        yield "patch_norm", "patch_embed.norm"
    for g, group in enumerate(model.groups):
        for i in range(len(group.blocks)):
            pre, key = f"groups.{g}.blocks.{i}", \
                f"layers.{g}.residual_group.blocks.{i}"
            yield from block_keys(pre, key)
            yield f"{pre}.rpb", f"{key}.attn.relative_position_bias_table"
        yield from _resi_keys(group.conv, f"groups.{g}.conv",
                              f"layers.{g}.conv")
    yield "norm", "norm"
    yield from _resi_keys(model.conv_body, "conv_body", "conv_after_body")
    if cfg.upsampler in ("pixelshuffle", "nearest+conv"):
        yield "conv_before_upsample", "conv_before_upsample.0"
    if cfg.upsampler in ("pixelshuffle", "pixelshuffledirect"):
        for i in range(len(model.upsample)):
            yield f"upsample.{i}", f"upsample.{2 * i}"
    for name in ("conv_up1", "conv_up2", "conv_hr", "conv_last"):
        if hasattr(model, name):
            yield name, name


def load_swinir(state: dict, dtype=torch.float32, device="cuda"
                ) -> tuple[SwinIR, SwinIRConfig]:
    """A BasicSR SwinIR checkpoint -> (model, its derived config)."""
    state = unwrap_basicsr(state)
    cfg = derive_config(state)
    with torch.device(device):
        model = SwinIR(cfg)
    load_keyed(model, state, _keys(model), "swinir", BUFFER_TOKENS)
    return model.to_compute(dtype, torch.device(device)), cfg


def state_dict_swinir(model: SwinIR) -> dict:
    """The model in the BasicSR layout (f32 numpy), each block's
    ``relative_position_index`` buffer included: ``load_swinir`` and the
    JAX package's ``load_swinir`` read it back."""
    out = export_keyed(model, _keys(model))
    for g, group in enumerate(model.groups):
        for i in range(len(group.blocks)):
            out[f"layers.{g}.residual_group.blocks.{i}.attn."
                "relative_position_index"] = rel_pos_index(model.cfg.window)
    return out

