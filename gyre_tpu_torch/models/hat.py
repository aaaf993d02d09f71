"""HAT (Hybrid Attention Transformer) super-resolution on torch, from the
published XPixelGroup checkpoints (HAT, HAT-L).

Counterpart of gyre_tpu/models/hat.py: residual hybrid attention groups,
each N hybrid attention blocks (shifted-window attention beside a
channel-attention conv branch) + one overlapping cross-attention block
(queries from the windows, keys and values from overlapping windows) + a
conv; pixel-shuffle upsampling. ``HAT`` is an ``nn.Module`` whose
parameter names follow the JAX package's params tree, so
``models/modelset.py::hat_from_jax`` fills it; the window helpers are
models/swinir.py's, as in the JAX package. A shifted window ADDS -100 to
the logits that cross a region boundary (the published ``attn_mask``),
where SwinIR replaces them with -1e9. Activations NHWC; attention logits,
bias, mask and softmax in f32.

``load_hat`` derives the architecture from the checkpoint's shapes and is
strict, as ``load_swinir``; ``state_dict_hat`` writes a model back in the
published layout.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import (conv_nhwc, export_keyed, gelu, load_keyed, random_init,
                     state_shape, unwrap_basicsr)
from .swinir import (BUFFER_TOKENS, block_keys, cross_region, img_mean,
                     init_rpb, lin, ln, pad_reflect, pixel_shuffle_scale,
                     pixel_shuffle_up, rel_pos_index, swin_groups,
                     upsample_convs, window_attention, window_partition,
                     window_reverse)


@dataclass(frozen=True)
class HATConfig:
    embed_dim: int = 180
    depths: tuple[int, ...] = (6, 6, 6, 6, 6, 6)
    heads: tuple[int, ...] = (6, 6, 6, 6, 6, 6)
    window: int = 16
    mlp_ratio: float = 2.0
    compress_ratio: int = 3
    squeeze_factor: int = 30
    conv_scale: float = 0.01
    overlap_ratio: float = 0.5
    scale: int = 4
    num_feat: int = 64
    patch_norm: bool = True
    img_range: float = 1.0
    mean: tuple[float, ...] = (0.4488, 0.4371, 0.4040)
    in_ch: int = 3
    out_ch: int = 3

    @property
    def overlap_win(self) -> int:
        return self.window + int(self.overlap_ratio * self.window)


HAT_M = HATConfig()
HAT_L = HATConfig(depths=(6,) * 12, heads=(6,) * 12)
HAT_TEST = HATConfig(embed_dim=12, depths=(2, 2), heads=(2, 2), window=4,
                     compress_ratio=3, squeeze_factor=4, num_feat=8,
                     overlap_ratio=0.5)


def rpi_oca(ws: int, wse: int) -> np.ndarray:
    """Relative position index between ws x ws query windows and wse x wse
    overlapping key windows. The published arithmetic leaves negative
    indices that wrap around the bias table (python semantics); the models
    were trained that way, hence the modulo."""
    co = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                              indexing="ij")).reshape(2, -1)
    ce = np.stack(np.meshgrid(np.arange(wse), np.arange(wse),
                              indexing="ij")).reshape(2, -1)
    rel = (ce[:, None, :] - co[:, :, None]).transpose(1, 2, 0) \
        .astype(np.int64)
    rel += ws - wse + 1
    idx = rel[..., 0] * (ws + wse - 1) + rel[..., 1]
    return idx % ((ws + wse - 1) ** 2)


def overlap_windows(kv, ws: int, wse: int):
    """[B,H,W,C] -> [B*nW, wse*wse, C] overlapping windows (stride ws,
    size wse, zero-padded), row-major per batch row: torch's unfold, whose
    features are ordered channel-slowest (c, kh, kw)."""
    b, h, w, c = kv.shape
    p = (wse - ws) // 2
    cols = F.unfold(kv.permute(0, 3, 1, 2), wse, padding=p, stride=ws)
    n = cols.shape[-1]
    return cols.reshape(b, c, wse * wse, n).permute(0, 3, 2, 1).reshape(
        b * n, wse * wse, c)


class _CAB(nn.Module):
    """The channel attention branch: conv3 -> GELU -> conv3, then a
    squeeze-excite gate."""

    def __init__(self, d: int, dc: int, ds: int):
        super().__init__()
        self.c1 = nn.Conv2d(d, dc, 3)
        self.c2 = nn.Conv2d(dc, d, 3)
        self.sq1 = nn.Conv2d(d, ds, 1)
        self.sq2 = nn.Conv2d(ds, d, 1)

    def forward(self, x):
        h = conv_nhwc(self.c2, gelu(conv_nhwc(self.c1, x)))
        y = h.mean(dim=(1, 2), keepdim=True)
        y = torch.sigmoid(conv_nhwc(self.sq2, F.relu(conv_nhwc(self.sq1, y))))
        return h * y


class _MLPBlock(nn.Module):
    def __init__(self, d: int, hidden: int, table: int, heads: int):
        super().__init__()
        self.ln1 = nn.LayerNorm(d)
        self.qkv = nn.Linear(d, d * 3)
        self.proj = nn.Linear(d, d)
        self.rpb = nn.Parameter(torch.zeros(table, heads))
        self.ln2 = nn.LayerNorm(d)
        self.fc1 = nn.Linear(d, hidden)
        self.fc2 = nn.Linear(hidden, d)

    def mlp(self, x):
        return x + lin(self.fc2, gelu(lin(self.fc1, ln(self.ln2, x))))


class _HAB(_MLPBlock):
    def __init__(self, cfg: HATConfig, heads: int):
        d = cfg.embed_dim
        super().__init__(d, int(d * cfg.mlp_ratio), (2 * cfg.window - 1) ** 2,
                         heads)
        self.cab = _CAB(d, max(d // cfg.compress_ratio, 1),
                        max(d // cfg.squeeze_factor, 1))

    def forward(self, x, cfg: HATConfig, heads, shift, rel_idx):
        b, h, w, c = x.shape
        xn = ln(self.ln1, x)
        conv_x = self.cab(xn)
        if shift:
            xn = torch.roll(xn, (-shift, -shift), dims=(1, 2))
        wins = window_partition(xn, cfg.window)
        n, t, _ = wins.shape
        qkv = lin(self.qkv, wins).reshape(n, t, 3, heads, c // heads)
        cross = cross_region(h, w, cfg.window, cfg.window // 2, x.device) \
            if shift else None
        out = window_attention(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2],
                               self.rpb, rel_idx, cross=cross, add=-100.0)
        out = window_reverse(lin(self.proj, out), cfg.window, h, w)
        if shift:
            out = torch.roll(out, (shift, shift), dims=(1, 2))
        return self.mlp(x + out + conv_x * cfg.conv_scale)


class _OCAB(_MLPBlock):
    def __init__(self, cfg: HATConfig, heads: int):
        d = cfg.embed_dim
        super().__init__(d, int(d * cfg.mlp_ratio),
                         (cfg.window + cfg.overlap_win - 1) ** 2, heads)

    def forward(self, x, cfg: HATConfig, heads, rel_idx):
        b, h, w, c = x.shape
        q, k, v = lin(self.qkv, ln(self.ln1, x)).chunk(3, dim=-1)
        ws, wse = cfg.window, cfg.overlap_win
        qw = window_partition(q, ws)
        n, nq, _ = qw.shape
        hd = c // heads
        kw, vw = overlap_windows(k, ws, wse), overlap_windows(v, ws, wse)
        out = window_attention(
            qw.reshape(n, nq, heads, hd), kw.reshape(n, -1, heads, hd),
            vw.reshape(n, -1, heads, hd), self.rpb, rel_idx)
        out = window_reverse(out, ws, h, w)
        return self.mlp(x + lin(self.proj, out))


class _Group(nn.Module):
    def __init__(self, cfg: HATConfig, depth: int, heads: int):
        super().__init__()
        self.blocks = nn.ModuleList(_HAB(cfg, heads) for _ in range(depth))
        self.ocab = _OCAB(cfg, heads)
        self.conv = nn.Conv2d(cfg.embed_dim, cfg.embed_dim, 3)


class HAT(nn.Module):
    """``forward`` is ``hat.apply``: x [B,H,W,3] in [0,1] -> [B,sH,sW,3]
    in the model's dtype (f32 in the manager)."""

    def __init__(self, cfg: HATConfig = HAT_TEST):
        super().__init__()
        self.cfg = cfg
        d, nf = cfg.embed_dim, cfg.num_feat
        self.conv_first = nn.Conv2d(cfg.in_ch, d, 3)
        self.groups = nn.ModuleList(
            _Group(cfg, depth, cfg.heads[gi])
            for gi, depth in enumerate(cfg.depths))
        self.norm = nn.LayerNorm(d)
        self.conv_body = nn.Conv2d(d, d, 3)
        self.conv_before_upsample = nn.Conv2d(d, nf, 3)
        self.conv_last = nn.Conv2d(nf, cfg.out_ch, 3)
        if cfg.patch_norm:
            self.patch_norm = nn.LayerNorm(d)
        self.upsample = upsample_convs(cfg.scale, nf)
        self.register_buffer("rel_sa", torch.from_numpy(
            rel_pos_index(cfg.window)), persistent=False)
        self.register_buffer("rel_oca", torch.from_numpy(
            rpi_oca(cfg.window, cfg.overlap_win)), persistent=False)

    @property
    def dtype(self):
        return self.conv_first.weight.dtype

    def to_compute(self, dtype, device):
        return self.to(device=device, dtype=dtype,
                       memory_format=torch.channels_last)

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
        body = ln(self.patch_norm, feat) if cfg.patch_norm else feat
        for gi, group in enumerate(self.groups):
            g_in = body
            for i, blk in enumerate(group.blocks):
                body = blk(body, cfg, cfg.heads[gi],
                           (cfg.window // 2) if i % 2 else 0, self.rel_sa)
            body = group.ocab(body, cfg, cfg.heads[gi], self.rel_oca)
            body = conv_nhwc(group.conv, body) + g_in
        feat = conv_nhwc(self.conv_body, ln(self.norm, body)) + feat
        feat = F.leaky_relu(conv_nhwc(self.conv_before_upsample, feat), 0.01)
        out = conv_nhwc(self.conv_last,
                        pixel_shuffle_up(self.upsample, feat, cfg.scale))
        out = out / cfg.img_range + mean
        return out[:, :h0 * scale, :w0 * scale].clamp(0.0, 1.0)


def random_hat(cfg: HATConfig = HAT_TEST, seed: int = 0, dtype=torch.float32,
               device="cuda") -> HAT:
    with torch.device(device):
        model = HAT(cfg)
    model = init_rpb(random_init(model, seed), seed)
    return model.to_compute(dtype, torch.device(device))


# ----------------------------------------------------------------- loading


def derive_config(state: dict) -> HATConfig:
    embed_dim, in_ch = state_shape(state, "conv_first.weight")[:2]
    depths, heads, window, mlp_ratio = swin_groups(state)
    oca = state_shape(state, "layers.0.residual_group.overlap_attn."
                        "relative_position_bias_table")
    wse = int(round(oca[0] ** 0.5)) + 1 - window
    blk = "layers.0.residual_group.blocks.0.conv_block.cab"
    num_feat = state_shape(state, "conv_before_upsample.0.weight")[0]
    return HATConfig(
        embed_dim=embed_dim, depths=tuple(depths), heads=tuple(heads),
        window=window, mlp_ratio=mlp_ratio,
        compress_ratio=embed_dim // state_shape(state, f"{blk}.0.weight")[0],
        squeeze_factor=embed_dim // state_shape(
            state, f"{blk}.3.attention.1.weight")[0],
        overlap_ratio=(wse - window) / window,
        scale=pixel_shuffle_scale(state, num_feat), num_feat=num_feat,
        patch_norm="patch_embed.norm.weight" in state,
        mean=img_mean(state, 3), in_ch=in_ch,
        out_ch=state_shape(state, "conv_last.weight")[0])


def _keys(model: HAT):
    yield "conv_first", "conv_first"
    if model.cfg.patch_norm:
        yield "patch_norm", "patch_embed.norm"
    for g, group in enumerate(model.groups):
        rg = f"layers.{g}.residual_group"
        for i in range(len(group.blocks)):
            pre, key = f"groups.{g}.blocks.{i}", f"{rg}.blocks.{i}"
            yield from block_keys(pre, key)
            yield f"{pre}.rpb", f"{key}.attn.relative_position_bias_table"
            cab = f"{key}.conv_block.cab"
            for mine, theirs in (("c1", "0"), ("c2", "2"),
                                 ("sq1", "3.attention.1"),
                                 ("sq2", "3.attention.3")):
                yield f"{pre}.cab.{mine}", f"{cab}.{theirs}"
        pre, key = f"groups.{g}.ocab", f"{rg}.overlap_attn"
        for mine, theirs in block_keys(pre, key):
            yield mine, theirs.replace(".attn.", ".")
        yield f"{pre}.rpb", f"{key}.relative_position_bias_table"
        yield f"groups.{g}.conv", f"layers.{g}.conv"
    yield "norm", "norm"
    yield "conv_body", "conv_after_body"
    yield "conv_before_upsample", "conv_before_upsample.0"
    for i in range(len(model.upsample)):
        yield f"upsample.{i}", f"upsample.{2 * i}"
    yield "conv_last", "conv_last"


def load_hat(state: dict, dtype=torch.float32, device="cuda"
             ) -> tuple[HAT, HATConfig]:
    """An XPixelGroup HAT checkpoint -> (model, its derived config)."""
    state = unwrap_basicsr(state)
    cfg = derive_config(state)
    with torch.device(device):
        model = HAT(cfg)
    load_keyed(model, state, _keys(model), "hat", BUFFER_TOKENS)
    return model.to_compute(dtype, torch.device(device)), cfg


def state_dict_hat(model: HAT) -> dict:
    """The model in the published layout (f32 numpy), with its
    ``relative_position_index_SA`` / ``_OCA`` buffers: ``load_hat`` and
    the JAX package's ``load_hat`` read it back."""
    out = export_keyed(model, _keys(model))
    out["relative_position_index_SA"] = rel_pos_index(model.cfg.window)
    out["relative_position_index_OCA"] = rpi_oca(model.cfg.window,
                                                 model.cfg.overlap_win)
    return out
