"""K-UNet: the sd-x2 latent upscaler's denoiser, on torch tensors.

Counterpart of gyre_tpu/models/kunet.py, the same params tree and NHWC
layout: Katherine Crowson's k-upscaler design as diffusers stores it
(``stabilityai/sd-x2-latent-upscaler``, KBlock module names):

  * a Gaussian Fourier time embedding of c_noise = 0.25 * ln(sigma)
    (``time_proj``, a fixed random frequency vector, kept in f32 whatever
    the model's dtype: its angles reach hundreds of radians, which bf16
    frequencies would put off by a large fraction of a turn), then two
    linears with exact GELU;
  * 4 down and 4 up KBlocks and no mid block. A resnet's norms are
    affine-free GroupNorms FiLM-modulated by a linear of the time
    embedding (``_ada_group_norm``, f32), its activation exact GELU and
    its 3x3 convs plain (cuDNN): no GroupNorm -> SiLU -> conv chain here,
    so no K2, as in the JAX package;
  * KAttentionBlocks: cross-attention against layer-normed text states
    (``attn2.norm_cross``) at every level but the first, and
    self-attention first at the deepest level; every attention is the
    flash kernel K1 on the card (layers.attention);
  * an up block concatenates its skip once, at its start;
  * fixed [1,3,3,1]/8 blur resampling, depthwise, on a reflect-padded
    input (a stride-2 conv down, a stride-2 transposed conv up).

``load_kunet`` reads the published layout strictly (a missing or extra
key raises KeyError, a misshapen one ValueError), every dimension taken
from the shapes as the JAX loader takes them; ``state_dict_kunet`` writes
it. The structure is the JAX package's init's (3x3 ``conv_in`` and
``conv_out``, no ``conv_norm_out``), all a KUNetConfig describes; the JAX
loader also takes a ``conv_norm_out`` and other kernel sizes from a
checkpoint, where this one raises (ROADMAP queue 3). Random weights and the JAX bridge go through the ModelSet's spec tree
(models/modelset.py).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from . import layers as L

Params = dict


@dataclasses.dataclass(frozen=True)
class KUNetConfig:
    in_channels: int = 8
    out_channels: int = 4
    block_out_channels: tuple = (384, 768, 768, 1536)
    layers_per_block: int = 4          # resnets a block
    # levels whose KAttentionBlocks also self-attend (the deepest)
    self_attn_levels: tuple = (False, False, False, True)
    # levels with attention at all (level 0 is a plain KDownBlock2D)
    attn_levels: tuple = (False, True, True, True)
    head_dim: int = 64
    cross_attention_dim: int = 768
    group_size: int = 32               # groups = C // group_size

    @property
    def levels(self) -> int:
        return len(self.block_out_channels)

    @property
    def time_embed_dim(self) -> int:
        return 2 * self.block_out_channels[0]


X2_DEFAULT = KUNetConfig()
X2_TEST = KUNetConfig(block_out_channels=(32, 64), layers_per_block=2,
                      self_attn_levels=(False, True),
                      attn_levels=(False, True), head_dim=16,
                      cross_attention_dim=64, group_size=16)


# ------------------------------------------------------------ param specs


def _conv_spec(k: int, ci: int, co: int, bias: bool = True) -> Params:
    p = {"w": L.Spec("conv", (co, ci, k, k))}
    if bias:
        p["b"] = L.Spec("bias", (co,))
    return p


def _up_channels(cfg: KUNetConfig, li: int, ri: int) -> tuple[int, int]:
    """(in, out) channels of up block li's resnet ri: the first takes the
    skip's concatenation, the last gives the next level's width."""
    rev = list(reversed(cfg.block_out_channels))
    here, nxt = rev[li], rev[min(li + 1, cfg.levels - 1)]
    last = ri == cfg.layers_per_block - 1
    return (2 * here if ri == 0 else here), (nxt if last else here)


def param_specs(cfg: KUNetConfig) -> Params:
    ted = cfg.time_embed_dim
    boc = cfg.block_out_channels

    def ada(c):
        return {"linear": L.linear_spec(ted, 2 * c)}

    def resnet(ci, co):
        p = {"norm1": ada(ci), "conv1": _conv_spec(3, ci, co),
             "norm2": ada(co), "conv2": _conv_spec(3, co, co)}
        if ci != co:
            p["conv_shortcut"] = _conv_spec(1, ci, co, bias=False)
        return p

    def attn_mod(c, kv):
        return {"q": L.linear_spec(c, c, bias=False),
                "k": L.linear_spec(kv, c, bias=False),
                "v": L.linear_spec(kv, c, bias=False),
                "out": L.linear_spec(c, c)}

    def katt(c, self_attn):
        p = {"norm2": ada(c),
             "attn2": {**attn_mod(c, cfg.cross_attention_dim),
                       "norm_cross": L.norm_spec(cfg.cross_attention_dim)}}
        if self_attn:
            p["norm1"] = ada(c)
            p["attn1"] = attn_mod(c, c)
        return p

    def block(lvl, chans):
        blk = {"resnets": [resnet(ci, co) for ci, co in chans]}
        if cfg.attn_levels[lvl]:
            blk["attentions"] = [katt(co, cfg.self_attn_levels[lvl])
                                 for _, co in chans]
        return blk

    n = cfg.layers_per_block
    p: Params = {
        "time_proj": L.Spec("normal", (boc[0],), std=16.0, f32=True,
                            exact=True),
        "time_emb1": L.linear_spec(ted, ted),
        "time_emb2": L.linear_spec(ted, ted),
        "conv_in": _conv_spec(3, cfg.in_channels, boc[0]),
        "down": [block(li, [(boc[max(li - 1, 0)] if ri == 0 else co, co)
                            for ri in range(n)])
                 for li, co in enumerate(boc)],
        "up": [block(cfg.levels - 1 - li,
                     [_up_channels(cfg, li, ri) for ri in range(n)])
               for li in range(cfg.levels)],
        "conv_out": _conv_spec(3, boc[0], cfg.out_channels),
    }
    return p


# ------------------------------------------------------------------ pieces

_BLUR_1D = np.asarray([1.0, 3.0, 3.0, 1.0], np.float32) / 8.0
_BLUR_2D = np.outer(_BLUR_1D, _BLUR_1D)                      # [4, 4]


def _blur_kernel(x, gain: float):
    c = x.shape[-1]
    k = torch.from_numpy(_BLUR_2D * gain).to(x.device, x.dtype)
    return k[None, None].expand(c, 1, 4, 4)


def _blur_down(x):
    """KDownsample2D: reflect-pad 1, depthwise 4x4 blur, stride 2: H ->
    H // 2 (NHWC)."""
    xp = F.pad(L.nchw(x), (1, 1, 1, 1), mode="reflect")
    y = F.conv2d(xp, _blur_kernel(x, 1.0), stride=2, groups=x.shape[-1])
    return L.nhwc(y).contiguous()


def _blur_up(x):
    """KUpsample2D: reflect-pad 1, then the depthwise 4x4 blur (times 4:
    diffusers doubles the 1-D kernel before the outer product) as a
    stride-2 transposed conv with padding 3, which gives exactly 2H x 2W
    (the JAX package's lhs-dilated VALID conv with the flipped kernel)."""
    xp = F.pad(L.nchw(x), (1, 1, 1, 1), mode="reflect")
    y = F.conv_transpose2d(xp, _blur_kernel(x, 4.0), stride=2, padding=3,
                           groups=x.shape[-1])
    return L.nhwc(y).contiguous()


def _ada_group_norm(p: Params, x, temb, groups: int):
    """Affine-free GroupNorm in f32, scaled by 1 + scale and shifted by
    shift from a linear of the time embedding."""
    b, c = x.shape[0], x.shape[-1]
    xg = x.float().reshape(b, -1, groups, c // groups)
    var, mean = torch.var_mean(xg, dim=(1, 3), keepdim=True, unbiased=False)
    xf = ((xg - mean) * torch.rsqrt(var + 1e-5)).reshape(x.shape)
    emb = L.linear(p["linear"], temb.to(x.dtype)).float()
    scale, shift = emb.chunk(2, dim=-1)
    shape = (b,) + (1,) * (x.dim() - 2) + (c,)
    return (xf * (1.0 + scale.reshape(shape)) +
            shift.reshape(shape)).to(x.dtype)


def _resnet(p: Params, x, temb, cfg: KUNetConfig):
    gin = max(1, x.shape[-1] // cfg.group_size)
    h = L.gelu(_ada_group_norm(p["norm1"], x, temb, gin))
    h = L.conv2d(p["conv1"], h)
    gout = max(1, h.shape[-1] // cfg.group_size)
    h = L.gelu(_ada_group_norm(p["norm2"], h, temb, gout))
    h = L.conv2d(p["conv2"], h)
    sc = L.conv2d(p["conv_shortcut"], x) if "conv_shortcut" in p else x
    return sc + h


def _attn(p: Params, x, ctx, heads: int):
    """One attention over flattened HW tokens x [B,T,C] (against ctx, or
    x itself when ctx is None)."""
    b, t, _ = x.shape
    d = p["q"]["w"].shape[0] // heads
    src = x if ctx is None else ctx
    q = L.linear(p["q"], x).reshape(b, t, heads, d)
    k = L.linear(p["k"], src).reshape(b, src.shape[1], heads, d)
    v = L.linear(p["v"], src).reshape(b, src.shape[1], heads, d)
    return L.linear(p["out"], L.attention(q, k, v).reshape(b, t, heads * d))


def _kattention(p: Params, x, temb, ctx, cfg: KUNetConfig):
    """KAttentionBlock: optional self-attention (norm1/attn1), then
    cross-attention (norm2/attn2) against the layer-normed context."""
    b, h, w, c = x.shape
    heads = max(1, c // cfg.head_dim)
    groups = max(1, c // cfg.group_size)
    if "attn1" in p:
        n = _ada_group_norm(p["norm1"], x, temb, groups)
        x = x + _attn(p["attn1"], n.reshape(b, h * w, c), None,
                      heads).reshape(b, h, w, c)
    n = _ada_group_norm(p["norm2"], x, temb, groups)
    cctx = ctx
    if "norm_cross" in p["attn2"]:
        cctx = L.layer_norm(p["attn2"]["norm_cross"], ctx)
    return x + _attn(p["attn2"], n.reshape(b, h * w, c), cctx,
                     heads).reshape(b, h, w, c)


def _block(blk: Params, h, temb, context, cfg: KUNetConfig):
    for ri, rp in enumerate(blk["resnets"]):
        h = _resnet(rp, h, temb, cfg)
        if "attentions" in blk:
            h = _kattention(blk["attentions"][ri], h, temb, context, cfg)
    return h


# ------------------------------------------------------------------- apply


def apply(params: Params, cfg: KUNetConfig, x, c_noise, context):
    """x [B,H,W,in] (the noisy latents and the upsampled source latents),
    c_noise [B] (0.25 * ln sigma), context [B,T,D] (CLIP text states) ->
    eps [B,H,W,out] in x's dtype."""
    t = c_noise.float().reshape(-1)
    freqs = params["time_proj"].float()
    ang = 2.0 * math.pi * t[:, None] * freqs[None, :]
    temb = torch.cat([torch.cos(ang), torch.sin(ang)], dim=-1).to(x.dtype)
    temb = L.linear(params["time_emb2"],
                    L.gelu(L.linear(params["time_emb1"], temb)))

    h = L.conv2d(params["conv_in"], x)
    skips = []
    last = len(params["down"]) - 1
    for li, blk in enumerate(params["down"]):
        h = _block(blk, h, temb, context, cfg)
        skips.append(h)
        if li != last:
            h = _blur_down(h)
    for li, blk in enumerate(params["up"]):
        h = torch.cat([h, skips[-(li + 1)]], dim=-1)
        h = _block(blk, h, temb, context, cfg)
        if li != last:
            h = _blur_up(h)
    return L.conv2d(params["conv_out"], h)


# -------------------------------------------------------------- checkpoint

_NAMES = {"time_emb1": "time_embedding.linear_1",
          "time_emb2": "time_embedding.linear_2",
          "down": "down_blocks", "up": "up_blocks", "q": "to_q",
          "k": "to_k", "v": "to_v", "out": "to_out.0"}
_LEAF = {"w": "weight", "b": "bias", "scale": "weight", "bias": "bias"}


def state_keys(path) -> tuple[str, ...]:
    """A leaf's diffusers key (``down_blocks.1.attentions.0.attn2.to_q.
    weight``), as load.py's key maps give it."""
    if path == ("time_proj",):
        return ("time_proj.weight",)
    *mod, leaf = path
    return (".".join(_NAMES.get(m, str(m)) for m in mod) + "." +
            _LEAF[leaf],)


def _count(state, fmt: str) -> int:
    n = 0
    while fmt.format(n) in state:
        n += 1
    return n


def derive_config(state: dict) -> KUNetConfig:
    """The architecture of a published-layout state dict, from its keys and
    shapes as the JAX loader derives it (head_dim 64, group_size 32)."""
    shape = lambda k: tuple(state[k].shape)  # noqa: E731
    levels = _count(state, "down_blocks.{}.resnets.0.conv1.weight")
    n = _count(state, "down_blocks.0.resnets.{}.conv1.weight")
    boc = tuple(shape(f"down_blocks.{li}.resnets.{n - 1}.conv2.weight")[0]
                for li in range(levels))
    attn = tuple(f"down_blocks.{li}.attentions.0.attn2.to_q.weight" in state
                 for li in range(levels))
    self_attn = tuple(f"down_blocks.{li}.attentions.0.attn1.to_q.weight"
                      in state for li in range(levels))
    cross = [shape(f"down_blocks.{li}.attentions.0.attn2.to_k.weight")[1]
             for li in range(levels) if attn[li]]
    return KUNetConfig(
        in_channels=shape("conv_in.weight")[1],
        out_channels=shape("conv_out.weight")[0], block_out_channels=boc,
        layers_per_block=n, self_attn_levels=self_attn, attn_levels=attn,
        head_dim=64, cross_attention_dim=cross[-1] if cross else 768)


def load_kunet(state: dict, dtype=torch.bfloat16, device="cuda"):
    """A published sd-x2 (k-upscaler) UNet state dict -> (params,
    KUNetConfig) on ``device``: every key read (KeyError naming those left
    over or missing), every shape checked (ValueError)."""
    from .load import load_tree
    from .modelset import map_specs

    cfg = derive_config(state)
    specs = param_specs(cfg)
    want = set()
    map_specs(lambda path, _: want.add(state_keys(path)[0]), specs)
    missing = sorted(want - set(state))
    left = sorted(set(state) - want)
    if missing or left:
        raise KeyError(f"k-UNet checkpoint: missing {missing[:8]}, "
                       f"unconsumed {left[:8]}")
    return load_tree(specs, state, state_keys, "kunet", dtype,
                     torch.device(device)), cfg


def state_dict_kunet(params: Params, cfg: KUNetConfig) -> dict:
    """The params in the published layout (f32 CPU tensors): ``load_kunet``
    and the JAX package's loader read it back."""
    from .load import export_tree

    return export_tree(params, param_specs(cfg), state_keys)
