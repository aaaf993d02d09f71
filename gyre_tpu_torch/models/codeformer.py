"""CodeFormer face restoration (Zhou et al., NeurIPS 2022) on torch.

Counterpart of gyre_tpu/models/codeformer.py: a VQGAN autoencoder
(sequential ``blocks``: the input conv, ResBlocks of GroupNorm -> swish
-> conv, single-head attention at 16², a (0, 1, 0, 1)-padded stride-2
downsample, nearest 2x upsample, a bare GroupNorm at the tail), a 9-layer
pre-norm transformer that predicts codebook indices from the degraded
16x16 latent (learned positions added to q and k only, exact GELU), an
argmax codebook lookup, and SFT fusion blocks that blend encoder features
into the decoder scaled by ``fidelity`` (1 keeps the input's identity, 0
trusts the codebook).

A block plan computed from the config (``encoder_plan``,
``generator_plan``) drives the module, the loader and the exporter, and
reproduces the published fuse indices. ``CodeFormer`` is an ``nn.Module``
whose parameter names follow the JAX package's params tree
(``encoder[3]["conv1"]["w"]`` is ``encoder.3.conv1.weight``), so
``models/modelset.py::codeformer_from_jax`` fills it leaf by leaf;
``load_codeformer`` reads the published ``codeformer.pth`` layout
strictly (every key but the ``quantize.`` buffers read) and
``state_dict_codeformer`` writes it.

The JAX package computes every GroupNorm -> swish -> conv and every
attention here in plain XLA, with no Pallas kernel, so the port keeps them
plain too: CodeFormer launches no K1 or K2. Its GroupNorms take eps 1e-5,
the JAX package's ``group_norm`` default (the published VQGAN's
``normalize`` uses 1e-6). It runs in f32.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import (export_keyed, load_keyed, nchw, nhwc, random_init,
                     state_shape)

_EPS = 1e-5


@dataclass(frozen=True)
class CodeFormerConfig:
    img_size: int = 512
    nf: int = 64
    ch_mult: tuple[int, ...] = (1, 2, 2, 4, 4, 8)
    res_blocks: int = 2
    attn_resolutions: tuple[int, ...] = (16,)
    emb_dim: int = 256          # VQ latent width
    codebook_size: int = 1024
    dim_embd: int = 512         # transformer width
    n_head: int = 8             # not in the state dict; published nets: 8
    n_layers: int = 9
    connect: tuple[str, ...] = ("32", "64", "128", "256")
    norm_groups: int = 32

    @property
    def latent_size(self) -> int:
        r = self.img_size // 2 ** (len(self.ch_mult) - 1)
        return r * r


CODEFORMER = CodeFormerConfig()
CODEFORMER_TEST = CodeFormerConfig(
    img_size=32, nf=8, ch_mult=(1, 2), res_blocks=1, attn_resolutions=(16,),
    emb_dim=16, codebook_size=32, dim_embd=32, n_head=8, n_layers=2,
    connect=("32",), norm_groups=8)


# ------------------------------------------------------------------- plans
# each entry: (kind, c_in, c_out, resolution)


def encoder_plan(cfg: CodeFormerConfig):
    plan = [("conv", 3, cfg.nf, cfg.img_size)]
    curr, c, fuse = cfg.img_size, cfg.nf, {}
    for i, mult in enumerate(cfg.ch_mult):
        out = cfg.nf * mult
        for _ in range(cfg.res_blocks):
            plan.append(("res", c, out, curr))
            c = out
            fuse[str(curr)] = len(plan) - 1   # the level's last ResBlock
            if curr in cfg.attn_resolutions:
                plan.append(("attn", c, c, curr))
        if i != len(cfg.ch_mult) - 1:
            plan.append(("down", c, c, curr))
            curr //= 2
    plan += [("res", c, c, curr), ("attn", c, c, curr), ("res", c, c, curr),
             ("norm", c, c, curr), ("conv", c, cfg.emb_dim, curr)]
    return plan, fuse


def generator_plan(cfg: CodeFormerConfig):
    c = cfg.nf * cfg.ch_mult[-1]
    curr = cfg.img_size // 2 ** (len(cfg.ch_mult) - 1)
    plan = [("conv", cfg.emb_dim, c, curr), ("res", c, c, curr),
            ("attn", c, c, curr), ("res", c, c, curr)]
    fuse = {}
    for idx, i in enumerate(reversed(range(len(cfg.ch_mult)))):
        out = cfg.nf * cfg.ch_mult[i]
        for j in range(cfg.res_blocks):
            plan.append(("res", c, out, curr))
            c = out
            # the published fuse points: the deepest level at its last
            # ResBlock, every other level at its first
            if (idx == 0 and j == cfg.res_blocks - 1) or (idx > 0 and j == 0):
                fuse[str(curr)] = len(plan) - 1
            if curr in cfg.attn_resolutions:
                plan.append(("attn", c, c, curr))
        if i != 0:
            plan.append(("up", c, c, curr))
            curr *= 2
    plan += [("norm", c, c, curr), ("conv", c, 3, curr)]
    return plan, fuse


# ------------------------------------------------------------------ blocks


def _swish(x):
    return x * torch.sigmoid(x)


def _gn(norm: nn.GroupNorm, x):
    return F.group_norm(x, norm.num_groups, norm.weight, norm.bias, _EPS)


class _Res(nn.Module):
    def __init__(self, ci: int, co: int, groups: int):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, ci)
        self.conv1 = nn.Conv2d(ci, co, 3, padding=1)
        self.norm2 = nn.GroupNorm(groups, co)
        self.conv2 = nn.Conv2d(co, co, 3, padding=1)
        if ci != co:
            self.conv_out = nn.Conv2d(ci, co, 1)

    def forward(self, x):
        h = self.conv1(_swish(_gn(self.norm1, x)))
        h = self.conv2(_swish(_gn(self.norm2, h)))
        if hasattr(self, "conv_out"):
            x = self.conv_out(x)
        return x + h


class _Attn(nn.Module):
    """Single-head attention over the HW tokens, 1x1-conv projections."""

    def __init__(self, c: int, groups: int):
        super().__init__()
        self.norm = nn.GroupNorm(groups, c)
        self.q, self.k, self.v, self.proj_out = (nn.Conv2d(c, c, 1)
                                                 for _ in range(4))

    def forward(self, x):
        b, c, h, w = x.shape
        hn = _gn(self.norm, x)
        q, k, v = (m(hn).flatten(2) for m in (self.q, self.k, self.v))
        attn = torch.softmax(q.transpose(1, 2) @ k * c ** -0.5, dim=-1)
        out = (v @ attn.transpose(1, 2)).reshape(b, c, h, w)
        return x + self.proj_out(out)


def _block(kind: str, ci: int, co: int, groups: int) -> nn.Module:
    if kind == "conv":
        return nn.Conv2d(ci, co, 3, padding=1)
    if kind == "down":
        return nn.Conv2d(ci, co, 3, stride=2)
    if kind == "up":
        return nn.Conv2d(ci, co, 3, padding=1)
    if kind == "res":
        return _Res(ci, co, groups)
    if kind == "attn":
        return _Attn(ci, groups)
    if kind == "norm":
        return nn.GroupNorm(groups, ci)
    raise ValueError(kind)


def _run_block(kind: str, blk: nn.Module, x):
    if kind == "down":
        return blk(F.pad(x, (0, 1, 0, 1)))
    if kind == "up":
        return blk(F.interpolate(x, scale_factor=2.0, mode="nearest"))
    if kind == "norm":
        return _gn(blk, x)              # bare: no swish after the tail norm
    return blk(x)


class _Fuse(nn.Module):
    """Published Fuse_sft_block: dec + w * (dec * scale + shift), scale and
    shift from the encoder's features."""

    def __init__(self, c: int, groups: int):
        super().__init__()
        self.encode_enc = _Res(2 * c, c, groups)
        self.scale1, self.scale2, self.shift1, self.shift2 = (
            nn.Conv2d(c, c, 3, padding=1) for _ in range(4))

    def forward(self, enc, dec, w: float):
        h = self.encode_enc(torch.cat([enc, dec], dim=1))
        scale = self.scale2(F.leaky_relu(self.scale1(h), 0.2))
        shift = self.shift2(F.leaky_relu(self.shift1(h), 0.2))
        return dec + w * (dec * scale + shift)


class _TFLayer(nn.Module):
    """Pre-norm transformer layer, the learned positions added to q and k
    only (published TransformerSALayer)."""

    def __init__(self, d: int, mlp: int, heads: int):
        super().__init__()
        self.heads = heads
        self.norm1 = nn.LayerNorm(d)
        self.in_proj = nn.Linear(d, 3 * d)
        self.out_proj = nn.Linear(d, d)
        self.norm2 = nn.LayerNorm(d)
        self.linear1 = nn.Linear(d, mlp)
        self.linear2 = nn.Linear(mlp, d)

    def forward(self, x, pos):
        b, t, d = x.shape
        hd = d // self.heads
        hn = self.norm1(x)
        wq, wk, wv = self.in_proj.weight.chunk(3, dim=0)
        bq, bk, bv = self.in_proj.bias.chunk(3, dim=0)
        qk_in = hn + pos[None]
        q = F.linear(qk_in, wq, bq).reshape(b, t, self.heads, hd)
        k = F.linear(qk_in, wk, bk).reshape(b, t, self.heads, hd)
        v = F.linear(hn, wv, bv).reshape(b, t, self.heads, hd)
        attn = torch.einsum("bqhd,bkhd->bhqk", q, k) * hd ** -0.5
        out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(attn, dim=-1), v)
        x = x + self.out_proj(out.reshape(b, t, d))
        hn = F.gelu(self.linear1(self.norm2(x)), approximate="none")
        return x + self.linear2(hn)


class CodeFormer(nn.Module):
    """``forward(images, fidelity)`` is ``codeformer.restore``: images
    [B,H,W,3] in [0, 1] at H = W = ``cfg.img_size`` -> restored [B,H,W,3]
    in [0, 1], f32."""

    def __init__(self, cfg: CodeFormerConfig = CODEFORMER_TEST):
        super().__init__()
        self.cfg = cfg
        g = cfg.norm_groups
        enc_plan, enc_fuse = encoder_plan(cfg)
        gen_plan, gen_fuse = generator_plan(cfg)
        self.enc_kinds = [k for k, *_ in enc_plan]
        self.gen_kinds = [k for k, *_ in gen_plan]
        self.encoder = nn.ModuleList(_block(k, ci, co, g)
                                     for k, ci, co, _ in enc_plan)
        self.generator = nn.ModuleList(_block(k, ci, co, g)
                                       for k, ci, co, _ in gen_plan)
        self.codebook = nn.Parameter(torch.zeros(cfg.codebook_size,
                                                 cfg.emb_dim))
        self.position_emb = nn.Parameter(torch.zeros(cfg.latent_size,
                                                     cfg.dim_embd))
        self.feat_emb = nn.Linear(cfg.emb_dim, cfg.dim_embd)
        self.ft_layers = nn.ModuleList(
            _TFLayer(cfg.dim_embd, cfg.dim_embd * 2, cfg.n_head)
            for _ in range(cfg.n_layers))
        self.idx_norm = nn.LayerNorm(cfg.dim_embd)
        self.idx_pred = nn.Linear(cfg.dim_embd, cfg.codebook_size,
                                  bias=False)
        chan = {str(res): co for _, _, co, res in enc_plan}
        self.fuse = nn.ModuleDict({size: _Fuse(chan[size], g)
                                   for size in cfg.connect})
        # block index -> the fuse size taken (encoder) or applied there
        self.enc_taps = {i: s for s, i in enc_fuse.items()
                         if s in cfg.connect}
        self.gen_taps = {i: s for s, i in gen_fuse.items()
                         if s in cfg.connect}

    def forward(self, images, fidelity: float = 0.5):
        cfg = self.cfg
        x = nchw(images.float()) * 2.0 - 1.0
        feats = {}
        for i, (kind, blk) in enumerate(zip(self.enc_kinds, self.encoder)):
            x = _run_block(kind, blk, x)
            if i in self.enc_taps:
                feats[self.enc_taps[i]] = x
        b, _, hh, ww = x.shape
        q = self.feat_emb(x.flatten(2).transpose(1, 2))
        for layer in self.ft_layers:
            q = layer(q, self.position_emb)
        idx = self.idx_pred(self.idx_norm(q)).argmax(dim=-1)      # [B, T]
        x = self.codebook[idx].reshape(b, hh, ww, cfg.emb_dim)
        x = nchw(x).contiguous()
        for i, (kind, blk) in enumerate(zip(self.gen_kinds,
                                            self.generator)):
            x = _run_block(kind, blk, x)
            size = self.gen_taps.get(i)
            if size in feats:
                x = self.fuse[size](feats[size], x, float(fidelity))
        return nhwc(x * 0.5 + 0.5).clamp(0.0, 1.0).contiguous()


def random_codeformer(cfg: CodeFormerConfig = CODEFORMER_TEST, seed: int = 0,
                      device="cuda") -> CodeFormer:
    """CodeFormer at ``cfg`` with random weights (layers.random_init), f32
    on ``device``."""
    with torch.device(device):
        model = CodeFormer(cfg)
    return random_init(model, seed).eval()


# -------------------------------------------------------------- checkpoint


def derive_config(state: dict) -> CodeFormerConfig:
    """The architecture of a published-layout state dict, from its keys and
    shapes as the JAX loader derives it."""
    nf = state_shape(state, "encoder.blocks.0.weight")[0]
    codebook, emb_dim = state_shape(state, "quantize.embedding.weight")
    dim_embd = state_shape(state, "feat_emb.weight")[0]
    latent = state_shape(state, "position_emb")[0]
    n_layers = 0
    while f"ft_layers.{n_layers}.norm1.weight" in state:
        n_layers += 1
    connect = tuple(sorted({k.split(".")[1] for k in state
                            if k.startswith("fuse_convs_dict.")}, key=int))
    # ch_mult and res_blocks from the ResBlocks' widths in order, less the
    # two mid ResBlocks (ch_mult[0] != ch_mult[1] in every published net)
    n_blocks = 1 + max(int(k.split(".")[2]) for k in state
                       if k.startswith("encoder.blocks."))
    outs = [state_shape(state, f"encoder.blocks.{i}.conv1.weight")[0]
            for i in range(n_blocks)
            if f"encoder.blocks.{i}.norm1.weight" in state][:-2]
    res_blocks = 0
    for o in outs:
        if o != outs[0]:
            break
        res_blocks += 1
    mult = tuple(outs[j] // nf for j in range(0, len(outs), res_blocks))
    img_size = int(round(latent ** 0.5)) * 2 ** (len(mult) - 1)
    return CodeFormerConfig(img_size=img_size, nf=nf, ch_mult=mult,
                            res_blocks=res_blocks, emb_dim=emb_dim,
                            codebook_size=codebook, dim_embd=dim_embd,
                            n_layers=n_layers, connect=connect,
                            norm_groups=min(32, nf))


def _keys(model: CodeFormer):
    """(parameter or module name, published key) pairs."""
    for part, kinds in (("encoder", model.enc_kinds),
                        ("generator", model.gen_kinds)):
        for i, kind in enumerate(kinds):
            theirs = f"{part}.blocks.{i}" + (".conv" if kind in ("down", "up")
                                             else "")
            blk = getattr(model, part)[i]
            if isinstance(blk, (nn.Conv2d, nn.GroupNorm)):
                yield f"{part}.{i}", theirs
            else:
                for name, _ in blk.named_children():
                    yield f"{part}.{i}.{name}", f"{theirs}.{name}"
    yield "codebook", "quantize.embedding.weight"
    yield "position_emb", "position_emb"
    yield "feat_emb", "feat_emb"
    for i in range(len(model.ft_layers)):
        mine, theirs = f"ft_layers.{i}", f"ft_layers.{i}"
        yield f"{mine}.in_proj.weight", f"{theirs}.self_attn.in_proj_weight"
        yield f"{mine}.in_proj.bias", f"{theirs}.self_attn.in_proj_bias"
        yield f"{mine}.out_proj", f"{theirs}.self_attn.out_proj"
        for name in ("norm1", "norm2", "linear1", "linear2"):
            yield f"{mine}.{name}", f"{theirs}.{name}"
    yield "idx_norm", "idx_pred_layer.0"
    yield "idx_pred", "idx_pred_layer.1"
    for size in model.fuse:
        mine, theirs = f"fuse.{size}", f"fuse_convs_dict.{size}"
        for name, _ in model.fuse[size].encode_enc.named_children():
            yield f"{mine}.encode_enc.{name}", f"{theirs}.encode_enc.{name}"
        for name, idx in (("scale1", "scale.0"), ("scale2", "scale.2"),
                          ("shift1", "shift.0"), ("shift2", "shift.2")):
            yield f"{mine}.{name}", f"{theirs}.{idx}"


def load_codeformer(state: dict, device="cuda") -> CodeFormer:
    """A sczhou/CodeFormer checkpoint (``params_ema`` / ``params`` nesting
    dropped) -> the model in f32 on ``device``, its architecture derived
    from the shapes; strict: a missing or misshapen key raises ValueError,
    one left unread (the ``quantize.`` buffers excepted) KeyError."""
    for wrap in ("params_ema", "params"):
        if isinstance(state.get(wrap), dict):
            state = state[wrap]
    with torch.device(device):
        model = CodeFormer(derive_config(state))
    return load_keyed(model, state, _keys(model), "codeformer",
                      buffers=("quantize.",)).eval()


def state_dict_codeformer(model: CodeFormer) -> dict:
    """The model in the codeformer.pth layout (f32 numpy): ``load_codeformer``
    and the JAX package's loader read it back."""
    return export_keyed(model, _keys(model))
