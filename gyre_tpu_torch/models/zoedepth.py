"""ZoeDepth's metric-bins head over the DPT trunk (models/dpt.py).

Counterpart of gyre_tpu/models/zoedepth.py, the single-head ZoeD_N
configuration: softplus seed bin centres from the bottleneck (``l4_rn``),
one projector and attractor layer a decoder level (inverse attractors
dx / (1 + alpha |dx|^gamma), mean-reduced), and a conditional
log-binomial distribution over the bins from the trunk's ``out_conv``
activation, its relative depth and the last bin embedding; metric depth is
the expectation of the bin centres. Every conv is 1x1, computed as a
product over the channel axis of NHWC maps, in f32. The head's GELU is the
tanh approximation, as ``jax.nn.gelu``'s default (the DPT trunk's is
exact).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch
import torch.nn as nn
import torch.nn.functional as F

from . import dpt as dpt_mod


@dataclass(frozen=True)
class ZoeConfig:
    n_bins: int = 64
    bin_embedding_dim: int = 128
    n_attractors: tuple = (16, 8, 4, 1)
    attractor_alpha: float = 1000.0
    attractor_gamma: float = 2.0
    attractor_kind: str = "mean"      # "mean" | "sum"
    attractor_type: str = "inv"       # "inv" | "exp"
    min_temp: float = 0.0212
    max_temp: float = 50.0
    min_depth: float = 1e-3
    max_depth: float = 10.0
    btlnck_features: int = 256
    num_out_features: int = 256       # per-level r4..r1 channels
    mlp_dim: int = 128                # projector/attractor hidden
    seed_mlp_dim: int = 256
    out_conv_ch: int = 32             # trunk head activation channels


ZOE_N = ZoeConfig()
ZOE_TEST = ZoeConfig(n_bins=8, bin_embedding_dim=16,
                     n_attractors=(4, 2, 2, 1), mlp_dim=16, seed_mlp_dim=16,
                     btlnck_features=64, num_out_features=64, out_conv_ch=32)


def _conv1x1(conv: nn.Conv2d, x):
    return torch.einsum("bhwc,dc->bhwd", x, conv.weight[:, :, 0, 0]) + \
        conv.bias


class _Mlp2(nn.Module):
    def __init__(self, cin: int, mid: int, cout: int):
        super().__init__()
        self.c0, self.c2 = nn.Conv2d(cin, mid, 1), nn.Conv2d(mid, cout, 1)

    def forward(self, x, act=F.relu):
        return _conv1x1(self.c2, act(_conv1x1(self.c0, x)))


class ZoeHead(nn.Module):
    """The metric-bins head; parameter names follow the JAX package's
    params tree."""

    def __init__(self, cfg: ZoeConfig = ZOE_TEST):
        super().__init__()
        self.cfg = cfg
        btl, emb = cfg.btlnck_features, cfg.bin_embedding_dim
        self.conv2 = nn.Conv2d(btl, btl, 1)
        self.seed_bin_regressor = _Mlp2(btl, cfg.seed_mlp_dim, cfg.n_bins)
        self.seed_projector = _Mlp2(btl, cfg.mlp_dim, emb)
        self.projectors = nn.ModuleList(
            _Mlp2(cfg.num_out_features, cfg.mlp_dim, emb) for _ in range(4))
        self.attractors = nn.ModuleList(
            _Mlp2(emb, cfg.mlp_dim, n) for n in cfg.n_attractors)
        clb_in = cfg.out_conv_ch + 1 + emb
        self.clb = _Mlp2(clb_in, clb_in // 4, 4)


def _resize(x, hw):
    return dpt_mod.resize_bilinear(x, hw, align_corners=True)


def _attract(centers, attractors, cfg: ZoeConfig):
    """Bin centres [B,h,w,n] pulled toward attractors [B,h,w,K]."""
    dx = attractors[..., :, None] - centers[..., None, :]
    if cfg.attractor_type == "inv":
        pulled = dx / (1.0 + cfg.attractor_alpha *
                       dx.abs() ** cfg.attractor_gamma)
    else:
        pulled = torch.exp(-cfg.attractor_alpha *
                           dx.abs() ** cfg.attractor_gamma) * dx
    red = pulled.mean(dim=-2) if cfg.attractor_kind == "mean" else \
        pulled.sum(dim=-2)
    return centers + red


def _log_binomial(p, t, n_classes: int):
    """Softmax over k of (log C(K-1, k) + k log p + (K-1-k) log(1-p)) / t,
    p and t [B,h,w,1] -> [B,h,w,K]."""
    eps = 1e-4
    k = torch.arange(n_classes, dtype=torch.float32, device=p.device)
    km1 = float(n_classes - 1)
    log_coef = (torch.lgamma(torch.tensor(km1 + 1.0)) -
                torch.lgamma(k + 1) - torch.lgamma(km1 - k + 1))
    y = log_coef + k * torch.log(p.clamp(eps, 1.0)) + \
        (km1 - k) * torch.log((1.0 - p).clamp(eps, 1.0))
    return torch.softmax(y / t, dim=-1)


def apply_head(head: ZoeHead, feats: dict):
    """The trunk's feature surface (dpt.DPT.apply_features, NHWC) ->
    metric depth [B,h,w,1] at the out_conv resolution, f32."""
    cfg = head.cfg
    btlnck = _conv1x1(head.conv2, feats["l4_rn"].float())
    b_prev = F.softplus(head.seed_bin_regressor(btlnck))
    prev_embed = head.seed_projector(btlnck)
    embed = prev_embed
    for proj, attr, name in zip(head.projectors, head.attractors,
                                ("r4", "r3", "r2", "r1")):
        xb = feats[name].float()
        embed = proj(xb)
        a_in = embed + _resize(prev_embed, xb.shape[1:3])
        attractors = F.softplus(attr(a_in))
        b_prev = _attract(_resize(b_prev, xb.shape[1:3]), attractors, cfg)
        prev_embed = embed
    last = feats["out_conv"].float()
    rel = _resize(feats["rel_depth"].float(), last.shape[1:3])
    cond = _resize(embed, last.shape[1:3])
    pc = F.softplus(head.clb(torch.cat([last, rel, cond], dim=-1),
                             act=lambda x: F.gelu(x, approximate="tanh")))
    p2 = pc[..., :2] + 1e-4
    prob = p2[..., :1] / (p2[..., :1] + p2[..., 1:2])
    c2 = pc[..., 2:] + cfg.min_temp
    temp = (c2[..., :1] / (c2[..., :1] + c2[..., 1:2])) * cfg.max_temp
    probs = _log_binomial(prob, temp, cfg.n_bins)
    centers = _resize(b_prev, probs.shape[1:3])
    return (probs * centers).sum(dim=-1, keepdim=True)


def published_key(name: str) -> str:
    """A ZoeHead parameter's key in the published checkpoint layout."""
    mod, _, kind = name.rpartition(".")
    mod = mod.replace("clb.", "conditional_log_binomial.mlp.")
    for part in ("seed_bin_regressor", "seed_projector"):
        mod = mod.replace(f"{part}.", f"{part}._net.")
    for part in ("projectors", "attractors"):
        if mod.startswith(part + "."):
            i, sub = mod[len(part) + 1:].split(".")
            mod = f"{part}.{i}._net.{sub}"
    mod = mod.replace(".c0", ".0").replace(".c2", ".2")
    return f"{mod}.{kind}"


def state_dict_published(head: ZoeHead) -> dict:
    """The head's parameters under their published keys (f32 CPU tensors):
    ``load_zoe_head`` reads them back."""
    return {published_key(n): p.detach().float().cpu().contiguous()
            for n, p in head.named_parameters()}


def load_zoe_head(state: dict, device="cuda") -> tuple[ZoeHead, ZoeConfig]:
    """A published ZoeDepth checkpoint's head keys (``module.`` or
    ``model.`` prefixes dropped; a missing bias reads as zeros) -> (head in
    f32, its config, from the shapes). Trunk keys (``core.core.*``) are
    not read here: dpt.load_dpt reads them."""
    def norm_key(k):
        for pre in ("module.", "model."):
            if k.startswith(pre):
                k = k[len(pre):]
        return k

    s = {norm_key(k): v for k, v in state.items()}

    def dim(key, axis):
        return int(s[key].shape[axis])

    emb = dim("seed_projector._net.2.weight", 0)
    cfg = dataclasses.replace(
        ZOE_N, n_bins=dim("seed_bin_regressor._net.2.weight", 0),
        bin_embedding_dim=emb, btlnck_features=dim("conv2.weight", 1),
        num_out_features=dim("projectors.0._net.0.weight", 1),
        n_attractors=tuple(dim(f"attractors.{i}._net.2.weight", 0)
                           for i in range(4)),
        mlp_dim=dim("projectors.0._net.0.weight", 0),
        seed_mlp_dim=dim("seed_bin_regressor._net.0.weight", 0),
        out_conv_ch=dim("conditional_log_binomial.mlp.0.weight", 1) - 1 -
        emb)

    def fetch(name):
        k = published_key(name)
        if k not in s and name.endswith("bias"):
            return torch.zeros(head.get_parameter(name).shape)
        return s[k]

    head = ZoeHead(cfg)
    dpt_mod.load_state(head, fetch, "zoedepth head")
    return head.to(device), cfg


def random_head(cfg: ZoeConfig = ZOE_TEST, seed: int = 0,
                device="cuda") -> ZoeHead:
    """Random f32 weights from a generator seeded ``seed``: each 1x1
    conv's weight uniform in +-1/sqrt(fan_in), its bias 0 (the JAX
    package's init)."""
    head = ZoeHead(cfg)
    gen = torch.Generator().manual_seed(int(seed))
    with torch.no_grad():
        for name, p in head.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            else:
                lim = p.shape[1] ** -0.5
                p.copy_((torch.rand(p.shape, generator=gen) * 2 - 1) * lim)
    return head.to(device)


def estimate_metric_depth(trunk, head: ZoeHead, image, size: int = 384):
    """Image [B,H,W,3] in [0,1] -> metric depth [B,H,W,1] (metres), f32."""
    _, h, w, _ = image.shape
    x = dpt_mod.resize_bilinear(image.float(), (size, size))
    d = apply_head(head, trunk.apply_features((x - 0.5) / 0.5))
    return dpt_mod.resize_bilinear(d, (h, w))


def estimate_depth_hint(trunk, head: ZoeHead, image, size: int = 384):
    """The hint map (as dpt.estimate_depth): inverse metric depth, min-max
    normalised per image, near bright."""
    d = estimate_metric_depth(trunk, head, image, size)
    inv = 1.0 / torch.clamp(d, min=head.cfg.min_depth)
    lo = inv.amin(dim=(1, 2, 3), keepdim=True)
    hi = inv.amax(dim=(1, 2, 3), keepdim=True)
    return (inv - lo) / torch.clamp(hi - lo, min=1e-6)
