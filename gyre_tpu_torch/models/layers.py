"""Functional neural-net primitives on torch tensors.

Counterpart of gyre_tpu/models/layers.py. Models are plain functions over a
params tree (nested dicts and lists of tensors), as in the JAX package, so
the two trees line up key for key (models/modelset.py bridges them).

Conventions:
  * Activations are NHWC [B,H,W,C], as in the JAX package. A conv hands
    F.conv2d the channels-last view ``x.permute(0,3,1,2)`` (no copy) and
    permutes back.
  * Weights are held in torch layout: linear (out, in), conv OIHW. The one
    exception is the 3x3 conv of every resnet's GN -> SiLU -> conv chain,
    held HWIO because that is the layout the fused kernel reads
    (ops/fused_norm_conv.py). The JAX package's layouts are linear (in, out)
    and conv HWIO; the bridge converts.
  * Compute is bf16 on the card; normalisation statistics and softmax in
    f32.

Below them, the checkpoint helpers that the task models' loaders and
exporters share: BatchNorm folding, strict loading by key, export by key.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import attention as attn_ops
from ..ops import fused_norm_conv

Params = dict


def linear(p: Params, x):
    return F.linear(x, p["w"].to(x.dtype),
                    p["b"].to(x.dtype) if "b" in p else None)


def conv2d(p: Params, x, stride: int = 1, padding: int | None = None):
    """NHWC conv with an OIHW weight; padding defaults to SAME for odd
    kernels at stride 1 (k // 2). 1x1 convs run as a linear over C."""
    w = p["w"].to(x.dtype)
    b = p["b"].to(x.dtype) if "b" in p else None
    if w.shape[2] == 1 and w.shape[3] == 1 and stride == 1:
        return F.linear(x, w[:, :, 0, 0], b)
    pad = w.shape[2] // 2 if padding is None else padding
    y = F.conv2d(x.permute(0, 3, 1, 2), w, b, stride=stride, padding=pad)
    return y.permute(0, 2, 3, 1).contiguous()


def conv_nhwc(conv, x, stride: int = 1, padding: int | None = None):
    """NHWC x through an nn.Conv2d's weights, as ``conv2d`` pads."""
    p = {"w": conv.weight}
    if conv.bias is not None:
        p["b"] = conv.bias
    return conv2d(p, x, stride, padding)


def conv2d_tiled(p: Params, x, stride: int = 1, tiling_x: bool = False,
                 tiling_y: bool = False):
    """NHWC conv (OIHW weight) with circular (seamless-tiling) padding on
    either axis and zero padding on the other, SAME for odd kernels."""
    kh, kw = p["w"].shape[2], p["w"].shape[3]
    ph, pw = (kh - 1) // 2, (kw - 1) // 2
    if tiling_y and ph:
        x = torch.cat([x[:, -ph:], x, x[:, :ph]], dim=1)
    if tiling_x and pw:
        x = torch.cat([x[:, :, -pw:], x, x[:, :, :pw]], dim=2)
    return conv2d(p, x, stride=stride,
                  padding=(0 if tiling_y else ph, 0 if tiling_x else pw))


def group_norm(p: Params, x, groups: int = 32, eps: float = 1e-5):
    """GroupNorm over the channel (last) axis, statistics in f32."""
    b, c = x.shape[0], x.shape[-1]
    xg = x.float().reshape(b, -1, groups, c // groups)
    var, mean = torch.var_mean(xg, dim=(1, 3), keepdim=True, unbiased=False)
    xf = ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    xf = xf * p["scale"].float() + p["bias"].float()
    return xf.to(x.dtype)


def layer_norm(p: Params, x, eps: float = 1e-5):
    return F.layer_norm(x.float(), (x.shape[-1],), p["scale"].float(),
                        p["bias"].float(), eps).to(x.dtype)


def silu(x):
    return F.silu(x)


def gelu(x):
    return F.gelu(x, approximate="none")


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def geglu(p: Params, x):
    """GEGLU feed-forward gate used by SD transformer blocks."""
    h, gate = linear(p, x).chunk(2, dim=-1)
    return h * gelu(gate)


def attention(q, k, v, mask=None, scale: float | None = None):
    """Multi-head scaled-dot-product attention, [B,T,H,D] layout.

    Unmasked attention runs the flash kernel on the card
    (ops/attention.py); softmax in f32 either way."""
    return attn_ops.attention(q, k, v, mask=mask, scale=scale)


class Shards(tuple):
    """A tensor-parallel leaf (parallel/mesh.py): one tensor per tp device,
    shard i on the i-th device of its dp group."""


def _tp_part(w, x, dtype, home):
    """A shard's partial product on its device, in f32 on the home device:
    the partials add in f32 and round to the compute dtype once."""
    return F.linear(x, w.to(dtype)).to(home).float()


def tp_attention(p: Params, x, ctx, heads: int, mask=None):
    """Attention whose q/k/v/out weights are ``Shards``: shard i computes
    heads/tp whole heads on its own device (q, k, v split by output rows,
    out by input columns), each shard's out-projection is a partial sum,
    the partials are added in f32 on x's device in shard order, with the
    replicated out bias once, and rounded to x's dtype. ``ctx is x`` for
    self-attention. x [B,T,C], ctx [B,S,Cc]."""
    b, t, c = x.shape
    s = ctx.shape[1]
    home, dtype = x.device, x.dtype
    n = len(p["q"]["w"])
    hs = heads // n
    out = None
    for i, wq in enumerate(p["q"]["w"]):
        dev = wq.device
        xs = x.to(dev)
        cs = xs if ctx is x else ctx.to(dev)

        def proj(name, inp, rows):
            bias = p[name].get("b")
            return F.linear(inp, p[name]["w"][i].to(dtype),
                            None if bias is None else bias[i].to(dtype)
                            ).reshape(b, rows, hs, -1)

        o = attention(proj("q", xs, t), proj("k", cs, s), proj("v", cs, s),
                      mask=None if mask is None else mask.to(dev))
        part = _tp_part(p["out"]["w"][i], o.reshape(b, t, -1), dtype, home)
        out = part if out is None else out + part
    if "b" in p["out"]:
        out = out + p["out"]["b"].float()
    return out.to(dtype)


def tp_mlp(p_in: Params, p_out: Params, x, hidden):
    """A two-layer MLP whose weights are ``Shards``: shard i applies
    ``hidden(p_in shard i, x)`` (the first layer and its activation, split
    by output: a GEGLU's value and gate halves each split, so a shard holds
    matching pairs) and the second layer split by input, on its own device;
    the partials are added in f32 on x's device in shard order, with the
    replicated output bias once, and rounded to x's dtype."""
    home, dtype = x.device, x.dtype
    out = None
    for i, w in enumerate(p_in["w"]):
        shard = {"w": w}
        if "b" in p_in:
            shard["b"] = p_in["b"][i]
        part = _tp_part(p_out["w"][i], hidden(shard, x.to(w.device)), dtype,
                        home)
        out = part if out is None else out + part
    if "b" in p_out:
        out = out + p_out["b"].float()
    return out.to(dtype)


def gn_silu_conv3x3(norm_p: Params, conv_p: Params, x, groups: int,
                    eps: float):
    """GroupNorm -> SiLU -> 3x3 conv of a resnet block, through the fused
    kernels K2a + K2b on the card (ops/fused_norm_conv.py); conv_p["w"]
    is HWIO, and the norm's scale and bias and the conv's bias are the f32
    leaves the kernels read (fused_norm_spec, fused_conv_spec)."""
    return fused_norm_conv.gn_silu_conv3x3(
        x.contiguous(), norm_p["scale"], norm_p["bias"], conv_p["w"],
        conv_p["b"], groups=groups, eps=eps)


def timestep_embedding(t, dim: int, max_period: float = 10000.0,
                       flip_sin_cos: bool = True, shift: float = 0.0,
                       scale: float = 1.0):
    """Sinusoidal embedding of (possibly fractional) timesteps, f32.
    flip_sin_cos=True gives [cos, sin] ordering (diffusers UNet)."""
    t = t.float().reshape(-1)
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) *
                      torch.arange(half, dtype=torch.float32,
                                   device=t.device) /
                      (half - shift if shift else half))
    args = t[:, None] * freqs[None, :] * scale
    sin, cos = torch.sin(args), torch.cos(args)
    emb = torch.cat([cos, sin] if flip_sin_cos else [sin, cos], dim=-1)
    if dim % 2:
        emb = F.pad(emb, (0, 1))
    return emb


def upsample_nearest_2x(x):
    b, h, w, c = x.shape
    x = x[:, :, None, :, None, :].expand(b, h, 2, w, 2, c)
    return x.reshape(b, h * 2, w * 2, c)


def avg_pool_2x(x):
    """2x2 mean over NHWC, stride 2 (an odd last row or column dropped):
    the T2I adapter's downsampling."""
    b, h, w, c = x.shape
    x = x[:, :h // 2 * 2, :w // 2 * 2]
    return x.reshape(b, h // 2, 2, w // 2, 2, c).sum(dim=(2, 4)) * 0.25


# ------------------------------------------------------------ param specs
# Each model's ``param_specs(cfg)`` builds its params tree with a Spec at
# every leaf: the leaf's kind and its shape in the port's layout. The same
# tree drives random initialisation and the bridge from the JAX package's
# params (models/modelset.py).


class Spec:
    """A parameter leaf. kind: "linear" (out, in) | "conv" OIHW |
    "conv_hwio" HWIO | "bias" (zeros) | "norm_scale" (ones) | "normal"
    (embeddings, N(0, std^2)). f32: the leaf is kept in float32 whatever
    the model's dtype, holding that dtype's value cast up (the fused
    kernels read these leaves as f32, so no call casts them); with exact,
    it holds its f32 value itself (the k-UNet's Fourier frequencies)."""

    __slots__ = ("kind", "shape", "std", "f32", "exact")

    def __init__(self, kind: str, shape: tuple, std: float = 0.0,
                 f32: bool = False, exact: bool = False):
        self.kind, self.shape, self.std = kind, tuple(shape), std
        self.f32, self.exact = f32 or exact, exact

    def fan_in(self) -> int:
        if self.kind == "linear":
            return self.shape[1]
        if self.kind == "conv":
            return self.shape[1] * self.shape[2] * self.shape[3]
        if self.kind == "conv_hwio":
            return self.shape[0] * self.shape[1] * self.shape[2]
        return 0


def linear_spec(d_in: int, d_out: int, bias: bool = True) -> Params:
    p = {"w": Spec("linear", (d_out, d_in))}
    if bias:
        p["b"] = Spec("bias", (d_out,))
    return p


def conv_spec(kh: int, kw: int, c_in: int, c_out: int) -> Params:
    return {"w": Spec("conv", (c_out, c_in, kh, kw)),
            "b": Spec("bias", (c_out,))}


def fused_conv_spec(c_in: int, c_out: int) -> Params:
    """3x3 conv behind GN -> SiLU, weight HWIO for the fused kernel, bias
    f32."""
    return {"w": Spec("conv_hwio", (3, 3, c_in, c_out)),
            "b": Spec("bias", (c_out,), f32=True)}


def norm_spec(c: int) -> Params:
    return {"scale": Spec("norm_scale", (c,)), "bias": Spec("bias", (c,))}


def fused_norm_spec(c: int) -> Params:
    """GroupNorm in front of a fused conv: scale and bias f32."""
    return {"scale": Spec("norm_scale", (c,), f32=True),
            "bias": Spec("bias", (c,), f32=True)}


# ------------------------------------------------- task models (nn.Module)
# The hinter models (models/{hinters,pose,uniformer,baenormal,mlsd}.py) are
# ``nn.Module``s whose parameter names follow the JAX package's params
# trees; they run NCHW with channels-last memory, cuDNN's layout for its
# tensor-core kernels.


def nchw(x):
    return x.permute(0, 3, 1, 2)


def nhwc(x):
    return x.permute(0, 2, 3, 1)


def same_padding(n: int, k: int, stride: int = 1, dilation: int = 1):
    """XLA's "SAME" padding of one axis, (before, after): the odd pixel of
    a stride-2 conv over an even size goes at the end."""
    k = (k - 1) * dilation + 1
    out = -(-n // stride)
    total = max((out - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


def conv_nchw(conv, x, stride: int = 1, padding="SAME", dilation: int = 1):
    """``conv`` (an nn.Conv2d) over x [B,C,H,W] in x's dtype, as the JAX
    package's ``conv2d`` pads: "SAME" (XLA's rule), "VALID", an int for
    every side, or ((top, bottom), (left, right)). Asymmetric padding is
    applied apart, zeros. Groups come from the module."""
    kh, kw = conv.weight.shape[2:]
    if padding == "SAME":
        ph = same_padding(x.shape[2], kh, stride, dilation)
        pw = same_padding(x.shape[3], kw, stride, dilation)
    elif padding == "VALID":
        ph = pw = (0, 0)
    elif isinstance(padding, int):
        ph = pw = (padding, padding)
    else:
        ph, pw = padding
    pad = (ph[0], pw[0])
    if ph[0] != ph[1] or pw[0] != pw[1]:
        x = F.pad(x, (pw[0], pw[1], ph[0], ph[1]))
        pad = (0, 0)
    x = x.contiguous(memory_format=torch.channels_last)
    bias = None if conv.bias is None else conv.bias.to(x.dtype)
    return F.conv2d(x, conv.weight.to(x.dtype), bias, stride, pad, dilation,
                    conv.groups)


def conv1x1_f32(conv, x):
    """A 1x1 conv over NHWC x as a product over the channel axis, in f32
    whatever the module's and x's dtype: the maps a threshold or an argmax
    reads."""
    w = conv.weight.float()[:, :, 0, 0]
    b = None if conv.bias is None else conv.bias.float()
    return F.linear(x.float(), w, b)


def linspace(stop: float, n: int, device=None):
    """``jnp.linspace(0, stop, n)`` as XLA computes it, f32: i * (stop *
    (1 / (n - 1))), the last point ``stop`` itself (torch.linspace rounds
    differently, and a rasteriser's thresholds see the last bit)."""
    if n == 1:
        return torch.zeros(1, device=device)
    step = np.float32(stop) * (np.float32(1.0) / np.float32(n - 1))
    i = torch.arange(n - 1, dtype=torch.float32, device=device)
    return torch.cat([i * float(step),
                      torch.full((1,), float(stop), device=device)])


def random_init(model, seed: int):
    """Random weights for a task model from a generator seeded ``seed`` on
    the model's device (a full-width model built on the card draws its
    weights there in a fraction of a second): conv and linear weights
    uniform in +-1/sqrt(fan_in) (the JAX package's conv_init and
    linear_init; fan_in: the inputs a weight sees, a transposed conv's
    in-channels x taps), biases zero, norm scales one and shifts zero."""
    dev = next(model.parameters()).device
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    norms = (nn.LayerNorm, nn.GroupNorm, nn.BatchNorm2d)
    with torch.no_grad():
        for name, p in model.named_parameters():
            owner = model.get_submodule(name.rsplit(".", 1)[0]) \
                if "." in name else model
            if isinstance(owner, norms):
                p.fill_(1.0 if name.endswith("weight") else 0.0)
            elif name.endswith("bias"):
                p.zero_()
            else:
                if isinstance(owner, nn.ConvTranspose2d):
                    fan_in = p.shape[0] * p.shape[2] * p.shape[3]
                else:
                    fan_in = int(np.prod(p.shape[1:]))
                lim = 1.0 / math.sqrt(fan_in)
                p.copy_((torch.rand(p.shape, generator=gen, device=dev) * 2
                         - 1) * lim)
    return model


# ------------------------------------------------- checkpoint helpers


def f32(v) -> np.ndarray:
    """A checkpoint value (a torch tensor of any float dtype, or an array)
    as a float32 numpy array."""
    if torch.is_tensor(v):
        return v.detach().float().cpu().numpy()
    return np.asarray(v, np.float32)


def fold_bn(w, b, state, pre, eps=1e-5):
    """Inference BatchNorm ``pre`` folded into the conv before it (OIHW w;
    numpy f32, as the JAX package folds); none when the state lacks it."""
    if pre is None or f"{pre}.weight" not in state:
        return w, b
    s = f32(state[f"{pre}.weight"]) / np.sqrt(
        f32(state[f"{pre}.running_var"]) + np.float32(eps))
    return (w * s[:, None, None, None],
            (b - f32(state[f"{pre}.running_mean"])) * s +
            f32(state[f"{pre}.bias"]))


def identity_bn(c: int, eps: float = 1e-5) -> dict:
    """A BatchNorm's four entries that fold to the identity (running
    variance 1 - eps), for the exporters."""
    return {"weight": np.ones(c, np.float32), "bias": np.zeros(c, np.float32),
            "running_mean": np.zeros(c, np.float32),
            "running_var": np.full(c, 1.0 - eps, np.float32)}


def state_shape(state, key) -> tuple:
    return tuple(state[key].shape)


def unwrap_basicsr(state: dict) -> dict:
    """A BasicSR .pth's ``params`` / ``params_ema`` nesting, dropped."""
    if "params" in state and isinstance(state["params"], dict):
        state = state["params"]
    if "params_ema" in state and isinstance(state["params_ema"], dict):
        state = state["params_ema"]
    return state


def load_state(model: nn.Module, fetch, name: str):
    """Fill every parameter of ``model`` from ``fetch(param_name)`` (a
    tensor or array in torch's layout; KeyError when the source lacks it),
    each checked against the parameter's shape."""
    with torch.no_grad():
        for pname, p in model.named_parameters():
            try:
                t = fetch(pname)
            except KeyError as e:
                raise ValueError(f"{name}: no key {e.args[0]} (for "
                                 f"{pname})") from None
            t = torch.as_tensor(np.asarray(t) if not torch.is_tensor(t)
                                else t)
            if tuple(t.shape) != tuple(p.shape):
                raise ValueError(f"{name}: {pname} has shape "
                                 f"{tuple(t.shape)}, expected "
                                 f"{tuple(p.shape)}")
            p.copy_(t.to(p.dtype))
    return model


def load_keyed(model: nn.Module, state: dict, pairs, name: str,
               buffers=()):
    """Fill ``model`` from a torch-layout ``state`` through (module prefix
    or bare parameter, published key or prefix) ``pairs``: strict, so a
    missing or misshapen key raises ValueError and a key left unread
    (``buffers`` tokens excepted) KeyError."""
    values, used = {}, set()
    params = dict(model.named_parameters())
    for mine, theirs in pairs:
        if mine in params:
            values[mine] = theirs
            continue
        for leaf in ("weight", "bias"):
            if f"{mine}.{leaf}" in params:
                values[f"{mine}.{leaf}"] = f"{theirs}.{leaf}"

    def fetch(pname):
        key = values[pname]
        used.add(key)
        return f32(state[key])

    load_state(model, fetch, name)
    left = sorted(k for k in state if k not in used and
                  not any(tok in k for tok in buffers))
    if left:
        raise KeyError(f"{name} loader left {len(left)} keys unconsumed: "
                       + ", ".join(left[:8]))
    return model


def export_keyed(model: nn.Module, pairs) -> dict:
    """``load_keyed``'s inverse: the parameters under their published keys,
    f32 numpy."""
    params = dict(model.named_parameters())
    out = {}
    for mine, theirs in pairs:
        for pname, key in ((mine, theirs),
                           (f"{mine}.weight", f"{theirs}.weight"),
                           (f"{mine}.bias", f"{theirs}.bias")):
            if pname in params:
                out[key] = params[pname].detach().float().cpu().numpy()
    return out
