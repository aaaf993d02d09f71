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
"""

from __future__ import annotations

import math

import torch
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


def gn_silu_conv3x3(norm_p: Params, conv_p: Params, x, groups: int,
                    eps: float):
    """GroupNorm -> SiLU -> 3x3 conv of a resnet block, through the fused
    kernels K2a + K2b on the card (ops/fused_norm_conv.py); conv_p["w"]
    is HWIO."""
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


# ------------------------------------------------------------ param specs
# Each model's ``param_specs(cfg)`` builds its params tree with a Spec at
# every leaf: the leaf's kind and its shape in the port's layout. The same
# tree drives random initialisation and the bridge from the JAX package's
# params (models/modelset.py).


class Spec:
    """A parameter leaf. kind: "linear" (out, in) | "conv" OIHW |
    "conv_hwio" HWIO | "bias" (zeros) | "norm_scale" (ones) | "normal"
    (embeddings, N(0, std^2))."""

    __slots__ = ("kind", "shape", "std")

    def __init__(self, kind: str, shape: tuple, std: float = 0.0):
        self.kind, self.shape, self.std = kind, tuple(shape), std

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
    """3x3 conv behind GN -> SiLU, weight HWIO for the fused kernel."""
    return {"w": Spec("conv_hwio", (3, 3, c_in, c_out)),
            "b": Spec("bias", (c_out,))}


def norm_spec(c: int) -> Params:
    return {"scale": Spec("norm_scale", (c,)), "bias": Spec("bias", (c,))}
