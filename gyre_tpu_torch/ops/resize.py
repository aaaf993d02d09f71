"""Image resize that computes what ``jax.image.resize`` computes.

The JAX package resizes with ``jax.image.resize``: the hires fix's latents
(bicubic, up and down), depth2img's depth map, the outmask composite's
keep mask and a hint's mask (bilinear), inpaint9's hard mask (nearest),
and a hint image rescaled to the request's size (lanczos3, ops/images.py's
``rescale``). ``F.interpolate`` has no lanczos kernel and computes the
others differently: its cubic kernel has a = -0.75 where JAX's Keys
kernel has a = -0.5, it clamps the taps at the edges where JAX drops the
taps outside the input and renormalises the rest, and it does not widen
its kernel when it downscales unless asked to. So each resized axis here
gets JAX's weight matrix, built as ``jax.image.scale_and_translate``
builds it: half-pixel sample positions, the method's kernel, scaled by the
downscale factor (antialiasing), taps outside the input dropped and each
output's weights renormalised to sum 1. Two einsums apply them. Nearest
takes the input pixel under each output pixel's centre, as JAX does.
"""

from __future__ import annotations

import numpy as np
import torch


def _triangle(x):
    return np.maximum(0.0, 1.0 - np.abs(x))


def _keys_cubic(x):
    """Keys (1981) cubic convolution kernel, a = -0.5."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return np.where(x >= 2.0, 0.0, out)


def _lanczos3(x):
    """Lanczos kernel of radius 3, as jax.image builds it: 1 within 1e-3
    of 0, sinc(x) sinc(x / 3) to 3, 0 past it (x >= 0)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        y = 3.0 * np.sin(np.pi * x) * np.sin(np.pi * x / 3.0)
        out = np.where(x > 1e-3, y / np.where(x != 0, np.pi ** 2 * x ** 2, 1),
                       1.0)
    return np.where(x > 3.0, 0.0, out)


_KERNELS = {"bilinear": _triangle, "bicubic": _keys_cubic,
            "lanczos3": _lanczos3}


def weight_matrix(in_size: int, out_size: int, method: str) -> np.ndarray:
    """[in_size, out_size] float32 resampling weights of one axis."""
    kernel = _KERNELS[method]
    inv_scale = in_size / out_size
    kernel_scale = max(inv_scale, 1.0)
    sample = (np.arange(out_size, dtype=np.float32) + 0.5) * np.float32(
        inv_scale) - 0.5
    x = np.abs(sample[None, :] - np.arange(in_size, dtype=np.float32)[:, None]
               ) / np.float32(kernel_scale)
    w = kernel(x).astype(np.float32)
    total = w.sum(axis=0, keepdims=True)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[None, :], w, 0).astype(np.float32)


def _nearest_index(in_size: int, out_size: int) -> np.ndarray:
    pos = (np.arange(out_size, dtype=np.float32) + 0.5) * np.float32(
        in_size) / np.float32(out_size)
    return np.floor(pos.astype(np.float32)).astype(np.int64)


def resize(x, size, method: str):
    """x [B,H,W,C] -> [B,h,w,C] for ``size`` = (h, w), by ``method``:
    "nearest", "bilinear", "bicubic" or "lanczos3". An axis whose size is
    unchanged is left as it is, as in JAX."""
    h, w = size
    b, in_h, in_w, c = x.shape
    if method == "nearest":
        if in_h != h:
            x = x[:, torch.from_numpy(_nearest_index(in_h, h)).to(x.device)]
        if in_w != w:
            x = x[:, :, torch.from_numpy(_nearest_index(in_w, w)).to(
                x.device)]
        return x
    if method not in _KERNELS:
        raise ValueError(f"unknown resize method {method!r}")
    if in_h != h:
        wh = torch.from_numpy(weight_matrix(in_h, h, method))
        x = torch.einsum("bhwc,hy->bywc", x, wh.to(x.device, x.dtype))
    if in_w != w:
        ww = torch.from_numpy(weight_matrix(in_w, w, method))
        x = torch.einsum("bhwc,wx->bhxc", x, ww.to(x.device, x.dtype))
    return x
