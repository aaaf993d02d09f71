"""Image coding at the protocol boundary.

Counterpart of gyre_tpu/ops/images.py, the part the serving surface needs:
``encode_png``, a direct numpy + zlib PNG encoder (filter-0 scanlines, one
zlib stream, tEXt/iTXt metadata chunks), byte-compatible with the JAX
package's and free of Pillow; ``decode_png``, ``encode_webp`` and
``png_metadata``, which use Pillow as the JAX package's do. Where Pillow
is not installed those three raise NotImplementedError naming it, so a
WebP answer or an uploaded image answers UNIMPLEMENTED while PNG answers
go on working.

The image tensor ops the generation modes need, on [B,H,W,C] tensors:
``normalise``, ``gaussian_blur`` (edge-replicated, separable),
``to_grayscale`` (depth2img's fallback depth map) and ``match_histograms``
(the inpaint outmask composite), and ``rescale`` (a hint image to the
request's size, lanczos3 through ops/resize.py). The other tensor ops of
the JAX file belong to the adjustments (ROADMAP D1).
"""

from __future__ import annotations

import io
import struct
import zlib

import numpy as np
import torch
import torch.nn.functional as F


def pil_image():
    """PIL.Image, or NotImplementedError when Pillow is not installed."""
    try:
        from PIL import Image
    except ImportError as e:
        raise NotImplementedError(
            "this needs the Pillow package (PIL), which is not installed "
            "here; PNG answers do not need it") from e
    return Image


def decode_png(data: bytes) -> np.ndarray:
    """bytes -> [1,H,W,C] float32 0..1 (C = 1/3/4)."""
    img = pil_image().open(io.BytesIO(data))
    arr = np.asarray(img).astype(np.float32) / 255.0
    if arr.ndim == 2:
        arr = arr[..., None]
    return arr[None]


def encode_webp(img: np.ndarray, quality: int = 90) -> bytes:
    """[H,W,C] or [1,H,W,C] (uint8, or float in [0,1]) -> WebP bytes."""
    image = pil_image()
    if img.ndim == 4:
        img = img[0]
    arr = np.asarray(img)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0, 1) * 255).round().astype(np.uint8)
    buf = io.BytesIO()
    image.fromarray(arr).save(buf, format="WEBP", quality=quality)
    return buf.getvalue()


def png_metadata(data: bytes) -> dict[str, str]:
    """The tEXt/iTXt chunks of PNG bytes."""
    img = pil_image().open(io.BytesIO(data))
    return dict(img.text) if hasattr(img, "text") else {}


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data +
            struct.pack(">I", zlib.crc32(tag + data)))


def _png_text_chunks(metadata: dict[str, str]) -> bytes:
    """tEXt for latin-1 payloads, iTXt (UTF-8) otherwise."""
    out = b""
    for k, v in metadata.items():
        key = str(k)[:79].encode("latin-1", "replace")
        try:
            out += _png_chunk(b"tEXt", key + b"\0" + str(v).encode("latin-1"))
        except UnicodeEncodeError:
            out += _png_chunk(b"iTXt", key + b"\0\0\0\0\0" +
                              str(v).encode("utf-8"))
    return out


def encode_png(img: np.ndarray,
               metadata: dict[str, str] | None = None) -> bytes:
    """[H,W,C] or [1,H,W,C] (uint8, or float in [0,1]) with C in 1/3/4 ->
    PNG bytes, zlib level 1 (the JAX package's serving default: encode
    time matters more than a few percent of size)."""
    if img.ndim == 4:
        img = img[0]
    arr = np.ascontiguousarray(img)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0, 1) * 255).round().astype(np.uint8)
    h, w, c = arr.shape
    color_type = {1: 0, 3: 2, 4: 6}.get(c)
    if color_type is None:
        raise ValueError(f"PNG encode: unsupported channel count {c}")
    raw = np.empty((h, 1 + w * c), np.uint8)
    raw[:, 0] = 0               # filter type 0 (None) per scanline
    raw[:, 1:] = arr.reshape(h, w * c)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", ihdr)
            + _png_text_chunks(metadata or {})
            + _png_chunk(b"IDAT", zlib.compress(raw.tobytes(), 1))
            + _png_chunk(b"IEND", b""))


# ------------------------------------------------------------ tensor ops


def normalise(img, r_from: float = 0.0, r_to: float = 1.0):
    """Each image's values mapped linearly onto [r_from, r_to]."""
    lo = img.amin(dim=(1, 2, 3), keepdim=True)
    hi = img.amax(dim=(1, 2, 3), keepdim=True)
    x = (img - lo) / torch.clamp(hi - lo, min=1e-8)
    return x * (r_to - r_from) + r_from


def _gaussian_kernel1d(sigma: float, radius: int) -> np.ndarray:
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / max(sigma, 1e-8)) ** 2)
    return (k / k.sum()).astype(np.float32)


def _depthwise_1d(x, kernel, axis: int):
    """Depthwise 1-D correlation of NHWC x along H (axis=1) or W (axis=2),
    no padding."""
    c = x.shape[-1]
    k = kernel.to(x.device, x.dtype)
    k = k.view(1, 1, -1, 1) if axis == 1 else k.view(1, 1, 1, -1)
    y = F.conv2d(x.permute(0, 3, 1, 2), k.expand(c, 1, *k.shape[2:]),
                 groups=c)
    return y.permute(0, 2, 3, 1)


def gaussian_blur(img, sigma: float):
    """Separable gaussian blur, edge-replicated."""
    radius = max(1, int(3 * sigma + 0.5))
    k = torch.from_numpy(_gaussian_kernel1d(sigma, radius))
    x = F.pad(img.permute(0, 3, 1, 2), (0, 0, radius, radius),
              mode="replicate").permute(0, 2, 3, 1)
    x = _depthwise_1d(x, k, 1)
    x = F.pad(x.permute(0, 3, 1, 2), (radius, radius, 0, 0),
              mode="replicate").permute(0, 2, 3, 1)
    return _depthwise_1d(x, k, 2)


def to_grayscale(img):
    """[B,H,W,1] luma (ITU-R 601 weights) of an RGB(A) image."""
    if img.shape[-1] == 1:
        return img
    w = torch.tensor([0.299, 0.587, 0.114], dtype=img.dtype,
                     device=img.device)
    return (img[..., :3] * w).sum(dim=-1, keepdim=True)


def match_histograms(source, reference, mask=None):
    """Each channel of ``source`` given ``reference``'s value distribution
    by sorted-value quantile mapping, [B,H,W,C] each. Ranks come from a
    stable sort, as ``jnp.argsort``'s: tied values (common in images
    clipped to [0, 1]) keep their pixel order."""
    b, h, w, c = source.shape
    n = h * w
    src = source.reshape(b, n, c)
    ref_sorted = torch.sort(reference.reshape(b, -1, c), dim=1,
                            stable=True).values
    order = torch.argsort(src, dim=1, stable=True)
    ranks = torch.argsort(order, dim=1, stable=True)
    ref_n = ref_sorted.shape[1]
    q = (ranks.float() / max(n - 1, 1)) * (ref_n - 1)
    lo = torch.floor(q).long()
    hi = torch.clamp(lo + 1, 0, ref_n - 1)
    frac = q - lo.float()
    mapped = (torch.gather(ref_sorted, 1, lo) * (1 - frac) +
              torch.gather(ref_sorted, 1, hi) * frac)
    out = mapped.reshape(b, h, w, c)
    if mask is not None:
        out = out * mask + source * (1 - mask)
    return out


def rescale(img, height: int, width: int):
    """img [B,H,W,C] to (height, width), lanczos3 (ops/resize.py): scaled
    to cover the target, then its centre cropped (the JAX package's
    ``fit="cover"``; its other fits belong to the adjustments, ROADMAP
    D1)."""
    from .resize import resize

    _, h, w, _ = img.shape
    scale = max(height / h, width / w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    out = resize(img, (nh, nw), "lanczos3")
    top, left = (nh - height) // 2, (nw - width) // 2
    return out[:, top:top + height, left:left + width]
