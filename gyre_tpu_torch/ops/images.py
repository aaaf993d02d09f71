"""Image coding at the protocol boundary.

Counterpart of gyre_tpu/ops/images.py, the part the serving surface needs:
``encode_png``, a direct numpy + zlib PNG encoder (filter-0 scanlines, one
zlib stream, tEXt/iTXt metadata chunks), byte-compatible with the JAX
package's and free of Pillow; ``decode_png``, ``encode_webp`` and
``png_metadata``, which use Pillow as the JAX package's do. Where Pillow
is not installed those three raise NotImplementedError naming it, so a
WebP answer or an uploaded image answers UNIMPLEMENTED while PNG answers
go on working.

The image tensor ops, on [B,H,W,C] float tensors in [0,1], each following
the JAX file's formula (its padding, its kernels, no antialiasing where it
has none): ``normalise``, ``gaussian_blur`` (edge-replicated, separable),
``to_grayscale``, ``match_histograms`` (the inpaint outmask composite),
``rescale`` (strict / cover / contain, lanczos3 through ops/resize.py),
and the adjustments' ops (services/adjustments.py): ``levels``,
``invert``, ``channelmap``, ``directionalblur``, ``crop``, ``autoscale``,
``sobel_edges``, ``canny_edge``, ``normalmap_from_depthmap``,
``palletize``, ``quantize``, ``shuffle`` (its flow the JAX package's
threefry draw, ``shuffle_flow``),
``infill``, ``frequency_blend``, ``box_sum``, ``guided_filter`` and
``tv_denoise``.
"""

from __future__ import annotations

import io
import struct
import zlib

import numpy as np
import torch
import torch.nn.functional as F

from ..utils import rng


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


def levels(img, in_low: float = 0.0, in_high: float = 1.0,
           out_low: float = 0.0, out_high: float = 1.0):
    x = ((img - in_low) / max(in_high - in_low, 1e-8)).clamp(0.0, 1.0)
    return x * (out_high - out_low) + out_low


def invert(img):
    return 1.0 - img


CHANNEL_INDEX = {"r": 0, "g": 1, "b": 2, "a": 3}


def channelmap(img, src: str, dst: str):
    """Channel ``src`` ('r', 'g', 'b', 'a', 'zero' or 'one') copied into
    ``dst``; channels up to ``dst`` that the image lacks are added as
    ones."""
    c = img.shape[-1]
    if src == "zero":
        col = torch.zeros_like(img[..., :1])
    elif src == "one":
        col = torch.ones_like(img[..., :1])
    else:
        col = img[..., CHANNEL_INDEX[src]:CHANNEL_INDEX[src] + 1]
    d = CHANNEL_INDEX[dst]
    if d >= c:
        img = torch.cat([img] + [torch.ones_like(img[..., :1])] *
                        (d + 1 - c), dim=-1)
    else:
        img = img.clone()
    img[..., d:d + 1] = col
    return img


def directionalblur(img, sigma: float, direction: str = "up"):
    """One-sided vertical gaussian blur (the mask feathering of the
    protocol's default mask post-adjustment): "up" keeps the kernel's lower
    half and takes the maximum with the image, "down" its upper half."""
    radius = max(1, int(3 * sigma + 0.5))
    k = _gaussian_kernel1d(sigma, radius)
    if direction == "up":
        k[:radius] = 0.0
    else:
        k[radius + 1:] = 0.0
    k = torch.from_numpy(k / k.sum())
    x = F.pad(img.permute(0, 3, 1, 2), (0, 0, radius, radius),
              mode="replicate").permute(0, 2, 3, 1)
    out = _depthwise_1d(x, k, 1)
    return torch.maximum(out, img) if direction == "up" else out


def rescale(img, height: int, width: int, fit: str = "cover",
            method: str = "lanczos3"):
    """img [B,H,W,C] to (height, width) by ``method`` (ops/resize.py):
    "strict" resizes to it; "cover" scales to cover it and crops the
    centre; "contain" scales to fit inside it and pads the rest with the
    edge pixels."""
    from .resize import resize

    _, h, w, _ = img.shape
    if fit == "strict":
        return resize(img, (height, width), method)
    scale = max(height / h, width / w) if fit == "cover" else \
        min(height / h, width / w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    out = resize(img, (nh, nw), method)
    if fit == "cover":
        top, left = (nh - height) // 2, (nw - width) // 2
        return out[:, top:top + height, left:left + width]
    pt, pl = (height - nh) // 2, (width - nw) // 2
    return F.pad(out.permute(0, 3, 1, 2),
                 (pl, width - nw - pl, pt, height - nh - pt),
                 mode="replicate").permute(0, 2, 3, 1)


def crop(img, top: int, left: int, height: int, width: int):
    return img[:, top:top + height, left:left + width]


def autoscale(img, height: int, width: int, mode: str = "lanczos3"):
    return rescale(img, height, width, fit="cover", method=mode)


# ------------------------------------------------------------ edge / depth

_SOBEL_X = np.array([[-1, 0, 1], [-2, 0, 2], [-1, 0, 1]], np.float32)
_SOBEL_Y = np.ascontiguousarray(_SOBEL_X.T)


def _conv3(img1, kernel):
    """3x3 correlation of a one-channel [B,H,W,1] image, edge-replicated."""
    k = torch.from_numpy(kernel).to(img1.device, img1.dtype).view(1, 1, 3, 3)
    x = F.pad(img1.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="replicate")
    return F.conv2d(x, k).permute(0, 2, 3, 1)


def sobel_edges(img):
    """(magnitude, direction) of the grayscale image's sobel gradient."""
    g = to_grayscale(img)
    gx = _conv3(g, _SOBEL_X)
    gy = _conv3(g, _SOBEL_Y)
    return torch.sqrt(gx ** 2 + gy ** 2), torch.atan2(gy, gx)


def canny_edge(img, low: float = 0.1, high: float = 0.2):
    """Blur (sigma 1.4) -> sobel -> non-maximum suppression over 4
    direction bins (neighbours by wrap-around shifts) -> double threshold,
    weak pixels kept next to a strong one (one dilation step). [B,H,W,1]
    of 0 and 1."""
    g = gaussian_blur(to_grayscale(img), 1.4)
    mag, theta = sobel_edges(g)
    ang = torch.remainder(theta, np.pi) / np.pi * 4.0
    shifts = [((0, 1), (0, -1)), ((-1, 1), (1, -1)),
              ((1, 0), (-1, 0)), ((1, 1), (-1, -1))]
    keep = torch.zeros_like(mag, dtype=torch.bool)
    for b, (s1, s2) in enumerate(shifts):
        n1 = torch.roll(mag, s1, dims=(1, 2))
        n2 = torch.roll(mag, s2, dims=(1, 2))
        keep |= (ang >= b) & (ang < b + 1) & (mag >= n1) & (mag >= n2)
    nms = torch.where(keep, mag, torch.zeros_like(mag))
    strong = nms > high
    weak = nms > low
    dil = F.max_pool2d(strong.to(mag.dtype).permute(0, 3, 1, 2), 3, 1,
                       padding=1).permute(0, 2, 3, 1) > 0
    return (strong | (weak & dil)).to(mag.dtype)


def normalmap_from_depthmap(depth, background_threshold: float = 0.05):
    """Depth [B,H,W,1] -> normals [B,H,W,3] in [0,1]: the sobel gradient
    as (-gx, -gy, 2/H), normalised; pixels below the threshold face the
    viewer."""
    d = to_grayscale(depth)
    gx = _conv3(d, _SOBEL_X)
    gy = _conv3(d, _SOBEL_Y)
    z = torch.ones_like(gx) * 2.0 / d.shape[1]
    n = torch.cat([-gx, -gy, z], dim=-1)
    n = n / torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    up = torch.tensor([0.0, 0.0, 1.0], dtype=n.dtype, device=n.device)
    n = torch.where(d < background_threshold, up, n)
    return n * 0.5 + 0.5


# --------------------------------------------------------- quantize / misc


def palletize(img, colors: int = 16):
    """Each channel rounded to ``colors`` uniform levels."""
    q = float(colors - 1)
    return torch.round(img * q) / q


def quantize(img, threshold=0.5):
    """1 where the image exceeds ``threshold`` (a float, or one a channel),
    else 0."""
    if not isinstance(threshold, (int, float)):
        threshold = torch.tensor(list(threshold), dtype=img.dtype,
                                 device=img.device)
    return (img > threshold).to(img.dtype)


def shuffle_flow(shape, seed: int, tile: int = 64):
    """The content shuffle's random flow for an image of ``shape``
    [B,H,W,C]: [B, H // tile + 1, W // tile + 1, 2] standard normal on the
    CPU, the JAX package's draw from the first half of the split of
    ``PRNGKey(seed)``."""
    b, h, w, _ = shape
    key = rng.split(rng.key_for_seed(seed))[0]
    return rng.normal(key, (b, h // tile + 1, w // tile + 1, 2))


def shuffle(img, flow, tile: int = 64):
    """The content shuffle (ControlNet shuffle): ``flow`` (shuffle_flow)
    resized bicubic to the image and scaled by tile / 2 gives each pixel
    the offset of the pixel it takes, clipped to the image."""
    from .resize import resize

    b, h, w, _ = img.shape
    flow = resize(flow.to(img.device, torch.float32), (h, w), "bicubic") * \
        (tile / 2.0)
    yy = torch.arange(h, device=img.device)[None, :, None]
    xx = torch.arange(w, device=img.device)[None, None, :]
    sy = (yy + flow[..., 0]).clamp(0, h - 1).long()
    sx = (xx + flow[..., 1]).clamp(0, w - 1).long()
    bidx = torch.arange(b, device=img.device)[:, None, None]
    return img[bidx, sy, sx]


def infill(img, mask_keep, iterations: int = 16):
    """Fill where ``mask_keep`` <= 0.5 by repeated normalised blurs
    (sigma 2) of the kept pixels, growing the filled area a step at a
    time; kept pixels are returned as they were."""
    out = img * mask_keep
    alpha = mask_keep
    for _ in range(iterations):
        out_b = gaussian_blur(out, 2.0)
        alpha_b = gaussian_blur(alpha, 2.0)
        fill = out_b / torch.clamp(alpha_b, min=1e-6)
        reached = alpha_b > 1e-4
        out = torch.where(alpha > 0.5, out, fill * reached)
        alpha = torch.maximum(alpha, reached.to(alpha.dtype))
    return torch.where(mask_keep > 0.5, img, out)


# ------------------------------------------------------ frequency blending


def frequency_blend(low_img, high_img, sigma: float = 4.0):
    """Low frequencies of one image with the high ones of another."""
    low = gaussian_blur(low_img, sigma)
    high = high_img - gaussian_blur(high_img, sigma)
    return (low + high).clamp(0.0, 1.0)


def _box_sum_1d(x, radius: int, axis: int):
    """Sum over [i - r, i + r] along ``axis``, zero outside, from a
    cumulative sum."""
    n = x.shape[axis]
    c = torch.cumsum(x, dim=axis)
    c = torch.cat([torch.zeros_like(c.narrow(axis, 0, 1)), c], dim=axis)
    idx = np.arange(n)
    hi = torch.from_numpy(np.clip(idx + radius + 1, 0, n)).to(x.device)
    lo = torch.from_numpy(np.clip(idx - radius, 0, n)).to(x.device)
    return c.index_select(axis, hi) - c.index_select(axis, lo)


def box_sum(x, radius: int):
    """Sum over the (2r+1)^2 box around each pixel of NHWC x, zero
    outside."""
    return _box_sum_1d(_box_sum_1d(x, radius, 1), radius, 2)


def guided_filter(guide, src, radius: int = 32, eps: float = 1e-6):
    """He et al.'s guided filter of ``src`` by a grayscale or RGB
    ``guide``, NHWC in [0,1], in f32 with box sums; an RGB guide solves a
    3x3 system a pixel."""
    guide = guide.float()
    src = src.float()
    gc = guide.shape[-1]
    n = box_sum(torch.ones(guide.shape[:3] + (1,), device=guide.device),
                radius)

    def mean(x):
        return box_sum(x, radius) / n

    mean_i = mean(guide)
    mean_p = mean(src)
    if gc == 1:
        cov_ip = mean(guide * src) - mean_i * mean_p
        var_i = mean(guide * guide) - mean_i * mean_i
        a = cov_ip / (var_i + eps)
        b = mean_p - a * mean_i
        return mean(a) * guide + mean(b)
    sc = src.shape[-1]
    bhw = tuple(guide.shape[:3])

    def mean_outer(x, y):
        prod = (x[..., :, None] * y[..., None, :]).reshape(
            bhw + (x.shape[-1] * y.shape[-1],))
        return mean(prod).reshape(bhw + (x.shape[-1], y.shape[-1]))

    cov_ip = mean_outer(guide, src) - mean_i[..., :, None] * \
        mean_p[..., None, :]
    sigma = mean_outer(guide, guide) - mean_i[..., :, None] * \
        mean_i[..., None, :]
    sigma = sigma + eps * torch.eye(gc, device=guide.device)
    a = torch.linalg.solve(sigma, cov_ip)
    b = mean_p - torch.einsum("bhwgc,bhwg->bhwc", a, mean_i)
    mean_a = mean(a.reshape(bhw + (gc * sc,))).reshape(a.shape)
    return torch.einsum("bhwgc,bhwg->bhwc", mean_a, guide) + mean(b)


def tv_denoise(img, weight: float = 0.1, iterations: int = 16):
    """Total-variation smoothing steps (forward differences, the last row
    and column repeated), clipped to [0,1]."""
    x = img
    for _ in range(iterations):
        dx = torch.diff(x, dim=2, append=x[:, :, -1:])
        dy = torch.diff(x, dim=1, append=x[:, -1:, :])
        norm = torch.sqrt(dx ** 2 + dy ** 2 + 1e-8)
        x = x + weight * 0.125 * (dx / norm + dy / norm)
    return x.clamp(0.0, 1.0)
