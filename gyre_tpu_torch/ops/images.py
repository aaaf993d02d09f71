"""Image coding at the protocol boundary.

Counterpart of gyre_tpu/ops/images.py, the part the serving surface needs:
``encode_png``, a direct numpy + zlib PNG encoder (filter-0 scanlines, one
zlib stream, tEXt/iTXt metadata chunks), byte-compatible with the JAX
package's and free of Pillow; ``decode_png``, ``encode_webp`` and
``png_metadata``, which use Pillow as the JAX package's do. Where Pillow
is not installed those three raise NotImplementedError naming it, so a
WebP answer or an uploaded image answers UNIMPLEMENTED while PNG answers
go on working.
"""

from __future__ import annotations

import io
import struct
import zlib

import numpy as np


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
