"""PNG bytes as the server writes them (one zlib stream of filter-0 RGB or
RGBA scanlines) back to pixels, with no image library."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def pixels(data: bytes) -> np.ndarray:
    """uint8 [H, W, 3] (or [H, W, 4])."""
    if not data.startswith(b"\x89PNG\r\n\x1a\n"):
        raise ValueError("not a PNG")
    off, idat, width, height, c = 8, b"", 0, 0, 0
    while off < len(data):
        (length,), tag = struct.unpack(">I", data[off:off + 4]), \
            data[off + 4:off + 8]
        chunk = data[off + 8:off + 8 + length]
        if tag == b"IHDR":
            width, height = struct.unpack(">II", chunk[:8])
            c = {b"\x08\x02": 3, b"\x08\x06": 4}.get(chunk[8:10], 0)
            if not c:
                raise ValueError("PNG is not 8-bit RGB or RGBA")
        elif tag == b"IDAT":
            idat += chunk
        off += 12 + length
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
        height, 1 + c * width)
    if raw[:, 0].any():
        raise ValueError("PNG uses scanline filters")
    return raw[:, 1:].reshape(height, width, c)
