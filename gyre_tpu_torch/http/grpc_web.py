"""gRPC-WEB protocol framing (the reference vendors sonora for this,
gyre/sonora/protocol.py:24-121; this is an original minimal implementation
of the same public protocol: 5-byte frame header [flags|u32 length], trailer
frames with flag 0x80, optional base64 ("text") mode).

Copy of gyre_tpu/http/grpc_web.py."""

from __future__ import annotations

import base64
import struct
from typing import Iterable, Iterator

HEADER = struct.Struct(">BI")
TRAILER_FLAG = 0x80


def wrap_message(data: bytes, trailer: bool = False) -> bytes:
    return HEADER.pack(TRAILER_FLAG if trailer else 0, len(data)) + data


def unwrap_message_stream(buf: bytes) -> Iterator[tuple[int, bytes]]:
    off = 0
    while off + 5 <= len(buf):
        flags, length = HEADER.unpack_from(buf, off)
        off += 5
        yield flags, buf[off:off + length]
        off += length


def encode_trailers(status: int = 0, message: str = "") -> bytes:
    lines = [f"grpc-status: {status}"]
    if message:
        lines.append(f"grpc-message: {message}")
    return ("\r\n".join(lines) + "\r\n").encode()


def frame_responses(messages: Iterable[bytes], status: int = 0,
                    message: str = "", text_mode: bool = False) -> Iterator[bytes]:
    """Yield wire chunks for a (streaming) grpc-web response."""

    def enc(chunk: bytes) -> bytes:
        return base64.b64encode(chunk) if text_mode else chunk

    for m in messages:
        yield enc(wrap_message(m))
    yield enc(wrap_message(encode_trailers(status, message), trailer=True))


def decode_request_body(body: bytes, content_type: str) -> bytes:
    """First message payload from a grpc-web request body."""
    if "text" in content_type:
        body = base64.b64decode(body)
    for flags, data in unwrap_message_stream(body):
        if not flags & TRAILER_FLAG:
            return data
    return b""


def is_grpc_web(content_type: str) -> bool:
    return content_type.startswith("application/grpc-web")
