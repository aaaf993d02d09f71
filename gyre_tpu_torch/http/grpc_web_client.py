"""gRPC-WEB client over plain HTTP (the reference vendors sonora's
requests-based WebChannel, gyre/sonora/client.py; this is an original
urllib implementation of the same protocol for environments without
grpc/h2 — e.g. browsers proxies, tests, simple tooling).

Copy of gyre_tpu/http/grpc_web_client.py."""

from __future__ import annotations

import urllib.request

from . import grpc_web


class GrpcWebError(RuntimeError):
    def __init__(self, status: int, message: str):
        self.status = status
        super().__init__(f"grpc-status {status}: {message}")


class WebChannel:
    def __init__(self, base_url: str, token: str | None = None,
                 timeout: float = 600.0):
        self.base_url = base_url.rstrip("/")
        self.token = token
        self.timeout = timeout

    def _call(self, path: str, payload: bytes) -> list[bytes]:
        headers = {"Content-Type": "application/grpc-web+proto"}
        if self.token:
            headers["Authorization"] = f"Bearer {self.token}"
        req = urllib.request.Request(
            self.base_url + path, data=grpc_web.wrap_message(payload),
            headers=headers, method="POST")
        with urllib.request.urlopen(req, timeout=self.timeout) as resp:
            body = resp.read()
        messages = []
        status, detail = 0, ""
        for flags, data in grpc_web.unwrap_message_stream(body):
            if flags & grpc_web.TRAILER_FLAG:
                for line in data.decode().splitlines():
                    k, _, v = line.partition(":")
                    if k.strip() == "grpc-status":
                        status = int(v.strip())
                    elif k.strip() == "grpc-message":
                        detail = v.strip()
            else:
                messages.append(data)
        if status != 0:
            raise GrpcWebError(status, detail)
        return messages

    def unary_unary(self, method: str, serializer, deserializer):
        def call(request):
            out = self._call(method, serializer(request))
            return deserializer(out[0]) if out else None

        return call

    def unary_stream(self, method: str, serializer, deserializer):
        def call(request):
            for data in self._call(method, serializer(request)):
                yield deserializer(data)

        return call
