"""Resource provider: whitelist rule engine + fetch into cache (reference
gyre/resources/__init__.py:36-226).

Sources: local files (path-prefix mapped), data embedded in requests, and —
when the deployment allows egress — http(s)/huggingface/civitai URLs.
The provider returns bytes; nothing here deserializes them.

Copy of gyre_tpu/utils/resources.py."""

from __future__ import annotations

import fnmatch
import logging
import os
import re
from dataclasses import dataclass, field

logger = logging.getLogger(__name__)


@dataclass
class WhitelistRule:
    """Accept rule: all present fields must match (reference rule engine,
    gyre/resources/__init__.py:36-101)."""

    source: str = "*"       # glob over URL / path
    type: str = "*"         # lora | embedding | image | ...
    format: str = "*"       # safetensors | png | ...
    max_size: int = 0       # bytes; 0 = unlimited

    def matches(self, source: str, rtype: str, fmt: str, size: int) -> bool:
        if not fnmatch.fnmatch(source, self.source):
            return False
        if not fnmatch.fnmatch(rtype, self.type):
            return False
        if not fnmatch.fnmatch(fmt, self.format):
            return False
        if self.max_size and size > self.max_size:
            return False
        return True


DEFAULT_WHITELIST = [
    WhitelistRule(source="file:*", type="*", format="safetensors"),
    WhitelistRule(source="file:*", type="image", format="*"),
    WhitelistRule(source="https://civitai.com/*", format="safetensors",
                  max_size=2 * 1024 ** 3),
    WhitelistRule(source="https://huggingface.co/*", format="safetensors",
                  max_size=8 * 1024 ** 3),
]


class ResourceError(PermissionError):
    pass


class ResourceProvider:
    def __init__(self, cache, whitelist: list[WhitelistRule] | None = None,
                 local_roots: dict[str, str] | None = None,
                 allow_network: bool = False):
        self.cache = cache
        self.whitelist = whitelist if whitelist is not None \
            else list(DEFAULT_WHITELIST)
        self.local_roots = local_roots or {}
        self.allow_network = allow_network

    def check(self, source: str, rtype: str, fmt: str,
              size: int = 0) -> bool:
        return any(r.matches(source, rtype, fmt, size)
                   for r in self.whitelist)

    def _local_path(self, source: str) -> str | None:
        if source.startswith("file:"):
            rel = source[5:].lstrip("/")
            prefix, _, rest = rel.partition("/")
            root = self.local_roots.get(prefix)
            if root is None:
                raise ResourceError(f"unmapped local prefix {prefix!r}")
            path = os.path.realpath(os.path.join(root, rest))
            if not path.startswith(os.path.realpath(root) + os.sep):
                raise ResourceError("path escapes mapped root")
            return path
        return None

    def fetch(self, source: str, rtype: str = "model",
              fmt: str = "safetensors") -> bytes:
        cached = self.cache.get(source) if self.cache else None
        if cached is not None:
            return cached
        if not self.check(source, rtype, fmt):
            raise ResourceError(
                f"resource {source!r} ({rtype}/{fmt}) not whitelisted")
        path = self._local_path(source)
        if path:
            with open(path, "rb") as fh:
                data = fh.read()
        elif source.startswith(("http://", "https://")):
            if not self.allow_network:
                raise ResourceError(
                    "network fetch disabled in this deployment")
            data = self._http_fetch(source)
        else:
            raise ResourceError(f"unsupported source {source!r}")
        if self.cache:
            self.cache.set(source, data)
        return data

    def _http_fetch(self, url: str) -> bytes:
        import urllib.request

        with urllib.request.urlopen(url, timeout=300) as resp:
            return resp.read()
