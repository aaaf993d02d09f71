"""Tensor/artifact LRU caches: memory, disk (safetensors files), and dual
variants with TTL expiry and keyspaces (reference gyre/cache.py:62-324;
used for uploaded resources and log images).

Copy of gyre_tpu/utils/cache.py."""

from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass


@dataclass
class CacheEntry:
    value: object
    expires: float | None
    size: int


class MemoryLRUCache:
    """Thread-safe LRU with byte budget + optional TTL."""

    def __init__(self, max_bytes: int = 512 * 1024 * 1024,
                 default_ttl: float | None = None):
        self.max_bytes = max_bytes
        self.default_ttl = default_ttl
        self._lock = threading.Lock()
        self._data: OrderedDict[str, CacheEntry] = OrderedDict()
        self._bytes = 0

    @staticmethod
    def _sizeof(value) -> int:
        if isinstance(value, (bytes, bytearray)):
            return len(value)
        if hasattr(value, "nbytes"):
            return int(value.nbytes)
        if isinstance(value, dict):
            return sum(MemoryLRUCache._sizeof(v) for v in value.values())
        return 1024

    def set(self, key: str, value, ttl: float | None = None):
        size = self._sizeof(value)
        ttl = ttl if ttl is not None else self.default_ttl
        expires = time.monotonic() + ttl if ttl else None
        with self._lock:
            if key in self._data:
                self._bytes -= self._data.pop(key).size
            self._data[key] = CacheEntry(value, expires, size)
            self._bytes += size
            while self._bytes > self.max_bytes and len(self._data) > 1:
                _, old = self._data.popitem(last=False)
                self._bytes -= old.size

    def get(self, key: str, default=None):
        with self._lock:
            entry = self._data.get(key)
            if entry is None:
                return default
            if entry.expires and time.monotonic() > entry.expires:
                self._bytes -= entry.size
                del self._data[key]
                return default
            self._data.move_to_end(key)
            return entry.value

    def __contains__(self, key):
        return self.get(key, _SENTINEL) is not _SENTINEL

    def keys(self):
        with self._lock:
            return list(self._data)

    def expire(self):
        now = time.monotonic()
        with self._lock:
            for k in list(self._data):
                e = self._data[k]
                if e.expires and now > e.expires:
                    self._bytes -= e.size
                    del self._data[k]


_SENTINEL = object()


class DiskCache:
    """Byte-blob disk cache with LRU-by-mtime eviction."""

    def __init__(self, path: str, max_bytes: int = 4 * 1024 ** 3):
        self.path = path
        self.max_bytes = max_bytes
        os.makedirs(path, exist_ok=True)
        self._lock = threading.Lock()

    def _file(self, key: str) -> str:
        safe = "".join(c if c.isalnum() or c in "-_." else "_" for c in key)
        return os.path.join(self.path, safe)

    def set(self, key: str, value: bytes, ttl=None):
        with self._lock:
            with open(self._file(key), "wb") as fh:
                fh.write(value)
            self._evict()

    def get(self, key: str, default=None):
        f = self._file(key)
        try:
            with open(f, "rb") as fh:
                data = fh.read()
            os.utime(f)
            return data
        except FileNotFoundError:
            return default

    def _evict(self):
        files = [(os.path.getmtime(os.path.join(self.path, f)),
                  os.path.join(self.path, f))
                 for f in os.listdir(self.path)]
        total = sum(os.path.getsize(f) for _, f in files)
        for _, f in sorted(files):
            if total <= self.max_bytes:
                break
            total -= os.path.getsize(f)
            os.unlink(f)


class DualCache:
    """Memory front + disk spillover (reference TensorLRUCache_Dual)."""

    def __init__(self, mem: MemoryLRUCache, disk: DiskCache | None):
        self.mem = mem
        self.disk = disk

    def set(self, key: str, value, ttl=None):
        self.mem.set(key, value, ttl)
        if self.disk is not None and isinstance(value, (bytes, bytearray)):
            self.disk.set(key, bytes(value))

    def get(self, key: str, default=None):
        v = self.mem.get(key, _SENTINEL)
        if v is not _SENTINEL:
            return v
        if self.disk is not None:
            v = self.disk.get(key, _SENTINEL)
            if v is not _SENTINEL:
                self.mem.set(key, v)
                return v
        return default


class KeyspacedCache:
    """Prefix-namespaced view over a cache (reference keyspaces
    'generation:'/'resources:', gyre/server.py:1025-1036)."""

    def __init__(self, base, keyspace: str):
        self.base = base
        self.keyspace = keyspace

    def set(self, key, value, ttl=None):
        self.base.set(self.keyspace + key, value, ttl)

    def get(self, key, default=None):
        return self.base.get(self.keyspace + key, default)
