"""Visual logging + in-memory log store (reference gyre/logging.py:41-350:
VisualRecord messages embedding image tensors as cached thumbnails served
at /log/<key>, plus a ring buffer backing the /log UI).

Copy of gyre_tpu/utils/logview.py; its ops.images import is the port's
module."""

from __future__ import annotations

import collections
import logging
import threading
import time
import uuid


class VisualRecord:
    """A log message carrying images: `logger.info(VisualRecord("stage", imgs))`.
    Images are pushed into the shared image cache and replaced by /log URLs
    in the formatted text."""

    cache = None  # class-level: set by the server at startup

    def __init__(self, message: str, *images):
        self.message = message
        self.keys: list[str] = []
        from ..ops import images as I

        for img in images:
            key = uuid.uuid4().hex[:12]
            if VisualRecord.cache is not None:
                try:
                    VisualRecord.cache.set(key, I.encode_png(img),
                                           ttl=3600.0)
                    self.keys.append(key)
                except Exception:  # noqa: BLE001
                    pass

    def __str__(self):
        urls = " ".join(f"/log/{k}" for k in self.keys)
        return f"{self.message} {urls}".strip()


class StoreHandler(logging.Handler):
    """Ring buffer of the last N formatted records (reference
    StoreHandler, gyre/logging.py:281-298)."""

    def __init__(self, capacity: int = 1000):
        super().__init__()
        self.records: collections.deque = collections.deque(maxlen=capacity)
        self._lock2 = threading.Lock()

    def emit(self, record):
        # A bad format string must never propagate into the caller (it
        # would abort the RPC that happened to log); match stdlib handler
        # behavior and route to handleError instead.
        try:
            message = self.format(record)
        except Exception:
            self.handleError(record)
            return
        with self._lock2:
            self.records.append({
                "time": time.time(),
                "level": record.levelname,
                "name": record.name,
                "message": message,
            })

    def tail(self, n: int = 100) -> list[dict]:
        with self._lock2:
            return list(self.records)[-n:]


_store: StoreHandler | None = None


def configure_logging(level=logging.INFO, image_cache=None) -> StoreHandler:
    """Root logging setup: console + ring buffer; wires the visual-record
    image cache (reference configure_logging, gyre/logging.py:324-350)."""
    global _store
    VisualRecord.cache = image_cache
    _store = StoreHandler()
    _store.setFormatter(logging.Formatter("%(message)s"))
    logging.basicConfig(
        level=level,
        format="%(asctime)s %(levelname).1s %(name)s: %(message)s")
    # basicConfig is a no-op if the root logger is already configured
    # (e.g. under a test runner) — force the level so INFO records flow
    logging.getLogger().setLevel(level)
    logging.getLogger().addHandler(_store)
    return _store


def log_store() -> StoreHandler | None:
    return _store
