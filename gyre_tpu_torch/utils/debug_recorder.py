"""Opt-in rolling debug recorder: recent requests/args/results captured as
gzipped JSON bundles for bug reports (reference gyre/debug_recorder.py:
36-109's rolling 10-minute YAML capture).

Copy of gyre_tpu/utils/debug_recorder.py."""

from __future__ import annotations

import gzip
import json
import os
import time
import uuid


class DebugNullRecorder:
    def record(self, label: str):
        return _NullStore()


class _NullStore:
    def store(self, key, value):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class DebugRecorder:
    def __init__(self, path: str, window_s: float = 600.0):
        self.path = path
        self.window_s = window_s
        os.makedirs(path, exist_ok=True)

    def record(self, label: str):
        return _Store(self, label)

    def _gc(self):
        now = time.time()
        for f in os.listdir(self.path):
            full = os.path.join(self.path, f)
            try:
                if now - os.path.getmtime(full) > self.window_s:
                    os.unlink(full)
            except OSError:
                pass


class _Store:
    def __init__(self, recorder: DebugRecorder, label: str):
        self.recorder = recorder
        self.label = label
        self.data: dict = {"label": label, "time": time.time()}

    def store(self, key: str, value):
        try:
            json.dumps(value)
            self.data[key] = value
        except TypeError:
            self.data[key] = repr(value)[:10000]

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc is not None:
            self.data["exception"] = repr(exc)
        name = f"{int(time.time())}-{self.label}-{uuid.uuid4().hex[:8]}.json.gz"
        try:
            with gzip.open(os.path.join(self.recorder.path, name),
                           "wt") as fh:
                json.dump(self.data, fh)
            self.recorder._gc()
        except OSError:
            pass
        return False
