"""Host-RAM and device-memory monitor.

Counterpart of gyre_tpu/utils/monitor.py: a sampling thread tracking peak
host RSS and device memory. Device memory comes from PyTorch's CUDA
caching allocator (``torch.cuda.memory_stats``) and the card's total from
``torch.cuda.mem_get_info``, under the JAX package's keys.
"""

from __future__ import annotations

import logging
import threading

import torch

logger = logging.getLogger(__name__)


def host_rss_bytes() -> int:
    try:
        with open("/proc/self/statm") as fh:
            pages = int(fh.read().split()[1])
        return pages * 4096
    except OSError:
        return 0


def device_memory_stats() -> list[dict]:
    """Per-CUDA-device memory: ``bytes_in_use`` and ``peak_bytes_in_use``
    are what this process's allocator holds in tensors now and at most,
    ``bytes_limit`` the card's total. Empty without CUDA."""
    if not torch.cuda.is_available():
        return []
    out = []
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out.append({
            "device": f"cuda:{i}",
            "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "bytes_limit": torch.cuda.mem_get_info(i)[1],
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
        })
    return out


class ResourceMonitor:
    """Background sampler tracking peak host RSS + device memory."""

    def __init__(self, interval: float = 0.5):
        self.interval = interval
        self.peak_rss = 0
        self.peak_hbm = 0
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def _run(self):
        while not self._stop.wait(self.interval):
            self.sample()

    def sample(self):
        self.peak_rss = max(self.peak_rss, host_rss_bytes())
        for dev in device_memory_stats():
            self.peak_hbm = max(self.peak_hbm,
                                dev.get("peak_bytes_in_use", 0) or
                                dev.get("bytes_in_use", 0))

    def start(self):
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)

    def report(self) -> dict:
        self.sample()
        return {"peak_rss_mb": round(self.peak_rss / 1e6, 1),
                "peak_hbm_mb": round(self.peak_hbm / 1e6, 1)}

    def log(self, tag: str = ""):
        logger.info("%s %s", tag, self.report())
