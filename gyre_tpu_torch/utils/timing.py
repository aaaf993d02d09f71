"""Request phase timing: the observability surface the reference lacks
(SURVEY §5: "none beyond timing prints" — reference gyre/server.py:1203-
1209, tests/test_harness.py:155-168). Phases recorded by the servicer
(extract / queue / compute / per-step / encode) aggregate into a ring
buffer summarised on /status.

Copy of gyre_tpu/utils/timing.py, with torch.profiler in place of its jax
profiler hooks (the /profile/start and /profile/stop routes)."""

from __future__ import annotations

import os
import threading
import time
from collections import defaultdict, deque


class RequestStats:
    """Thread-safe per-phase duration ring (seconds)."""

    def __init__(self, maxlen: int = 512):
        self._lock = threading.Lock()
        self._rings: dict[str, deque] = defaultdict(
            lambda: deque(maxlen=maxlen))

    def record(self, phase: str, seconds: float):
        with self._lock:
            self._rings[phase].append(seconds)

    def timer(self, phase: str):
        return _Timer(self, phase)

    def summary(self) -> dict:
        out = {}
        with self._lock:
            for phase, ring in self._rings.items():
                if not ring:
                    continue
                vals = sorted(ring)
                n = len(vals)
                out[phase] = {
                    "count": n,
                    "p50_ms": round(vals[n // 2] * 1e3, 1),
                    "p95_ms": round(vals[min(n - 1,
                                             int(n * 0.95))] * 1e3, 1),
                    "last_ms": round(ring[-1] * 1e3, 1),
                }
        return out


class _Timer:
    def __init__(self, stats: RequestStats, phase: str):
        self.stats = stats
        self.phase = phase

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.stats.record(self.phase, time.perf_counter() - self.t0)
        return False


STATS = RequestStats()


_profile_lock = threading.Lock()
_profile: dict = {}     # the running trace: its thread and stop event


def profiler_start(log_dir: str) -> str | None:
    """Start a torch.profiler trace of the host and, with a CUDA device,
    of the card, written under log_dir by profiler_stop. The profiler
    starts and stops on a thread of its own (torch.profiler must stop on
    the thread that started it; the HTTP routes that call these run on
    one thread each). Returns an error string or None."""
    with _profile_lock:
        if _profile:
            return "a profile is already running"
        started, stop, box = threading.Event(), threading.Event(), {}
        thread = threading.Thread(target=_trace, daemon=True,
                                  name="profiler",
                                  args=(log_dir, started, stop, box))
        thread.start()
        started.wait()
        if "error" in box:
            thread.join()
            return box["error"]
        _profile.update(thread=thread, stop=stop, box=box)
    return None


def profiler_stop() -> str | None:
    """Stop the trace and write it as ``<log_dir>/trace-<time>.json``
    (Chrome trace format). Returns an error string or None."""
    with _profile_lock:
        if not _profile:
            return "no profile is running"
        _profile["stop"].set()
        _profile["thread"].join()
        box = _profile["box"]
        _profile.clear()
    return box.get("error")


def _trace(log_dir, started, stop, box):
    import torch
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    try:
        # every thread's operators, the dispatcher's too
        prof = profile(activities=activities,
                       experimental_config=_ExperimentalConfig(
                           profile_all_threads=True))
        prof.start()
    except (RuntimeError, TypeError) as e:
        box["error"] = str(e)
        started.set()
        return
    started.set()
    stop.wait()
    try:
        prof.stop()
        os.makedirs(log_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace-{time.strftime('%Y%m%d-%H%M%S')}.json"))
    except (RuntimeError, OSError) as e:
        box["error"] = str(e)
