"""The device trace of a ``--trace 1`` run: torch.profiler's CUDA activity
(CUPTI), started and stopped on the dispatcher's thread between two
chunks, so that every kernel launched in the traced part of the window ran
in it and the launch counters bracket exactly the traced work. Host
operations are not traced: their tracing would slow the host, which paces
part of the work, and move the device's idle share.

``reduce`` turns the profile into what the per-layer readers and the
result line take: the device's busy seconds (the union of every kernel,
copy and set on the card), the traced window's length, device time by
operation, each kernel's name and duration, and the longest idle gaps,
each named by what the dispatcher's thread was doing then (from the
chunks it ran, program.py ``ChunkLog``).
"""

from __future__ import annotations

import time
from collections import defaultdict
from dataclasses import dataclass, field


@dataclass
class Trace:
    window_s: float = 0.0
    busy_s: float = 0.0
    kernels: list = field(default_factory=list)     # (name, seconds)
    device_ops: list = field(default_factory=list)  # top (name, seconds)
    idle_gaps: list = field(default_factory=list)   # top (name, seconds)
    launches: dict = field(default_factory=dict)    # launch counter delta


class Tracer:
    """Start and stop the profiler from the dispatcher's thread."""

    def __init__(self, system):
        self.system = system
        self.prof = None
        self.t = [0.0, 0.0]
        self.launches = [{}, {}]
        self.offset_ns = 0        # epoch ns minus perf_counter ns

    def _begin(self):
        import torch

        torch.cuda.synchronize()
        self.launches[0] = self.system.launches()
        self.prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        self.prof.start()
        self.system.log.tracing = True
        self.offset_ns = time.time_ns() - time.perf_counter_ns()
        self.t[0] = time.perf_counter()

    def _end(self):
        import torch

        torch.cuda.synchronize()
        self.t[1] = time.perf_counter()
        self.system.log.tracing = False
        self.launches[1] = self.system.launches()
        self.prof.stop()

    def prime(self):
        """Start and stop the profiler once before the window, so that
        its first start (CUPTI's set-up, seconds) is paid in set-up."""
        self.system.on_dispatcher(self._begin)
        self.system.on_dispatcher(self._end)
        self.prof = None

    def start(self):
        self.system.on_dispatcher(self._begin)

    def stop(self):
        self.system.on_dispatcher(self._end)

    def reduce(self) -> Trace:
        from torch.autograd import DeviceType

        dev = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA:
                s = e.start_ns()
                dev.append((s, s + e.duration_ns(), e.name()))
        out = Trace(window_s=self.t[1] - self.t[0])
        out.launches = {k: self.launches[1].get(k, 0) - v
                        for k, v in self.launches[0].items()}
        if not dev:
            return out
        dev.sort()
        by_name = defaultdict(float)
        for s, e, name in dev:
            by_name[name] += (e - s) * 1e-9
            out.kernels.append((name, (e - s) * 1e-9))
        # busy time: the union of the device intervals; idle gaps between
        busy, gaps = 0, []
        cur_s, cur_e = dev[0][0], dev[0][1]
        for s, e, _ in dev[1:]:
            if s > cur_e:
                busy += cur_e - cur_s
                gaps.append((s - cur_e, cur_e, s))
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        busy += cur_e - cur_s
        out.busy_s = busy * 1e-9
        out.device_ops = [[n[:120], v] for n, v in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:10]]
        gaps.sort(reverse=True)
        out.idle_gaps = [[self._host_at((a + b) / 2), g * 1e-9]
                         for g, a, b in gaps[:10]]
        return out

    def _host_at(self, t_ns: float) -> str:
        """What the dispatcher's thread was doing at ``t_ns`` (epoch ns):
        queuing a chunk of a batch, or between chunks."""
        t = (t_ns - self.offset_ns) * 1e-9
        for c in self.system.log.entries:
            if c.t0 <= t <= c.t1:
                if c.kind == "decode":
                    what = "queuing the VAE decode and copying the images out"
                elif c.first == 0:
                    what = f"encoding prompts, queuing steps {c.first}-{c.end}"
                else:
                    what = f"queuing steps {c.first}-{c.end}"
                return f"host: {what} ({c.rows} rows)"
        return "host: between chunks (admitting or finishing a batch)"
