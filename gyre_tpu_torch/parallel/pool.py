"""A pipeline over a device mesh: one UnifiedPipeline a dp group.

The counterpart of what the JAX package's mesh does below its pipeline:
there XLA splits a merged batch over the ``dp`` axis inside one program;
here ``PooledPipeline.begin`` splits the merged request's samples with
``mesh.split_rows``, runs each group's chunked generator on a worker
thread of its own (one host thread driving several cards would serialise
their launches: a batch-1 call is host-bound), advances the groups in
lockstep at chunk boundaries, so the dispatcher's interleave and
cancellation work as for one pipeline, and concatenates the images in row
order on the first group's device. Each sample's noise depends on its
seed alone (utils/rng.py), so the images do not depend on the split.

A request's hint models (ControlNets, T2I and style adapters) are put on
each group's home device at first use and kept (``place``).
"""

from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor

import torch

from . import mesh as pmesh


class _Worker:
    """One thread for one group's home device, its current CUDA device
    set once."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.pool = ThreadPoolExecutor(
            1, thread_name_prefix=f"pool-{self.device}",
            initializer=self._init)

    def _init(self):
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)

    def submit(self, fn, *args):
        return self.pool.submit(fn, *args)


def _step(gen):
    """(done, value): one chunk of a group's generator."""
    try:
        return False, next(gen)
    except StopIteration as e:
        return True, e.value


class PooledPipeline:
    """``pipes[g]`` is dp group g's UnifiedPipeline (its ModelSet from
    ``mesh.shard_modelset``); ``ms`` and ``device`` are group 0's."""

    def __init__(self, pipes, workers=None, placed=None):
        self.pipes = list(pipes)
        self.workers = workers or [_Worker(p.device) for p in self.pipes]
        # id(tree) -> (tree, {device: placed tree}): hint models by group
        self._placed = placed if placed is not None else {}
        self._lock = threading.Lock()

    @property
    def ms(self):
        return self.pipes[0].ms

    @property
    def device(self):
        return self.pipes[0].device

    def derive(self, modelsets) -> "PooledPipeline":
        """A view over other weights of the same architecture, one ModelSet
        a group (LoRA/TI folded into each), sharing the workers."""
        return PooledPipeline([p.derive(ms) for p, ms in
                               zip(self.pipes, modelsets)], self.workers,
                              self._placed)

    def place(self, tree, device):
        """``tree`` on ``device``, copied once and kept while ``tree``
        lives in the cache."""
        with self._lock:
            src, by_dev = self._placed.setdefault(id(tree), (tree, {}))
            if src is not tree:        # a recycled id: start afresh
                src, by_dev = self._placed[id(tree)] = (tree, {})
            if device not in by_dev:
                by_dev[device] = pmesh.place(tree, device)
            return by_dev[device]

    def _group_kwargs(self, kwargs):
        parts = pmesh.split_rows(kwargs, len(self.pipes))
        out = []
        for pipe, kw in zip(self.pipes, parts):
            if kw.get("hints"):
                kw["hints"] = [dict(h, params=self.place(h["params"],
                                                         pipe.device))
                               for h in kw["hints"]]
            out.append((pipe, kw))
        return out

    def __call__(self, **kwargs):
        gen = self.begin(**kwargs)
        while True:
            try:
                next(gen)
            except StopIteration as e:
                return e.value

    def begin(self, **kwargs):
        """The dispatcher's stepper over every group: yields (steps_done,
        steps_total) after each chunk every group has run; its
        StopIteration value is the images in row order, or None when
        cancelled. ``progress_callback`` hears the slowest group's
        progress whenever it moves."""
        progress = kwargs.get("progress_callback")
        groups = self._group_kwargs(kwargs)
        marks = [None] * len(groups)
        gens = []
        for g, (pipe, kw) in enumerate(groups):
            if progress is not None:
                kw["progress_callback"] = \
                    lambda d, t, g=g: marks.__setitem__(g, (d, t))
            gens.append((self.workers[g], pipe.begin(**kw)))
        return self._lockstep(gens, progress, marks)

    def _lockstep(self, gens, progress, marks):
        results = [None] * len(gens)
        live = list(range(len(gens)))
        heard = None
        try:
            while live:
                futures = {g: gens[g][0].submit(_step, gens[g][1])
                           for g in live}
                steps = []
                for g, fut in futures.items():
                    done, value = fut.result()
                    if done:
                        results[g] = value
                        live.remove(g)
                    else:
                        steps.append(value)
                if progress is not None and None not in marks:
                    now = (min(d for d, _ in marks),
                           max(t for _, t in marks))
                    if now != heard:
                        heard = now
                        progress(*now)
                if steps:
                    yield min(d for d, _ in steps), max(t for _, t in steps)
        finally:
            for g in live:
                gens[g][0].submit(gens[g][1].close).result()
        if any(r is None for r in results):
            return None
        home = self.device
        return torch.cat([r.to(home) for r in results])
