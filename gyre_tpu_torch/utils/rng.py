"""Batch-independent random numbers from per-seed torch generators.

Counterpart of gyre_tpu/utils/rng.py. Each sample draws from its own
``torch.Generator`` seeded by its request seed and a named stream, so a
sample's noise depends only on its seed, never on how requests were packed
into a batch. The generators run on the CPU, so a seed gives the same noise
on every device; the draw is moved to the compute device afterwards.

A key is a request seed, or a seed with the names of the sub-streams
derived from it (``substream``, the counterpart of the JAX package's
``stream``): the hires fix's low-resolution rows draw from the "hires_lo"
and "lo" sub-streams of their seed. Every draw of the pipeline goes through
``draw``, keyed by (key, stream, step), so a test can put the JAX
package's draws in at that one place.

The JAX package derives its noise from threefry keys, which torch cannot
reproduce: the same seed gives different noise, and a different image, in
the two packages.
"""

from __future__ import annotations

import zlib

import torch


def stream_seed(seed: int, name: str) -> int:
    """Generator seed for stream ``name`` of sample seed ``seed``. The CPU
    generator keeps 32 bits of its seed; XOR with a per-stream constant
    keeps the streams of one seed apart and, within a stream, maps distinct
    seeds to distinct generator seeds."""
    return (int(seed) ^ zlib.crc32(name.encode())) & 0xFFFFFFFF


def _path(key) -> tuple:
    return tuple(key) if isinstance(key, tuple) else (int(key),)


def substream(keys, name: str) -> list:
    """The keys of sub-stream ``name`` of each key."""
    return [_path(k) + (name,) for k in keys]


def draw(keys, path: tuple, shape, device, dist: str = "normal"):
    """[len(keys), *shape] f32, standard normal or uniform in [0, 1): row
    i from a generator seeded by keys[i] and ``path`` (stream names and
    step indices), so a row depends on its own key alone."""
    names = []
    for key in keys:
        seed, *subs = _path(key)
        name = ":".join(str(p) for p in (*subs, *path))
        names.append(stream_seed(seed, f"uniform/{name}"
                                 if dist == "uniform" else name))
    return _draw(names, shape, device, dist)


def batched_normal(keys, name: str, shape, device):
    """[len(keys), *shape] f32 standard normal noise of stream ``name``,
    row i from keys[i]."""
    return draw(keys, (name,), shape, device)


def batched_stream_normal(keys, name: str, step: int, shape, device):
    """Noise of stream ``name`` at ``step`` (a sampler's global step index,
    brownian noise's sigma key, or 0 for a mode's one draw), [len(keys),
    *shape] f32: row i from its own generator seeded by (keys[i], name,
    step), so a draw is independent of the batch and distinct across steps
    and streams."""
    return draw(keys, (name, int(step)), shape, device)


def batched_uniform(keys, shape, device):
    """[len(keys), *shape] f32 uniform in [0, 1) from each key itself (the
    hires fix's and graft's random maps)."""
    return draw(keys, (), shape, device, dist="uniform")


def _draw(gen_seeds, shape, device, dist: str = "normal"):
    """Row i from a CPU generator seeded gen_seeds[i]. For a CUDA device
    the rows are drawn into pinned memory and copied without blocking,
    so a per-step draw does not wait for the card's queue to drain (the
    caching host allocator keeps the buffer until the copy is done)."""
    device = torch.device(device)
    out = torch.empty((len(gen_seeds), *shape), dtype=torch.float32,
                      pin_memory=device.type == "cuda")
    fill = torch.rand if dist == "uniform" else torch.randn
    for row, seed in zip(out, gen_seeds):
        g = torch.Generator(device="cpu").manual_seed(seed)
        fill(tuple(shape), generator=g, out=row)
    return out.to(device, non_blocking=True)
