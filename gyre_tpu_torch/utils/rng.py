"""Batch-independent random numbers from per-seed torch generators.

Counterpart of gyre_tpu/utils/rng.py. Each sample draws from its own
``torch.Generator`` seeded by its request seed and a named stream, so a
sample's noise depends only on its seed, never on how requests were packed
into a batch. The generators run on the CPU, so a seed gives the same noise
on every device; the draw is moved to the compute device afterwards.

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


def batched_normal(seeds, name: str, shape, device):
    """[len(seeds), *shape] f32 standard normal noise, row i from
    seeds[i]."""
    return _draw([stream_seed(s, name) for s in seeds], shape, device)


def batched_stream_normal(seeds, name: str, step: int, shape, device):
    """Noise of stream ``name`` at ``step`` (a sampler's global step index,
    or brownian noise's sigma key), [len(seeds), *shape] f32: row i from
    its own generator seeded by (seeds[i], name, step), so a draw is
    independent of the batch and distinct across steps and streams."""
    return _draw([stream_seed(s, f"{name}:{int(step)}") for s in seeds],
                 shape, device)


def _draw(gen_seeds, shape, device):
    """Row i from a CPU generator seeded gen_seeds[i]. For a CUDA device
    the rows are drawn into pinned memory and copied without blocking,
    so a per-step draw does not wait for the card's queue to drain (the
    caching host allocator keeps the buffer until the copy is done)."""
    device = torch.device(device)
    out = torch.empty((len(gen_seeds), *shape), dtype=torch.float32,
                      pin_memory=device.type == "cuda")
    for row, seed in zip(out, gen_seeds):
        g = torch.Generator(device="cpu").manual_seed(seed)
        torch.randn(tuple(shape), generator=g, out=row)
    return out.to(device, non_blocking=True)
