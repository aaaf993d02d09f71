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
    rows = []
    for s in seeds:
        g = torch.Generator(device="cpu").manual_seed(stream_seed(s, name))
        rows.append(torch.randn(tuple(shape), generator=g,
                                dtype=torch.float32))
    return torch.stack(rows).to(device)
