"""Batch-independent random numbers: the JAX package's threefry draws.

Counterpart of gyre_tpu/utils/rng.py. The port computes JAX's default PRNG
itself, with no JAX: Threefry-2x32 (20 rounds), keys made from uint32
seeds (``key_for_seed``, ``PRNGKey``'s [0, seed]), ``fold_in`` and
``split``, and the bits of JAX's partitionable scheme
(``jax_threefry_partitionable``, on by default since JAX 0.5 and never
changed by the JAX package): element i of a draw of any shape is
``y0 ^ y1`` of threefry2x32(key, (0, i)), its flat row-major index the
counter. ``uniform``, ``normal`` (sqrt(2) * erfinv of a uniform on
(-1, 1)) and ``randint`` build on those bits as ``jax.random`` does, so a
seed gives the JAX package's noise: the integer bits and uniforms equal,
a normal within 3 ulp (``erfinv`` is XLA's polynomial, within 2 ulp of
XLA's: their log1p differs).

A key of the pipeline is a request seed, or a seed with the names of the
sub-streams derived from it (``substream``, the JAX package's ``stream``):
the hires fix's low-resolution rows draw from the "hires_lo" and "lo"
sub-streams of their seed. Every draw of the pipeline goes through
``draw``, keyed by (key, path): a name in the path is ``stream``'s
``fold_in(crc32(name) & 0x7FFFFFFF)``, an integer ``step_key``'s
``fold_in(step)``. A row depends on its own key alone, so packing and a
device pool's split of a batch cannot change it.

Keys are host integers (a key is a few dozen integer operations); the
words of a draw are computed where the draw is used, on int64 tensors
masked to 32 bits, so a draw for the card runs on the card and does not
wait for its queue.
"""

from __future__ import annotations

import math
import zlib

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
# jax.random.normal's uniform on (nextafter(-1, 0), 1) in f32
_NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
_SQRT2 = float(np.float32(np.sqrt(2.0)))


def threefry2x32(key, x0, x1):
    """Threefry-2x32 with 20 rounds of the counter words (x0, x1) under
    ``key`` = (k0, k1): python ints or int64 tensors holding 32-bit
    values (broadcast together); returns the two output words."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _M32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def key_for_seed(seed) -> tuple:
    """``jax.random.PRNGKey`` of a uint32 seed: (0, seed)."""
    return (0, int(seed) & _M32)


def fold_in(key, data) -> tuple:
    """``jax.random.fold_in``: the key hashed with ``data`` as a uint32
    (a negative int32 wraps, as JAX converts it)."""
    return threefry2x32(key, 0, int(data) & _M32)


def split(key, num: int = 2) -> list:
    """``jax.random.split``: under the partitionable scheme subkey i is
    the key's threefry of the counter (0, i), i.e. ``fold_in(key, i)``."""
    return [threefry2x32(key, 0, i) for i in range(num)]


def stream(key, name: str) -> tuple:
    """The named sub-stream of ``key`` (the JAX package's ``stream``)."""
    return fold_in(key, zlib.crc32(name.encode()) & 0x7FFFFFFF)


def step_key(key, step) -> tuple:
    return fold_in(key, step)


def _bits(keys, shape, device):
    """[len(keys), *shape] int64 tensor of the 32-bit words each key draws
    for ``shape`` (``jax.random.bits``, uint32). The keys go to a CUDA
    device through pinned memory without blocking."""
    device = torch.device(device)
    n = math.prod(shape)
    k = torch.tensor([list(key) for key in keys], dtype=torch.int64)
    if device.type == "cuda":
        k = k.pin_memory()
    k = k.to(device, non_blocking=True)
    count = torch.arange(n, dtype=torch.int64, device=device)[None]
    y0, y1 = threefry2x32((k[:, :1], k[:, 1:]), 0, count)
    return (y0 ^ y1).reshape(len(keys), *shape)


def _unit(bits):
    """Words -> f32 in [0, 1): the top 23 bits as the mantissa of a float
    in [1, 2), minus 1."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
    return f - 1.0


# XLA's f32 erf_inv (M. Giles, "Approximating the erfinv function"): a
# degree-8 polynomial in w - 2.5 for w = -log1p(-x²) < 5, else in
# sqrt(w) - 3
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erfinv(x):
    """f32 erfinv as XLA computes it (``jax.lax.erf_inv``), within 2 ulp
    of it (its log1p and the order of rounding differ); torch.erfinv
    differs from it by up to ~90 ulp near 0."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    coef = [torch.where(lt, torch.tensor(a, dtype=torch.float32,
                                         device=x.device),
                        torch.tensor(b, dtype=torch.float32,
                                     device=x.device))
            for a, b in zip(_ERFINV_LT5, _ERFINV_GE5)]
    p = coef[0]
    for c in coef[1:]:
        p = c + p * w
    return torch.where(x.abs() == 1.0, x * torch.finfo(torch.float32).max,
                       p * x)


def _normal(bits):
    u = torch.clamp_min(_unit(bits) * 2.0 + _NORMAL_LO, _NORMAL_LO)
    return erfinv(u) * _SQRT2


def uniform(key, shape, device="cpu", minval: float = 0.0,
            maxval: float = 1.0):
    """``jax.random.uniform(key, shape)`` in f32 (``minval``/``maxval``
    exact in f32)."""
    u = _unit(_bits([key], tuple(shape), device))[0]
    lo = torch.tensor(minval, dtype=torch.float32, device=u.device)
    span = torch.tensor(maxval, dtype=torch.float32, device=u.device) - lo
    return torch.maximum(lo, u * span + lo)


def normal(key, shape, device="cpu"):
    """``jax.random.normal(key, shape)`` in f32."""
    return _normal(_bits([key], tuple(shape), device))[0]


def randint(key, minval: int, maxval: int) -> int:
    """``jax.random.randint(key, (), minval, maxval)`` (int32): the
    remainder of two words by the span, in uint32 arithmetic."""
    k1, k2 = split(key)
    hi = _word(k1)
    lo = _word(k2)
    span = 1 if maxval <= minval else (maxval - minval) & _M32
    mult = (2 ** 16) % span
    mult = (mult * mult & _M32) % span
    off = (((hi % span) * mult & _M32) + lo % span) & _M32
    return minval + off % span


def _word(key) -> int:
    """The one word a scalar draw of ``key`` takes."""
    y0, y1 = threefry2x32(key, 0, 0)
    return y0 ^ y1


def uniform_scalar(key) -> float:
    """``jax.random.uniform(key)`` (shape ()), as a host f32."""
    f = np.array((_word(key) >> 9) | 0x3F800000, np.uint32).view(np.float32)
    return np.float32(f - np.float32(1.0))


# ------------------------------------------------------ the pipeline's keys


def _path(key) -> tuple:
    return tuple(key) if isinstance(key, tuple) else (int(key),)


def substream(keys, name: str) -> list:
    """The keys of sub-stream ``name`` of each key."""
    return [_path(k) + (name,) for k in keys]


def threefry_key(key, path: tuple = ()) -> tuple:
    """The JAX key of a pipeline key (a seed, or a seed and its sub-stream
    names) followed by ``path``: a name folds in as ``stream``, an integer
    as ``step_key``."""
    seed, *subs = _path(key)
    k = key_for_seed(seed)
    for p in (*subs, *path):
        k = stream(k, p) if isinstance(p, str) else step_key(k, p)
    return k


def draw(keys, path: tuple, shape, device, dist: str = "normal"):
    """[len(keys), *shape] f32 on ``device``, standard normal or uniform
    in [0, 1): row i is ``jax.random.normal`` (``uniform``) of keys[i]'s
    threefry key with ``path`` folded in, so a row depends on its own key
    alone."""
    bits = _bits([threefry_key(k, path) for k in keys], tuple(shape),
                 device)
    return _unit(bits) if dist == "uniform" else _normal(bits)


def batched_stream_normal(keys, name: str, step: int, shape, device):
    """Noise of stream ``name`` at ``step`` (a sampler's global step index,
    brownian noise's sigma key, or 0 for a mode's one draw), [len(keys),
    *shape] f32: the JAX package's ``batched_stream_normal``, row i from
    keys[i] alone."""
    return draw(keys, (name, int(step)), shape, device)


def batched_uniform(keys, shape, device):
    """[len(keys), *shape] f32 uniform in [0, 1) from each key itself (the
    hires fix's and graft's random maps)."""
    return draw(keys, (), shape, device, dist="uniform")
