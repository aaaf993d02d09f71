"""The port's attention (gyre_tpu_torch.ops.attention) against the JAX
package's flash kernel, run as tests/test_attention.py runs it on the CPU:
the Pallas kernel ``_flash_forward`` in interpret mode.

On CPU tensors the port's wrapper takes its plain version; the kernel
itself (csrc/flash_attention.cu) runs only on the card and is compared with
the plain version there (tests/test_torch_kernels_cuda.py, chip_smoke.py).

Tolerance: max abs error <= 1e-4 of max |JAX|, f32 on both sides. The
flash kernel's streaming softmax and the plain one-pass softmax differ only
in rounding order (~1e-6 relative at these lengths).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gyre_tpu.ops import attention as JA
from gyre_tpu_torch import _build
from gyre_tpu_torch.ops import attention as TA

TOL = 1e-4


def _qkv(b, h, tq, tk, d, seed):
    r = np.random.default_rng(seed)
    return (r.standard_normal((b, h, tq, d)).astype(np.float32),
            r.standard_normal((b, h, tk, d)).astype(np.float32),
            r.standard_normal((b, h, tk, d)).astype(np.float32))


def _err(port, ref):
    ref = np.asarray(ref)
    return np.abs(port.numpy() - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("tq,tk,d", [
    (128, 128, 64),
    (256, 256, 40),     # SD1.5 level-0 head dim (not a power of two)
    (96, 77, 80),       # cross-attention: ragged Tk = 77
    (130, 77, 40),      # ragged Tq and Tk
    (64, 64, 512),      # the VAE's single-head width, small T
])
def test_matches_jax_flash_kernel(tq, tk, d):
    q, k, v = _qkv(2, 2, tq, tk, d, seed=tq + tk + d)
    scale = 1.0 / math.sqrt(d)
    ref = JA._flash_forward(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            scale)
    before = dict(_build.launches)
    out = TA.flash_attention_bhtd(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), scale)
    assert _err(out, ref) <= TOL
    # CPU tensors take the plain version: no kernel launch is counted
    assert _build.launches == before


def test_cpu_wrapper_is_the_plain_version():
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 3, 33, 21, 24, seed=1))
    out = TA.flash_attention_bhtd(q, k, v, 0.3)
    assert torch.equal(out, TA.attention_plain(q, k, v, 0.3))


def test_layout_wrapper_matches_jax():
    """[B,T,H,D] entry point (models/layers contract)."""
    r = np.random.default_rng(2)
    q, k, v = (r.standard_normal((2, 50, 4, 40)).astype(np.float32)
               for _ in range(3))
    ref = JA.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       impl="ref")
    out = TA.attention(torch.from_numpy(q), torch.from_numpy(k),
                       torch.from_numpy(v))
    assert _err(out, ref) <= TOL


def test_masked_path_matches_jax():
    """CLIP's causal mask stays on the plain path, as in the JAX package."""
    r = np.random.default_rng(3)
    q, k, v = (r.standard_normal((2, 77, 4, 16)).astype(np.float32)
               for _ in range(3))
    mask = np.tril(np.ones((77, 77), bool))[None, None]
    ref = JA.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       mask=jnp.asarray(mask))
    out = TA.attention(torch.from_numpy(q), torch.from_numpy(k),
                       torch.from_numpy(v), mask=torch.from_numpy(mask))
    assert _err(out, ref) <= TOL
