"""The port's fused GroupNorm -> SiLU -> conv3x3 (gyre_tpu_torch.ops.
fused_norm_conv) against the JAX package's: the Pallas kernel
``_gn_silu_conv3x3_impl`` in interpret mode at a lane-aligned shape, and the
unfused reference chain ``gn_silu_conv3x3_reference`` at channel counts the
TPU kernel does not take (96, 160). Both GroupNorm eps values of the slice:
1e-5 (UNet) and 1e-6 (VAE).

On CPU tensors the port's wrappers take their plain versions; the kernels
(csrc/gn_stats.cu, csrc/gn_silu_conv3x3.cu) run only on the card
(tests/test_torch_kernels_cuda.py, chip_smoke.py).

Tolerance: max abs error <= 1e-4 of max |JAX|, f32 on both sides (sums in
another order; the two-pass and E[x^2]-mean^2 variances agree to ~1e-6 at
these sizes).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gyre_tpu.ops import fused_norm_conv as JF
from gyre_tpu_torch.ops import fused_norm_conv as TF

TOL = 1e-4


def _inputs(b, h, w, c, co, seed):
    r = np.random.default_rng(seed)
    x = (r.standard_normal((b, h, w, c)) +
         r.standard_normal((c,))).astype(np.float32)
    gs = (1 + 0.1 * r.standard_normal((c,))).astype(np.float32)
    gb = (0.1 * r.standard_normal((c,))).astype(np.float32)
    wt = (r.standard_normal((3, 3, c, co)) / np.sqrt(9 * c)).astype(
        np.float32)
    cb = (0.1 * r.standard_normal((co,))).astype(np.float32)
    return x, gs, gb, wt, cb


def _port(args, groups, eps):
    return TF.gn_silu_conv3x3(*(torch.from_numpy(a) for a in args),
                              groups=groups, eps=eps).numpy()


def _err(out, ref):
    ref = np.asarray(ref)
    return np.abs(out - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("eps", [1e-5, 1e-6])
def test_matches_pallas_kernel(eps):
    args = _inputs(2, 8, 8, 128, 128, seed=1)
    ref = JF._gn_silu_conv3x3_impl(*(jnp.asarray(a) for a in args),
                                   groups=32, eps=eps, th=4)
    assert _err(_port(args, 32, eps), ref) <= TOL


@pytest.mark.parametrize("c,co,groups", [(96, 64, 32), (160, 96, 32),
                                         (96, 160, 8)])
@pytest.mark.parametrize("eps", [1e-5, 1e-6])
def test_matches_reference_chain(c, co, groups, eps):
    args = _inputs(2, 6, 10, c, co, seed=c + co)
    ref = JF.gn_silu_conv3x3_reference(*(jnp.asarray(a) for a in args),
                                       groups=groups, eps=eps)
    assert _err(_port(args, groups, eps), ref) <= TOL


@pytest.mark.parametrize("eps", [1e-5, 1e-6])
def test_gn_affine_matches_jax(eps):
    """K2a's plain version: the folded per-(batch, channel) affine."""
    x, gs, gb, _, _ = _inputs(2, 5, 7, 64, 8, seed=3)
    a_ref, b_ref = JF.gn_affine(jnp.asarray(x), jnp.asarray(gs),
                                jnp.asarray(gb), 16, eps)
    a, b = TF.gn_affine(torch.from_numpy(x), torch.from_numpy(gs),
                        torch.from_numpy(gb), 16, eps)
    assert _err(a.numpy(), a_ref) <= TOL
    assert _err(b.numpy(), b_ref) <= TOL


def test_affine_then_conv_equals_chain():
    """K2a then K2b (their plain versions, as the CPU path composes them)
    equal the unfused chain."""
    x, gs, gb, wt, cb = (torch.from_numpy(a)
                         for a in _inputs(1, 9, 9, 32, 16, seed=4))
    a, b = TF.gn_affine(x, gs, gb, 8, 1e-6)
    two_pass = TF.affine_silu_conv3x3(x, a, b, wt, cb)
    chain = TF.gn_silu_conv3x3_plain(x, gs, gb, wt, cb, groups=8, eps=1e-6)
    assert _err(two_pass.numpy(), chain.numpy()) <= TOL


def test_kernel_sweep_variants_apply_to_the_kernel():
    """kernel_sweep.py builds K2b's launch overrides and pipeline ablations
    by textual substitution of csrc/gn_silu_conv3x3.cu: each must still
    find its line in the committed kernel, so that the sweep cannot rot
    unnoticed beside it."""
    import kernel_sweep
    from gyre_tpu_torch import _build

    src = (_build.CSRC / "gn_silu_conv3x3.cu").read_text()
    variants = kernel_sweep.conv_variants(src)
    assert set(variants) == {
        "kernel", "no_weight_loads", "no_halo_loads", "no_activation",
        "no_halo_or_activation", "neither", "neither_nor_products"}
    assert 'getenv("GYRE_SPLIT")' in variants["kernel"]
    others = [v for k, v in variants.items() if k != "kernel"]
    assert all(v != variants["kernel"] for v in others)
    assert len(set(others)) == len(others)
