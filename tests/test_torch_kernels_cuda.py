"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Marked ``cuda``: they skip where there is no CUDA device (a CUDA
kernel has no CPU mode). This file imports torch and the port only, so the
card's machine, which has no JAX, runs it (see README):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_kernels_cuda.py

Shapes are small and ragged on purpose: head dims 40 / 8 / 512, Tk = 77,
channel counts that are not multiples of the conv kernel's 32-channel
k-step or 64-channel tile, pixel counts that are not multiples of its
128-pixel tile. Bounds as in chip_smoke.py: 2e-2 of max |plain| in bf16
(compounded bf16 rounding, ~5x margin), 1e-3 for K2a's f32 statistics.
"""

import pytest
import torch

from gyre_tpu_torch import _build
from gyre_tpu_torch.ops import attention as A
from gyre_tpu_torch.ops import fused_norm_conv as FC

BF16_BOUND = 2e-2
F32_STATS_BOUND = 1e-3


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.Generator(device="cuda").manual_seed(0)


def _rel(out, ref):
    out, ref = out.float(), ref.float()
    assert bool(out.isfinite().all())
    return float((out - ref).abs().max() / ref.abs().max())


def _randn(gen, *shape, dtype=torch.bfloat16):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,tq,tk,d", [
    (2, 3, 300, 300, 40), (1, 2, 129, 77, 80), (2, 1, 70, 77, 8),
    (1, 1, 100, 64, 512), (1, 2, 16, 200, 160)])
def test_flash_attention(gen, b, h, tq, tk, d):
    q = _randn(gen, b, h, tq, d)
    k, v = _randn(gen, b, h, tk, d), _randn(gen, b, h, tk, d)
    before = _build.launches["flash_attention"]
    out = A.flash_attention_bhtd(q, k, v, d ** -0.5)
    assert _build.launches["flash_attention"] == before + 1
    assert _rel(out, A.attention_plain(q, k, v, d ** -0.5)) <= BF16_BOUND


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["float32", "head_dim", "strided"])
def test_flash_attention_rejects(gen, bad):
    q = _randn(gen, 1, 2, 32, 16)
    if bad == "float32":
        q = q.float()
    elif bad == "head_dim":
        q = _randn(gen, 1, 2, 32, 12)
    else:
        q = _randn(gen, 1, 32, 2, 16).transpose(1, 2)
    k = v = _randn(gen, 1, 2, 32, q.shape[-1])
    with pytest.raises(ValueError):
        A.flash_attention_bhtd(q, k, v, 0.25)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,c,co,groups", [
    (2, 9, 7, 96, 72, 32), (1, 16, 16, 160, 64, 32), (3, 5, 11, 16, 8, 8),
    (1, 12, 12, 64, 200, 32)])
def test_gn_silu_conv3x3(gen, b, h, w, c, co, groups):
    x = (torch.randn((b, h, w, c), generator=gen, device="cuda") +
         3.0).to(torch.bfloat16)
    gs = 1 + 0.1 * _randn(gen, c, dtype=torch.float32)
    gb = 0.1 * _randn(gen, c, dtype=torch.float32)
    wt = _randn(gen, 3, 3, c, co) * (9 * c) ** -0.5
    cb = 0.1 * _randn(gen, co, dtype=torch.float32)

    a, bb = FC.gn_affine(x, gs, gb, groups, 1e-6)
    a_ref, b_ref = FC.gn_affine_plain(x, gs, gb, groups, 1e-6)
    assert _rel(a, a_ref) <= F32_STATS_BOUND
    assert _rel(bb, b_ref) <= F32_STATS_BOUND
    out = FC.affine_silu_conv3x3(x, a_ref, b_ref, wt, cb)
    ref = FC.affine_silu_conv3x3_plain(x, a_ref, b_ref, wt, cb)
    assert _rel(out, ref) <= BF16_BOUND
    chain = FC.gn_silu_conv3x3(x, gs, gb, wt, cb, groups=groups, eps=1e-6)
    chain_ref = FC.gn_silu_conv3x3_plain(x, gs, gb, wt, cb, groups=groups,
                                         eps=1e-6)
    assert _rel(chain, chain_ref) <= BF16_BOUND


@pytest.mark.cuda
def test_fused_conv_rejects(gen):
    x = _randn(gen, 1, 4, 4, 12)                  # C not a multiple of 8
    a = torch.ones((1, 12), device="cuda")
    with pytest.raises(ValueError):
        FC.affine_silu_conv3x3(x, a, a, _randn(gen, 3, 3, 12, 8),
                               torch.zeros(8, device="cuda"))
    with pytest.raises(ValueError):
        FC.gn_affine(x.float(), a[0], a[0], 4, 1e-6)
