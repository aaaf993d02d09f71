"""The hand-written CUDA kernels against their plain PyTorch versions, on
the card. Marked ``cuda``: they skip where there is no CUDA device (a CUDA
kernel has no CPU mode). This file imports torch and the port only, so the
card's machine, which has no JAX, runs it (see README):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_kernels_cuda.py

K1 is called as the models call it, through ``attention`` on [B,T,H,D]
projections. Shapes are small and ragged on purpose: head dims 40 / 8 /
512, Tk = 77, channel counts that are not multiples of the conv kernel's
64-channel chunk or its 128-channel tile, images that are not multiples
of its 8 x 16 (or 8 x 8) pixel tile; then the kernels' own paths at
main-path sizes: K1 at T >= 1024 for every SD1.5 head dim and on strided
[B,T,H,D] views, K2b's split-K (M <= 512) and a ragged C = 960, K2a's
cluster launch at path shapes of batch 1 and 8, ragged, with vectors that
straddle two groups and under cancellation; both at the hires fix's
ragged UNet levels (9, 18, 36), on a non-square canvas and at the
ControlNet's batch-1 shapes (one CFG row); K1 at SD2's and SDXL's head
dim 64 and K2a/K2b at the SDXL refiner's channel counts (12 to 96
channels a group). Bounds as in chip_smoke.py:
2e-2 of max |plain| in bf16 (compounded bf16 rounding, ~5x margin), 1e-3
for K2a's f32 statistics.
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


def _btd(gen, b, t, h, d):
    """A [B,T,H,D] projection as the models hand it to attention(): a
    linear layer's [B,T,H*D] output, reshaped."""
    return _randn(gen, b, t, h * d).view(b, t, h, d)


def _attention_ref(q, k, v):
    """The plain version on the [B,H,T,D] views, back to [B,T,H,D]."""
    return A.attention_plain(*(t.transpose(1, 2) for t in (q, k, v)),
                             q.shape[-1] ** -0.5).transpose(1, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,tq,tk,d", [
    (2, 3, 300, 300, 40), (1, 2, 129, 77, 80), (2, 1, 70, 77, 8),
    (1, 1, 100, 64, 512), (1, 2, 16, 200, 160)])
def test_flash_attention(gen, b, h, tq, tk, d):
    q = _btd(gen, b, tq, h, d)
    k, v = _btd(gen, b, tk, h, d), _btd(gen, b, tk, h, d)
    before = _build.launches["flash_attention"]
    out = A.attention(q, k, v)
    assert _build.launches["flash_attention"] == before + 1
    assert _rel(out, _attention_ref(q, k, v)) <= BF16_BOUND


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,t,d", [
    (1, 2, 1024, 40), (1, 2, 1024, 80), (1, 2, 1024, 160),
    (1, 1, 1024, 512)])
def test_flash_attention_long(gen, b, h, t, d):
    """Many KV tiles through the online softmax, at every SD1.5 head dim
    (d = 512 takes the head-dim-split path)."""
    q, k, v = (_btd(gen, b, t, h, d) for _ in range(3))
    out = A.attention(q, k, v)
    assert _rel(out, _attention_ref(q, k, v)) <= BF16_BOUND


@pytest.mark.cuda
@pytest.mark.parametrize("tq,tk,d", [(300, 77, 40), (1024, 1024, 80)])
def test_flash_attention_strided_views(gen, tq, tk, d):
    """attention() hands K1 the [B,T,H,D] views as they are: here slices of
    fused projections, whose token stride is not H*D. The output is
    [B,T,H,D] and contiguous, and matches the plain version on contiguous
    [B,H,T,D] copies."""
    b, h = 2, 3
    qkv = _randn(gen, b, tq, 3, h, d)
    kv = _randn(gen, b, tk, 2, h, d)
    q, k, v = qkv[:, :, 0], kv[:, :, 0], kv[:, :, 1]
    assert not q.is_contiguous()
    before = _build.launches["flash_attention"]
    out = A.attention(q, k, v)
    assert _build.launches["flash_attention"] == before + 1
    assert out.shape == (b, tq, h, d) and out.is_contiguous()
    ref = A.attention_plain(*(t.transpose(1, 2).contiguous()
                              for t in (q, k, v)), d ** -0.5)
    assert _rel(out, ref.transpose(1, 2)) <= BF16_BOUND


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["float32", "head_dim", "last_dim_stride"])
def test_flash_attention_rejects(gen, bad):
    q = _randn(gen, 1, 32, 2, 16)
    if bad == "float32":
        q = q.float()
    elif bad == "head_dim":
        q = _randn(gen, 1, 32, 2, 12)
    else:
        q = _randn(gen, 1, 32, 16, 2).transpose(2, 3)
    k = v = _randn(gen, 1, 32, 2, q.shape[-1])
    with pytest.raises(ValueError):
        A.attention(q, k, v, scale=0.25)


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
@pytest.mark.parametrize("b,h,w,c,eps,offset", [
    (2, 8, 8, 1280, 1e-5, 1.0),        # UNet 8x8: the launch floor
    (2, 64, 64, 320, 1e-5, 1.0),       # UNet 64x64; 10 channels a group
    (1, 512, 512, 128, 1e-6, 1.0),     # VAE 512x512: bandwidth
    (16, 64, 64, 320, 1e-5, 1.0),      # the batch-8 call's 16 CFG rows
    (3, 37, 41, 960, 1e-5, 1.0),       # 1517 pixels; 30 channels a group
    (2, 32, 32, 960, 1e-5, 1.0),       # 30 channels a group
    (2, 64, 64, 320, 1e-5, 30.0),      # per-channel offsets 30x the spread
])
def test_gn_stats(gen, b, h, w, c, eps, offset):
    """K2a, one cluster launch per call, against its plain version; a and
    b are contiguous views of one tensor; a second call gives the same
    bits (every sum in a fixed order)."""
    x = (torch.randn((b, h, w, c), generator=gen, device="cuda") + offset *
         torch.randn((c,), generator=gen, device="cuda")).to(torch.bfloat16)
    gs = 1 + 0.1 * _randn(gen, c, dtype=torch.float32)
    gb = 0.1 * _randn(gen, c, dtype=torch.float32)
    before = _build.launches["gn_stats"]
    a, bb = FC.gn_affine(x, gs, gb, 32, eps)
    assert _build.launches["gn_stats"] == before + 1
    assert a.is_contiguous() and bb.is_contiguous()
    assert a.shape == bb.shape == (b, c)
    a_ref, b_ref = FC.gn_affine_plain(x, gs, gb, 32, eps)
    assert _rel(a, a_ref) <= F32_STATS_BOUND
    assert _rel(bb, b_ref) <= F32_STATS_BOUND
    a2, b2 = FC.gn_affine(x, gs, gb, 32, eps)
    assert torch.equal(a, a2) and torch.equal(bb, b2)


@pytest.mark.cuda
@pytest.mark.parametrize("b,hw,c,co", [
    (2, 8, 2560, 1280), (2, 16, 1920, 1280), (2, 8, 1280, 1280)])
def test_conv_split_k(gen, b, hw, c, co):
    """UNet 8x8 and 16x16 shapes (M = 128 / 512 pixels), where K is split
    over a thread-block cluster; the cluster's reduction runs in a fixed
    order, so two calls give the same bits."""
    x = _randn(gen, b, hw, hw, c)
    a = 1 + 0.1 * _randn(gen, b, c, dtype=torch.float32)
    bb = 0.1 * _randn(gen, b, c, dtype=torch.float32)
    wt = _randn(gen, 3, 3, c, co) * (9 * c) ** -0.5
    cb = 0.1 * _randn(gen, co, dtype=torch.float32)
    out = FC.affine_silu_conv3x3(x, a, bb, wt, cb)
    assert _rel(out, FC.affine_silu_conv3x3_plain(x, a, bb, wt, cb)) \
        <= BF16_BOUND
    assert torch.equal(out, FC.affine_silu_conv3x3(x, a, bb, wt, cb))


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,c,co", [(2, 32, 32, 960, 640),
                                        (1, 12, 20, 960, 320)])
def test_conv_ragged_c(gen, b, h, w, c, co):
    """C = 960 is 15 chunks of 64 channels but not a multiple of 128; the
    second shape also has ragged pixel tiles and Co = 320 (its last
    128-channel tile is 64 channels short)."""
    x = (torch.randn((b, h, w, c), generator=gen, device="cuda") +
         1.0).to(torch.bfloat16)
    gs = 1 + 0.1 * _randn(gen, c, dtype=torch.float32)
    gb = 0.1 * _randn(gen, c, dtype=torch.float32)
    wt = _randn(gen, 3, 3, c, co) * (9 * c) ** -0.5
    cb = 0.1 * _randn(gen, co, dtype=torch.float32)
    chain = FC.gn_silu_conv3x3(x, gs, gb, wt, cb, groups=32, eps=1e-5)
    chain_ref = FC.gn_silu_conv3x3_plain(x, gs, gb, wt, cb, groups=32,
                                         eps=1e-5)
    assert _rel(chain, chain_ref) <= BF16_BOUND


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,c,co,d", [
    (9, 9, 2560, 1280, 160), (18, 18, 1280, 1280, 160),
    (36, 36, 640, 640, 80), (64, 96, 320, 320, 40)])
def test_kernels_at_ragged_latent_sizes(gen, h, w, c, co, d):
    """The hires fix's low-resolution UNet levels (9, 18, 36: tiles that
    overhang the image) and a non-square 64 x 96 canvas, at the batch of a
    CFG call (2): K2a + K2b on a level's conv, K1 on its self-attention
    and its cross-attention against 77 tokens, 8 heads."""
    b = 2
    x = (torch.randn((b, h, w, c), generator=gen, device="cuda") +
         1.0).to(torch.bfloat16)
    gs = 1 + 0.1 * _randn(gen, c, dtype=torch.float32)
    gb = 0.1 * _randn(gen, c, dtype=torch.float32)
    wt = _randn(gen, 3, 3, c, co) * (9 * c) ** -0.5
    cb = 0.1 * _randn(gen, co, dtype=torch.float32)
    chain = FC.gn_silu_conv3x3(x, gs, gb, wt, cb, groups=32, eps=1e-5)
    chain_ref = FC.gn_silu_conv3x3_plain(x, gs, gb, wt, cb, groups=32,
                                         eps=1e-5)
    assert _rel(chain, chain_ref) <= BF16_BOUND
    q = _btd(gen, b, h * w, 8, d)
    for tk in (h * w, 77):
        k, v = _btd(gen, b, tk, 8, d), _btd(gen, b, tk, 8, d)
        assert _rel(A.attention(q, k, v), _attention_ref(q, k, v)) <= \
            BF16_BOUND


@pytest.mark.cuda
@pytest.mark.parametrize("bad", ["channels", "x_float32", "scale_bf16",
                                 "bias_bf16", "conv_bias_bf16"])
def test_fused_conv_rejects(gen, bad):
    """What the kernels do not take raises: C not a multiple of 8, f32 x,
    and the f32 parameters passed as bf16 (the wrappers cast nothing)."""
    if bad == "channels":
        x = _randn(gen, 1, 4, 4, 12)
        a = torch.ones((1, 12), device="cuda")
        with pytest.raises(ValueError):
            FC.affine_silu_conv3x3(x, a, a, _randn(gen, 3, 3, 12, 8),
                                   torch.zeros(8, device="cuda"))
        with pytest.raises(ValueError):
            FC.gn_affine(x, a[0], a[0], 4, 1e-6)
        return
    x = _randn(gen, 1, 4, 4, 16)
    ones = torch.ones(16, device="cuda")
    scale, bias = ones, ones
    if bad == "conv_bias_bf16":
        a = torch.ones((1, 16), device="cuda")
        with pytest.raises(ValueError):
            FC.affine_silu_conv3x3(x, a, a, _randn(gen, 3, 3, 16, 8),
                                   torch.zeros(8, device="cuda").bfloat16())
        return
    if bad == "x_float32":
        x = x.float()
    elif bad == "scale_bf16":
        scale = ones.bfloat16()
    else:
        bias = ones.bfloat16()
    with pytest.raises(ValueError):
        FC.gn_affine(x, scale, bias, 4, 1e-6)


# the ControlNet's down path at one row (hint priority "hint" runs it on
# the guided CFG half only, at batch 1): each level's GN -> SiLU -> conv3x3
# pairs and its self- and cross-attention (8 heads; 77 context tokens)
CONTROLNET_B1_LEVELS = [
    # (H=W, [(C, Co), ...], T, head dim)
    (64, [(320, 320)], 4096, 40),
    (32, [(320, 640), (640, 640)], 1024, 80),
    (16, [(640, 1280), (1280, 1280)], 256, 160),
    (8, [(1280, 1280)], 64, 160),
]


@pytest.mark.cuda
@pytest.mark.parametrize("hw,pairs,t,d", CONTROLNET_B1_LEVELS)
def test_kernels_at_controlnet_batch1_shapes(gen, hw, pairs, t, d):
    """K2a, K2b and K1 at the ControlNet's batch-1 shapes (B = 1, where
    the UNet's shapes have B = 2) against their plain versions."""
    for c, co in pairs:
        x = (torch.randn((1, hw, hw, c), generator=gen, device="cuda") +
             torch.randn((c,), generator=gen, device="cuda")).to(
                 torch.bfloat16)
        gs = 1 + 0.1 * _randn(gen, c, dtype=torch.float32)
        gb = 0.1 * _randn(gen, c, dtype=torch.float32)
        wt = _randn(gen, 3, 3, c, co) * (9 * c) ** -0.5
        cb = 0.1 * _randn(gen, co, dtype=torch.float32)
        a, bb = FC.gn_affine(x, gs, gb, 32, 1e-5)
        a_ref, b_ref = FC.gn_affine_plain(x, gs, gb, 32, 1e-5)
        assert _rel(a, a_ref) <= F32_STATS_BOUND
        assert _rel(bb, b_ref) <= F32_STATS_BOUND
        assert _rel(FC.affine_silu_conv3x3(x, a_ref, b_ref, wt, cb),
                    FC.affine_silu_conv3x3_plain(x, a_ref, b_ref, wt, cb)
                    ) <= BF16_BOUND
    for tk in (t, 77):
        q = _btd(gen, 1, t, 8, d)
        k, v = _btd(gen, 1, tk, 8, d), _btd(gen, 1, tk, 8, d)
        assert _rel(A.attention(q, k, v), _attention_ref(q, k, v)) <= \
            BF16_BOUND


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,tq,tk,d", [
    (2, 5, 2304, 2304, 64), (2, 10, 1024, 77, 64), (2, 20, 576, 576, 64),
    (1, 24, 300, 77, 64)])
def test_flash_attention_head_dim_64(gen, b, h, tq, tk, d):
    """SD2's and SDXL's one head dim (64), at 5 to 24 heads (SD2 at 768²,
    SDXL and its refiner at 1024²), self and against 77 tokens."""
    q = _btd(gen, b, tq, h, d)
    k, v = _btd(gen, b, tk, h, d), _btd(gen, b, tk, h, d)
    assert _rel(A.attention(q, k, v), _attention_ref(q, k, v)) <= BF16_BOUND


@pytest.mark.cuda
@pytest.mark.parametrize("hw,c,co", [
    (32, 384, 768), (16, 1152, 768), (16, 2304, 1536), (8, 3072, 1536)])
def test_kernels_at_refiner_channels(gen, hw, c, co):
    """K2a's slabs and K2b at the SDXL refiner's channel counts: 12, 36,
    72 and 96 channels a group (384, 1152, 2304, 3072), at a CFG call's
    two rows."""
    x = (torch.randn((2, hw, hw, c), generator=gen, device="cuda") +
         torch.randn((c,), generator=gen, device="cuda")).to(torch.bfloat16)
    gs = 1 + 0.1 * _randn(gen, c, dtype=torch.float32)
    gb = 0.1 * _randn(gen, c, dtype=torch.float32)
    wt = _randn(gen, 3, 3, c, co) * (9 * c) ** -0.5
    cb = 0.1 * _randn(gen, co, dtype=torch.float32)
    a, bb = FC.gn_affine(x, gs, gb, 32, 1e-5)
    a_ref, b_ref = FC.gn_affine_plain(x, gs, gb, 32, 1e-5)
    assert _rel(a, a_ref) <= F32_STATS_BOUND
    assert _rel(bb, b_ref) <= F32_STATS_BOUND
    chain = FC.gn_silu_conv3x3(x, gs, gb, wt, cb, groups=32, eps=1e-5)
    chain_ref = FC.gn_silu_conv3x3_plain(x, gs, gb, wt, cb, groups=32,
                                         eps=1e-5)
    assert _rel(chain, chain_ref) <= BF16_BOUND
