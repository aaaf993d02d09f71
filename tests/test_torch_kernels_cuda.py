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
channels a group); K1 at DPT-Large's self-attention (one image, 16 heads
of 64, T = 257 / 577 / 1025: ragged query rows) and inside the DPT's
blocks, and K2a/K2b at the SD1.5 UNet's one-row shapes of cfg_sequential;
K1 at the x4 upscaler's head dims 8, 16 and 32 and its VAE's 512 over
16384 tokens, at the k-UNet's head dim 64 and on ToMe's merged tokens;
K2a/K2b at the x4 UNet's 2 channels a group and Co = 64; K1 at
ViT-L/14's, the style adapter's and the 28²-cutout VAE's shapes and
against 85 context tokens, K2a/K2b through the cutout decode; the
gradients through K1's and K2's recompute Functions against the plain
versions' autograd, and the refusal of a direct launch that would cut the
graph; a pool of two replicas and a tp = 2 split on one card against
one replica (parallel/pool.py). Bounds as in chip_smoke.py:
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
    out, ref = out.detach().float(), ref.detach().float()
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


@pytest.mark.cuda
@pytest.mark.parametrize("t", [257, 577, 1025])
def test_flash_attention_dpt(gen, t):
    """DPT-Large's self-attention: T = (size / 16)² + 1 is odd and no
    multiple of K1's tiles, so query rows and key columns are ragged."""
    q, k, v = (_btd(gen, 1, t, 16, 64) for _ in range(3))
    before = _build.launches["flash_attention"]
    out = A.attention(q, k, v)
    assert _build.launches["flash_attention"] == before + 1
    assert _rel(out, _attention_ref(q, k, v)) <= BF16_BOUND


@pytest.mark.cuda
def test_dpt_blocks_launch_k1(gen):
    """A DPT (test widths, bf16 on the card) runs one K1 launch a block,
    and its depth map is close to the same weights' in f32 on the CPU."""
    from gyre_tpu_torch.models import dpt

    model = dpt.random_dpt(dpt.DPT_TEST, seed=0, dtype=torch.bfloat16,
                           device="cuda")
    x = torch.rand((1, 64, 64, 3), generator=gen, device="cuda")
    before = _build.launches["flash_attention"]
    with torch.inference_mode():
        out = dpt.estimate_depth(model, x, 64)
    assert _build.launches["flash_attention"] == \
        before + dpt.DPT_TEST.layers
    cpu = dpt.random_dpt(dpt.DPT_TEST, seed=0, device="cpu")
    with torch.inference_mode():
        ref = dpt.estimate_depth(cpu, x.cpu(), 64)
    assert float((out.cpu() - ref).abs().max()) <= 0.1


@pytest.mark.cuda
@pytest.mark.parametrize("hw,c,co", [
    (8, 2560, 1280), (16, 2560, 1280), (16, 1920, 1280), (32, 1920, 640),
    (32, 1280, 640), (32, 960, 640), (64, 960, 320), (64, 640, 320)])
def test_kernels_at_one_row(gen, hw, c, co):
    """K2a and K2b at the SD1.5 UNet's up-path shapes at one row (each
    CFG half a call of its own under cfg_sequential)."""
    x = (torch.randn((1, hw, hw, c), generator=gen, device="cuda") +
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


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,tq,tk,d", [
    (2, 8, 16384, 16384, 8), (2, 8, 16384, 77, 8), (2, 8, 4096, 4096, 16),
    (2, 8, 1024, 77, 32), (1, 1, 16384, 16384, 512)])
def test_flash_attention_x4_upscaler(gen, b, h, tq, tk, d):
    """The x4 upscaler's head dims at a 128² input: 8 (its 64-wide level,
    16384 tokens: half of every product is the pad to 16), 16 and 32, self
    and against 77 text tokens; and its VAE's mid block, one head of 512
    over 16384 tokens (the plain version's 1 GiB of f32 logits)."""
    q = _btd(gen, b, tq, h, d)
    k, v = _btd(gen, b, tk, h, d), _btd(gen, b, tk, h, d)
    assert _rel(A.attention(q, k, v), _attention_ref(q, k, v)) <= BF16_BOUND


@pytest.mark.cuda
@pytest.mark.parametrize("hw,c,co", [
    (128, 64, 64), (128, 128, 64), (128, 192, 64), (64, 64, 128),
    (32, 128, 256), (16, 512, 256)])
def test_kernels_at_x4_upscaler_channels(gen, hw, c, co):
    """K2a at 2 to 16 channels a group (x4 UNet widths 64-512 in 32
    groups: a slab of 8 channels holds 4 groups at 64) and K2b at Co = 64,
    half of its 128-channel tile, at a CFG call's two rows."""
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


@pytest.mark.cuda
@pytest.mark.parametrize("t,tk,h", [(4096, 77, 12), (256, 256, 24),
                                    (256, 77, 24)])
def test_flash_attention_kunet(gen, t, tk, h):
    """The sd-x2 k-UNet's attentions at a 512² input (head dim 64):
    cross-attention at its 768-wide 64² level, self- and cross-attention
    at its 1536-wide 16² level."""
    q = _btd(gen, 2, t, h, 64)
    k, v = _btd(gen, 2, tk, h, 64), _btd(gen, 2, tk, h, 64)
    assert _rel(A.attention(q, k, v), _attention_ref(q, k, v)) <= BF16_BOUND


@pytest.mark.cuda
@pytest.mark.parametrize("n,c,heads", [(4096, 320, 8), (1024, 640, 8)])
def test_tome_merged_self_attention(gen, n, c, heads):
    """ToMe at ratio 0.5 on SD1.5's two first levels: the merged tokens
    (T = N - r) projected and through K1, one launch, against the plain
    attention of the same merged tokens; the unmerged output has N
    tokens."""
    from gyre_tpu_torch.models import unet as U
    from gyre_tpu_torch.ops import tome

    x = _randn(gen, 2, n, c)
    p = {name: {"w": _randn(gen, c, c) * c ** -0.5}
         for name in ("q", "k", "v")}
    p["out"] = {"w": _randn(gen, c, c) * c ** -0.5,
                "b": _randn(gen, c) * 0.1}
    r = tome.merge_count(n, 0.5)
    merged, info = tome.merge(x, r)
    assert merged.shape == (2, n - r, c) and merged.is_contiguous()
    before = _build.launches["flash_attention"]
    out = U._attn(p, merged, merged, heads)
    assert _build.launches["flash_attention"] == before + 1
    d = c // heads
    q, k, v = (torch.nn.functional.linear(merged, p[nm]["w"]).view(
        2, n - r, heads, d) for nm in ("q", "k", "v"))
    ref = torch.nn.functional.linear(
        _attention_ref(q, k, v).reshape(2, n - r, c), p["out"]["w"],
        p["out"]["b"])
    assert _rel(out, ref) <= BF16_BOUND
    assert tome.unmerge(out, info).shape == (2, n, c)


# ------------------------------------------------ CLIP guidance, style


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,t,d", [
    (4, 16, 257, 64), (8, 16, 257, 64), (1, 8, 265, 128), (2, 1, 784, 512)])
def test_flash_attention_clip_shapes(gen, b, h, t, d):
    """ViT-L/14's attention on 4 guidance views and on a safety batch of 8
    (T = 257), the style adapter's (257 + 8 tokens, 8 heads of 128), the
    VAE mid block on two 28² latent cutouts (784 tokens of one 512 head)."""
    q, k, v = (_btd(gen, b, t, h, d) for _ in range(3))
    assert _rel(A.attention(q, k, v), _attention_ref(q, k, v)) <= BF16_BOUND


@pytest.mark.cuda
@pytest.mark.parametrize("t,d", [(4096, 40), (1024, 80), (256, 160),
                                 (64, 160)])
def test_flash_attention_style_cross(gen, t, d):
    """The UNet's cross-attention against 77 + 8 style tokens."""
    q = _btd(gen, 2, t, 8, d)
    k, v = _btd(gen, 2, 85, 8, d), _btd(gen, 2, 85, 8, d)
    assert _rel(A.attention(q, k, v), _attention_ref(q, k, v)) <= BF16_BOUND


@pytest.mark.cuda
@pytest.mark.parametrize("b,hw,c,co", [(2, 28, 512, 512), (2, 56, 512, 512),
                                       (2, 112, 512, 256),
                                       (1, 224, 256, 128)])
def test_kernels_at_cutout_decode(gen, b, hw, c, co):
    """K2a + K2b through the VAE decoder of 28² latent cutouts (widths 28,
    56, 112, 224: no multiple of K2b's 16-pixel tile but 112 and 224)."""
    x = (torch.randn((b, hw, hw, c), generator=gen, device="cuda") +
         1.0).to(torch.bfloat16)
    gs = 1 + 0.1 * _randn(gen, c, dtype=torch.float32)
    gb = 0.1 * _randn(gen, c, dtype=torch.float32)
    wt = _randn(gen, 3, 3, c, co) * (9 * c) ** -0.5
    cb = 0.1 * _randn(gen, co, dtype=torch.float32)
    out = FC.gn_silu_conv3x3(x, gs, gb, wt, cb, groups=32, eps=1e-6)
    ref = FC.gn_silu_conv3x3_plain(x, gs, gb, wt, cb, groups=32, eps=1e-6)
    assert _rel(out, ref) <= BF16_BOUND


def _grads(fn, ins, g):
    xs = [t.detach().requires_grad_() for t in ins]
    out = fn(*xs)
    return [out, *torch.autograd.grad(out, xs, g)]


@pytest.mark.cuda
@pytest.mark.parametrize("tq,tk,d", [(600, 77, 40), (1024, 1024, 80),
                                     (257, 257, 64)])
def test_flash_attention_gradient(gen, tq, tk, d):
    """attention() on tensors that require grad runs K1 once, under
    FlashGrad; its gradients (the chunked plain recompute's, 512 query
    rows a block) against the plain version's autograd."""
    q = _btd(gen, 1, tq, 8, d)
    k, v = _btd(gen, 1, tk, 8, d), _btd(gen, 1, tk, 8, d)
    g = _randn(gen, 1, tq, 8, d)
    before = _build.launches["flash_attention"]
    got = _grads(A.attention, (q, k, v), g)
    assert _build.launches["flash_attention"] == before + 1
    assert got[0].grad_fn is not None
    ref = _grads(_attention_ref, (q, k, v), g)
    assert max(_rel(a, b) for a, b in zip(got, ref)) <= BF16_BOUND


@pytest.mark.cuda
@pytest.mark.parametrize("b,hw,c,co", [(1, 64, 320, 320), (2, 28, 512, 512)])
def test_gn_silu_conv3x3_gradient(gen, b, hw, c, co):
    """gn_silu_conv3x3 on tensors that require grad runs K2a and K2b once
    each, under GnSiluConvGrad; the gradients of x, the GN affine, the
    weight and the conv bias against the plain chain's autograd."""
    x = (torch.randn((b, hw, hw, c), generator=gen, device="cuda") +
         1.0).to(torch.bfloat16)
    ins = (x, 1 + 0.1 * _randn(gen, c, dtype=torch.float32),
           0.1 * _randn(gen, c, dtype=torch.float32),
           _randn(gen, 3, 3, c, co) * (9 * c) ** -0.5,
           0.1 * _randn(gen, co, dtype=torch.float32))
    g = _randn(gen, b, hw, hw, co)
    before = (_build.launches["gn_stats"], _build.launches["gn_silu_conv3x3"])
    got = _grads(lambda *a: FC.gn_silu_conv3x3(*a, groups=32, eps=1e-6),
                 ins, g)
    assert (_build.launches["gn_stats"],
            _build.launches["gn_silu_conv3x3"]) == (before[0] + 1,
                                                    before[1] + 1)
    ref = _grads(lambda *a: FC.gn_silu_conv3x3_plain(*a, groups=32,
                                                     eps=1e-6), ins, g)
    assert max(_rel(a, b) for a, b in zip(got, ref)) <= BF16_BOUND


@pytest.mark.cuda
def test_kernels_refuse_to_cut_a_graph(gen):
    """A direct launch of K1, K2a or K2b on a tensor that requires grad
    raises (its output would have no grad_fn); under no_grad it runs."""
    q = _btd(gen, 1, 64, 2, 16).requires_grad_()
    with pytest.raises(RuntimeError, match="autograd graph"):
        A._flash(q, q, q, 0.25)
    x = _randn(gen, 1, 8, 8, 32).requires_grad_()
    gs, gb = (torch.ones(32, device="cuda"), torch.zeros(32, device="cuda"))
    with pytest.raises(RuntimeError, match="autograd graph"):
        FC.gn_affine(x, gs, gb, 32, 1e-6)
    a, b = FC.gn_affine(x.detach(), gs, gb, 32, 1e-6)
    w = _randn(gen, 3, 3, 32, 8)
    with pytest.raises(RuntimeError, match="autograd graph"):
        FC.affine_silu_conv3x3(x, a, b, w, torch.zeros(8, device="cuda"))
    with torch.no_grad():
        assert A._flash(q, q, q, 0.25).shape == q.shape


@pytest.mark.cuda
@pytest.mark.parametrize("tp", [1, 2])
def test_pool_on_one_card_matches_one_replica(gen, tp):
    """A pool of two replicas on cuda:0 (tp = 1: the 3 samples split 2 + 1,
    each group on its own host thread), and one tp = 2 group with both
    shards on cuda:0, against one replica: SD1.5 at 128², 3 steps, every
    group launching the kernels (K1 twice a UNet attention under tp = 2:
    each shard launches). uint8 levels as chip_smoke's pool phase holds
    them: the pool within 2 of one replica on each group's rows, and within
    12 of one replica's batch of 3 (in bf16 one replica's images of 2 rows
    differ from its images of 3), tp = 2 within 12 (each shard's partial
    out-projection is rounded to bf16 before the sum)."""
    import threading

    from gyre_tpu_torch.models.modelset import random_preset
    from gyre_tpu_torch.parallel import mesh as pmesh
    from gyre_tpu_torch.parallel.pool import PooledPipeline
    from gyre_tpu_torch.pipeline.unified import UnifiedPipeline

    ms = random_preset("sd15", seed=0, dtype=torch.bfloat16, device="cuda")
    kw = dict(prompt="a boat", height=128, width=128, steps=3,
              sampler="k_dpmpp_2m", guidance_scale=7.5, seeds=[1, 2, 3],
              output_dtype="uint8", chunk_steps=2,
              stop_event=threading.Event())
    ref = UnifiedPipeline(ms, compute_dtype=torch.bfloat16)(**kw)
    mesh = pmesh.make_mesh(["cuda:0", "cuda:0"], tp=tp)
    pool = PooledPipeline([UnifiedPipeline(m, compute_dtype=torch.bfloat16)
                           for m in pmesh.shard_modelset(ms, mesh)])
    _build.reset_launches()
    got = pool(**kw)
    groups, k1 = (2, 32) if tp == 1 else (1, 64)
    assert dict(_build.launches) == {
        "flash_attention": groups * (k1 * 3 + 1),
        "gn_stats": groups * (44 * 3 + 28),
        "gn_silu_conv3x3": groups * (44 * 3 + 28)}
    assert got.shape == ref.shape == (3, 128, 128, 3)
    assert int((got.int() - ref.int()).abs().max()) <= 12
    if tp == 1:
        one = UnifiedPipeline(ms, compute_dtype=torch.bfloat16)
        per = torch.cat([one(**dict(kw, seeds=kw["seeds"][:2])),
                         one(**dict(kw, seeds=kw["seeds"][2:]))])
        assert int((got.int() - per.int()).abs().max()) <= 2
