"""CLIP guidance of the port (gyre_tpu_torch.pipeline.clip_guidance, the
pipeline's guided denoiser, the servicer's guidance parameters) and the
recompute backward rules of K1 and K2 (ops/attention.py's FlashGrad,
ops/fused_norm_conv.py's GnSiluConvGrad), against the JAX package on the
same weights: SD_TEST and CLIP_VISION_TEST, f32 on the CPU.

The crops' offsets are put in at the port's one seam (``cutout_offsets``)
from the JAX package's own draws (the port's own threefry draws equal
them: tests/test_torch_rng.py), and the end-to-end images use the
whole-image views ("approx" and "vae"), which draw nothing.

Tolerances (ROADMAP): layers 1e-4, models 1e-3, images 2e-3 absolute; a
gradient is held relative to its largest element. The guided x0 is
x0 - grad * sigma^2 * scale * 500, so its tolerance is stated relative to
the correction's largest element as well.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gyre_tpu.generated import generation_pb2 as jpb
from gyre_tpu.models import clip as jclip
from gyre_tpu.models import configs
from gyre_tpu.models import modelset as jms
from gyre_tpu.models import unet as junet
from gyre_tpu.models import vae as jvae
from gyre_tpu.ops import attention as jattn
from gyre_tpu.ops import fused_norm_conv as jfnc
from gyre_tpu.pipeline import clip_guidance as jcg
from gyre_tpu.pipeline import denoiser as jden
from gyre_tpu.pipeline import modes as jmodes
from gyre_tpu.pipeline import unified as junified
from gyre_tpu.services import generate as jgen
from gyre_tpu.utils import rng as jrng
from gyre_tpu_torch.generated import generation_pb2 as tpb
from gyre_tpu_torch.models import modelset as tms
from gyre_tpu_torch.models import unet as tunet
from gyre_tpu_torch.models import vae as tvae
from gyre_tpu_torch.ops import attention as tattn
from gyre_tpu_torch.ops import fused_norm_conv as tfnc
from gyre_tpu_torch.pipeline import clip_guidance as tcg
from gyre_tpu_torch.pipeline import denoiser as tden
from gyre_tpu_torch.pipeline import modes as tmodes
from gyre_tpu_torch.pipeline import unified as tunified
from gyre_tpu_torch.services import generate as tgen
from test_torch_modes import one_torch_thread  # noqa: F401

CFG = configs.SD_TEST
_OWN_OFFSETS = tcg.cutout_offsets          # before _jax_crops patches it
VCFG = jclip.CLIP_VISION_TEST
SEEDS = [3, 4]
PROMPT = "a red boat"


def _np(t):
    return np.asarray(t.detach().cpu().numpy() if torch.is_tensor(t) else t)


def _rel(a, b):
    a, b = _np(a), _np(b)
    return float(np.abs(a - b).max() / np.abs(b).max())


def jax_offsets(seeds, stream, n, h, w, cut, cut_power=1.0):
    """The JAX package's crop offsets (make_cutouts' draws, before the
    clamp) for each seed's ``stream``: [B, n, 2]."""
    min_side = min(h, w)
    out = []
    for key in jrng.keys_for_seeds(np.asarray(seeds, np.uint32)):
        key = jrng.stream(key, stream)
        row = []
        for i in range(n):
            k1, k2, k3 = jax.random.split(jax.random.fold_in(key, i), 3)
            frac = jax.random.uniform(k1) ** cut_power
            size = jnp.clip((frac * (min_side - cut) + cut).astype(jnp.int32),
                            8, min_side)
            row.append((int(jax.random.randint(k2, (), 0,
                                               jnp.maximum(h - size, 1))),
                        int(jax.random.randint(k3, (), 0,
                                               jnp.maximum(w - size, 1)))))
        out.append(row)
    return np.asarray(out, np.int64)


@pytest.fixture(autouse=True)
def _jax_crops(monkeypatch):
    """The port's crops at the JAX package's offsets."""
    monkeypatch.setattr(
        tcg, "cutout_offsets",
        lambda keys, stream, n, h, w, cut, cut_power=1.0: jax_offsets(
            [k if isinstance(k, int) else k[0] for k in keys], stream, n, h,
            w, cut, cut_power))


@pytest.fixture(scope="module")
def models():
    """(JAX ModelSet, port ModelSet, JAX vision params, port vision params)
    on the same weights."""
    jm = jms.random_modelset(CFG, seed=0, dtype=jnp.float32)
    tree = (jax.tree.map(np.asarray, jm.unet_params),
            jax.tree.map(np.asarray, jm.vae_params),
            [jax.tree.map(np.asarray, t) for t in jm.text_params])
    tm = tms.from_jax_params(*tree, CFG, device="cpu")
    vcfg = jclip.CLIPVisionConfig(**{**VCFG.__dict__, "projection_dim": 64})
    jv = jclip.vision_init(jax.random.PRNGKey(1), vcfg)
    tv = tms.clip_vision_from_jax(jax.tree.map(np.asarray, jv), vcfg,
                                  device="cpu")
    return jm, tm, (jv, tv, vcfg)


def _target(b=2):
    t = np.random.default_rng(5).standard_normal((1, 64)).astype(np.float32)
    t = np.repeat(t / np.linalg.norm(t), b, axis=0)
    return jnp.asarray(t), torch.from_numpy(t)


# ------------------------------------------------ the backward rules


@pytest.mark.parametrize("tq,tk", [(600, 77), (130, 130)])
def test_flash_backward_matches_jax_vjp(tq, tk):
    """FlashGrad's backward (built over the plain forward, so that it runs
    on the CPU; 600 query rows span two 512-row blocks) against jax.vjp of
    chunked_attention_bhtd, the JAX rule's recompute."""
    r = np.random.default_rng(0)
    q, k, v = (r.standard_normal((2, t, 3, 16)).astype(np.float32)
               for t in (tq, tk, tk))
    g = r.standard_normal((2, tq, 3, 16)).astype(np.float32)
    scale = 0.25
    tr = lambda a: jnp.asarray(a).transpose(0, 2, 1, 3)  # noqa: E731
    out, vjp = jax.vjp(lambda a, b, c: jattn.chunked_attention_bhtd(
        a, b, c, scale), tr(q), tr(k), tr(v))
    ref = [np.asarray(x).transpose(0, 2, 1, 3) for x in vjp(tr(g))]
    tq_, tk_, tv_ = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = tattn.FlashGrad.apply(tq_, tk_, tv_, scale, tattn._plain_bthd)
    got = torch.autograd.grad(o, (tq_, tk_, tv_), torch.from_numpy(g))
    assert _rel(o, np.asarray(out).transpose(0, 2, 1, 3)) <= 1e-4
    assert max(_rel(a, b) for a, b in zip(got, ref)) <= 1e-4


def test_gn_silu_conv_backward_matches_jax_vjp():
    """GnSiluConvGrad's backward (over the plain forward on the CPU)
    against jax.vjp of gn_silu_conv3x3_reference: x, the GN affine, w and
    the conv bias."""
    r = np.random.default_rng(1)
    x = r.standard_normal((2, 9, 7, 64)).astype(np.float32)
    gs = (1 + 0.1 * r.standard_normal(64)).astype(np.float32)
    gb = (0.1 * r.standard_normal(64)).astype(np.float32)
    w = (r.standard_normal((3, 3, 64, 16)) * 0.05).astype(np.float32)
    cb = (0.1 * r.standard_normal(16)).astype(np.float32)
    g = r.standard_normal((2, 9, 7, 16)).astype(np.float32)
    args = [jnp.asarray(a) for a in (x, gs, gb, w, cb)]
    out, vjp = jax.vjp(lambda *a: jfnc.gn_silu_conv3x3_reference(
        *a, groups=32, eps=1e-6), *args)
    ref = vjp(jnp.asarray(g))
    ins = [torch.from_numpy(a).requires_grad_() for a in (x, gs, gb, w, cb)]
    o = tfnc.GnSiluConvGrad.apply(*ins, 32, 1e-6,
                                  tfnc.gn_silu_conv3x3_plain)
    got = torch.autograd.grad(o, ins, torch.from_numpy(g))
    assert _rel(o, out) <= 1e-4
    assert [_rel(a, b) for a, b in zip(got, ref)] == pytest.approx(
        [0.0] * 5, abs=1e-4)


# ------------------------------------------------------------ the pieces


@pytest.mark.parametrize("shape,n,cut,stream,clamps", [
    ((2, 64, 80, 3), 3, 24, "clip_cuts_rgb", True),    # crop 48: clamped
    ((2, 16, 16, 4), 2, 4, "clip_cuts_vae", False)])
def test_make_cutouts_matches_jax(shape, n, cut, stream, clamps):
    imgs = np.random.default_rng(2).random(shape).astype(np.float32)
    keys = jax.vmap(lambda k: jrng.stream(k, stream))(
        jrng.keys_for_seeds(np.asarray(SEEDS, np.uint32)))
    ref = jcg.make_cutouts(jnp.asarray(imgs), keys, n, cut)
    offs = jax_offsets(SEEDS, stream, n, *shape[1:3], cut)
    side = min(2 * cut, *shape[1:3])
    assert (offs > np.asarray(shape[1:3]) - side).any() == clamps
    got = tcg.make_cutouts(torch.from_numpy(imgs), SEEDS, n, cut, stream)
    assert got.shape == ref.shape == (2 * n, cut, cut, shape[-1])
    assert np.abs(_np(got) - np.asarray(ref)).max() <= 1e-5


def test_cutout_offsets_are_per_seed():
    """The port's own draws: each sample's crops from its seed alone, the
    same at every call, within the offsets' range."""
    both = _OWN_OFFSETS([7, 9], "clip_cuts_rgb", 4, 512, 512, 224)
    alone = _OWN_OFFSETS([9], "clip_cuts_rgb", 4, 512, 512, 224)
    assert np.array_equal(both[1], alone[0])
    assert np.array_equal(both, _OWN_OFFSETS([7, 9], "clip_cuts_rgb", 4,
                                             512, 512, 224))
    assert not np.array_equal(both, _OWN_OFFSETS([7, 9], "clip_cuts_vae", 4,
                                                 512, 512, 224))
    assert (both >= 0).all() and (both < 512 - 224).all()


def test_spherical_dist_matches_jax():
    r = np.random.default_rng(3)
    x, y = (r.standard_normal((2, 4, 32)).astype(np.float32) for _ in "xy")
    ref = jcg.spherical_dist(jnp.asarray(x), jnp.asarray(y))
    got = tcg.spherical_dist(torch.from_numpy(x), torch.from_numpy(y))
    assert np.abs(_np(got) - np.asarray(ref)).max() <= 1e-5


@pytest.mark.parametrize("opts", [
    {"approx_cutouts": 2, "vae_cutouts": 0},
    {"approx_cutouts": 0, "vae_cutouts": 2},
    {"approx_cutouts": 0, "vae_cutouts": 0, "no_cutouts": "approx"},
    {"approx_cutouts": 0, "vae_cutouts": 0, "no_cutouts": "vae"}])
def test_guidance_loss_matches_jax(models, opts):
    jm, tm, (jv, tv, vcfg) = models
    ccfg = dict(guidance_scale=0.5, **opts)
    x0 = np.random.default_rng(4).standard_normal((2, 8, 8, 4)).astype(
        np.float32)
    jt, tt = _target()
    keys = jrng.keys_for_seeds(np.asarray(SEEDS, np.uint32))
    ref = jcg.guidance_loss(
        jnp.asarray(x0), keys, jv, vcfg, jt, jcg.ClipGuidanceConfig(**ccfg),
        vae_decode=lambda z: jvae.decode(jm.vae_params, CFG.vae, z))
    got = tcg.guidance_loss(
        torch.from_numpy(x0), SEEDS, tv, vcfg, tt,
        tcg.ClipGuidanceConfig(**ccfg),
        vae_decode=lambda z: tvae.decode(tm.vae_params, CFG.vae, z))
    assert abs(float(got) - float(ref)) <= 1e-4 * max(1.0, abs(float(ref)))


@pytest.mark.parametrize("losses,window", [
    ([0.5, 0.5], None), ([0.5] * 10, None),
    (list(np.linspace(2.0, 1.0, 10)), None), ([2.0] * 10, None),
    ([0.9] * 4, 2), ([0.95, 0.9, 0.91, 0.905], 3)])
def test_flatloss_check_equals_original(losses, window):
    kw = dict(gradient_length=5, gradient_threshold=0.01,
              gradient_maxloss=1.0)
    assert tcg.flatloss_check(losses, tcg.ClipGuidanceConfig(**kw),
                              samples_per_window=window) == \
        jcg.flatloss_check(losses, jcg.ClipGuidanceConfig(**kw),
                           samples_per_window=window)


# ------------------------------------------------------ the denoiser


def _denoisers(pkg, ms, ctx_u, ctx_g):
    """(CFG denoiser, cond-only stem) of SD_TEST's UNet in one package."""
    if pkg == "jax":
        def unet(x, t, c):
            return junet.apply(ms.unet_params, CFG.unet, x, t, c)

        return (jden.make_denoiser(jden.cfg_model(unet, ctx_u, ctx_g, 7.5),
                                   ms.schedule),
                jden.make_denoiser(jden.plain_model(unet, ctx_g),
                                   ms.schedule))

    def unet(x, t, c):
        return tunet.apply(ms.unet_params, CFG.unet, x, t, c)

    return (tden.make_denoiser(tden.cfg_model(unet, ctx_u, ctx_g, 7.5),
                               ms.schedule),
            tden.make_denoiser(tden.plain_model(unet, ctx_g), ms.schedule))


@pytest.mark.parametrize("base", ["guided", "mixed"])
def test_guided_denoiser_matches_jax(models, base):
    """The steered x0 at one sigma of a 20-step ramp (sigma ~ 1.3) and
    the loss's gradient, under "guided" (through the cond stem) and
    "mixed" (through the CFG prediction), with 1 approx and 1 VAE cutout
    at the JAX package's offsets."""
    jm, tm, (jv, tv, vcfg) = models
    r = np.random.default_rng(6)
    x = r.standard_normal((2, 8, 8, 4)).astype(np.float32) * 2.0
    cu, cg_ = (r.standard_normal((2, 77, 64)).astype(np.float32) * 0.5
               for _ in "ug")
    sigma = 1.3
    ccfg = dict(guidance_scale=0.5, guidance_base=base, approx_cutouts=1,
                vae_cutouts=1)
    jt, tt = _target()
    keys = jrng.keys_for_seeds(np.asarray(SEEDS, np.uint32))
    jdn, jstem = _denoisers("jax", jm, jnp.asarray(cu), jnp.asarray(cg_))
    tdn, tstem = _denoisers("torch", tm, torch.from_numpy(cu),
                            torch.from_numpy(cg_))

    def jdec(z):
        return jvae.decode(jm.vae_params, CFG.vae, z)

    def tdec(z):
        return tvae.decode(tm.vae_params, CFG.vae, z)

    jc, tc = jcg.ClipGuidanceConfig(**ccfg), tcg.ClipGuidanceConfig(**ccfg)
    steer_j = jcg.make_clip_guided_denoiser(
        jdn, jv, vcfg, jt, keys, config=jc, cond_stem=jstem, vae_decode=jdec)
    stem_j = jstem if base == "guided" else jdn
    stem_t = tstem if base == "guided" else tdn
    # one compile for both (eager jax.grad through the UNet is slower)
    jx0, jgrad = jax.jit(lambda xv: (steer_j(xv, sigma), jax.grad(
        lambda a: jcg.guidance_loss(stem_j(a, sigma), keys, jv, vcfg, jt, jc,
                                    vae_decode=jdec))(xv)))(jnp.asarray(x))
    with torch.no_grad():
        tx0 = tcg.make_clip_guided_denoiser(
            tdn, tv, vcfg, tt, SEEDS, config=tc, cond_stem=tstem,
            vae_decode=tdec)(torch.from_numpy(x), sigma)
    xv = torch.from_numpy(x).requires_grad_()
    (tgrad,) = torch.autograd.grad(tcg.guidance_loss(
        stem_t(xv, sigma), SEEDS, tv, vcfg, tt, tc, vae_decode=tdec), xv)
    assert float(jnp.abs(jgrad).max()) > 0
    assert _rel(tgrad, jgrad) <= 1e-3
    correction = np.asarray(jgrad) * sigma ** 2 * 0.5 * 500
    assert np.abs(_np(tx0) - np.asarray(jx0)).max() <= \
        1e-3 * max(np.abs(correction).max(), 1.0)


# ----------------------------------------------------- the pipeline


@pytest.fixture(scope="module")
def pipes(models):
    jm, tm, (jv, tv, vcfg) = models
    jpipe = junified.UnifiedPipeline(jm, compute_dtype=jnp.float32)
    tpipe = tunified.UnifiedPipeline(tm, compute_dtype=torch.float32)
    # one vision tower on both sides (the engines' random ones differ)
    jpipe._clip_vision, jpipe._clip_vision_cfg = jv, vcfg
    tpipe._clip.update(vision=tv, vision_cfg=vcfg)
    return jpipe, tpipe


def _jax_noise(seeds, shape, sigma_max, device, natural=0):
    keys = jrng.keys_for_seeds(np.asarray(seeds, np.uint32))
    x = jmodes.txt2img_initial(keys, shape, sigma_max, natural=natural)
    return torch.from_numpy(np.array(x)).to(device)


GUIDED = dict(prompt=PROMPT, height=64, width=64, steps=2,
              sampler="k_euler", seeds=SEEDS, guidance_scale=7.5,
              clip_guidance_scale=0.5)


@pytest.mark.parametrize("no_cutouts", ["approx", "vae"])
def test_guided_image_matches_jax(pipes, monkeypatch, no_cutouts):
    """A 2-step guided request with a whole-image view against the JAX
    pipeline's image (the JAX initial noise put in)."""
    jpipe, tpipe = pipes
    opts = {"approx_cutouts": 0, "vae_cutouts": 0, "no_cutouts": no_cutouts}
    ref = np.asarray(jpipe(**GUIDED, clip_guidance_options=opts))
    monkeypatch.setattr(tmodes, "txt2img_initial", _jax_noise)
    got = tpipe(**GUIDED, clip_guidance_options=opts)
    plain = tpipe(**{k: v for k, v in GUIDED.items()
                     if k != "clip_guidance_scale"})
    assert got.shape == ref.shape == (2, 64, 64, 3)
    assert np.abs(_np(got) - ref).max() <= 2e-3
    assert np.abs(_np(got) - _np(plain)).max() > 1e-2   # guidance steers


def test_guided_chunks_record_the_flat_loss(pipes, monkeypatch):
    """A chunked guided request evaluates one unguided loss after every
    chunk but the last (at the chunk's end sigma) and steers until the
    loss is flat; the chunk windows as in the JAX package."""
    _, tpipe = pipes
    import threading

    seen = []
    real = tcg.guidance_loss

    def spy(*a, **kw):
        out = real(*a, **kw)
        if not torch.is_grad_enabled():
            seen.append(float(out))
        return out

    monkeypatch.setattr(tcg, "guidance_loss", spy)
    kw = dict(GUIDED, steps=6, clip_guidance_options={
        "approx_cutouts": 1, "vae_cutouts": 0, "gradient_length": 2,
        "gradient_maxloss": 100.0, "gradient_threshold": 100.0})
    out = tpipe(**kw, chunk_steps=2, stop_event=threading.Event())
    # chunks end at steps 2 and 4 before the last: window max(2, 1 + 1),
    # so the stop trips only after a third loss; two are recorded
    assert len(seen) == 2 and np.isfinite(_np(out)).all()


def test_guided_request_on_adapted_engine():
    """A guided request on a LoRA-adapted engine: the folded leaves are
    made under no_grad (not inference mode), so the guided step can save
    them for its backward; the image differs from the adapted engine's
    unguided one and from the base engine's guided one."""
    from gyre_tpu_torch.manager.manager import EngineManager
    from test_torch_adapters import make_state

    lora = {k: torch.from_numpy(v) for k, v in make_state("kohya").items()}
    m = EngineManager([{"id": "tiny", "model": "preset/test"}],
                      device="cpu", compute_dtype=torch.float32)
    try:
        view = m.adapted_pipeline("tiny", loras=[(lora, 0.8, "k")])
        kw = dict(GUIDED, seeds=[5], clip_guidance_options={
            "approx_cutouts": 1, "vae_cutouts": 1})
        guided = view(**kw)
        unguided = view(**{k: v for k, v in kw.items()
                           if k != "clip_guidance_scale"})
        base = m.dispatch_view("tiny")(**kw)
        assert np.isfinite(_np(guided)).all()
        assert np.abs(_np(guided) - _np(unguided)).max() > 1e-2
        assert np.abs(_np(guided) - _np(base)).max() > 1e-2
    finally:
        m.dispatcher.stop()


@pytest.mark.parametrize("caller_mode", ["default", "inference"])
def test_guided_request_after_style_hint(models, caller_mode):
    """The vision tower an engine keeps is loaded by whichever request
    first needs it. When that is an unguided style hint, run in the
    pipeline's own grad mode or under the caller's inference mode, a
    later guided request on the same engine still saves the kept tower
    for its backward."""
    import contextlib

    from gyre_tpu_torch.models import t2i_adapter as tt2i

    _, tm, _ = models
    pipe = tunified.UnifiedPipeline(tm, compute_dtype=torch.float32)
    style = tt2i.random_style(7, torch.float32, "cpu", context_dim=64,
                              vision_dim=64, n_layers=1)
    hint = {"image": np.ones((1, 64, 64, 3), np.float32), "kind": "style",
            "params": style}
    plain = {k: v for k, v in GUIDED.items() if k != "clip_guidance_scale"}
    outer = (torch.inference_mode() if caller_mode == "inference"
             else contextlib.nullcontext())
    with outer:
        styled = pipe(**plain, hints=[hint])
    assert not pipe._clip["vision"]["patch_embed"]["w"].is_inference()
    kw = dict(GUIDED, clip_guidance_options={
        "approx_cutouts": 0, "vae_cutouts": 0, "no_cutouts": "approx"})
    guided, unguided = _np(pipe(**kw)), _np(pipe(**plain))
    assert np.isfinite(guided).all()
    assert np.abs(guided - unguided).max() > 1e-2
    assert np.abs(_np(styled) - unguided).max() > 1e-3


# ------------------------------------------------------ the servicer


def _request(pb, preset=None, strength=None):
    req = pb.Request(engine_id="tiny", request_id="g")
    req.prompt.add().text = "a boat"
    img = req.image
    img.height, img.width, img.steps = 64, 64, 2
    img.seed.append(3)
    if preset is not None:
        g = img.parameters.add().guidance
        g.guidance_preset = preset
        if strength is not None:
            g.instances.add().guidance_strength = strength
    return req


def _pipeline_kwargs(gen, pb, manager, req, context):
    """The kwargs a servicer hands the pipeline for ``req``: the
    dispatcher, the engine and its size stubbed, so no model is built."""
    from contextlib import contextmanager

    calls = []

    class Done:
        def __init__(self, value):
            self.value = value

        def result(self):
            return self.value

    def submit(fn, kwargs, *_, **__):
        calls.append(kwargs)
        return Done(np.zeros((len(kwargs["seeds"]), 64, 64, 3), np.uint8))

    @contextmanager
    def with_engine(*_, **__):
        yield None

    manager.dispatcher.submit = submit
    manager.with_engine = with_engine
    manager.natural_size = lambda _: 64
    list(gen.GenerationServiceServicer(manager).Generate(req, context))
    (kwargs,) = calls
    return kwargs


@pytest.mark.parametrize("preset,strength,opts", [
    ("GUIDANCE_PRESET_NONE", None, {}),
    ("GUIDANCE_PRESET_SIMPLE", None, {}),
    ("GUIDANCE_PRESET_FAST_BLUE", 0.25, {}),
    (None, None, {"clip_guidance_scale": 0.3}),
    (None, None, {"clip": {"guidance_scale": 0.4, "vae_cutouts": 1,
                           "guidance_base": "mixed"}}),
    ("GUIDANCE_PRESET_SIMPLE", 0.7, {"clip": {"approx_cutouts": 1}})])
def test_servicer_reads_guidance_as_jax(preset, strength, opts):
    """The request's guidance parameters and the engine's clip options
    reach the pipeline as the JAX servicer passes them."""
    from gyre_tpu.http.router import FakeGrpcContext as JContext
    from gyre_tpu.manager.manager import EngineManager as JManager
    from gyre_tpu_torch.http.router import FakeGrpcContext as TContext
    from gyre_tpu_torch.manager.manager import EngineManager as TManager

    spec = [{"id": "tiny", "model": "preset/test", "options": opts}]
    got, ref = (
        _pipeline_kwargs(gen, pb, mgr, _request(
            pb, None if preset is None else getattr(pb, preset), strength),
            ctx)
        for gen, pb, mgr, ctx in (
            (tgen, tpb, TManager(spec, device="cpu",
                                 compute_dtype=torch.float32), TContext()),
            (jgen, jpb, JManager(spec, compute_dtype=jnp.float32),
             JContext())))
    keys = ("clip_guidance_scale", "clip_guidance_options")
    assert {k: got[k] for k in keys} == {k: ref[k] for k in keys}
