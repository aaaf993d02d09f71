"""The latent diffusion upscalers (gyre_tpu_torch.pipeline.
diffusion_upscaler) against the JAX package's, on the CPU in f32 with the
same weights (the JAX package's random ModelSets at the test presets,
bridged) and the JAX package's noise put in at ``utils.rng.draw``: the
class-embedded and the scale-shift UNets (1e-3, and their checkpoint round
trip), ``DiffusionUpscaler`` (x4) and ``LatentUpscalerX2`` at 2 steps
(2e-3), the prompt reaching the image, and both engines through the
port's manager and generate servicer: an init-image request answers a PNG
4x and 2x the input within one level of the JAX pipeline's image (a task
request runs with no prompt and seed 0, as in the JAX servicer), and
ListEngines' upscale group reports them ready.

Each JAX upscaler is built and run once for the module (its jit compiles
at every call).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gyre_tpu.models import configs as jconfigs
from gyre_tpu.models import modelset as jms
from gyre_tpu.models import unet as junet
from gyre_tpu.pipeline import diffusion_upscaler as jdu
from gyre_tpu_torch.generated import engines_pb2 as epb
from gyre_tpu_torch.generated import generation_pb2 as tpb
from gyre_tpu_torch.http.router import FakeGrpcContext as TContext
from gyre_tpu_torch.manager import manager as tmanager
from gyre_tpu_torch.models import configs as tconfigs
from gyre_tpu_torch.models import load as tload
from gyre_tpu_torch.models import modelset as tms
from gyre_tpu_torch.models import unet as tunet
from gyre_tpu_torch.ops import images as timages
from gyre_tpu_torch.pipeline import diffusion_upscaler as tdu
from gyre_tpu_torch.services import generate as tgen
from gyre_tpu_torch.services.engines import EnginesServiceServicer
from gyre_tpu_torch.utils import rng as trng
from test_torch_modes import _jax_draw, one_torch_thread  # noqa: F401

LEVEL = 1.0 / 255 + 1e-6
# an image on the PNG levels, so an init-image request carries it exactly
IMG = np.round(np.random.default_rng(23).random((1, 16, 16, 3)) *
               255).astype(np.float32) / 255


def bridge(jax_ms, cfg, engine_id="bridged"):
    """The port's ModelSet at ``cfg`` (its own configs) holding a JAX
    ModelSet's weights."""
    trees = (jax.tree.map(np.asarray, jax_ms.unet_params),
             jax.tree.map(np.asarray, jax_ms.vae_params),
             [jax.tree.map(np.asarray, t) for t in jax_ms.text_params])
    return tms.from_jax_params(*trees, cfg, device="cpu",
                               engine_id=engine_id)


def bridged_random(monkeypatch):
    """The port manager's random ModelSets become the JAX package's random
    ModelSets of the same preset and seed, bridged: both managers then
    serve the same weights."""
    def make(cfg, seed=0, dtype=torch.float32, device="cpu",
             engine_id="random"):
        name = next(n for n, c in tconfigs.PRESETS.items() if c is cfg)
        jset = jms.random_modelset(jconfigs.PRESETS[name], seed=seed,
                                   dtype=jnp.float32, engine_id=engine_id)
        return bridge(jset, cfg, engine_id)

    monkeypatch.setattr(tmanager, "random_modelset", make)


@pytest.fixture
def jax_noise(monkeypatch):
    monkeypatch.setattr(trng, "draw", _jax_draw)


@pytest.fixture(scope="module")
def jax_x4():
    """(JAX x4 upscaler, its image of IMG at the engine's settings: 2
    steps, no prompt, seed 0, noise level 20)."""
    up = jdu.DiffusionUpscaler.random(test=True)
    return up, np.asarray(up(IMG, steps=2))


@pytest.fixture(scope="module")
def jax_x2():
    up = jdu.LatentUpscalerX2.random(test=True)
    return up, np.asarray(up(IMG, steps=2))


# ------------------------------------------------------------------ UNets


@pytest.mark.parametrize("field", ["class_embed", "time_scale_shift"])
def test_upscaler_unet_conditioning_matches_jax(field, tmp_path):
    """The x4 upscaler's class embedding (noise levels as class labels) and
    the scale-shift resnets against the JAX UNet; an export of either
    loads back with the same leaves (``class_embedding.linear_{1,2}``,
    ``resnet_time_scale_shift``)."""
    jcfg = dataclasses.replace(jconfigs.UNET_TEST, **{field: True})
    tcfg = dataclasses.replace(tconfigs.UNET_TEST, **{field: True})
    params = junet.init(jax.random.PRNGKey(2), jcfg)
    tparams = tms._from_jax(tunet.param_specs(tcfg),
                            jax.tree.map(np.asarray, params), "unet",
                            torch.float32, torch.device("cpu"))
    rs = np.random.RandomState(1)
    x = rs.randn(2, 16, 16, 4).astype(np.float32)
    t = np.asarray([5.0, 700.0], np.float32)
    ctx = rs.randn(2, 77, jcfg.cross_attention_dim).astype(np.float32)
    labels = np.asarray([20.0, 350.0], np.float32)
    run = jax.jit(lambda p, *a: junet.apply(p, jcfg, *a[:3],
                                            class_labels=a[3]))
    want = np.asarray(run(params, jnp.asarray(x), jnp.asarray(t),
                          jnp.asarray(ctx), jnp.asarray(labels)))
    with torch.no_grad():
        got = tunet.apply(tparams, tcfg, torch.from_numpy(x),
                          torch.from_numpy(t), torch.from_numpy(ctx),
                          class_labels=torch.from_numpy(labels)).numpy()
    assert np.abs(got - want).max() <= 1e-3

    cfg = dataclasses.replace(tconfigs.SD_TEST, unet=tcfg)
    ms = tms.random_modelset(cfg, seed=3, dtype=torch.float32, device="cpu")
    tload.save_modelset(ms, str(tmp_path / "m"))
    back = tload.load_modelset(str(tmp_path / "m"), tconfigs.SD_TEST,
                               dtype=torch.float32, device="cpu")
    assert getattr(back.config.unet, field)
    for a, b in zip(tms._leaves(back.unet_params),
                    tms._leaves(ms.unet_params), strict=True):
        assert torch.equal(a, b)


# ------------------------------------------------------------- pipelines


def test_x4_upscaler_matches_jax(jax_x4, jax_noise):
    jup, want = jax_x4
    up = tdu.DiffusionUpscaler(bridge(jup.ms, tdu.X4_TEST_CONFIG))
    got = up(IMG, steps=2).numpy()
    assert got.shape == want.shape == (1, 64, 64, 3)
    assert np.abs(got - want).max() <= 2e-3
    assert got.std() > 1e-2


def test_x2_upscaler_matches_jax(jax_x2, jax_noise):
    jup, want = jax_x2
    up = tdu.LatentUpscalerX2(bridge(jup.ms, tdu.X2_TEST_CONFIG))
    got = up(IMG, steps=2).numpy()
    assert got.shape == want.shape == (1, 32, 32, 3)
    assert np.abs(got - want).max() <= 2e-3
    assert got.std() > 1e-2


@pytest.mark.parametrize("cls", [tdu.DiffusionUpscaler,
                                 tdu.LatentUpscalerX2])
def test_prompt_conditioning_flows(cls):
    up = cls.random(test=True, device="cpu")
    a = up(IMG, prompt="sharp photo", steps=2, seeds=[1])
    b = up(IMG, prompt="a different condition", steps=2, seeds=[1])
    c = up(IMG, prompt="sharp photo", steps=2, seeds=[1])
    assert torch.equal(a, c)
    assert (a - b).abs().max() > 1e-6


def test_presets_register_at_full_width():
    """The full-width presets the engines default to: the x4's UNet
    (64/128/256/256, 7 channels, class-embedded) and 3-level VAE, the x2's
    k-UNet (384/768/768/1536, 4 resnets a block) over the SD VAE."""
    x4, x2 = tconfigs.PRESETS["upscaler-x4"], tconfigs.PRESETS["upscaler-x2"]
    assert x4.unet.block_out_channels == (64, 128, 256, 256)
    assert x4.unet.in_channels == 7 and x4.unet.class_embed
    assert x4.vae.block_out_channels == (128, 256, 512)
    assert x2.unet.block_out_channels == (384, 768, 768, 1536)
    assert x2.unet.layers_per_block == 4 and x2.unet.in_channels == 8
    assert x2.vae == tconfigs.VAE_SD
    for name in ("upscaler-x4", "upscaler-x2", "upscaler-x4-test",
                 "upscaler-x2-test"):
        assert name in jconfigs.PRESETS


# -------------------------------------------------------------- engines


def _request(engine_id):
    req = tpb.Request(engine_id=engine_id, request_id=engine_id)
    req.prompt.add().text = "ignored by a task engine"
    p = req.prompt.add()
    p.artifact.type = tpb.ARTIFACT_IMAGE
    p.artifact.binary = timages.encode_png(IMG[0])
    p.parameters.init = True
    req.image.seed.append(77)
    return req


def test_engines_serve_as_in_jax(jax_x4, jax_x2, jax_noise, monkeypatch):
    """config/engines/utility.yaml's upscaler-x4 and upscaler-x2 (at the
    test presets, 2 steps) through the manager and the servicer: one PNG
    each, 4x and 2x the init image, within one level of the JAX upscaler's
    image on the same weights and noise; the answer reports the request's
    seed; both ready in ListEngines' upscale group."""
    bridged_random(monkeypatch)
    m = tmanager.EngineManager(
        [{"id": "upscaler-x4", "task": "upscaler", "kind": "sd-x4",
          "model": "preset/upscaler-x4-test", "steps": 2},
         {"id": "upscaler-x2", "task": "upscaler", "kind": "sd-x2",
          "model": "preset/upscaler-x2-test", "steps": 2}],
        device="cpu", compute_dtype=torch.float32)
    try:
        m.load_engines()
        servicer = tgen.GenerationServiceServicer(m)
        for eid, (_, want) in (("upscaler-x4", jax_x4),
                               ("upscaler-x2", jax_x2)):
            (answer,) = servicer.Generate(_request(eid), TContext())
            art = answer.artifacts[0]
            got = timages.decode_png(art.binary)
            assert got.shape == want.shape
            assert np.abs(got - want).max() <= LEVEL + 2e-3
            assert art.seed == 77
        status = {s["id"]: s["weights"] for s in m.status()}
        assert status == {"upscaler-x4": "random", "upscaler-x2": "random"}
        listed = EnginesServiceServicer(m).ListEngines(
            epb.ListEnginesRequest(task_group=epb.UPSCALE),
            TContext()).engine
        assert {e.id: e.ready for e in listed} == {"upscaler-x4": True,
                                                   "upscaler-x2": True}
    finally:
        m.dispatcher.stop()
