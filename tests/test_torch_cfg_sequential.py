"""Sequential classifier-free guidance and the latent dumps of the port's
pipeline, on the SD_TEST preset in f32 on the CPU with the JAX package's
weights and initial noise (as tests/test_torch_pipeline.py): the
sequential image equals the port's parallel one within 1e-4 and the JAX
pipeline's sequential one within 2e-3 (the image bound of the pipeline
parity tests); it runs two UNet calls of B rows a model call, and a
cfg_only ControlNet forces it off. ``SD_DEBUG_LATENTS`` dumps land in the
log ring, and ``approx_decode`` equals the JAX package's."""

import logging
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gyre_tpu.pipeline import clip_guidance as jcg
from gyre_tpu_torch.models import controlnet as tcn
from gyre_tpu_torch.models import unet as tunet
from gyre_tpu_torch.pipeline import clip_guidance as tcg
from gyre_tpu_torch.pipeline import modes as tmodes
from gyre_tpu_torch.utils import logview
from gyre_tpu_torch.utils.cache import MemoryLRUCache
from test_torch_modes import one_torch_thread  # noqa: F401
from test_torch_pipeline import CFG, REQUEST, _jax_noise, pipes  # noqa: F401

SEQ = dict(REQUEST, steps=4, seeds=[3])


@pytest.fixture
def unet_calls(monkeypatch):
    """The rows of every UNet call."""
    rows = []
    apply = tunet.apply

    def counted(params, cfg, x, *args, **kw):
        rows.append(x.shape[0])
        return apply(params, cfg, x, *args, **kw)

    monkeypatch.setattr(tunet, "apply", counted)
    return rows


@pytest.fixture(scope="module")
def images(pipes):  # noqa: F811
    jpipe, tpipe = pipes
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tmodes, "txt2img_initial", _jax_noise)
        par = tpipe(**SEQ)
        seq = tpipe(**SEQ, cfg_sequential=True)
    ref = np.asarray(jpipe(**SEQ, cfg_sequential=True))
    return par, seq, ref


def test_sequential_equals_parallel(images):
    par, seq, _ = images
    assert seq.shape == (1, 64, 64, 3)
    assert float((seq - par).abs().max()) <= 1e-4


def test_sequential_matches_jax(images):
    _, seq, ref = images
    assert np.abs(seq.numpy() - ref).max() <= 2e-3


def test_sequential_runs_two_calls_of_b_rows(pipes, unet_calls):  # noqa: F811
    _, tpipe = pipes
    tpipe(**dict(SEQ, seeds=[3, 4]), cfg_sequential=True)
    assert unet_calls == [2] * (2 * SEQ["steps"])
    unet_calls.clear()
    tpipe(**dict(SEQ, seeds=[3, 4]))
    assert unet_calls == [4] * SEQ["steps"]


def test_cfg_only_controlnet_forces_parallel(pipes, unet_calls):  # noqa: F811
    """cfg_only needs the [uncond; guided] rows of one call: the request
    runs parallel CFG, with the same image as without cfg_sequential."""
    _, tpipe = pipes
    hint = {"image": np.ones((1, 64, 64, 3), np.float32),
            "params": tcn.random_controlnet(CFG.unet, dtype=torch.float32,
                                            device="cpu"),
            "soft_injection": True, "cfg_only": True}
    a = tpipe(**SEQ, hints=[hint], cfg_sequential=True)
    assert unet_calls == [2] * SEQ["steps"]
    b = tpipe(**SEQ, hints=[hint])
    assert torch.equal(a, b)


def test_approx_decode_matches_jax():
    x = np.random.default_rng(0).standard_normal((2, 8, 6, 4)).astype(
        np.float32) * 2
    ref = np.asarray(jcg.approx_decode(jnp.asarray(x)))
    got = tcg.approx_decode(torch.from_numpy(x)).numpy()
    assert np.abs(ref - got).max() <= 1e-6
    assert np.asarray(jcg.LATENT_RGB).tolist() == \
        np.asarray(tcg.LATENT_RGB, np.float32).tolist()


def test_latent_dumps_reach_the_log_ring(pipes, monkeypatch):  # noqa: F811
    """init (an img2img request), every chunk and the final latents, each a
    record in the ring with its preview image in the cache; none without
    the variable."""
    _, tpipe = pipes
    cache = MemoryLRUCache()
    monkeypatch.setattr(logview.VisualRecord, "cache", cache)
    ring = logview.StoreHandler()
    logger = logging.getLogger("gyre_tpu_torch.latents")
    logger.addHandler(ring)
    level = logger.level
    logger.setLevel(logging.INFO)
    req = dict(SEQ, init_image=np.full((1, 64, 64, 3), 0.4, np.float32),
               strength=1.0, chunk_steps=2, stop_event=threading.Event())
    try:
        monkeypatch.setenv("SD_DEBUG_LATENTS", "")
        tpipe(**req)
        assert not ring.tail()
        monkeypatch.setenv("SD_DEBUG_LATENTS", "init,chunk,final")
        tpipe(**req)
        msgs = [r["message"] for r in ring.tail()]
    finally:
        logger.removeHandler(ring)
        logger.setLevel(level)
    tags = [m.split()[0] for m in msgs]
    assert tags == ["latents:init", "latents:chunk:2", "latents:chunk:4",
                    "latents:final"]
    for m in msgs:
        key = m.split("/log/")[1]
        assert cache.get(key).startswith(b"\x89PNG")
