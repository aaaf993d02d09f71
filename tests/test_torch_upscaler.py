"""The port's Real-ESRGAN (gyre_tpu_torch/models/esrgan.py) and tiled
upscaler pipeline (pipeline/upscaler.py) against the JAX package's, in f32
on the CPU on the same weights: RRDBNet through the strict bridge within
1e-3 of max |JAX|, its BasicSR export read back by the JAX loader and by
the port's strict loader; the reflect padding of any width as numpy's;
the tiled pipeline's image (its alpha channel resized apart) within 2e-3
of the JAX pipeline's on an RGBA image; the ESRGAN, SwinIR and HAT
upscaler engines of both managers over one checkpoint on disk; an engine
whose checkpoint does not load raises and one without weights reports
"random"."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

from gyre_tpu.manager.manager import EngineManager as JManager
from gyre_tpu.models import esrgan as je
from gyre_tpu.pipeline import upscaler as jup
from gyre_tpu_torch.manager.manager import EngineManager as TManager
from gyre_tpu_torch.models import esrgan as te
from gyre_tpu_torch.models import hat as th
from gyre_tpu_torch.models import modelset as tms
from gyre_tpu_torch.models import swinir as ts
from gyre_tpu_torch.pipeline import upscaler as tup
from test_torch_modes import one_torch_thread  # noqa: F401

TOL = 1e-3
IMG_TOL = 2e-3

IMG = np.random.default_rng(0).random((1, 13, 10, 3)).astype(np.float32)
RGBA = np.random.default_rng(1).random((1, 48, 40, 4)).astype(np.float32)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def esrgan_params():
    return _np(je.init(jax.random.PRNGKey(3), num_blocks=2, nf=16, gc=8))


def _err(ref, got):
    ref = np.asarray(ref)
    return float(np.abs(ref - got.detach().numpy()).max()) / \
        float(np.abs(ref).max())


def test_reflect_index_is_numpys():
    for n in (1, 2, 3, 7, 16):
        for before, after in ((0, 0), (1, 0), (5, 40), (16, 112)):
            x = np.arange(n)
            assert np.array_equal(
                x[tup.reflect_index(n, before, after)],
                np.pad(x, (before, after), mode="reflect"))


def test_bridge_matches_jax(esrgan_params):
    ref = je.apply(esrgan_params, jnp.asarray(IMG))
    model = tms.esrgan_from_jax(esrgan_params, device="cpu")
    with torch.no_grad():
        got = model(torch.from_numpy(IMG))
    assert tuple(got.shape) == ref.shape == (1, 52, 40, 3)
    assert _err(ref, got) <= TOL
    assert float(got.std()) > 1e-3
    with pytest.raises(ValueError, match="mystery"):
        tms.esrgan_from_jax(dict(esrgan_params, mystery={"w": np.zeros(1)}),
                            device="cpu")
    wrong = jax.tree.map(np.copy, esrgan_params)
    wrong["conv_hr"]["b"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="shape"):
        tms.esrgan_from_jax(wrong, device="cpu")


def test_export_reads_back_in_both_loaders(esrgan_params):
    model = tms.esrgan_from_jax(esrgan_params, device="cpu")
    state = te.state_dict_esrgan(model)
    assert "body.1.rdb3.conv5.weight" in state and len(state) == 2 * (
        2 * 15 + 6)
    jp = _np(je.load_params(state))
    assert jax.tree.structure(jp) == jax.tree.structure(esrgan_params)
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(esrgan_params)):
        assert np.abs(a - b).max() <= 1e-6
    again = te.load_esrgan({k: torch.from_numpy(v) for k, v in state.items()},
                           device="cpu")
    for (n, a), (_, b) in zip(model.named_parameters(),
                              again.named_parameters()):
        assert torch.equal(a, b), n
    # strict: an unread key and a missing one raise
    with pytest.raises(KeyError, match="mystery"):
        te.load_esrgan(dict(state, mystery=np.zeros(1, np.float32)),
                       device="cpu")
    with pytest.raises(ValueError, match="conv_up2.weight"):
        te.load_esrgan({k: v for k, v in state.items()
                        if k != "conv_up2.weight"}, device="cpu")


def test_published_width():
    """Real-ESRGAN x4plus: 23 blocks, nf 64, gc 32 (16.7 M parameters, as
    the JAX init)."""
    shapes = jax.eval_shape(lambda: je.init(jax.random.PRNGKey(0)))
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    with torch.device("meta"):
        model = te.RRDBNet()
    assert sum(p.numel() for p in model.parameters()) == n_jax == 16697987


@pytest.mark.parametrize("tile,overlap", [(32, 8), (16, 4)])
def test_tiled_pipeline_matches_jax(esrgan_params, tile, overlap):
    """The same tile grid, clamps, reflect padding, feather and crop as the
    JAX pipeline (run in f32 on the same weights), the alpha channel
    rescaled apart; the result stays on the model's device."""
    jp = jup.UpscalerPipeline(esrgan_params, scale=4, tile=tile,
                              overlap=overlap)
    pipe = tup.UpscalerPipeline(
        tms.esrgan_from_jax(esrgan_params, device="cpu"), scale=4,
        tile=tile, overlap=overlap)
    pipe.batch_tiles = 3                # a last batch of fewer tiles
    ref = jp(RGBA)
    got = pipe(RGBA)
    assert isinstance(got, torch.Tensor)
    assert tuple(got.shape) == ref.shape == (1, 192, 160, 4)
    assert np.abs(ref - got.numpy()).max() <= IMG_TOL
    # the grid: tiles at the JAX loop's clamped positions
    pos, hh, ww = pipe.positions(48, 40)
    assert len(pos) == len({p for p in pos}) and hh >= 48 + 2 * overlap


@pytest.fixture(scope="module")
def upscaler_ckpts(tmp_path_factory, esrgan_params):
    """Published-layout checkpoints of an ESRGAN (from the JAX params), a
    SwinIR and a HAT (the port's random ones at their test configs)."""
    root = tmp_path_factory.mktemp("upscalers")
    states = {
        "esrgan": te.state_dict_esrgan(tms.esrgan_from_jax(esrgan_params,
                                                           device="cpu")),
        "swinir": ts.state_dict_swinir(ts.random_swinir(
            dataclasses.replace(ts.SWINIR_TEST, upsampler="pixelshuffle"),
            5, device="cpu")),
        "hat": th.state_dict_hat(th.random_hat(th.HAT_TEST, 6,
                                               device="cpu"))}
    paths = {}
    for kind, state in states.items():
        paths[kind] = str(root / f"{kind}.safetensors")
        save_file({k: np.asarray(v) for k, v in state.items()}, paths[kind])
    return paths


@pytest.mark.parametrize("kind", ["esrgan", "swinir", "hat"])
def test_manager_engines_match_jax(upscaler_ckpts, kind):
    """Each image-space upscaler engine of both managers over the same
    checkpoint (its architecture derived from the file) answers the same
    4x image, within 2e-3; weights "real", ready."""
    spec = [{"id": "gen", "model": "preset/test", "default": True},
            {"id": "up", "task": "upscaler", "model": upscaler_ckpts[kind],
             "tile": 32 if kind == "esrgan" else 16,
             **({} if kind == "esrgan" else {"kind": kind})}]
    tm = TManager(spec, device="cpu", compute_dtype=torch.float32)
    jm = JManager(spec, compute_dtype=jnp.float32)
    try:
        img = RGBA[..., :3][:, :24, :20]
        got = tm.task_pipeline("upscaler", "up")(img)
        ref = np.asarray(jm.task_pipeline("upscaler", "up")(img))
        assert tuple(got.shape) == ref.shape == (1, 96, 80, 3)
        assert np.abs(ref - got.numpy()).max() <= IMG_TOL
        status = {s["id"]: s for s in tm.status()}["up"]
        assert status["weights"] == "real"
        tm.load_engines()
        assert {s["id"]: s for s in tm.status()}["up"]["ready"]
    finally:
        tm.dispatcher.stop()
        jm.dispatcher.stop()


def test_engine_without_weights_is_random_and_a_bad_checkpoint_raises(
        upscaler_ckpts, tmp_path):
    """No checkpoint: the JAX package's random sizes (ESRGAN at
    ``blocks``, SwinIR at SWINIR_TEST), weights "random". A checkpoint
    that resolves and does not load fails the engine (never a random
    model in its place)."""
    bad = str(tmp_path / "bad.safetensors")
    save_file({"conv_first.weight": np.zeros((4, 3, 3, 3), np.float32)},
              bad)
    tm = TManager([{"id": "gen", "model": "preset/test", "default": True},
                   {"id": "up", "task": "upscaler", "blocks": 2},
                   {"id": "sw", "task": "upscaler", "kind": "swinir"},
                   {"id": "bad", "task": "upscaler", "model": bad},
                   {"id": "badhat", "task": "upscaler", "kind": "hat",
                    "model": upscaler_ckpts["swinir"]}],
                  device="cpu", compute_dtype=torch.float32)
    try:
        up = tm.task_pipeline("upscaler", "up")
        assert len(up.model.body) == 2 and up.tile == 128
        assert up.overlap == 16
        sw = tm.task_pipeline("upscaler", "sw")
        assert sw.model.cfg == ts.SWINIR_TEST and sw.overlap == 2
        for eid in ("bad", "badhat"):
            with pytest.raises((KeyError, ValueError)):
                tm.task_pipeline("upscaler", eid)
        weights = {s["id"]: s["weights"] for s in tm.status()}
        assert weights["up"] == weights["sw"] == "random"
        assert weights["bad"] == "real"
    finally:
        tm.dispatcher.stop()
