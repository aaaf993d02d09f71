"""The port's M-LSD line detector (gyre_tpu_torch/models/mlsd.py) against
the JAX package's, in f32 on the CPU on the same weights: the published
``mlsd_large_512_fp32.pth`` layout (tests/torch_oracles.py's MlsdLarge,
random BatchNorm statistics) through both strict loaders, the port's
export read back by the JAX loader, the bridge from the JAX tree (its
``stride``/``res`` plan checked). The 16-channel map within 1e-3; the
decode on identical maps exactly (NMS, the stable top-k with ties, the
displacement gather and thresholds; scores within one ulp: XLA's CPU
logistic and torch's round differently) and the rasteriser exactly; the
aligned-corners upsampling within 1e-5; the mlsd engine, which the JAX
package's manager cannot run, against the JAX model."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

from gyre_tpu.manager.manager import EngineManager as JManager
from gyre_tpu.models import mlsd as jm
from gyre_tpu_torch.manager.manager import EngineManager as TManager
from gyre_tpu_torch.models import mlsd as tm
from gyre_tpu_torch.models import modelset as tms
from test_mlsd import oracle, state_numpy
from test_torch_modes import one_torch_thread  # noqa: F401

TOL = 1e-3
IMG = np.random.default_rng(31).random((2, 48, 56, 3)).astype(np.float32)
XIN = np.concatenate([IMG[:, :32, :32] * 2 - 1,
                      np.ones((2, 32, 32, 1), np.float32)], -1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _exact(ref, got):
    ref, got = np.asarray(ref), got.numpy()
    assert ref.shape == got.shape
    assert np.array_equal(ref, got), float(np.abs(ref - got).max())


@pytest.fixture(scope="module")
def state():
    return state_numpy(oracle(1))


@pytest.fixture(scope="module")
def jparams(state):
    return jax.tree.map(np.asarray, jm.load_mlsd(state))


def test_loaders_match_jax(state, jparams):
    model = tm.load_mlsd(state, device="cpu")
    ref = jax.jit(lambda x: jm.backbone_fpn(jparams, x))(XIN)
    with torch.no_grad():
        got = model.tp_map(_t(XIN))
    assert tuple(got.shape) == (2, 16, 16, 16)
    assert float(np.abs(np.asarray(ref) - got.numpy()).max()) <= TOL
    assert float(got.std()) > 1e-2
    bridged = tms.mlsd_from_jax(jparams, device="cpu")
    for (n, a), (_, b) in zip(model.named_parameters(),
                              bridged.named_parameters()):
        assert torch.equal(a, b), n


def test_loader_and_bridge_are_strict(state, jparams):
    with pytest.raises(KeyError, match="unconsumed"):
        tm.load_mlsd(dict(state, **{"block24.weight": np.zeros(1)}),
                     device="cpu")
    bad = jax.tree.map(lambda a: a, jparams)
    bad["blocks"][1] = dict(bad["blocks"][1], stride=1)
    with pytest.raises(ValueError, match="block 1"):
        tms.mlsd_from_jax(bad, device="cpu")
    del bad["blocks"][1]
    with pytest.raises(ValueError, match="blocks"):
        tms.mlsd_from_jax(bad, device="cpu")


def test_export_round_trip(state, jparams):
    model = tm.load_mlsd(state, device="cpu")
    again = jm.load_mlsd(tm.state_dict_mlsd(model))     # strict in JAX
    for a, b in zip(jax.tree.leaves(jparams), jax.tree.leaves(again)):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        assert np.abs(a - b).max() <= 1e-5 * max(1.0, np.abs(a).max())


def _tp(seed, g=16):
    """A 16-channel map: centre logits with a plateau (equal scores) and
    displacements long enough for about half the peaks to pass."""
    rng = np.random.default_rng(seed)
    tp = rng.standard_normal((2, g, g, 16)).astype(np.float32)
    tp[..., 7] *= 3.0
    tp[0, 4:7, 4:7, 7] = 2.5                       # a plateau of ties
    tp[..., 8:12] *= 2.0
    return tp


def test_decode_of_identical_maps_is_exact(monkeypatch):
    tp = _tp(2)
    monkeypatch.setattr(jm, "backbone_fpn", lambda p, x: jnp.asarray(tp))
    for k in (20, 200):
        ref = jax.jit(lambda x: jm.detect({}, x, top_k=k, input_size=32))(
            IMG)
        got = tm.detect_from_map(_t(tp), top_k=k)
        _exact(ref[0], got[0])
        _exact(ref[1], got[1])
        assert float(np.abs(np.asarray(ref[2]) - got[2].numpy()).max()) \
            <= 6e-8
    assert 0 < float(got[1].sum()) < got[1].numel()
    heat = jax.jit(jm._nms_heat)(tp[..., 7])
    assert float(np.abs(np.asarray(heat) -
                        tm.nms_heat(_t(tp[..., 7])).numpy()).max()) <= 6e-8


def test_rasteriser_is_exact():
    rng = np.random.default_rng(3)
    segs = rng.random((2, 60, 4)).astype(np.float32)
    valid = (rng.random((2, 60)) > 0.3).astype(np.float32)
    ref = jax.jit(lambda s, v: jm.render_segments(s, v, 40, 52))(segs, valid)
    got = tm.render_segments(_t(segs), _t(valid), 40, 52)
    _exact(ref, got)
    assert 0 < float(got.mean()) < 1


@pytest.mark.parametrize("shape", [(1, 4, 5, 3), (2, 7, 3, 2)])
def test_upsample_align_corners_matches_jax(shape):
    x = np.random.default_rng(4).random(shape).astype(np.float32)
    ref = jm._upsample_bilinear_ac(jnp.asarray(x), 2)
    got = tm.upsample_align_corners(_t(x), 2)
    assert float(np.abs(np.asarray(ref) - got.numpy()).max()) <= 1e-5


def test_mlsd_engine_serves_where_jax_fails(state, jparams, tmp_path):
    """config/engines/utility.yaml's mlsd-lines engine over the
    checkpoint. The JAX package's engine jits ``mlsd.apply`` with the
    params as an argument, so the blocks' ``stride`` entries are traced and
    every request fails (gyre_tpu/manager/manager.py:756,
    gyre_tpu/models/mlsd.py:102); the port's serves the JAX model's own
    line map (its apply with the params closed over; the image resized to
    512 inside): ready, "real"."""
    path = str(tmp_path / "mlsd.safetensors")
    save_file({k: np.ascontiguousarray(v) for k, v in state.items()}, path)
    spec = [{"id": "mlsd-lines", "task": "hinter", "kind": "mlsd",
             "model": path}]
    tmgr = TManager(spec, device="cpu", compute_dtype=torch.float32)
    jmgr = JManager(spec, compute_dtype=jnp.float32)
    try:
        with pytest.raises(jax.errors.TracerBoolConversionError):
            jmgr.task_pipeline("hinter")(IMG[:1])
        tmgr.load_engines()
        ref = np.asarray(jax.jit(lambda x: jm.apply(jparams, x))(IMG[:1]))
        got = tmgr.task_pipeline("hinter")(IMG[:1])
        assert tuple(got.shape) == (1, 48, 56, 3)
        assert (ref != got.numpy()).mean() <= 1e-3
        assert float(got.max()) == 1.0
        assert [(s["ready"], s["weights"]) for s in tmgr.status()] == \
            [(True, "real")]
    finally:
        tmgr.dispatcher.stop()
        jmgr.dispatcher.stop()
