"""The port's BAE normal estimator (gyre_tpu_torch/models/baenormal.py)
against the JAX package's, in f32 on the CPU on the same weights at
EFFNET_TEST width: the JAX params through the strict bridge, the
published NNET layout (tests/test_baenormal.py's synthetic state, its
BatchNorms given random statistics) through both loaders, the port's
export read back by the JAX loader, and the normal engine through both
managers. The normal maps within 1e-3 of the JAX package's; the layers
(TF "SAME" stride-2 convs at even and odd sizes, the aligned-corners
resize) within 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

from gyre_tpu.manager.manager import EngineManager as JManager
from gyre_tpu.models import baenormal as jb
from gyre_tpu.models import layers as jl
from gyre_tpu_torch.manager.manager import EngineManager as TManager
from gyre_tpu_torch.models import baenormal as tb
from gyre_tpu_torch.models import layers as tl
from gyre_tpu_torch.models import modelset as tms
from test_baenormal import _synthetic_state
from test_torch_modes import one_torch_thread  # noqa: F401

TOL = 1e-3          # a model's output
L_TOL = 1e-5        # a layer's
IMG = np.random.default_rng(21).random((2, 64, 48, 3)).astype(np.float32)
J_APPLY = jax.jit(jb.apply, static_argnums=2)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _err(ref, got):
    return float(np.abs(np.asarray(ref) - got.detach().numpy()).max())


def _run(model):
    with torch.no_grad():
        return model(torch.from_numpy(IMG))


def test_bridge_matches_jax():
    cfg = tb.EFFNET_TEST
    jparams = _np(jax.jit(jb.init, static_argnums=1)(jax.random.PRNGKey(0),
                                                      jb.EFFNET_TEST))
    got = _run(tms.baenormal_from_jax(jparams, cfg, device="cpu"))
    assert tuple(got.shape) == (2, 64, 48, 3)
    assert _err(J_APPLY(jparams, IMG, jb.EFFNET_TEST), got) <= TOL
    assert float(got.std()) > 1e-2
    bad = jax.tree.map(np.copy, jparams)
    del bad["decoder"]["out_res4"][2]["b"]
    with pytest.raises(ValueError, match="out_res4.2.bias"):
        tms.baenormal_from_jax(bad, cfg, device="cpu")


@pytest.fixture(scope="module")
def nnet_state():
    state = _synthetic_state()
    rng = np.random.default_rng(5)
    for bn in [k[:-len(".running_var")] for k in state
               if k.endswith(".running_var")]:
        c = state[f"{bn}.weight"].shape
        state[f"{bn}.weight"] = rng.uniform(0.5, 1.5, c).astype(np.float32)
        state[f"{bn}.bias"] = rng.uniform(-0.2, 0.2, c).astype(np.float32)
        state[f"{bn}.running_mean"] = rng.uniform(-0.2, 0.2, c).astype(
            np.float32)
        state[f"{bn}.running_var"] = rng.uniform(0.5, 1.5, c).astype(
            np.float32)
    return state


def test_published_layout_loads_as_in_jax(nnet_state):
    jparams, jcfg = jb.load_baenormal(nnet_state)
    model, cfg = tb.load_baenormal(nnet_state, device="cpu")
    assert cfg.stages == jcfg.stages and (cfg.stem, cfg.head) == \
        (jcfg.stem, jcfg.head)
    got = _run(model)
    assert _err(J_APPLY(_np(jparams), IMG, jcfg), got) <= TOL
    assert float(got.std()) > 1e-2


def test_export_round_trip(nnet_state):
    """The export of the loaded model, read by the JAX loader, is the tree
    the published state gave, and the port reads it back to the same
    output."""
    model, cfg = tb.load_baenormal(nnet_state, device="cpu")
    state = tb.state_dict_baenormal(model)
    assert set(state) == set(nnet_state)
    for k in state:
        assert state[k].shape == np.shape(nnet_state[k]), k
    ref = _np(jb.load_baenormal(nnet_state)[0])
    again = _np(jb.load_baenormal(state)[0])
    for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(again)):
        assert np.abs(a - b).max() <= 1e-5 * max(1.0, np.abs(a).max())
    back, _ = tb.load_baenormal(state, device="cpu")
    assert float((_run(back) - _run(model)).abs().max()) <= 1e-5


@pytest.mark.parametrize("size", [(16, 16), (15, 17)])
@pytest.mark.parametrize("k,groups", [(3, 1), (5, 4)])
def test_same_padding_at_stride_two(size, k, groups):
    """XLA's "SAME" at stride 2 (the odd pixel bottom and right) at even
    and odd sizes, dense and grouped."""
    rng = np.random.default_rng(k)
    x = rng.standard_normal((1, *size, 4)).astype(np.float32)
    w = rng.standard_normal((k, k, 4 // groups, 8)).astype(np.float32)
    ref = jl.conv2d({"w": jnp.asarray(w)}, jnp.asarray(x), stride=2,
                    feature_group_count=groups)
    conv = torch.nn.Conv2d(4, 8, k, groups=groups, bias=False)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(w.transpose(3, 2, 0, 1)))
        got = tl.nhwc(tl.conv_nchw(conv, tl.nchw(torch.from_numpy(x)),
                                   stride=2))
    assert tuple(got.shape) == ref.shape
    assert _err(ref, got) <= L_TOL


@pytest.mark.parametrize("size", [(8, 6), (1, 5), (7, 7)])
def test_resize_align_corners_matches_jax(size):
    x = np.random.default_rng(2).random((1, 3, 4, 5)).astype(np.float32)
    ref = jb._resize_align_true(jnp.asarray(x), size)
    got = tb.resize_align_corners(torch.from_numpy(x), size)
    assert _err(ref, got) <= L_TOL


def test_normal_engine_matches_jax(nnet_state, tmp_path):
    """config/engines/utility.yaml's bae-normal engine over the checkpoint
    through both managers; without weights, random at EFFNET_TEST."""
    path = str(tmp_path / "bae.safetensors")
    save_file(nnet_state, path)
    spec = [{"id": "bae-normal", "task": "normal", "kind": "bae",
             "model": path},
            {"id": "bae2", "task": "normal", "kind": "bae"}]
    tm = TManager(spec, device="cpu", compute_dtype=torch.float32)
    jm = JManager(spec[:1], compute_dtype=jnp.float32)
    try:
        tm.load_engines()
        ref = jm.task_pipeline("normal")(IMG[:1])
        got = tm.task_pipeline("normal")(IMG[:1])
        assert tuple(got.shape) == (1, 64, 48, 3)
        assert _err(ref, got) <= TOL
        rnd = tm.task_pipeline("normal", "bae2")
        assert rnd.models[0].cfg == tb.EFFNET_TEST
        assert [(s["ready"], s["weights"]) for s in tm.status()] == \
            [(True, "real"), (True, "random")]
    finally:
        tm.dispatcher.stop()
        jm.dispatcher.stop()


def test_bf16_normals_stay_near_f32():
    """The encoder and up-blocks in bf16, the heads and normalisation in
    f32: a map in [0, 1] whose typical pixel stays near the f32 map's
    (where the heads' 3-vector is short, its direction moves more: the
    card's bound is checked on the card, chip_smoke.py)."""
    f32 = tb.random_baenormal(tb.EFFNET_TEST, 1, torch.float32, "cpu")
    b16 = tb.random_baenormal(tb.EFFNET_TEST, 1, torch.bfloat16, "cpu")
    with torch.no_grad():
        a, b = f32(torch.from_numpy(IMG[:1])), b16(torch.from_numpy(IMG[:1]))
    assert b.dtype == torch.float32 and torch.isfinite(b).all()
    assert float(b.min()) >= 0 and float(b.max()) <= 1
    assert float((a - b).abs().median()) <= 5e-3
