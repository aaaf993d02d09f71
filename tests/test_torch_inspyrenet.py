"""The port's InSPyReNet (gyre_tpu_torch/models/inspyrenet.py) against the
JAX package's, in f32 on the CPU on the same weights: the Gaussian of the
Laplacian pyramid against cv2.getGaussianKernel (the port computes it in
numpy); the upsampling resizes; the model at SWIN_TEST with decoder depth
8 through the strict bridge (every gamma, threshold and bias moved off its
init so that each branch shows), on a 96x64 image whose last two stages
pad inside their blocks, logits within 1e-3 of max |JAX|; the published
export read back by the JAX loader and by the port's strict loader; then
the background-removal engines of both managers over one checkpoint on
disk at ``max_res: 64``: a 160x144 image (scaled, guided filter), a
100x90 one (scaled, no filter) and a 60x44 one (padded, unscaled), their
RGBA within 2e-3, each engine's path checked as taken."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

from gyre_tpu.manager.manager import EngineManager as JManager
from gyre_tpu.models import inspyrenet as ji
from gyre_tpu_torch.manager.manager import EngineManager as TManager
from gyre_tpu_torch.models import inspyrenet as ti
from gyre_tpu_torch.models import modelset as tms
from test_torch_modes import one_torch_thread  # noqa: F401

TOL = 1e-3
IMG_TOL = 2e-3

RNG = np.random.default_rng(0)
IMG = RNG.random((2, 96, 64, 3)).astype(np.float32)
CFG = ti.SwinBConfig(embed_dim=16, depths=(1, 1, 2, 1), heads=(2, 2, 2, 2),
                     window=4)


def _err(ref, got):
    ref = np.asarray(ref)
    return float(np.abs(ref - got.detach().numpy()).max()) / \
        float(np.abs(ref).max())


def _moved(tree, rng, path=()):
    """The JAX init with its zero gammas, 0.5 thresholds and zero biases
    moved, so that every attention, threshold and bias reaches the map."""
    if isinstance(tree, dict):
        return {k: _moved(v, rng, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_moved(v, rng, path + (i,)) for i, v in enumerate(tree)]
    tree = np.asarray(tree)
    if path[-1] == "gamma":
        return np.full_like(tree, 0.7)
    if path[-1] in ("threshold", "lthreshold"):
        return np.full_like(tree, 0.4)
    if path[-1] == "b":
        return (rng.standard_normal(tree.shape) * 0.05).astype(np.float32)
    return tree


@pytest.fixture(scope="module")
def jax_case():
    params = _moved(ji.init(jax.random.PRNGKey(1), ji.SWIN_TEST, depth=8),
                    np.random.default_rng(1))
    logits = np.asarray(jax.jit(lambda p, x: ji.apply(
        p, x, ji.SWIN_TEST, return_logits=True))(params, IMG))
    return params, logits


def test_gaussian_kernel_is_cv2s():
    import cv2

    k = cv2.getGaussianKernel(7, 1.0)
    assert np.array_equal(ti.gauss_kernel(7, 1.0),
                          np.outer(k, k).astype(np.float32))
    assert np.array_equal(ti.gauss_kernel(), ji._gauss_kernel())


def test_resizes_match_jax_and_only_upsample():
    x = RNG.standard_normal((1, 3, 5, 7)).astype(np.float32)
    for ac in (False, True):
        got = ti._resize(torch.from_numpy(x), (12, 9), align_corners=ac)
        ref = np.asarray(ji._resize_nchw(jnp.asarray(x), (12, 9),
                                         align_corners=ac))
        assert np.abs(got.numpy() - ref).max() <= 1e-6
    with pytest.raises(AssertionError):
        ti._resize(torch.from_numpy(x), (4, 9))


def test_pyramid_expand_matches_jax():
    x = RNG.standard_normal((2, 1, 6, 5)).astype(np.float32)
    kernel = ti.InSPyReNet._kernel()
    got = ti._pyr_expand(torch.from_numpy(x), kernel)
    ref = np.asarray(ji._pyr_expand(jnp.asarray(x), ji._gauss_kernel()))
    assert got.shape == ref.shape == (2, 1, 12, 10)
    assert np.abs(got.numpy() - ref).max() <= 1e-5


def test_bridge_matches_jax(jax_case):
    params, ref = jax_case
    model = tms.inspyrenet_from_jax(params, CFG, device="cpu")
    with torch.no_grad():
        feats = model.backbone(torch.from_numpy(IMG))
        got = model(torch.from_numpy(IMG), return_logits=True)
        sal = model(torch.from_numpy(IMG))
    # the last stages' maps are not window multiples: padded in-block
    assert [tuple(f.shape[1:3]) for f in feats] == [
        (24, 16), (24, 16), (12, 8), (6, 4), (3, 2)]
    assert tuple(got.shape) == ref.shape == (2, 96, 64, 1)
    assert _err(ref, got) <= TOL
    assert float(got.std()) > 1e-3
    want = 1.0 / (1.0 + np.exp(-ref.astype(np.float64)))
    lo = want.min(axis=(1, 2, 3), keepdims=True)
    hi = want.max(axis=(1, 2, 3), keepdims=True)
    want = (want - lo) / (hi - lo + 1e-8)
    assert np.abs(sal.numpy() - want).max() <= IMG_TOL


def test_export_reads_back_in_both_loaders(jax_case):
    params, ref = jax_case
    model = tms.inspyrenet_from_jax(params, CFG, device="cpu")
    state = ti.state_dict_inspyrenet(model)
    assert "context3.branch2.Hattn.query_conv.conv.weight" in state
    assert "attention1.lthreshold" in state
    assert "decoder.conv5.conv.bias" in state and \
        "decoder.conv4.bn.running_var" in state
    jp, jcfg = ji.load_inspyrenet(state)
    assert jcfg == ji.SWIN_TEST
    assert jax.tree.structure(jp) == jax.tree.structure(params)
    for a, b in zip(jax.tree.leaves(jp), jax.tree.leaves(params)):
        assert np.abs(np.asarray(a) - b).max() <= 1e-5
    again, cfg = ti.load_inspyrenet(
        {k: torch.from_numpy(v) for k, v in state.items()}, device="cpu")
    assert cfg == CFG and again.depth == 8
    with torch.no_grad():
        assert _err(ref, again(torch.from_numpy(IMG), return_logits=True)) \
            <= TOL


def test_loader_and_bridge_are_strict(jax_case):
    params, _ = jax_case
    state = ti.state_dict_inspyrenet(ti.random_inspyrenet(CFG, 8, 3,
                                                          device="cpu"))
    buffers = {"decoder.conv1.bn.num_batches_tracked": np.zeros((), np.int64),
               "backbone.layers.0.blocks.0.attn.relative_position_index":
                   np.zeros((16, 16), np.int64)}
    ti.load_inspyrenet({**state, **buffers}, device="cpu")
    with pytest.raises(KeyError, match="mystery"):
        ti.load_inspyrenet(dict(state, mystery=np.zeros(1, np.float32)),
                           device="cpu")
    key = "attention2.conv_value.1.conv.weight"
    with pytest.raises(KeyError, match=key):
        ti.load_inspyrenet({k: v for k, v in state.items() if k != key},
                           device="cpu")
    wrong = dict(state, **{"attention0.threshold": np.zeros(2, np.float32)})
    with pytest.raises(ValueError, match="shape"):
        ti.load_inspyrenet(wrong, device="cpu")
    with pytest.raises(ValueError, match="mystery"):
        tms.inspyrenet_from_jax(dict(params, mystery={"w": np.zeros(1)}),
                                CFG, device="cpu")
    short = jax.tree.map(np.copy, params)
    del short["attention1"]["lthreshold"]
    with pytest.raises(ValueError, match="lthreshold"):
        tms.inspyrenet_from_jax(short, CFG, device="cpu")


def test_published_width():
    """InSPyReNet-SwinB (embed 128, depths 2/2/18/2, window 12, decoder
    depth 64): as many parameters as the JAX init."""
    assert ti.SWIN_B == ti.SwinBConfig(**{
        k: getattr(ji.SWIN_B, k) for k in ("embed_dim", "depths", "heads",
                                           "window", "mlp_ratio")})
    shapes = jax.eval_shape(lambda: ji.init(jax.random.PRNGKey(0)))
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    with torch.device("meta"):
        model = ti.InSPyReNet(ti.SWIN_B, 64)
    assert sum(p.numel() for p in model.parameters()) == n_jax


@pytest.fixture(scope="module")
def bg_managers(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("bg") / "inspyrenet.safetensors")
    save_file(ti.state_dict_inspyrenet(ti.random_inspyrenet(
        CFG, 8, 4, device="cpu")), path)
    spec = [{"id": "gen", "model": "preset/test", "default": True},
            {"id": "bg", "task": "background_removal", "model": path,
             "max_res": 64}]
    tm = TManager(spec, device="cpu", compute_dtype=torch.float32)
    jm = JManager(spec, compute_dtype=jnp.float32)
    yield tm, jm
    tm.dispatcher.stop()
    jm.dispatcher.stop()


@pytest.mark.parametrize("size,scaled,filtered", [
    ((160, 144), True, True), ((100, 90), True, False),
    ((60, 44), False, False)])
def test_background_removal_engines_match_jax(bg_managers, monkeypatch,
                                               size, scaled, filtered):
    """The JAX manager's geometry at ``max_res: 64``: past 64 the image is
    resized for the model and its map back (160 and 100 on the long side),
    past twice 64 the map is guided-filtered (160 only), else padded to a
    multiple of 32 (60x44). The same RGBA within 2e-3, the port's on its
    device, and each path the one taken."""
    from gyre_tpu_torch.ops import images as timages

    tm, jm = bg_managers
    calls = []
    filt = timages.guided_filter
    monkeypatch.setattr(timages, "guided_filter",
                        lambda *a, **k: calls.append(1) or filt(*a, **k))
    img = np.full((1,) + size + (3,), 0.1, np.float32)
    img[:, 40:120, 30:110] = 0.9
    img += np.random.default_rng(5).random(img.shape).astype(np.float32) \
        * 0.05
    run = tm.task_pipeline("background_removal", "bg")
    assert run.size == 64
    assert (max(size) > run.size) == scaled
    got = run(img)
    assert len(calls) == int(filtered)
    ref = np.asarray(jm.task_pipeline("background_removal", "bg")(img))
    assert isinstance(got, torch.Tensor)
    assert tuple(got.shape) == ref.shape == (1,) + size + (4,)
    assert np.abs(ref - got.numpy()).max() <= IMG_TOL
    assert float(got[..., 3].std()) > 1e-3
    assert {s["id"]: s["weights"] for s in tm.status()}["bg"] == "real"


def test_background_removal_weights(tmp_path):
    """No checkpoint: InSPyReNet at SWIN_TEST, decoder depth 64 (the JAX
    package's random size), weights "random", ready; a checkpoint that
    resolves and does not load fails the engine."""
    bad = str(tmp_path / "bad.safetensors")
    state = ti.state_dict_inspyrenet(ti.random_inspyrenet(CFG, 8, 4,
                                                          device="cpu"))
    state.pop("decoder.conv3.conv.weight")
    save_file(state, bad)
    tm = TManager([{"id": "gen", "model": "preset/test", "default": True},
                   {"id": "bg", "task": "background_removal"},
                   {"id": "bad", "task": "background_removal",
                    "model": bad}],
                  device="cpu", compute_dtype=torch.float32)
    try:
        run = tm.task_pipeline("background_removal", "bg")
        (model,) = run.models
        assert model.cfg == ti.SWIN_TEST and model.depth == 64
        with pytest.raises(KeyError, match="decoder.conv3"):
            tm.task_pipeline("background_removal", "bad")
        tm.load_engines()
        status = {s["id"]: s for s in tm.status()}
        assert status["bg"]["weights"] == "random" and status["bg"]["ready"]
    finally:
        tm.dispatcher.stop()
