"""The port's MiDaS DPT and ZoeDepth (gyre_tpu_torch/models/dpt.py,
zoedepth.py) against the JAX package's, in f32 on the CPU at DPT_TEST and
ZOE_TEST widths, on the same weights: checkpoints in the transformers
layout (a tiny transformers DPTForDepthEstimation) and the MiDaS one,
the JAX package's own params through the bridge, at the native size and
a non-native one. Tolerances: the models' outputs within 1e-3, the depth
hint maps within 1e-4. Also the strict loader, the full-size constants,
the bilinear resize rule and the depth task engines through the port's
manager against the JAX package's."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

from gyre_tpu.manager.manager import EngineManager as JManager
from gyre_tpu.models import dpt as jdpt
from gyre_tpu.models import zoedepth as jzoe
from gyre_tpu_torch.manager.manager import EngineManager as TManager
from gyre_tpu_torch.models import dpt as tdpt
from gyre_tpu_torch.models import modelset as tms
from gyre_tpu_torch.models import zoedepth as tzoe
from test_dpt import _to_midas_layout, state_numpy, tiny_torch_dpt
from test_torch_modes import one_torch_thread  # noqa: F401


# the JAX side compiled once a shape (eager, each op compiles on its own)
J_FEATURES = jax.jit(jdpt.apply_features, static_argnums=2)
J_DEPTH = jax.jit(jdpt.estimate_depth, static_argnums=(2, 3))
J_METRIC = jax.jit(jzoe.estimate_metric_depth, static_argnums=(3, 4, 5))
J_HINT = jax.jit(jzoe.estimate_depth_hint, static_argnums=(3, 4, 5))


@pytest.fixture(scope="module")
def hf_state():
    return state_numpy(tiny_torch_dpt())


def _x(shape, seed):
    return np.random.RandomState(seed).rand(*shape).astype(np.float32)


def _err(ref, got):
    return float(np.abs(np.asarray(ref) - got.detach().numpy()).max())


@pytest.mark.parametrize("layout", ["hf", "midas"])
@pytest.mark.parametrize("size", [(64, 64), (96, 80)])
def test_dpt_from_checkpoint_matches_jax(hf_state, layout, size):
    state = hf_state if layout == "hf" else _to_midas_layout(hf_state)
    jp, jcfg = jdpt.load_dpt(state)
    model, cfg = tdpt.load_dpt(state, device="cpu")
    assert dataclasses.astuple(cfg) == dataclasses.astuple(jcfg)
    x = _x((2, *size, 3), 4)
    ref = J_FEATURES(jp, jnp.asarray(x), jcfg)
    with torch.no_grad():
        got = model.apply_features(torch.from_numpy(x))
    assert set(got) == set(ref)
    for k in ref:
        assert tuple(got[k].shape) == ref[k].shape, k
        assert _err(ref[k], got[k]) <= 1e-3, k


@pytest.mark.parametrize("size", [64, 96])
def test_depth_hint_matches_jax(hf_state, size):
    jp, jcfg = jdpt.load_dpt(hf_state)
    model, _ = tdpt.load_dpt(hf_state, device="cpu")
    img = _x((2, 100, 60, 3), 5)
    ref = J_DEPTH(jp, jnp.asarray(img), jcfg, size)
    with torch.no_grad():
        got = tdpt.estimate_depth(model, torch.from_numpy(img), size)
    assert tuple(got.shape) == (2, 100, 60, 1)
    assert _err(ref, got) <= 1e-4
    assert float(got.std()) > 0.05


def test_dpt_bridge_from_jax_params():
    """The JAX package's own init through the bridge, every leaf."""
    cfg = jdpt.DPT_TEST
    jp = jax.jit(jdpt.init, static_argnums=1)(jax.random.PRNGKey(0), cfg)
    model = tms.dpt_from_jax(jax.tree.map(np.asarray, jp), tdpt.DPT_TEST,
                             device="cpu")
    x = _x((1, 64, 64, 3), 6)
    with torch.no_grad():
        got = model.apply_features(torch.from_numpy(x))
    ref = J_FEATURES(jp, jnp.asarray(x), cfg)
    for k in ref:
        assert _err(ref[k], got[k]) <= 1e-3, k
    bad = jax.tree.map(np.asarray, jp)
    bad["extra"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="extra"):
        tms.dpt_from_jax(bad, tdpt.DPT_TEST, device="cpu")


def test_strict_loader(hf_state):
    left = dict(hf_state, **{"neck.mystery.weight": np.zeros((3, 3))})
    with pytest.raises(KeyError, match="unconsumed"):
        tdpt.load_dpt(left, device="cpu")
    missing = {k: v for k, v in hf_state.items()
               if k != "neck.convs.2.weight"}
    with pytest.raises(ValueError, match="neck.convs.2.weight"):
        tdpt.load_dpt(missing, device="cpu")
    wrong = dict(hf_state)
    wrong["head.head.4.bias"] = np.zeros(2, np.float32)
    with pytest.raises(ValueError, match="shape"):
        tdpt.load_dpt(wrong, device="cpu")
    # the ViT's final norm never reaches the head: tolerated, as in JAX
    assert "dpt.layernorm.weight" in hf_state
    # export and load back: the same bits
    model, _ = tdpt.load_dpt(hf_state, device="cpu")
    again, _ = tdpt.load_dpt({k: v.numpy() for k, v in
                              tdpt.state_dict_hf(model).items()},
                             device="cpu")
    for (n, a), (_, b) in zip(model.named_parameters(),
                              again.named_parameters()):
        assert torch.equal(a, b), n


def test_full_size_config():
    """DPT-Large: ViT-L/16 at 384², taps 5/11/17/23; ZoeD_N's head."""
    for cfg in (tdpt.DPT_LARGE, jdpt.DPT_LARGE):
        assert (cfg.hidden, cfg.layers, cfg.heads, cfg.mlp, cfg.patch,
                cfg.hooks, cfg.neck_ch, cfg.fusion, cfg.grid) == (
            1024, 24, 16, 4096, 16, (5, 11, 17, 23), (256, 512, 1024, 1024),
            256, 24)
    assert dataclasses.astuple(tzoe.ZOE_N) == dataclasses.astuple(jzoe.ZOE_N)
    assert dataclasses.astuple(tzoe.ZOE_TEST) == \
        dataclasses.astuple(jzoe.ZOE_TEST)
    n = sum(p.numel() for p in tdpt.DPT(tdpt.DPT_LARGE).parameters())
    assert 340e6 < n < 346e6


@pytest.mark.parametrize("align", [False, True])
@pytest.mark.parametrize("src,dst", [((4, 4), (7, 5)), ((24, 24), (12, 30)),
                                     ((9, 5), (1, 1)), ((5, 5), (5, 9))])
def test_resize_bilinear_matches_jax(align, src, dst):
    x = _x((2, *src, 3), 7)
    ref = jdpt.resize_bilinear(jnp.asarray(x), dst, align_corners=align)
    got = tdpt.resize_bilinear(torch.from_numpy(x), dst, align_corners=align)
    assert _err(ref, got) <= 1e-5       # positions within an f32 ulp


def test_random_dpt_varies():
    model = tdpt.random_dpt(tdpt.DPT_TEST, seed=0, device="cpu")
    with torch.no_grad():
        d = tdpt.estimate_depth(model, torch.from_numpy(_x((1, 64, 64, 3),
                                                            8)), 64)
    assert torch.isfinite(d).all() and float(d.std()) > 0.01


# -------------------------------------------------------------- ZoeDepth


def _zoe_state(hf_state, seed=2):
    """A ZoeDepth checkpoint: the tiny trunk under core.core. and a head
    of the published layout (the tests' torch reconstruction) sized to
    the trunk's fusion width. The seed-bin and log-binomial weights are
    scaled by 16: at their random init the bins' distribution is near
    uniform and the metric depth flat to 3e-4, where the hint's min-max
    normalisation magnifies f32 rounding past any bound."""
    import torch_oracles as oracle

    torch.manual_seed(seed)
    head = oracle.ZoeHead(btlnck=24, out_feats=24).eval()
    state = {f"core.core.{k}": v for k, v in hf_state.items()}
    for k, v in head.state_dict().items():
        sharp = k.startswith(("conditional_log_binomial", "seed_bin")) and \
            k.endswith("weight")
        state[k] = v.numpy() * (16.0 if sharp else 1.0)
    return state


def test_zoe_head_matches_jax(hf_state):
    state = _zoe_state(hf_state)
    jp, jcfg = jzoe.load_zoe_head(state)
    head, cfg = tzoe.load_zoe_head(state, device="cpu")
    assert dataclasses.astuple(cfg) == dataclasses.astuple(jcfg)
    rng = np.random.default_rng(5)
    feats = {"l4_rn": (1, 4, 24), "r4": (1, 8, 24), "r3": (1, 16, 24),
             "r2": (1, 32, 24), "r1": (1, 64, 24), "out_conv": (1, 64, 32),
             "rel_depth": (1, 64, 1)}
    feats = {k: np.abs(rng.standard_normal((b, s, s, c))).astype(np.float32)
             for k, (b, s, c) in feats.items()}
    ref = jax.jit(jzoe.apply_head, static_argnums=2)(
        jp, {k: jnp.asarray(v) for k, v in feats.items()}, jcfg)
    with torch.no_grad():
        got = tzoe.apply_head(head, {k: torch.from_numpy(v)
                                     for k, v in feats.items()})
    assert _err(ref, got) <= 1e-3 * max(1.0, float(np.abs(ref).max()))


@pytest.mark.parametrize("size", [64, 96])
def test_zoe_depth_matches_jax(hf_state, size):
    state = _zoe_state(hf_state)
    core = {k[len("core.core."):]: v for k, v in state.items()
            if k.startswith("core.core.")}
    jt, tcfg = jdpt.load_dpt(core)
    jh, zcfg = jzoe.load_zoe_head(state)
    trunk, _ = tdpt.load_dpt(core, device="cpu")
    head, _ = tzoe.load_zoe_head(state, device="cpu")
    img = _x((1, 80, 72, 3), 9)
    ref_m = J_METRIC(jt, jh, jnp.asarray(img), tcfg, zcfg, size)
    ref_h = J_HINT(jt, jh, jnp.asarray(img), tcfg, zcfg, size)
    with torch.no_grad():
        got_m = tzoe.estimate_metric_depth(trunk, head,
                                           torch.from_numpy(img), size)
        got_h = tzoe.estimate_depth_hint(trunk, head, torch.from_numpy(img),
                                         size)
    assert _err(ref_m, got_m) <= 1e-3 * max(1.0, float(np.abs(ref_m).max()))
    assert _err(ref_h, got_h) <= 1e-4
    assert float(got_h.std()) > 0.05


def test_zoe_bridge_from_jax_params():
    zcfg = dataclasses.replace(jzoe.ZOE_TEST, btlnck_features=24,
                               num_out_features=24)
    jp = jax.jit(jzoe.init, static_argnums=1)(jax.random.PRNGKey(3), zcfg)
    head = tms.zoe_head_from_jax(jax.tree.map(np.asarray, jp),
                                 dataclasses.replace(
                                     tzoe.ZOE_TEST, btlnck_features=24,
                                     num_out_features=24), device="cpu")
    rng = np.random.default_rng(1)
    feats = {k: rng.random((1, s, s, c)).astype(np.float32)
             for k, s, c in (("l4_rn", 2, 24), ("r4", 4, 24),
                             ("r3", 8, 24), ("r2", 16, 24), ("r1", 32, 24),
                             ("out_conv", 64, 32), ("rel_depth", 64, 1))}
    ref = jax.jit(jzoe.apply_head, static_argnums=2)(
        jp, {k: jnp.asarray(v) for k, v in feats.items()}, zcfg)
    with torch.no_grad():
        got = tzoe.apply_head(head, {k: torch.from_numpy(v)
                                     for k, v in feats.items()})
    assert _err(ref, got) <= 1e-3 * max(1.0, float(np.abs(ref).max()))


# --------------------------------------------------------- task engines


@pytest.mark.parametrize("kind", ["midas", "zoedepth"])
def test_depth_task_engine_matches_jax(hf_state, tmp_path, kind):
    """A depth engine through each package's manager, from one checkpoint
    on disk: the same 3-channel hint, weights "real"."""
    state = hf_state if kind == "midas" else _zoe_state(hf_state)
    path = str(tmp_path / "depth.safetensors")
    save_file({k: np.ascontiguousarray(v) for k, v in state.items()}, path)
    entries = [{"id": "depth", "task": "depth", "kind": kind,
                "model": path}]
    tm = TManager(entries, device="cpu", compute_dtype=torch.float32)
    jm = JManager(entries, compute_dtype=jnp.float32)
    try:
        img = _x((1, 72, 64, 3), 10)
        ref = jm.task_pipeline("depth", None)(img)
        got = tm.task_pipeline("depth", None)(img)
        assert tuple(got.shape) == (1, 72, 64, 3)
        assert _err(ref, got) <= 1e-4
        assert {s["id"]: s["weights"] for s in tm.status()} == \
            {"depth": "real"}
        assert tm.task_pipeline("depth", "depth") is \
            tm.task_pipeline("depth", None)            # built once
        assert tm.task_pipeline("edge", None) is None
    finally:
        tm.dispatcher.stop()
        jm.dispatcher.stop()


@pytest.mark.parametrize("kind", ["depth", "zoe"])
def test_weightless_depth_engine_random_inits(kind):
    """No resolvable weights: random at DPT_TEST (the JAX package's rule),
    reported "random"; a hint map of the image's size."""
    tm = TManager([{"id": "d", "task": "depth", "kind": kind,
                    "model": "@nowhere"}], device="cpu",
                  compute_dtype=torch.float32)
    try:
        out = tm.task_pipeline("depth")(_x((2, 40, 56, 3), 11))
        assert tuple(out.shape) == (2, 40, 56, 3)
        assert torch.isfinite(out).all() and float(out.std()) > 0.01
        assert tm.status()[0]["weights"] == "random"
    finally:
        tm.dispatcher.stop()


def test_unloadable_depth_checkpoint_raises(hf_state, tmp_path):
    """A checkpoint that resolves and does not load fails the engine (no
    quiet fallback)."""
    path = str(tmp_path / "bad.safetensors")
    save_file({k: v for k, v in hf_state.items()
               if not k.startswith("head.")}, path)
    tm = TManager([{"id": "d", "task": "depth", "model": path}],
                  device="cpu", compute_dtype=torch.float32)
    try:
        with pytest.raises(ValueError, match="head.head"):
            tm.task_pipeline("depth")
    finally:
        tm.dispatcher.stop()
