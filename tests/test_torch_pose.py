"""The port's pose engine (gyre_tpu_torch/models/pose.py) against the JAX
package's, in f32 on the CPU on the same weights: the published OpenPose
body checkpoint (tests/torch_oracles.py's BodyPose layout) through both
loaders and the port's export back through the JAX loader, the small
PoseNet through the bridge (models within 1e-3); the decoders on
identical maps, to exact equality: argmax joints, NMS peaks with ties
(lowest index first, as lax.top_k), mutual-best limb matching, the
union-find grouping, the bilinear crop and the openpose, keypose and limb
renders; the bottom-up and top-down renders of whole images (small crops
on the CPU), and the pose engine through both managers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

from gyre_tpu.manager.manager import EngineManager as JManager
from gyre_tpu.models import pose as jp
from gyre_tpu_torch.manager.manager import EngineManager as TManager
from gyre_tpu_torch.models import modelset as tms
from gyre_tpu_torch.models import pose as tp
from test_torch_modes import one_torch_thread  # noqa: F401
from torch_oracles import BodyPose as OracleBody

TOL = 1e-3          # a model's maps against the JAX package's
IMG = np.random.default_rng(7).random((2, 64, 56, 3)).astype(np.float32)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def _exact(ref, got, ulp=False):
    """Equal bits; with ``ulp``, within one f32 ulp of [0, 1] (a sigmoid:
    XLA's CPU logistic and torch's round differently)."""
    ref = np.asarray(ref)
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    assert ref.shape == got.shape
    if ulp:
        assert float(np.abs(ref - got).max()) <= 6e-8
    else:
        assert np.array_equal(ref, got), float(np.abs(ref - got).max())


@pytest.fixture(scope="module")
def body_state():
    torch.manual_seed(0)
    net = OracleBody()
    with torch.no_grad():       # maps that peak somewhere
        for s in range(1, 7):
            for b in (1, 2):
                getattr(net, f"model{s}_{b}")[-1].bias.uniform_(-0.5, 0.5)
    return {k: v.numpy() for k, v in net.state_dict().items()}


@pytest.fixture(scope="module")
def body(body_state):
    return _np(jp.load_body(body_state)), tp.load_body(body_state,
                                                       device="cpu")


J_BODY = jax.jit(jp.body_apply)
J_NET = jax.jit(jp.heatmaps_and_pafs)


def test_body_loaders_match_jax(body):
    jparams, model = body
    ref = J_BODY(jparams, IMG)
    with torch.no_grad():
        got = model(_t(IMG))
    for r, g, c in zip(ref, got, (18, 34)):
        assert tuple(g.shape) == (2, 8, 7, c)
        assert float(np.abs(np.asarray(r) - g.numpy()).max()) <= TOL
        assert float(g.std()) > 1e-3


def test_body_export_and_bridge(body, body_state):
    """The export equals the published state it was loaded from (no
    BatchNorms to fold), the JAX loader reads it, and the bridge from the
    JAX tree gives the same module."""
    jparams, model = body
    state = tp.state_dict_body(model)
    assert set(state) == set(body_state)
    for k, v in state.items():
        assert np.array_equal(v, body_state[k]), k
    again = _np(jp.load_body(state))
    for a, b in zip(jax.tree.leaves(jparams), jax.tree.leaves(again)):
        assert np.array_equal(a, b)
    bridged = tms.pose_body_from_jax(jparams, device="cpu")
    for (n, a), (_, b) in zip(model.named_parameters(),
                              bridged.named_parameters()):
        assert torch.equal(a, b), n
    bad = dict(jparams, stem=jparams["stem"][:-1])
    with pytest.raises(ValueError, match="stem.11"):
        tms.pose_body_from_jax(bad, device="cpu")


@pytest.fixture(scope="module")
def posenet():
    params = _np(jax.jit(jp.init)(jax.random.PRNGKey(3)))
    return params, tms.posenet_from_jax(params, device="cpu")


def test_posenet_bridge_matches_jax(posenet):
    params, model = posenet
    ref = J_NET(params, IMG)
    with torch.no_grad():
        got = model(_t(IMG))
    for r, g in zip(ref, got):
        assert float(np.abs(np.asarray(r) - g.numpy()).max()) <= TOL


# ------------------------------------------------------------- decoders


def _maps(seed, h=12, w=10, k=18, ties=True):
    """Heat maps with two blobs a joint, a plateau of equal values and a
    flat channel (ties everywhere), and PAFs along each limb of person 0."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    heat = rng.random((1, h, w, k)).astype(np.float32) * 0.05
    centres = rng.random((2, k, 2)) * [w - 1, h - 1]
    for p in range(2):
        for j in range(k):
            cx, cy = centres[p, j]
            heat[0, ..., j] += np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) /
                                      2.0).astype(np.float32) * (0.9 - 0.2 * p)
    if ties:
        heat[0, 2:5, 2:5, 3] = 0.5              # a plateau
        heat[0, ..., 4] = 0.25                  # all equal
    pafs = rng.standard_normal((1, h, w, 2 * len(tp.LIMBS))).astype(
        np.float32) * 0.05
    for li, (a, b) in enumerate(tp.LIMBS):
        d = centres[0, b] - centres[0, a]
        d = d / (np.linalg.norm(d) + 1e-8)
        pafs[0, ..., 2 * li] += d[0]
        pafs[0, ..., 2 * li + 1] += d[1]
    return heat, pafs


@pytest.mark.parametrize("sig", [True, False])
def test_peaks_and_argmax_decode_exactly(sig):
    heat, _ = _maps(1)
    ref = jax.jit(lambda m: jp.top_peaks(m, 8, apply_sigmoid=sig))(heat)
    got = tp.top_peaks(_t(heat), 8, apply_sigmoid=sig)
    _exact(ref[0], got[0])
    _exact(ref[1], got[1], ulp=sig)
    # the flat channel: its first 8 pixels in index order
    assert got[0][0, 4, :, 0].tolist()[:2] == [0.0, float(np.float32(1 / 9))]
    ref = jax.jit(lambda m: jp.decode_keypoints(m, sig))(heat)
    got = tp.decode_keypoints(_t(heat), sig)
    _exact(ref[0], got[0])
    _exact(ref[1], got[1], ulp=sig)


def test_limb_matching_decodes_exactly():
    heat, pafs = _maps(2)
    xy, conf = tp.top_peaks(_t(heat), 8, apply_sigmoid=False)
    jxy, jconf = jax.jit(lambda m: jp.top_peaks(m, 8, apply_sigmoid=False))(
        heat)
    ref = jax.jit(lambda x, c, p: jp._match_limbs_full(x, c, p, 0.1, 0.05))(
        jxy[0], jconf[0], pafs[0])
    got = tp._match_limbs_full(xy[0], conf[0], _t(pafs[0]), 0.1, 0.05)
    for r, g in zip(ref, got):
        _exact(r, g)
    assert float(got[2].sum()) >= 5                # limbs were accepted
    pa, pb, ok = tp.match_limbs(xy[0], conf[0], _t(pafs[0]), 0.1)
    best_j, ok_i = tp.match_limb_indices(xy[0], conf[0], _t(pafs[0]), 0.1)
    for r, g in zip(ref, (pa, pb, ok, best_j)):
        _exact(r, g)
    boxes = jp.group_people(jxy[0], jconf[0], ref[3], ref[2])
    got_b = tp.group_people(xy[0].numpy(), conf[0].numpy(), best_j.numpy(),
                            ok_i.numpy())
    _exact(boxes[0], got_b[0])
    _exact(boxes[1], got_b[1])
    assert got_b[1].sum() >= 1


def test_group_people_two_clusters():
    """Two chains of accepted limbs -> two boxes, the larger first; a
    two-joint cluster is dropped; the rest padded invalid."""
    xy = np.zeros((18, 3, 2), np.float32)
    xy[:, 0] = np.linspace(0.1, 0.3, 18)[:, None]
    xy[:, 1] = np.linspace(0.6, 0.9, 18)[:, None]
    conf = np.ones((18, 3), np.float32)
    best_j = np.zeros((17, 3), np.int32)
    ok = np.zeros((17, 3), np.float32)
    for li in range(5):                             # person 0: 5 limbs
        ok[li, 0] = 1
    for li in range(6, 9):                          # person 1: 3 limbs
        best_j[li, 1], ok[li, 1] = 1, 1
    best_j[12, 2], ok[12, 2] = 2, 1                 # a lone pair
    ref = jp.group_people(xy, conf, best_j, ok, max_people=4)
    got = tp.group_people(xy, conf, best_j, ok, max_people=4)
    _exact(ref[0], got[0])
    _exact(ref[1], got[1])
    assert got[1].tolist() == [True, True, False, False]


@pytest.mark.parametrize("style", ["openpose", "keypose"])
def test_renders_exactly(style):
    rng = np.random.default_rng(4)
    kps = rng.random((2, 18, 2)).astype(np.float32)
    conf = rng.random((2, 18)).astype(np.float32)
    ref = jax.jit(lambda k, c: jp.render_pose(k, c, 48, 40, style=style))(
        kps, conf)
    got = tp.render_pose(_t(kps), _t(conf), 48, 40, style=style)
    _exact(ref, got)
    assert float(got.sum()) > 0
    pa = rng.random((17, 8, 2)).astype(np.float32)
    pb = rng.random((17, 8, 2)).astype(np.float32)
    ok = (rng.random((17, 8)) > 0.5).astype(np.float32)
    ref = jax.jit(lambda a, b, o: jp.render_limbs(a, b, o, 48, 40))(
        pa, pb, ok)
    _exact(ref, tp.render_limbs(_t(pa), _t(pb), _t(ok), 48, 40))


def test_bilinear_crop_matches_jax():
    img = IMG[0]
    boxes = np.asarray([[0.1, 0.2, 0.7, 0.9], [0.0, 0.0, 1.0, 1.0],
                        [0.5, 0.3, 0.55, 0.4]], np.float32)
    ref = jax.jit(jax.vmap(lambda b: jp._bilinear_crop(jnp.asarray(img), b,
                                                        24)))(boxes)
    got = tp.bilinear_crop(_t(img), _t(boxes), 24)
    # continuous: the layer tolerance's tenth (XLA fuses the lerps)
    assert float(np.abs(np.asarray(ref) - got.numpy()).max()) <= 1e-5


# ------------------------------------------------------ whole-image paths


@pytest.mark.parametrize("style", ["openpose", "keypose"])
def test_bottom_up_renders_match_jax(body, posenet, style):
    for (jparams, model), fn in ((body, jp.estimate_and_render_body),
                                 (posenet, jp.estimate_and_render_multi)):
        ref = jax.jit(fn, static_argnames=("style",))(jparams, IMG,
                                                      style=style)
        with torch.no_grad():
            got = tp.estimate_and_render(model, _t(IMG), style=style)
        assert tuple(got.shape) == (2, 64, 56, 3)
        _exact(ref, got)


def test_topdown_matches_jax(posenet):
    """The two-pass path at a 32-pixel crop through PoseNet (people found
    in at least one image): the same render in both styles."""
    jparams, model = posenet
    jrun = jp.make_topdown(jparams, body=False, crop=32)
    trun = tp.make_topdown(model, crop=32)
    with torch.no_grad():
        for style in ("openpose", "keypose"):
            _exact(jrun(IMG, style=style), trun(_t(IMG), style=style))
        maps, pafs = model(_t(IMG))
    xy, conf = tp.top_peaks(maps, 8)
    assert any(tp.group_people(
        xy[b].numpy(), conf[b].numpy(), *[t.numpy() for t in
                                          tp.match_limb_indices(
                                              xy[b], conf[b], pafs[b],
                                              conf_threshold=0.1)])[1].any()
        for b in range(2))


def test_body_refine_pass_matches_jax(body, style="openpose"):
    """The body model's second pass over given boxes (one invalid)."""
    jparams, model = body
    boxes = np.asarray([[0.1, 0.2, 0.7, 0.9], [0.3, 0.0, 1.0, 0.6],
                        [0.0, 0.0, 1.0, 1.0]], np.float32)
    valid = np.asarray([True, True, False])
    ref = jax.jit(lambda i, b, v: jp._refine_pass(
        jparams, i, b, v, 64, 56, 32, True, 0.1, style=style))(
        IMG[0], boxes, valid)
    with torch.no_grad():
        got = tp.refine_people(model, _t(IMG[0]), _t(boxes), _t(valid), 32,
                               0.1, style)
    _exact(ref, got)
    assert float(got.sum()) > 0


def test_pose_engine_matches_jax(body_state, tmp_path):
    """The openpose engine of config/engines/utility.yaml over a body
    checkpoint (bottom-up: ``refine: none``; the top-down crop is 368 px)
    through both managers: openpose and keypose renders equal; ready and
    "real"."""
    path = str(tmp_path / "body.safetensors")
    save_file(body_state, path)
    spec = [{"id": "openpose", "task": "pose", "model": path,
             "refine": "none"}]
    tm = TManager(spec, device="cpu", compute_dtype=torch.float32)
    jm = JManager(spec, compute_dtype=jnp.float32)
    try:
        tm.load_engines()
        for style in ("openpose", "keypose"):
            ref = jm.task_pipeline("pose")(IMG[:1], style=style)
            got = tm.task_pipeline("pose")(IMG[:1], style=style)
            _exact(ref, got)
        assert tm.status()[0]["ready"] and tm.status()[0]["weights"] == \
            "real"
        assert isinstance(tm.task_pipeline("pose").models[0], tp.BodyPose)
    finally:
        tm.dispatcher.stop()
        jm.dispatcher.stop()


def test_weightless_pose_engine_runs_topdown():
    """No checkpoint: the small PoseNet, random; the default top-down path
    at its 368 px crop."""
    tm = TManager([{"id": "openpose", "task": "pose"}], device="cpu",
                  compute_dtype=torch.float32)
    try:
        out = tm.task_pipeline("pose")(IMG[:1, :32, :32], style="keypose")
        assert tuple(out.shape) == (1, 32, 32, 3)
        assert isinstance(tm.task_pipeline("pose").models[0], tp.PoseNet)
        assert tm.status()[0]["weights"] == "random"
    finally:
        tm.dispatcher.stop()
