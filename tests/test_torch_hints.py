"""The port's hint models (gyre_tpu_torch.models.controlnet, t2i_adapter,
the UNet's residual inputs, layers.avg_pool_2x), their loaders and bridges,
the lanczos3 resize, the hintset manager and the servicer's hint artifacts,
against the JAX package on the CPU at the SD_TEST preset in f32.

Tolerances: the models 1e-4 absolute (f32, sums in another order), the
resize 1e-5, the loaders exact (the same tensors through the same key
maps).
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gyre_tpu.manager import hints as jhints
from gyre_tpu.models import configs
from gyre_tpu.models import controlnet as jcn
from gyre_tpu.models import layers as jlayers
from gyre_tpu.models import load as jload
from gyre_tpu.models import modelset as jms
from gyre_tpu.models import t2i_adapter as jt2i
from gyre_tpu.models import unet as junet
from gyre_tpu.ops import images as jimages
from gyre_tpu_torch.generated import generation_pb2 as tpb
from gyre_tpu_torch.http.router import FakeGrpcContext as TContext
from gyre_tpu_torch.manager import hints as thints
from gyre_tpu_torch.manager.manager import EngineManager as TManager
from gyre_tpu_torch.models import controlnet as tcn
from gyre_tpu_torch.models import layers as tlayers
from gyre_tpu_torch.models import load as tload
from gyre_tpu_torch.models import modelset as tms
from gyre_tpu_torch.models import t2i_adapter as tt2i
from gyre_tpu_torch.models import unet as tunet
from gyre_tpu_torch.ops import images as timages
from gyre_tpu_torch.ops import resize as tresize
from gyre_tpu_torch.services import generate as tgen
from test_torch_modes import one_torch_thread  # noqa: F401

CFG = configs.SD_TEST
UCFG = configs.UNET_TEST
T2I_CHANNELS = (32, 64, 128, 128)


def _np(tree):
    return jax.tree.map(lambda v: np.asarray(v) if hasattr(v, "shape")
                        else v, tree, is_leaf=lambda v: v is None)


def live_controlnet(seed=0):
    """JAX ControlNet params with random zero convs (as tests/test_hints.py
    makes one), so that its residuals flow."""
    key = jax.random.PRNGKey(seed)
    p = jcn.init(key, UCFG)
    p["cond_embed"]["conv_out"]["w"] = jax.random.normal(
        key, p["cond_embed"]["conv_out"]["w"].shape) * 0.1
    p["mid_zero"]["w"] = jax.random.normal(key, p["mid_zero"]["w"].shape) * 0.1
    p["zero_convs"] = [
        {"w": jax.random.normal(jax.random.fold_in(key, i),
                                zc["w"].shape) * 0.1, "b": zc["b"]}
        for i, zc in enumerate(p["zero_convs"])]
    return p


@pytest.fixture(scope="module")
def nets():
    """(JAX, port) ControlNet, T2I adapter and UNet on the same weights."""
    jp = live_controlnet()
    ja = jt2i.init(jax.random.PRNGKey(2), channels=T2I_CHANNELS)
    ms = jms.random_modelset(CFG, seed=0, dtype=jnp.float32)
    tm = tms.from_jax_params(_np(ms.unet_params), _np(ms.vae_params),
                             [_np(t) for t in ms.text_params], CFG,
                             device="cpu")
    return ((jp, tms.controlnet_from_jax(_np(jp), UCFG, device="cpu")),
            (ja, tms.t2i_adapter_from_jax(_np(ja), device="cpu")),
            (ms.unet_params, tm.unet_params))


def _inputs(seed=0, b=2, size=64):
    r = np.random.default_rng(seed)
    return (r.random((b, size, size, 3), np.float32),
            r.standard_normal((b, size // 8, size // 8, 4), np.float32),
            np.array([700.0, 30.0][:b], np.float32),
            r.standard_normal((b, 77, UCFG.cross_attention_dim), np.float32))


def _t(a):
    return torch.from_numpy(np.array(a))


def _err(ja, t):
    return float(np.abs(np.asarray(ja) - t.detach().numpy()).max())


# --------------------------------------------------------------- modules


def test_controlnet_matches_jax(nets):
    (jp, tp), _, _ = nets
    cond, x, t, ctx = _inputs()
    je = jcn.embed_condition(jp, jnp.asarray(cond))
    with torch.inference_mode():
        te = tcn.embed_condition(tp, _t(cond))
        td, tm = tcn.apply(tp, UCFG, _t(x), _t(t), _t(ctx), te,
                           conditioning_scale=0.7)
    assert _err(je, te) <= 1e-4
    jd, jm = jcn.apply(jp, UCFG, jnp.asarray(x), jnp.asarray(t),
                       jnp.asarray(ctx), je, conditioning_scale=0.7)
    assert len(td) == len(jd) == 12
    assert max(_err(a, b) for a, b in zip(jd, td)) <= 1e-4
    assert _err(jm, tm) <= 1e-4
    down, mid = tcn.residual_resolutions(UCFG, 8, 8)
    assert down == [tuple(r.shape[1:3]) for r in td]
    assert (down, mid) == jcn.residual_resolutions(UCFG, 8, 8)


def test_random_controlnet_adds_zero():
    p = tcn.random_controlnet(UCFG, seed=3, dtype=torch.float32,
                              device="cpu")
    cond, x, t, ctx = _inputs(1)
    with torch.inference_mode():
        d, m = tcn.apply(p, UCFG, _t(x), _t(t), _t(ctx),
                         tcn.embed_condition(p, _t(cond)))
    assert all(not r.any() for r in d + [m])
    assert p["down"][0]["resnets"][0]["conv1"]["w"].shape == (3, 3, 32, 32)


def test_t2i_adapter_matches_jax(nets):
    _, (ja, ta), _ = nets
    cond = _inputs(2)[0]
    jf = jt2i.apply(ja, jnp.asarray(cond))
    tf = tt2i.apply(ta, _t(cond))
    assert [tuple(f.shape) for f in tf] == [
        (2, 8, 8, 32), (2, 4, 4, 64), (2, 2, 2, 128), (2, 1, 1, 128)]
    assert max(_err(a, b) for a, b in zip(jf, tf)) <= 1e-4
    fused = tt2i.coadapter_fuse([tf, tf], [0.25, 0.5])
    jfused = jt2i.coadapter_fuse([jf, jf], [0.25, 0.5])
    assert max(_err(a, b) for a, b in zip(jfused, fused)) <= 1e-4
    with pytest.raises(NotImplementedError, match="C6"):
        tt2i.style_apply(None, None)


def test_avg_pool_2x_matches_jax():
    x = np.random.default_rng(4).standard_normal((2, 7, 10, 3), np.float32)
    assert _err(jlayers.avg_pool_2x(jnp.asarray(x)),
                tlayers.avg_pool_2x(_t(x))) <= 1e-6


def test_unet_with_residuals_and_adapter_states_matches_jax(nets):
    (jp, tp), (ja, ta), (ju, tu) = nets
    cond, x, t, ctx = _inputs(5)
    jd, jm = jcn.apply(jp, UCFG, jnp.asarray(x), jnp.asarray(t),
                       jnp.asarray(ctx), jcn.embed_condition(
                           jp, jnp.asarray(cond)))
    jf = jt2i.apply(ja, jnp.asarray(cond))
    jf[2] = None                               # a level without a state
    ref = junet.apply(ju, UCFG, jnp.asarray(x), jnp.asarray(t),
                      jnp.asarray(ctx), down_residuals=jd, mid_residual=jm,
                      adapter_states=jf)
    with torch.inference_mode():
        out = tunet.apply(tu, UCFG, _t(x), _t(t), _t(ctx),
                          down_residuals=[_t(r) for r in jd],
                          mid_residual=_t(jm),
                          adapter_states=[None if f is None else _t(f)
                                          for f in jf])
        plain = tunet.apply(tu, UCFG, _t(x), _t(t), _t(ctx))
    assert _err(ref, out) <= 1e-4
    assert float((out - plain).abs().max()) > 1e-2


# --------------------------------------------------------------- loaders


def test_controlnet_loader_round_trips_and_reads_jax_exports(nets):
    (jp, tp), _, _ = nets
    state = tload.export_controlnet_state(tp, UCFG)
    jstate = jload.export_controlnet_state(jp, UCFG)
    assert state.keys() == jstate.keys()
    for k in state:
        np.testing.assert_array_equal(state[k].numpy(),
                                      np.asarray(jstate[k]))
    for src in (state, {k: np.asarray(v) for k, v in jstate.items()}):
        loaded = tload.load_controlnet_params(src, UCFG,
                                              dtype=torch.float32,
                                              device="cpu")
        for (_, a), (_, b) in zip(_leaves(loaded), _leaves(tp)):
            assert torch.equal(a, b)


def test_t2i_loader_round_trips_and_reads_jax_exports(nets):
    _, (ja, ta), _ = nets
    state = tt2i.export_state(ta)
    jstate = jt2i.export_state(ja)
    assert state.keys() == jstate.keys()
    for k in state:
        np.testing.assert_array_equal(state[k].numpy(),
                                      np.asarray(jstate[k]))
    loaded = tt2i.load_params(state, dtype=torch.float32, device="cpu")
    assert loaded["downscale"] == 8
    for (_, a), (_, b) in zip(_leaves(loaded), _leaves(ta)):
        assert torch.equal(a, b) if torch.is_tensor(a) else a == b


def test_bridges_are_strict(nets):
    (jp, _), (ja, _), _ = nets
    jp = _np(jp)
    extra = dict(jp, stray={"w": np.zeros(3)})
    with pytest.raises(ValueError, match="stray"):
        tms.controlnet_from_jax(extra, UCFG, device="cpu")
    short = dict(jp, zero_convs=jp["zero_convs"][:-1])
    with pytest.raises(ValueError, match="zero_convs"):
        tms.controlnet_from_jax(short, UCFG, device="cpu")
    ja = _np(ja)
    ja["levels"][1]["proj"] = None             # a proj the channels need
    with pytest.raises(ValueError, match="proj"):
        tms.t2i_adapter_from_jax(ja, device="cpu")


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree, key=str):
            yield from _leaves(tree[k], path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


# ---------------------------------------------------------------- resize


@pytest.mark.parametrize("src,dst", [((40, 56), (64, 64)),
                                     ((96, 80), (32, 48)),
                                     ((64, 64), (24, 100))])
def test_lanczos3_matches_jax(src, dst):
    x = np.random.default_rng(6).random((2, *src, 3), np.float32)
    ref = jax.image.resize(jnp.asarray(x), (2, *dst, 3), "lanczos3")
    assert _err(ref, tresize.resize(_t(x), dst, "lanczos3")) <= 1e-5


@pytest.mark.parametrize("src,dst", [((48, 80), (64, 64)),
                                     ((80, 48), (64, 64)),
                                     ((96, 128), (40, 56))])
def test_rescale_matches_jax(src, dst):
    """The servicer's hint rescale: JAX's cover fit, up and down."""
    x = np.random.default_rng(7).random((1, *src, 3), np.float32)
    ref = jimages.rescale(jnp.asarray(x), *dst, fit="cover")
    assert _err(ref, timages.rescale(_t(x), *dst)) <= 1e-5


# -------------------------------------------------------------- hintsets

HINTSETS = [
    {"hintset_id": "hs-a",
     "controlnet11/canny": {"aliases": ["controlnet/canny", "canny"],
                            "priority": 210, "model": "@cn-canny"},
     "t2i/sketch": {"aliases": ["sketch", "scribble"]},
     "hints": {"depth": "dpt.safetensors", "seg": {"kind": "t2i",
                                                   "priority": 3}}},
    {"hintset_id": "hs-b",
     "controlnet10/canny": {"aliases": "canny", "priority": 100},
     "a/depth": {"aliases": "depth", "priority": 5},
     "coadapter/zoedepth": {"aliases": ["depth", "depth/zoe"],
                            "priority": 25}},
]


def test_parse_hintset_entry_matches_jax():
    for entry in HINTSETS + [{"hintset_id": "x", "plain": 1}]:
        assert [vars(s) for s in thints.parse_hintset_entry(entry)] == \
            [vars(s) for s in jhints.parse_hintset_entry(entry)]
    assert thints.HINT_ALIASES == jhints.HINT_ALIASES


def test_hintset_manager_matches_jax_choices():
    t = thints.HintsetManager(HINTSETS, UCFG, compute_dtype=torch.float32,
                              device="cpu", model_loader=_no_weights)
    j = jhints.HintsetManager(HINTSETS, UCFG, compute_dtype=jnp.float32,
                              model_loader=_no_weights)
    assert t.set_ids() == j.set_ids()
    for hs in (None, "hs-a", "hs-b"):
        assert t.types_for(hs) == j.types_for(hs)
    picked = {}
    for m, name in ((t, "port"), (j, "jax")):
        built = []
        m._build = lambda spec, cfg, built=built: built.append(
            (spec.name, spec.kind, spec.model)) or {"kind": spec.kind}
        for htype in ("canny", "sketch", "depth", "depth/zoe", "seg"):
            for hs in (None, "hs-a", "hs-b", "nonexistent"):
                m.for_type(htype, hintset=hs)
        picked[name] = built
    assert picked["port"] == picked["jax"]
    # a type no hintset names: no model (the JAX package builds a random
    # ControlNet for it, whose zero convs add exactly zero)
    for hs in (None, "hs-a", "nonexistent"):
        assert t.for_type("pose", hintset=hs) is None


def _no_weights(ref):
    raise FileNotFoundError(ref)


def test_random_hint_models_have_a_stable_seed():
    """The port seeds a random hint model with a function of its type that
    is the same in every process; the JAX package's ``hash()`` is salted
    per process (PYTHONHASHSEED)."""
    code = ("import sys; sys.modules['jax'] = None; "
            "from gyre_tpu_torch.manager.hints import random_seed; "
            "print(random_seed('canny_edge'), hash('canny_edge') & "
            "0x7FFFFFFF)")
    outs = [subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env=dict(os.environ, PYTHONHASHSEED=str(salt)), timeout=120,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ).stdout.split() for salt in (1, 2)]
    assert outs[0][0] == outs[1][0]          # the port's seed
    assert outs[0][1] != outs[1][1]          # the JAX package's
    hs = thints.HintsetManager(HINTSETS, UCFG, compute_dtype=torch.float32,
                               device="cpu", model_loader=_no_weights)
    a = hs.for_type("sketch", hintset="hs-a")["params"]
    b = thints.HintsetManager(
        HINTSETS, UCFG, compute_dtype=torch.float32, device="cpu",
        model_loader=_no_weights).for_type("sketch", hintset="hs-a")
    assert all(torch.equal(x, y) for (_, x), (_, y) in
               zip(_leaves(a), _leaves(b["params"])) if torch.is_tensor(x))


# ------------------------------------------------------------- servicer


def test_servicer_hint_through_the_engines_hintset(nets, tmp_path):
    """A hint image of another size than the request's, rescaled with
    lanczos3 and conditioned through the engine's hintset entry (a
    ControlNet checkpoint on disk), gives the in-process image; a type no
    hintset names is skipped."""
    (_, tp), _, _ = nets
    path = tmp_path / "cn.safetensors"
    tload.write_safetensors(str(path), tload.export_controlnet_state(tp,
                                                                      UCFG))
    m = TManager([{"id": "tiny", "default": True, "model": "preset/test",
                   "hintset": "hs"},
                  {"model_id": "cn", "model": str(path)},
                  {"hintset_id": "hs",
                   "controlnet/canny": {"aliases": ["canny"],
                                        "model": "@cn"}}],
                 device="cpu", compute_dtype=torch.float32, batch_max=2,
                 gather_ms=0.0)
    m.load_engines()
    servicer = tgen.GenerationServiceServicer(m, batch_max=2)
    try:
        hint = np.random.default_rng(8).integers(0, 256, (48, 80, 3),
                                                 np.uint8)
        outs = {}
        for prio in ("balanced", "prompt", "hint", None):
            req = tpb.Request(engine_id="tiny", request_id="h")
            req.prompt.add().text = "a boat"
            img = req.image
            img.height, img.width, img.steps, img.samples = 64, 64, 2, 1
            img.seed.append(5)
            img.transform.diffusion = tpb.SAMPLER_K_DPMPP_2M
            art = req.prompt.add()
            art.artifact.type = tpb.ARTIFACT_HINT_IMAGE
            art.artifact.hint_image_type = "canny" if prio else "pose"
            art.artifact.binary = timages.encode_png(hint)
            if prio:
                art.parameters.hint_priority = {
                    "balanced": tpb.HINT_BALANCED,
                    "prompt": tpb.HINT_PRIORITISE_PROMPT,
                    "hint": tpb.HINT_PRIORITISE_HINT}[prio]
            (answer,) = list(servicer.Generate(req, TContext()))
            outs[prio] = np.round(timages.decode_png(
                answer.artifacts[0].binary)[0] * 255).astype(np.uint8)
        pipe = m.dispatch_view("tiny").pipe
        cond = timages.rescale(_t(timages.decode_png(timages.encode_png(
            hint))), 64, 64)
        params = m.hint_model("canny", "tiny")["params"]
        for prio in ("balanced", "prompt", "hint"):
            want = pipe(prompt="a boat", height=64, width=64, steps=2,
                        seeds=[5], hints=[{
                            "params": params, "image": cond, "scale": 1.0,
                            "soft_injection": prio != "balanced",
                            "cfg_only": prio == "hint"}],
                        output_dtype="uint8")
            np.testing.assert_array_equal(outs[prio], want[0].numpy())
        plain = pipe(prompt="a boat", height=64, width=64, steps=2,
                     seeds=[5], output_dtype="uint8")
        np.testing.assert_array_equal(outs[None], plain[0].numpy())
        assert len({outs[p].tobytes() for p in outs}) == 4
    finally:
        m.dispatcher.stop()
