"""The port's device mesh (gyre_tpu_torch/parallel/mesh.py, pool.py) on the
CPU, held to the JAX package's gyre_tpu/parallel/mesh.py on the SD_TEST
preset: its tp rules leaf by leaf, the indivisible-dim fallback, a pool of
two ``cpu`` groups (dp = 2) and a tp = 2 split against one device, through
the EngineManager (txt2img, img2img, a ControlNet hint and a LoRA view),
the port's tp = 2 image against the JAX package's tp = 2 mesh run with no
noise put in, and ``server.py --tp 2 --device cpu``.

Tolerances (f32): a pool's and a tp split's images within 1e-5 of one
device's (a pool runs each sample's ops on fewer rows, and the CPU's GEMMs
block 2 rows otherwise than 4: up to 3.7e-6 measured; a tp split adds its
partial out-projections in another order), the port against the JAX
package within 2e-3 (as tests/test_torch_pipeline.py).
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from gyre_tpu.models import configs
from gyre_tpu.models import modelset as jms
from gyre_tpu.parallel import mesh as jmesh
from gyre_tpu.pipeline import unified as junified
from gyre_tpu_torch import server as tserver
from gyre_tpu_torch.generated import generation_pb2 as tpb
from gyre_tpu_torch.http.router import FakeGrpcContext
from gyre_tpu_torch.manager.manager import EngineManager
from gyre_tpu_torch.models import configs as tconfigs
from gyre_tpu_torch.models import controlnet as tcn
from gyre_tpu_torch.models import layers as L
from gyre_tpu_torch.models import modelset as tms
from gyre_tpu_torch.ops import images as timages
from gyre_tpu_torch.parallel import mesh as tmesh
from gyre_tpu_torch.parallel.pool import PooledPipeline
from gyre_tpu_torch.pipeline import unified as tunified
from gyre_tpu_torch.services import generate as tgen
from test_torch_adapters import make_state
from test_torch_modes import one_torch_thread  # noqa: F401

CFG = configs.SD_TEST
ENGINE = "tiny"
REQUEST = dict(prompt="mesh test", height=64, width=64, steps=2,
               sampler="k_euler", guidance_scale=7.5)


# ------------------------------------------------------------ the rules


@pytest.fixture(scope="module")
def trees():
    """(JAX params trees, the port's trees of the same weights)."""
    ms = jms.random_modelset(CFG, seed=0, dtype=jnp.float32)
    jt = {"unet": jax.tree.map(np.asarray, ms.unet_params),
          "vae": jax.tree.map(np.asarray, ms.vae_params),
          "clip": jax.tree.map(np.asarray, ms.text_params[0])}
    tm = tms.from_jax_params(jt["unet"], jt["vae"], [jt["clip"]], CFG,
                             device="cpu")
    return jt, {"unet": tm.unet_params, "vae": tm.vae_params,
                "clip": tm.text_params[0]}


def _paths(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _paths(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _paths(v, path + (i,))
    else:
        yield path, tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _differences(jtree, ttree, heads, tp=2):
    """Paths whose split differs between the packages; every other leaf is
    split alike, on the transposed dim for a 2-D linear weight."""
    jspecs = jmesh.param_specs(jtree)
    layout = tmesh.param_layout(ttree, tp, heads)
    differ, split = set(), 0
    for path, leaf in _paths(ttree):
        jleaf = _get(jtree, path)
        js = _get(jspecs, path)
        if js == P() or not jmesh._divisible(jleaf, js, tp):
            js = P()
        ts = _get(layout, path)
        if not js and not ts:
            continue
        want = tuple(js)[::-1] if jleaf.ndim == 2 else tuple(js)
        if ts != want:
            differ.add("/".join(map(str, path)))
        else:
            split += 1
    return differ, split


@pytest.mark.parametrize("name", ["unet", "clip", "vae"])
def test_tp_rules_match_jax(trees, name):
    """The same leaves split as JAX's rules split them, on the port's
    transposed dim; only the VAE's single-head mid attention differs (JAX
    splits its 512 columns, the port keeps whole heads)."""
    jt, tt = trees
    heads = {"unet": tmesh.unet_heads(CFG.unet),
             "clip": lambda _p: CFG.text_encoders[0].num_heads,
             "vae": lambda _p: 1}[name]
    differ, split = _differences(jt[name], tt[name], heads)
    expected = {f"{part}/mid/attn/{n}/{w}" for part in ("encoder", "decoder")
                for n, w in [*((n, w) for n in "qkv" for w in "wb"),
                             ("out", "w")]} if name == "vae" else set()
    assert differ == expected
    assert split == 0 if name == "vae" else split > 10


def test_head_indivisible_levels_stay_replicated(trees):
    """A level whose head count does not divide by tp (SD2's 5 heads at
    tp = 2) keeps its attention whole in the port; GSPMD would split it
    inside a head. Its GEGLU still splits."""
    jt, tt = trees
    cfg = dataclasses.replace(tconfigs.UNET_TEST, num_heads=(5, 4, 4, 4))
    differ, _ = _differences(jt["unet"], tt["unet"], tmesh.unet_heads(cfg))
    assert differ and all(p.startswith(("down/0/attns/", "up/3/attns/"))
                          and "/attn" in p for p in differ)
    assert {p.split("/")[-2] for p in differ} == {"q", "k", "v", "out"}


def test_indivisible_dims_fall_back_replicated():
    """tests/test_mesh.py's case: a weight whose tp dim does not divide
    stays one tensor, not an error."""
    params = {"attn1": {"q": {"w": torch.ones((5, 7))}}}
    out = tmesh.shard_params(params, ["cpu", "cpu"], heads=lambda _p: 2)
    assert torch.is_tensor(out["attn1"]["q"]["w"]) and \
        not isinstance(out["attn1"]["q"]["w"], L.Shards)
    assert tmesh.param_layout(params, 2, lambda _p: 2) == \
        {"attn1": {"q": {"w": ()}}}


def test_geglu_shards_hold_value_and_gate_pairs():
    w = torch.arange(16.0).reshape(8, 2)       # 4 value rows, 4 gate rows
    a, b = tmesh.split_leaf(("ff1", "w"), w, ("tp", None), 2)
    assert torch.equal(a, torch.cat([w[0:2], w[4:6]]))
    assert torch.equal(b, torch.cat([w[2:4], w[6:8]]))


def test_split_rows_and_make_mesh():
    mesh = tmesh.make_mesh(["cpu"] * 4, tp=2)
    assert mesh.shape == {"dp": 2, "tp": 2}
    with pytest.raises(AssertionError):
        tmesh.make_mesh(["cpu"] * 3, tp=2)
    img = np.arange(3)[:, None] * np.ones((3, 4))
    kw = dict(seeds=[1, 2, 3], prompt=["a", "b", "c"], negative_prompt="n",
              guidance_scale=[5.0, 6.0, 7.0], init_image=img,
              mask_image=np.ones((1, 4)), steps=2,
              hints=[{"image": img, "params": None}])
    g0, g1 = tmesh.split_rows(kw, 2)
    assert g0["seeds"] == [1, 2] and g1["seeds"] == [3]
    assert g0["prompt"] == ["a", "b"] and g1["negative_prompt"] == "n"
    assert g1["guidance_scale"] == [7.0]
    assert np.array_equal(g1["init_image"], img[2:])
    assert g1["mask_image"].shape == (1, 4) and g1["steps"] == 2
    assert np.array_equal(g0["hints"][0]["image"], img[:2])
    assert len(tmesh.split_rows(dict(seeds=[7]), 2)) == 1


# -------------------------------------------------------------- the pool


def _manager(mesh=None):
    return EngineManager([{"id": ENGINE, "default": True,
                           "model": "preset/test"}], device="cpu",
                         compute_dtype=torch.float32, mesh=mesh,
                         gather_ms=0.0)


@pytest.fixture(scope="module")
def managers():
    ms = {"one": _manager(),
          "dp2": _manager(tmesh.make_mesh(["cpu", "cpu"])),
          "tp2": _manager(tmesh.make_mesh(["cpu", "cpu"], tp=2))}
    yield ms
    for m in ms.values():
        m.dispatcher.stop()


def _controlnet():
    """A random ControlNet whose zero convs are not zero, so the hint
    moves the image."""
    p = tcn.random_controlnet(CFG.unet, seed=3, dtype=torch.float32,
                              device="cpu")
    g = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for zc in p["zero_convs"] + [p["mid_zero"],
                                     p["cond_embed"]["conv_out"]]:
            zc["w"].copy_(torch.randn(zc["w"].shape, generator=g) * 0.05)
    return p


_CN = _controlnet()
_INIT = np.random.default_rng(5).random((4, 64, 64, 3)).astype(np.float32)
_HINT = np.random.default_rng(6).random((1, 64, 64, 3)).astype(np.float32)
_LORA = [(make_state("kohya"), 0.8, "kohya-0.8")]
CASES = {
    "txt2img": {},
    "img2img": {"init_image": _INIT, "strength": 0.6},
    "hinted": {"hints": [{"params": _CN, "kind": "controlnet",
                          "image": _HINT, "scale": 1.0}]},
    "lora": {},
}


_ONE: dict = {}


def _one(managers, case, seeds):
    """One device's images of a case, run once."""
    key = (case, tuple(seeds))
    if key not in _ONE:
        _ONE[key] = _run(managers["one"], case, seeds)
    return _ONE[key]


def _run(m, case, seeds):
    kw = dict(REQUEST, seeds=seeds, **CASES[case])
    if "init_image" in kw:
        kw["init_image"] = kw["init_image"][:len(seeds)]
    view = m.adapted_pipeline(ENGINE, loras=_LORA if case == "lora" else
                              None)
    return view(**kw)


@pytest.mark.parametrize("seeds", [[1, 2, 3, 4], [1, 2, 3]],
                         ids=["even", "uneven"])
@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("layout", ["dp2", "tp2"])
def test_pool_matches_one_device(managers, layout, case, seeds):
    """dp = 2 (the samples split 2 + 2, or 2 + 1) and tp = 2 (both shards
    on the CPU) give one device's images."""
    want = _one(managers, case, seeds)
    got = _run(managers[layout], case, seeds)
    assert got.shape == want.shape == (len(seeds), 64, 64, 3)
    assert (got - want).abs().max() <= 1e-5
    assert want.std() > 1e-2


def test_pool_layout_and_chunked_dispatch(managers):
    """Each dp group's replica on its device, tp leaves as shards, LoRA
    folded into every replica; a chunked request through the dispatcher
    (lockstep chunks, progress, the stop event) gives the one run's
    images."""
    dp2, tp2 = managers["dp2"], managers["tp2"]
    pool = dp2.pipeline(ENGINE)
    assert isinstance(pool, PooledPipeline) and len(pool.pipes) == 2
    blk = tp2.replicas(ENGINE)[0].unet_params["down"][0]["attns"][0][
        "blocks"][0]
    assert isinstance(blk["attn1"]["q"]["w"], L.Shards)
    assert isinstance(blk["ff2"]["w"], L.Shards)
    assert torch.is_tensor(blk["attn1"]["out"]["b"])
    lora = dp2.adapted_pipeline(ENGINE, loras=_LORA)
    assert all(p.ms.id.endswith("+adapters") for p in lora.pipe.pipes)
    seen = []
    kw = dict(REQUEST, seeds=[1, 2, 3], chunk_steps=1,
              stop_event=threading.Event(),
              progress_callback=lambda d, n: seen.append((d, n)))
    got = dp2.dispatcher.submit(dp2.dispatch_view(ENGINE), kw,
                                kw["stop_event"]).result()
    want = _one(managers, "txt2img", [1, 2, 3])
    assert np.abs(np.asarray(got) - want.numpy()).max() <= 1e-5
    assert seen == [(1, 2), (2, 2)]
    stop = threading.Event()
    stop.set()
    assert dp2.pipeline(ENGINE)(**dict(kw, stop_event=stop,
                                       progress_callback=None)) is None
    assert dp2.status()[0]["devices"] == ["cpu", "cpu"]


# ------------------------------------------------ against the JAX package


def test_tp2_image_matches_jax_mesh_run():
    """tests/test_mesh.py's request on the JAX package's tp = 2 mesh (8
    virtual devices) and on the port's tp = 2 split of the same weights,
    with no noise put in."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    ms = jms.random_modelset(CFG, seed=0, dtype=jnp.float32)
    kw = dict(REQUEST, seeds=[1, 2, 3, 4])
    ref = np.asarray(junified.UnifiedPipeline(
        jmesh.shard_modelset(ms, jmesh.make_mesh(jax.devices()[:8], tp=2)),
        compute_dtype=jnp.float32)(**kw))
    tree = (jax.tree.map(np.asarray, ms.unet_params),
            jax.tree.map(np.asarray, ms.vae_params),
            [jax.tree.map(np.asarray, t) for t in ms.text_params])
    (tm,) = tmesh.shard_modelset(
        tms.from_jax_params(*tree, CFG, device="cpu"),
        tmesh.make_mesh(["cpu", "cpu"], tp=2))
    out = tunified.UnifiedPipeline(tm, compute_dtype=torch.float32)(**kw)
    assert out.shape == ref.shape == (4, 64, 64, 3)
    assert np.abs(out.numpy() - ref).max() <= 2e-3


def test_server_tp2_serves_the_one_device_image(tmp_path):
    """``server.py --tp 2 --device cpu`` builds a tp = 2 mesh on the CPU;
    its dispatcher's image equals one device's within 1e-5 and its
    Generate answer within one level."""
    cfg = tmp_path / "engines.yaml"
    cfg.write_text(f"- {{id: {ENGINE}, default: true, model: preset/test}}"
                   "\n")

    def build(*extra):
        return tserver.build_manager(tserver.parse_args(
            ["--enginecfg", str(cfg), "--device", "cpu", "--dtype",
             "float32", "--gather_ms", "0", *extra]))

    one, tp2 = build(), build("--tp", "2")
    try:
        assert one.mesh is None and tp2.mesh.shape == {"dp": 1, "tp": 2}
        kw = dict(REQUEST, seeds=[5, 6])
        imgs = [np.asarray(m.dispatcher.submit(m.dispatch_view(ENGINE),
                                               dict(kw)).result())
                for m in (one, tp2)]
        assert np.abs(imgs[0] - imgs[1]).max() <= 1e-5

        def generate(m):
            req = tpb.Request(engine_id=ENGINE, request_id="r")
            req.prompt.add().text = "mesh test"
            req.image.height = req.image.width = 64
            req.image.steps = 2
            req.image.seed.append(5)
            answers = list(tgen.GenerationServiceServicer(m).Generate(
                req, FakeGrpcContext()))
            return timages.decode_png(answers[0].artifacts[0].binary)

        a, b = generate(one), generate(tp2)
        assert a.shape == b.shape == (1, 64, 64, 3)
        assert np.abs(a - b).max() <= 1.0 / 255 + 1e-6
    finally:
        one.dispatcher.stop()
        tp2.dispatcher.stop()


def test_pool_launches_each_shard_from_threads(monkeypatch):
    """Each group's rows run on its own worker thread; the launch counter
    stays exact under concurrent counting."""
    from gyre_tpu_torch import _build

    threads = []
    pool = PooledPipeline([tunified.UnifiedPipeline(
        tms.random_modelset(tconfigs.SD_TEST, seed=0, dtype=torch.float32,
                            device="cpu"), compute_dtype=torch.float32)
        for _ in range(2)])
    real = tunified.UnifiedPipeline._generate

    def spy(self, **kw):
        threads.append(threading.current_thread())
        return (yield from real(self, **kw))

    monkeypatch.setattr(tunified.UnifiedPipeline, "_generate", spy)
    pool(**dict(REQUEST, seeds=[1, 2], steps=1))
    assert len(set(threads)) == 2 and all(
        t.name.startswith("pool-cpu") for t in threads)
    _build.reset_launches()
    counters = [threading.Thread(target=lambda: [
        _build.count_launch("gn_stats") for _ in range(20000)])
        for _ in range(4)]
    for t in counters:
        t.start()
    for t in counters:
        t.join()
    assert _build.launches["gn_stats"] == 80000
    _build.reset_launches()
