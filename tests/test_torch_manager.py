"""The port's engine manager and server on weights from disk, on the CPU at
the SD_TEST preset: the engines.yaml DSL, WeightResolver references,
``@engine`` part references, ``fallback:``, mixes (held to the JAX
package's mixing.py within 1e-6 in f32), weight provenance in status(),
prewarm, the server's flags (defaults equal to the JAX server's), and the
server started from the shipped config/engines.yaml with its SD 1.5 engine
pointed at the test preset.
"""

import dataclasses
import os
import threading
import time

import grpc
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gyre_tpu import server as jserver
from gyre_tpu.generated import engines_pb2 as epb
from gyre_tpu.generated import generation_pb2 as pb
from gyre_tpu.manager import mixing as jmixing
from gyre_tpu.models import configs as jconfigs
from gyre_tpu.models import load as jload
from gyre_tpu.models import modelset as jms
from gyre_tpu_torch import server as tserver
from gyre_tpu_torch.manager import mixing as tmixing
from gyre_tpu_torch.manager.manager import EngineManager
from gyre_tpu_torch.manager.weights import WeightResolver
from gyre_tpu_torch.models import configs as tconfigs
from gyre_tpu_torch.models import load as tload
from gyre_tpu_torch.models import modelset as tms
from gyre_tpu_torch.ops import images as I
from gyre_tpu_torch.pipeline.unified import UnifiedPipeline
from test_torch_modes import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SD15 = "stable-diffusion-v1-5"
INPAINT = "stable-diffusion-v1-5-inpainting"


@pytest.fixture(scope="module")
def weight_root(tmp_path_factory):
    """A weight root holding a tiny SD checkpoint as `org/tiny` and a
    9-channel (inpaint-shaped) one as `org/tiny-inpaint`."""
    root = tmp_path_factory.mktemp("weights")
    tload.save_modelset(
        tms.random_preset("test", seed=1, dtype=torch.float32, device="cpu"),
        str(root / "org--tiny"))
    cfg9 = dataclasses.replace(tconfigs.SD_TEST, unet=dataclasses.replace(
        tconfigs.SD_TEST.unet, in_channels=9))
    tload.save_modelset(
        tms.random_modelset(cfg9, seed=2, dtype=torch.float32, device="cpu"),
        str(root / "org--tiny-inpaint"))
    return str(root)


def _manager(entries, weight_root):
    return EngineManager(entries, device="cpu", compute_dtype=torch.float32,
                         weight_resolver=WeightResolver(
                             local_dirs=[weight_root]))


def _leaves(tree):
    return jax.tree.leaves(tree)


def test_status_reports_weight_provenance(weight_root):
    m = _manager([{"id": "loaded", "model": "org/tiny", "default": True},
                  {"id": "random", "model": {"preset": "test", "seed": 3}},
                  {"id": "off", "model": "org/tiny", "enabled": False},
                  {"id": "up", "task": "upscaler", "kind": "sd-x4",
                   "model": "preset/upscaler-x4-test", "steps": 2}],
                 weight_root)
    try:
        m.load_engines()
        status = {s["id"]: s for s in m.status()}
        assert status["loaded"]["weights"] == "real"
        assert status["random"]["weights"] == "random"
        assert status["off"]["weights"] == "pending"
        assert status["loaded"]["ready"] and not status["off"]["ready"]
        # the diffusion upscaler (D4b): ready, its weights pending until
        # its first use builds it, then random (its test preset)
        assert status["up"]["ready"] and status["up"]["weights"] == \
            "pending"
        ref = tload.load_modelset(os.path.join(weight_root, "org--tiny"),
                                  tconfigs.SD_TEST, dtype=torch.float32,
                                  device="cpu")
        for a, b in zip(_leaves(m.modelset("loaded").unet_params),
                        _leaves(ref.unet_params)):
            assert torch.equal(a, b)
        # a task engine has no generate ModelSet of its own; its pipeline
        # holds one
        with pytest.raises(ValueError, match="upscaler engine"):
            m.modelset("up")
        up = m.task_pipeline("upscaler", "up")
        assert up.upscaler.ms.config.unet.class_embed
        assert {s["id"]: s["weights"] for s in m.status()}["up"] == "random"
    finally:
        m.dispatcher.stop()


def test_engine_reference_shares_storage(weight_root):
    m = _manager([{"id": "base", "model": "org/tiny"},
                  {"id": "other", "model": {"preset": "test", "seed": 4,
                                            "vae": "@base",
                                            "tokenizer": "@base"}}],
                 weight_root)
    try:
        base, other = m.modelset("base"), m.modelset("other")
        pairs = list(zip(_leaves(base.vae_params),
                         _leaves(other.vae_params)))
        assert pairs and all(a.data_ptr() == b.data_ptr() for a, b in pairs)
        assert other.tokenizer is base.tokenizer
        assert not torch.equal(base.unet_params["conv_in"]["w"],
                               other.unet_params["conv_in"]["w"])
    finally:
        m.dispatcher.stop()


def test_fallback_takes_over_a_missing_path(weight_root, tmp_path):
    m = _manager([{"id": "broken", "model": {"path": str(tmp_path / "no")},
                   "fallback": "random"},
                  {"id": "random", "model": "preset/test"}], weight_root)
    try:
        assert m.modelset("broken") is m.modelset("random")
        assert {s["id"]: s["weights"] for s in m.status()}["broken"] == \
            "random"
        m2 = _manager([{"id": "broken", "model": str(tmp_path / "no")}],
                      weight_root)
        with pytest.raises(FileNotFoundError):
            m2.modelset("broken")
        m2.dispatcher.stop()
    finally:
        m.dispatcher.stop()


def test_load_model_entry_follows_alias_chains(weight_root):
    m = _manager([{"model_id": "alias", "model": "@real"},
                  {"model_id": "real", "model": "org/tiny",
                   "subfolder": "vae"},
                  {"model_id": "loop", "model": "@loop"}], weight_root)
    try:
        state, entry, path = m.load_model_entry("@alias")
        assert path.endswith(os.path.join("org--tiny", "vae"))
        assert entry["subfolder"] == "vae"
        assert "decoder.conv_in.weight" in state
        with pytest.raises(ValueError, match="cycle"):
            m.load_model_entry("@loop")
    finally:
        m.dispatcher.stop()


# ------------------------------------------------------------------ mixing


def _np_ms(ms):
    """The JAX ModelSet with numpy leaves: the JAX package's mixing code
    then runs as numpy f32 arithmetic, without a dispatch per leaf."""
    return dataclasses.replace(
        ms, unet_params=jax.tree.map(np.asarray, ms.unet_params),
        vae_params=jax.tree.map(np.asarray, ms.vae_params),
        text_params=[jax.tree.map(np.asarray, t) for t in ms.text_params])


@pytest.fixture(scope="module")
def jax_pair():
    return [_np_ms(jms.random_modelset(jconfigs.SD_TEST, seed=s,
                                       dtype=jnp.float32)) for s in (0, 1)]


def _bridge(ms):
    t = jax.tree.map(np.asarray, (ms.unet_params, ms.vae_params,
                                  ms.text_params))
    return tms.from_jax_params(*t, tconfigs.SD_TEST, device="cpu")


def _close(port_tree, jax_tree, spec_tree):
    """port_tree within 1e-6 of jax_tree, converted to the port's
    layouts."""
    ref = tms.convert_tree(spec_tree, lambda p, s: _jax_leaf(jax_tree, p, s),
                           "ref", torch.float32, "cpu")
    for a, b in zip(_leaves(port_tree), _leaves(ref)):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= 1e-6


def _jax_leaf(tree, path, spec):
    for k in path:
        tree = tree[k]
    a = np.array(tree, np.float32)
    return a.T if spec.kind == "linear" else \
        a.transpose(3, 2, 0, 1) if spec.kind == "conv" else a


@pytest.mark.parametrize("algorithm", ["weighted_sum", "sigmoid"])
def test_mix_modelsets_matches_jax(jax_pair, algorithm):
    ref = jmixing.mix_modelsets([(jax_pair[0], 1.0), (jax_pair[1], 3.0)],
                                algorithm)
    port = tmixing.mix_modelsets([(_bridge(jax_pair[0]), 1.0),
                                  (_bridge(jax_pair[1]), 3.0)], algorithm)
    specs = tms.model_specs(tconfigs.SD_TEST)
    _close(port.unet_params, ref.unet_params, specs[0])
    _close(port.text_params[0], ref.text_params[0], specs[2][0])


def test_add_difference_matches_jax(jax_pair):
    a, b = jax_pair
    base = _np_ms(jms.random_modelset(jconfigs.SD_TEST, seed=2,
                                      dtype=jnp.float32))
    ref = jmixing.add_difference(base.unet_params, a.unet_params,
                                 b.unet_params, 0.7)
    port = tmixing.add_difference(_bridge(base).unet_params,
                                  _bridge(a).unet_params,
                                  _bridge(b).unet_params, 0.7)
    _close(port, ref, tms.model_specs(tconfigs.SD_TEST)[0])


def test_mix_engine(weight_root):
    """A `mix:` engine of two engines is mix_modelsets of their ModelSets,
    'real' only when every source is."""
    m = _manager([{"id": "a", "model": "org/tiny"},
                  {"id": "b", "model": {"preset": "test", "seed": 5}},
                  {"id": "ab", "model": {"mix": ["@a", {"source": "@b",
                                                        "weight": 3.0}]}}],
                 weight_root)
    try:
        mixed = m.modelset("ab")
        ref = tmixing.mix_modelsets([(m.modelset("a"), 1.0),
                                     (m.modelset("b"), 3.0)], "weighted_sum")
        for x, y in zip(_leaves(mixed.unet_params), _leaves(ref.unet_params)):
            assert torch.equal(x, y)
        assert {s["id"]: s["weights"] for s in m.status()}["ab"] == "random"
    finally:
        m.dispatcher.stop()


# ------------------------------------------------------------------ server


def test_parse_args_defaults_match_jax():
    port = vars(tserver.parse_args([]))
    ref = vars(jserver.parse_args([]))
    ported = sorted(set(port) - {"device"})
    assert set(ported) <= set(ref)
    assert {k: port[k] for k in ported} == {k: ref[k] for k in ported}
    assert port["device"] == "cuda"
    assert port["enginecfg"] == "config/engines.yaml"


@pytest.fixture(scope="module")
def shipped(weight_root, tmp_path_factory):
    """A user config over the shipped config/engines.yaml: the SD 1.5 engine
    on the test preset, the inpainting engine on the 9-channel test
    checkpoint."""
    d = tmp_path_factory.mktemp("cfg")
    path = d / "port-engines.yaml"
    path.write_text(
        f"- !include {os.path.join(REPO, 'config', 'engines.yaml')}\n"
        f"- {{id: {SD15}, model: preset/test}}\n"
        f"- {{id: {INPAINT}, model: org/tiny-inpaint}}\n")
    return str(path)


def _args(cfg, weight_root, *extra):
    return tserver.parse_args(
        ["--enginecfg", cfg, "--engine_id", SD15, "--engine_id", INPAINT,
         "--device", "cpu", "--dtype", "float32", "--weight_root",
         weight_root, "--gather_ms", "0", *extra])


@pytest.fixture(scope="module")
def served(shipped, weight_root):
    manager = tserver.build_manager(_args(shipped, weight_root))
    manager.load_engines()
    server, port = tserver.build_server(manager, 0, host="localhost")
    channel = grpc.insecure_channel(f"localhost:{port}")
    yield manager, channel
    channel.close()
    server.stop(0).wait()
    manager.dispatcher.stop()


def test_engines_yaml_filters_and_builds(served):
    manager, _ = served
    enabled = [s.id for s in manager.specs if s.enabled]
    assert enabled == [SD15, INPAINT]          # --engine_id filters
    assert len(manager.specs) > 10 and manager.model_entries
    assert manager.default_engine_id() == SD15
    status = {s["id"]: s["weights"] for s in manager.status()}
    assert status[SD15] == "random" and status[INPAINT] == "real"
    assert manager.modelset(INPAINT).config.unet.in_channels == 9
    assert manager.suggest_max_batch(SD15, 64, 64) >= 1


def _request(engine_id, seed=7):
    req = pb.Request(engine_id=engine_id, request_id=f"r{seed}")
    req.prompt.add().text = "a boat"
    img = req.image
    img.height, img.width, img.steps, img.samples = 64, 64, 2, 1
    img.seed.append(seed)
    img.transform.diffusion = pb.SAMPLER_K_DPMPP_2M
    return req


def _generate(channel):
    return channel.unary_stream(
        "/gooseai.GenerationService/Generate",
        request_serializer=pb.Request.SerializeToString,
        response_deserializer=pb.Answer.FromString)


def test_shipped_config_serves(served):
    _, channel = served
    answers = list(_generate(channel)(_request(SD15), timeout=120))
    arts = [a for ans in answers for a in ans.artifacts]
    assert len(arts) == 1 and arts[0].binary.startswith(b"\x89PNG")
    engines = channel.unary_unary(
        "/gooseai.EnginesService/ListEngines",
        request_serializer=epb.ListEnginesRequest.SerializeToString,
        response_deserializer=epb.Engines.FromString)(
            epb.ListEnginesRequest(), timeout=30).engine
    ready = {e.id: e.ready for e in engines}
    # the 9-channel engine's weights are resident and its mode is served
    assert ready[SD15] and ready[INPAINT]
    assert not ready["stable-diffusion-v2-1"]          # disabled


def test_nine_channel_engine_serves_inpainting(served):
    """The 9-channel engine answers a PNG for an init image whose alpha is
    the mask; without a mask it refuses the request."""
    _, channel = served
    rgba = np.full((64, 64, 4), 200, np.uint8)
    rgba[16:48, 16:48, 3] = 0                    # transparent: regenerate
    req = _request(INPAINT)
    init = req.prompt.add()
    init.artifact.type = pb.ARTIFACT_IMAGE
    init.artifact.binary = I.encode_png(rgba)
    init.parameters.init = True
    arts = [a for ans in _generate(channel)(req, timeout=120)
            for a in ans.artifacts]
    assert len(arts) == 1 and arts[0].binary.startswith(b"\x89PNG")
    px = I.decode_png(arts[0].binary)[0]
    assert px.shape == (64, 64, 3)
    assert (np.round(px[:8] * 255) == 200).all()       # kept: the init
    with pytest.raises(grpc.RpcError) as err:
        list(_generate(channel)(_request(INPAINT), timeout=60))
    assert err.value.code() == grpc.StatusCode.INVALID_ARGUMENT
    assert "mask" in err.value.details()


def _ready_by_rpc_and_status(manager):
    """{id: ready} from ListEngines over every task group, and from the
    HTTP router's /status."""
    import json
    import urllib.request

    from gyre_tpu_torch.http.router import make_http_server, \
        start_http_server
    from gyre_tpu_torch.services.engines import EnginesServiceServicer

    engines = EnginesServiceServicer(manager)
    listed = {}
    for group in epb.EngineTaskGroup.values():
        for e in engines.ListEngines(epb.ListEnginesRequest(
                task_group=group), None).engine:
            listed[e.id] = e.ready
    http = make_http_server("localhost", 0, manager=manager,
                            generation=None, engines=engines)
    start_http_server(http)
    try:
        with urllib.request.urlopen(
                f"http://localhost:{http.server_address[1]}/status",
                timeout=30) as resp:
            status = {e["id"]: e["ready"]
                      for e in json.loads(resp.read())["engines"]}
    finally:
        http.shutdown()
        http.server_close()
    return listed, status


def test_task_engine_is_not_ready(weight_root):
    """Task engines are ready once the engines have loaded (the test keeps
    its name from when the sd-x4 diffusion upscaler, D4b, and before
    ESRGAN any upscaler, were not): the sd-x4 and sd-x2 diffusion
    upscalers, CodeFormer, ESRGAN and a depth engine (D2), over ListEngines
    and /status alike; none is a generate engine with a ModelSet."""
    m = _manager([{"id": "gen", "model": "org/tiny", "default": True},
                  {"id": "up", "task": "upscaler", "kind": "sd-x4"},
                  {"id": "x2", "task": "upscaler", "kind": "sd-x2"},
                  {"id": "face", "task": "face_restore"},
                  {"id": "esrgan", "task": "upscaler"},
                  {"id": "depth", "task": "depth"}], weight_root)
    try:
        m.load_engines()
        listed, status = _ready_by_rpc_and_status(m)
        assert listed == status == {"gen": True, "up": True, "x2": True,
                                    "face": True, "esrgan": True,
                                    "depth": True}
        for eid in ("up", "x2", "face"):
            with pytest.raises(ValueError, match="no generate ModelSet"):
                m.modelset(eid)
    finally:
        m.dispatcher.stop()


def test_nine_channel_engine_is_ready(weight_root):
    m = _manager([{"id": "gen", "model": "org/tiny", "default": True},
                  {"id": "inpaint", "model": "org/tiny-inpaint"}],
                 weight_root)
    try:
        m.load_engines()
        assert {s["id"]: s["weights"] for s in m.status()} == \
            {"gen": "real", "inpaint": "real"}
        listed, status = _ready_by_rpc_and_status(m)
        assert listed == status == {"gen": True, "inpaint": True}
    finally:
        m.dispatcher.stop()


def test_shipped_config_reports_only_servable_engines_ready(shipped,
                                                            weight_root):
    """Every enabled engine of the shipped config/engines.yaml: the
    4-channel SD 1.5 engine, the 9-channel inpainting engine, the MiDaS
    depth engine, the hinter engines (edge, lines, pose, segmentation,
    DexiNed, line art, normals), background removal and the ESRGAN
    upscaler are ready: every enabled engine."""
    manager = tserver.build_manager(tserver.parse_args(
        ["--enginecfg", shipped, "--device", "cpu", "--dtype", "float32",
         "--weight_root", weight_root]))
    try:
        manager.load_engines()
        listed, status = _ready_by_rpc_and_status(manager)
        enabled = {s.id for s in manager.specs if s.enabled}
        tasks = {s.id for s in manager.specs
                 if s.enabled and s.task != "generate"}
        assert {"esrgan-x4", "midas-depth", "mlsd-lines", "dexined-edge",
                "lineart"} <= tasks
        ready = {SD15, INPAINT, "midas-depth", "hed-edge", "mlsd-lines",
                 "openpose", "segmentation", "dexined-edge", "lineart",
                 "bae-normal", "background-removal", "esrgan-x4"}
        assert ready == enabled
        assert {i for i in enabled if status[i]} == ready
        assert {i for i in enabled if listed.get(i)} == ready
    finally:
        manager.dispatcher.stop()


def test_prewarm_reaches_done(served):
    manager, _ = served
    assert tserver.start_prewarm(manager, "auto", "cpu") is None
    worker = threading.Thread(target=manager.prewarm, kwargs=dict(
        height=64, width=64, steps=2, buckets=True))
    worker.start()
    deadline = time.monotonic() + 120
    while manager.prewarm_state["state"] in ("off", "running") and \
            time.monotonic() < deadline:
        time.sleep(0.05)
    worker.join(timeout=10)
    assert not worker.is_alive()
    assert manager.prewarm_state["state"] == "done"
    assert manager.prewarm_state["sizes"] == [1, manager.batch_max]


def test_save_safetensors_exports_for_the_jax_loader(shipped, weight_root,
                                                     tmp_path):
    out = str(tmp_path / "export")
    cache = str(tmp_path / "cache")
    tserver.main(["--enginecfg", shipped, "--device", "cpu", "--dtype",
                  "float32", "--weight_root", weight_root,
                  "--cache_path", cache,
                  "--save_safetensors", f"{INPAINT}:{out}"])
    assert not os.path.exists(cache)  # an export builds no cache
    back = jload.load_modelset(out, jconfigs.SD_TEST)
    assert back.config.unet.in_channels == 9
    ref = tload.load_modelset(os.path.join(weight_root, "org--tiny-inpaint"),
                              tconfigs.SD_TEST, dtype=torch.float32,
                              device="cpu")
    port = tload.export_tree(ref.unet_params,
                             tms.model_specs(ref.config)[0], tload.unet_keys)
    jax_state = jload.export_unet_state(back.unet_params, back.config.unet)
    for k, v in port.items():
        assert np.array_equal(v.numpy(), jax_state[k]), k


def test_graft_engine_pipeline_grafts_the_named_engine(weight_root):
    """An engine's `graft:` builds its pipeline with that engine's
    ModelSet on top (the JAX manager's rule, tests/test_hints.py): the same
    tensors, and an image that differs from either engine alone."""
    m = _manager([{"id": "root", "model": {"preset": "test", "seed": 0},
                   "default": True, "graft": "top"},
                  {"id": "top", "model": {"preset": "test", "seed": 9}}],
                 weight_root)
    try:
        m.load_engines()
        pipe = m.pipeline("root")
        assert pipe.graft_ms is m.modelset("top")
        kw = dict(prompt="a tree", height=64, width=64, steps=3,
                  sampler="k_euler", seeds=[5], guidance_scale=7.5)
        grafted = pipe(**kw)
        assert grafted.shape == (1, 64, 64, 3)
        assert bool(grafted.isfinite().all())
        root_alone = UnifiedPipeline(m.modelset("root"),
                                     compute_dtype=torch.float32)(**kw)
        for alone in (root_alone, m.pipeline("top")(**kw)):
            assert float((grafted - alone).abs().max()) > 1e-4
        assert m.pipeline("top").graft_ms is None
    finally:
        m.dispatcher.stop()


def test_dropped_manager_frees_its_engines_without_the_cycle_collector(
        weight_root):
    """The hintsets hold the manager's loader through a weak reference, so
    dropping the last reference to a manager frees its engines at once."""
    import gc
    import weakref

    m = _manager([{"id": "gen", "model": {"preset": "test", "seed": 1}}],
                 weight_root)
    m.dispatcher.stop()
    ms = weakref.ref(m.modelset("gen"))
    with pytest.raises(KeyError, match="unknown model_id"):
        m.hintsets.model_loader("@nope")     # reaches load_model_entry
    enabled = gc.isenabled()
    gc.disable()
    try:
        del m
        assert ms() is None
    finally:
        if enabled:
            gc.enable()
