"""Artifact adjustment chains, depth engines and engine options through the
port's generate servicer and server, on the CPU at the SD_TEST preset in
f32, against the JAX package's servicer: the masks and hints that
client.py's --mask_from_image_alpha and --hint_from_image (depth, canny,
color, shuffle, hed) requests extract (1e-4, hed 1e-3; the shuffle given
the JAX flow), a request addressed to a depth or edge engine (its PNG
within one level), the engine of config/examples.yaml with its
``options:``, CLIP guidance (C7) answering UNIMPLEMENTED and ToMe serving,
the diffusion upscalers, CodeFormer and background removal answering
their images, a request to the normal
engine (which the JAX servicer runs as a generation),
``cfg_sequential`` reaching the pipeline; then client.py itself against
the port's server for each."""

import os
import threading
import time
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file

from gyre_tpu.generated import generation_pb2 as jpb
from gyre_tpu.http.router import FakeGrpcContext as JContext
from gyre_tpu.manager.manager import EngineManager as JManager
from gyre_tpu.services import adjustments as jadj
from gyre_tpu.services import generate as jgen
from gyre_tpu_torch import server as tserver
from gyre_tpu_torch.generated import generation_pb2 as tpb
from gyre_tpu_torch.http.router import FakeGrpcContext as TContext
from gyre_tpu_torch.manager.manager import EngineManager as TManager
from gyre_tpu_torch.models import dpt as tdpt
from gyre_tpu_torch.ops import images as timages
from gyre_tpu_torch.services import generate as tgen
from test_torch_adjustments import _client_request, _jax_flow, _png
from test_torch_modes import one_torch_thread  # noqa: F401
from test_torch_server import BEARER, TOKEN, _free_port

RNG = np.random.default_rng(17)
IMG = RNG.random((64, 64, 3)).astype(np.float32)
RGBA = np.concatenate([IMG, np.ones((64, 64, 1), np.float32)], -1)
RGBA[20:44, 16:40, 3] = 0.0                  # a transparent hole


@pytest.fixture(scope="module")
def depth_ckpt(tmp_path_factory):
    state = tdpt.state_dict_hf(tdpt.random_dpt(tdpt.DPT_TEST, 4,
                                               device="cpu"))
    path = str(tmp_path_factory.mktemp("dpt") / "dpt.safetensors")
    save_file({k: v.numpy() for k, v in state.items()}, path)
    return path


def _engines(depth_ckpt):
    return [{"id": "tiny", "default": True, "model": "preset/test"},
            # config/examples.yaml:63-66's options
            {"id": "examples", "model": "preset/test",
             "options": {"sampler": "k_dpmpp_2m",
                         "hintset": "sd15-hints"}},
            {"id": "midas-depth", "task": "depth", "model": depth_ckpt}]


@pytest.fixture(scope="module")
def servicers(depth_ckpt, one_torch_thread):  # noqa: F811
    engines = _engines(depth_ckpt)
    tm = TManager(engines, device="cpu", compute_dtype=torch.float32,
                  batch_max=2, gather_ms=0.0)
    tm.load_engines()
    jm = JManager(engines, compute_dtype=jnp.float32, batch_max=2)
    jm.load_engines()
    yield (tgen.GenerationServiceServicer(tm, batch_max=2),
           jgen.GenerationServiceServicer(jm, batch_max=2))
    tm.dispatcher.stop()
    jm.dispatcher.stop()


@pytest.fixture(autouse=True)
def jax_shuffle_flow(monkeypatch):
    monkeypatch.setattr(timages, "shuffle_flow", _jax_flow)


def _argv(kind, tmp_path):
    if kind == "mask_from_image_alpha":
        return ["-i", _png(tmp_path / "init.png", RGBA),
                "--mask_from_image_alpha"]
    return ["--hint_from_image", f"{kind}:{_png(tmp_path / 'h.png', IMG)}"]


@pytest.mark.parametrize("kind", ["mask_from_image_alpha", "depth",
                                  "canny", "color", "shuffle"])
def test_client_requests_extract_as_in_jax(servicers, kind, tmp_path,
                                           monkeypatch):
    """extract_params with each servicer's adjuster: the mask or the hint
    image of client.py's request equals the JAX servicer's; the depth hint
    runs the configured DPT engine in both."""
    port, ref = servicers
    jreq = _client_request(_argv(kind, tmp_path) + ["-S", "0"], monkeypatch)
    treq = tpb.Request.FromString(jreq.SerializeToString())
    got = tgen.extract_params(treq, adjuster=port._adjuster(0))
    want = jgen.extract_params(jreq, adjuster=lambda img, chain: (
        jadj.apply_image_adjustment(img, chain, ref.manager, None)))
    if kind == "mask_from_image_alpha":
        pairs = [(got.mask_image, want.mask_image),
                 (got.init_image, want.init_image)]
        assert want.mask_image.max() > 0.5          # the hole regenerates
    else:
        (t, img, w, prio), = got.hint_images
        (jt, jimg, jw, jprio), = want.hint_images
        assert (t, w, prio) == (jt, jw, jprio) == (kind, 1.0, "balanced")
        pairs = [(img, jimg)]
    for a, b in pairs:
        assert a.shape == b.shape
        assert np.abs(np.asarray(a) - np.asarray(b)).max() <= 1e-4


def _depth_request(pb, img=IMG):
    req = pb.Request(engine_id="midas-depth", request_id="d")
    req.prompt.add().text = ""
    p = req.prompt.add()
    p.artifact.type = pb.ARTIFACT_IMAGE
    p.artifact.binary = timages.encode_png(img)
    p.parameters.init = True
    req.image.seed.append(5)
    return req


def test_depth_engine_request_matches_jax(servicers):
    port, ref = servicers
    t = list(port.Generate(_depth_request(tpb), TContext()))
    j = list(ref.Generate(_depth_request(jpb), JContext()))
    assert len(t) == len(j) == 1
    ti = timages.decode_png(t[0].artifacts[0].binary)
    ji = timages.decode_png(j[0].artifacts[0].binary)
    assert ti.shape == ji.shape == (1, 64, 64, 3)
    assert np.abs(ti - ji).max() <= 1.0 / 255 + 1e-6
    assert ti.std() > 0.05


def _generate_request(pb, engine_id):
    req = pb.Request(engine_id=engine_id, request_id=engine_id)
    req.prompt.add().text = "a boat"
    img = req.image
    img.height, img.width, img.steps = 64, 64, 2
    img.seed.append(3)
    return req


def test_examples_engine_options_serve_as_in_jax(servicers):
    """config/examples.yaml's engine options (a sampler, a hintset) serve:
    the JAX servicer reads the sampler and ignores the rest; the port used
    to refuse every request of that engine."""
    port, ref = servicers
    t = list(port.Generate(_generate_request(tpb, "examples"), TContext()))
    j = list(ref.Generate(_generate_request(jpb, "examples"), JContext()))
    assert [(a.artifacts[0].mime, a.artifacts[0].seed) for a in t] == \
        [(a.artifacts[0].mime, a.artifacts[0].seed) for a in j]
    meta = timages.png_metadata(t[0].artifacts[0].binary)
    assert meta["sampler"] == "k_dpmpp_2m"


@pytest.mark.parametrize("options,item", [
    ({"tome_ratio": 0.5}, "C6"), ({"clip_guidance_scale": 0.3}, "C7"),
    ({"clip": {"guidance_scale": 0.4}}, "C7")])
def test_unported_engine_options_are_unimplemented(options, item):
    """The engine options of ToMe (filed under C6 until it was ported
    beside D4b) and CLIP guidance (C7, ported since; the case ids keep the
    items) serve: one PNG, not the image of the same request to the same
    weights without the option (tests/test_torch_tome.py and
    tests/test_torch_guidance.py hold them to JAX)."""
    m = TManager([{"id": "tiny", "model": "preset/test",
                   "options": options},
                  {"id": "plain", "model": "preset/test"}], device="cpu",
                 compute_dtype=torch.float32)
    try:
        servicer = tgen.GenerationServiceServicer(m)
        (got,) = servicer.Generate(_generate_request(tpb, "tiny"),
                                   TContext())
        (plain,) = servicer.Generate(_generate_request(tpb, "plain"),
                                     TContext())
        assert got.artifacts[0].mime == "image/png"
        got, plain = (timages.decode_png(a.artifacts[0].binary)
                      for a in (got, plain))
        assert got.shape == plain.shape == (1, 64, 64, 3)
        assert np.abs(got - plain).max() > 1.0 / 255
    finally:
        m.dispatcher.stop()


def test_cfg_sequential_and_ignored_options_reach_the_pipeline(monkeypatch):
    """``cfg_sequential`` and ``tome_ratio`` reach the pipeline; an option
    the port does not read (a non-dict clip, an unknown key) changes
    nothing."""
    m = TManager([{"id": "tiny", "model": "preset/test",
                   "options": {"cfg_sequential": True, "tome_ratio": 0.0,
                               "clip": "@clip-common", "unknown": 1}}],
                 device="cpu", compute_dtype=torch.float32)
    seen = []
    submit = m.dispatcher.submit

    def record(fn, kwargs, *args, **kw):
        seen.append(dict(kwargs))
        return submit(fn, kwargs, *args, **kw)

    monkeypatch.setattr(m.dispatcher, "submit", record)
    try:
        servicer = tgen.GenerationServiceServicer(m)
        answers = list(servicer.Generate(_generate_request(tpb, "tiny"),
                                         TContext()))
        assert len(answers) == 1
        assert [(k.get("cfg_sequential"), k.get("tome_ratio"))
                for k in seen if "seeds" in k] == [(True, 0.0)]
    finally:
        m.dispatcher.stop()


@pytest.fixture(scope="module")
def hed_ckpt(tmp_path_factory):
    from gyre_tpu_torch.models import hinters as th

    path = str(tmp_path_factory.mktemp("hed") / "hed.safetensors")
    save_file(th.state_dict_hed(th.random_hed(2, device="cpu")), path)
    return path


def _task_request(pb, engine_id, img=IMG):
    req = _depth_request(pb, img)
    req.engine_id = engine_id
    return req


def test_unported_hinter_engines_are_unimplemented(depth_ckpt, hed_ckpt,
                                                   tmp_path, monkeypatch):
    """The hinter engines serve (the test keeps its name from before they
    were ported, when these answered UNIMPLEMENTED naming D3): with
    config/engines/utility.yaml's edge engine over a HED checkpoint,
    client.py's ``--hint_from_image hed:`` hint equals the JAX servicer's
    (1e-3) and a request to the engine answers its PNG (within one
    level). So do the engines of ROADMAP D4b, which answered UNIMPLEMENTED
    until they were ported: the sd-x4 and sd-x2 diffusion upscalers (at
    their test presets, 2 steps) answer a PNG 4x and 2x the init image,
    each equal within one level to its engine's pipeline run in-process
    (tests/test_torch_diffusion_upscaler.py holds those to JAX), and
    CodeFormer (random at CODEFORMER_TEST) one of the init image's size;
    background removal an RGBA image (D3b). Every engine is ready."""
    engines = _engines(depth_ckpt) + [
        {"id": "hed-edge", "task": "edge", "model": hed_ckpt}]
    tm = TManager(engines + [
        {"id": "background-removal", "task": "background_removal"},
        {"id": "upscaler-x4", "task": "upscaler", "kind": "sd-x4",
         "model": "preset/upscaler-x4-test", "steps": 2},
        {"id": "upscaler-x2", "task": "upscaler", "kind": "sd-x2",
         "model": "preset/upscaler-x2-test", "steps": 2},
        {"id": "codeformer", "task": "face_restore"}],
        device="cpu", compute_dtype=torch.float32)
    jm = JManager(engines, compute_dtype=jnp.float32)
    try:
        tm.load_engines()
        jm.load_engines()
        port = tgen.GenerationServiceServicer(tm)
        ref = jgen.GenerationServiceServicer(jm)
        jreq = _client_request(["--hint_from_image",
                                f"hed:{_png(tmp_path / 'h.png', IMG)}"],
                               monkeypatch)
        treq = tpb.Request.FromString(jreq.SerializeToString())
        got = tgen.extract_params(treq, adjuster=port._adjuster(0))
        want = jgen.extract_params(jreq, adjuster=lambda img, chain: (
            jadj.apply_image_adjustment(img, chain, jm, None)))
        (t, img, _, _), = got.hint_images
        (jt, jimg, _, _), = want.hint_images
        assert t == jt == "hed"
        assert np.abs(np.asarray(img) - np.asarray(jimg)).max() <= 1e-3
        assert float(np.asarray(img).std()) > 1e-3
        ti = list(port.Generate(_task_request(tpb, "hed-edge"), TContext()))
        ji = list(ref.Generate(_task_request(jpb, "hed-edge"), JContext()))
        ti = timages.decode_png(ti[0].artifacts[0].binary)
        ji = timages.decode_png(ji[0].artifacts[0].binary)
        assert ti.shape == ji.shape == (1, 64, 64, 3)
        assert np.abs(ti - ji).max() <= 1.0 / 255 + 1e-6
        small = IMG[:16, :16]
        for eid, size in (("upscaler-x4", 64), ("upscaler-x2", 32),
                          ("codeformer", 16)):
            (answer,) = port.Generate(_task_request(tpb, eid, small),
                                      TContext())
            served = timages.decode_png(answer.artifacts[0].binary)
            assert served.shape == (1, size, size, 3)
            init = timages.decode_png(timages.encode_png(small))
            direct = tm.task_pipeline(tm.spec(eid).task, eid)(init)
            assert np.abs(served - direct.numpy()).max() <= \
                1.0 / 255 + 1e-6
        bg = list(port.Generate(_task_request(tpb, "background-removal"),
                                TContext()))
        bg = timages.decode_png(bg[0].artifacts[0].binary)
        assert bg.shape == (1, 64, 64, 4)
        ready = {s["id"]: s["ready"] for s in tm.status()}
        assert all(ready[e] for e in ("hed-edge", "background-removal",
                                      "upscaler-x4", "upscaler-x2",
                                      "codeformer"))
    finally:
        tm.dispatcher.stop()
        jm.dispatcher.stop()


def test_direct_normal_request_serves_where_jax_fails(depth_ckpt,
                                                     monkeypatch):
    """A request sent to the bae-normal engine: the JAX servicer's list of
    direct task engines (gyre_tpu/services/generate.py:551-554) lacks
    "normal", so it runs the request as a generation on that engine
    (``with_engine``; unpatched, after building a random SD1.5 ModelSet
    for it, that answers INVALID_ARGUMENT on a shape error); the port's
    servicer runs any task engine and answers its normal map (a deliberate
    difference, ROADMAP queue 3)."""
    engines = _engines(depth_ckpt) + [
        {"id": "bae-normal", "task": "normal", "kind": "bae"}]
    tm = TManager(engines, device="cpu", compute_dtype=torch.float32)
    jm = JManager(engines, compute_dtype=jnp.float32)
    asked = []

    def with_engine(engine_id, **kw):
        asked.append(engine_id)
        raise RuntimeError(f"a generation on {engine_id}")

    monkeypatch.setattr(jm, "with_engine", with_engine)
    try:
        tm.load_engines()
        with pytest.raises(Exception):
            list(jgen.GenerationServiceServicer(jm).Generate(
                _task_request(jpb, "bae-normal"), JContext()))
        assert asked == ["bae-normal"]
        out = list(tgen.GenerationServiceServicer(tm).Generate(
            _task_request(tpb, "bae-normal"), TContext()))
        got = timages.decode_png(out[0].artifacts[0].binary)
        sent = timages.decode_png(timages.encode_png(IMG))
        want = tm.task_pipeline("normal")(sent).numpy()
        assert got.shape == (1, 64, 64, 3)
        assert np.abs(got - want).max() <= 1.0 / 255 + 1e-6
    finally:
        tm.dispatcher.stop()
        jm.dispatcher.stop()


# ----------------------------------------------- client.py against the server


@pytest.fixture(scope="module")
def server(depth_ckpt, tmp_path_factory):
    root = tmp_path_factory.mktemp("srv")
    cfg = root / "engines.yaml"
    cfg.write_text(
        f"- {{id: tiny, default: true, model: preset/test}}\n"
        f"- {{id: examples, model: preset/test, options: {{sampler: "
        f"k_dpmpp_2m, hintset: sd15-hints}}}}\n"
        f"- {{id: midas-depth, task: depth, model: {depth_ckpt}}}\n")
    grpc_port, http_port = _free_port(), _free_port()
    argv = ["--grpc_port", str(grpc_port), "--http_port", str(http_port),
            "--enginecfg", str(cfg), "--device", "cpu", "--dtype",
            "float32", "--cache_path", str(root / "cache"),
            "--access_token", TOKEN]
    stop = threading.Event()
    thread = threading.Thread(target=tserver.main, args=(argv, stop),
                              daemon=True)
    thread.start()
    deadline = time.monotonic() + 120
    while True:
        try:
            with urllib.request.urlopen(urllib.request.Request(
                    f"http://localhost:{http_port}/status", headers=BEARER),
                    timeout=2) as r:
                import json

                if all(e["ready"] for e in json.loads(r.read())["engines"]):
                    break
        except (OSError, ValueError):
            pass
        if time.monotonic() > deadline or not thread.is_alive():
            pytest.fail("server did not come up")
        time.sleep(0.2)
    yield grpc_port
    stop.set()
    thread.join(30)


@pytest.mark.parametrize("case", ["mask_from_image_alpha", "depth", "canny",
                                  "color", "shuffle", "depth_engine",
                                  "examples"])
def test_client_py_against_the_port(server, case, tmp_path):
    """client.py, unchanged, gets its PNG from the port's server."""
    import client

    out = str(tmp_path / "out.png")
    argv = ["a boat", "--host", f"localhost:{server}", "--key", TOKEN,
            "-o", out, "-W", "64", "-H", "64", "--steps", "2", "-S", "9"]
    if case == "depth_engine":
        argv += ["-e", "midas-depth", "-i", _png(tmp_path / "i.png", IMG)]
    elif case == "examples":
        argv += ["-e", "examples"]
    else:
        argv += _argv(case, tmp_path)
    assert client.main(argv) in (0, None)
    files = sorted(f for f in os.listdir(tmp_path) if f.startswith("out"))
    assert files, os.listdir(tmp_path)
    img = timages.decode_png(open(tmp_path / files[0], "rb").read())
    assert img.shape == (1, 64, 64, 3)
