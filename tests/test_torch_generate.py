"""The port's generate servicer against the JAX package's, on the CPU at the
SD_TEST preset in f32: answer-type negotiation, the Pillow image helpers,
Generate's answers, the Async trio and ChainGenerate.

The two packages draw their noise differently (ROADMAP A2), so the same
seed gives different pixels: the servicers are compared by the structure
of their answers (count, mime, seeds, indices, finish reasons, metadata
keys), and everything else exactly.
"""

import gzip
import io
import json
import os
import sys
import time
from concurrent.futures import Future

import grpc
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from gyre_tpu.generated import generation_pb2 as jpb
from gyre_tpu.http.router import AbortError as JAbortError
from gyre_tpu.http.router import FakeGrpcContext as JContext
from gyre_tpu.manager.manager import EngineManager as JManager
from gyre_tpu.ops import images as jimages
from gyre_tpu.services import generate as jgen
from gyre_tpu_torch.generated import generation_pb2 as tpb
from gyre_tpu_torch.http.router import AbortError as TAbortError
from gyre_tpu_torch.http.router import FakeGrpcContext as TContext
from gyre_tpu_torch.manager.manager import EngineManager as TManager
from gyre_tpu_torch.ops import images as timages
from gyre_tpu_torch.services import generate as tgen
from gyre_tpu_torch.utils.debug_recorder import DebugRecorder
from test_torch_modes import one_torch_thread  # noqa: F401

ENGINES = [{"id": "tiny", "name": "Tiny", "default": True,
            "model": "preset/test"}]


# ------------------------------------------------------ answer negotiation


@pytest.mark.parametrize("accept", [
    "", "image/png", "image/webp", "image/webp, image/png",
    "image/png;q=1.0, image/webp;q=0.5", "image/png;q=0.2, image/webp",
    "image/*", "*/*", "application/json", "IMAGE/WEBP ; q=0.9",
    "image/webp;q=junk, image/png;q=0.1", "text/html, image/webp;q=0",
    ",,;", "image/webp;q=0.8, */*;q=0.9"])
def test_negotiate_mime_matches_jax(accept):
    assert tgen.negotiate_mime(accept) == jgen.negotiate_mime(accept)


# --------------------------------------------------------- image helpers


def _images():
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, (1, 24, 40, 3), dtype=np.uint8)
    rgba = rng.integers(0, 256, (17, 9, 4), dtype=np.uint8)
    gray = rng.integers(0, 256, (1, 8, 8, 1), dtype=np.uint8)
    flt = rng.random((16, 16, 3)).astype(np.float32)
    return {"rgb": rgb, "rgba": rgba, "gray": gray, "float": flt}


@pytest.mark.parametrize("name", ["rgb", "rgba", "gray", "float"])
def test_image_helpers_match_jax(name):
    img = _images()[name]
    meta = {"prompt": "a boat", "seed": "7", "note": "naïve ☃"}
    png = timages.encode_png(img, meta)
    assert png == jimages.encode_png(img, meta)
    np.testing.assert_array_equal(timages.decode_png(png),
                                  jimages.decode_png(png))
    assert timages.png_metadata(png) == jimages.png_metadata(png) == meta
    if img.shape[-1] != 1:          # PIL writes no 1-channel WebP
        assert timages.encode_webp(img) == jimages.encode_webp(img)
    # a PNG written by PIL, with its adaptive scanline filters
    arr = img[0] if img.ndim == 4 else img
    if arr.dtype != np.uint8:
        arr = (arr * 255).round().astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr.squeeze(-1) if arr.shape[-1] == 1 else arr).save(
        buf, format="PNG")
    np.testing.assert_array_equal(timages.decode_png(buf.getvalue()),
                                  jimages.decode_png(buf.getvalue()))


def test_without_pillow_png_works_and_the_rest_is_unimplemented(
        monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    img = _images()["rgb"]
    assert timages.encode_png(img).startswith(b"\x89PNG")
    for call in (lambda: timages.encode_webp(img),
                 lambda: timages.decode_png(b"\x89PNG"),
                 lambda: timages.png_metadata(b"\x89PNG")):
        with pytest.raises(NotImplementedError, match="Pillow"):
            call()


# -------------------------------------------------------------- servicers


@pytest.fixture(scope="module")
def port():
    m = TManager(ENGINES, device="cpu", compute_dtype=torch.float32,
                 batch_max=2, gather_ms=0.0)
    m.load_engines()
    yield tgen.GenerationServiceServicer(m, batch_max=2)
    m.dispatcher.stop()


@pytest.fixture(scope="module")
def ref():
    m = JManager(ENGINES, compute_dtype=jnp.float32, batch_max=2)
    m.load_engines()
    yield jgen.GenerationServiceServicer(m, batch_max=2)
    m.dispatcher.stop()


def _request(pb, seed=7, samples=1, accept=""):
    req = pb.Request(engine_id="tiny", request_id=f"r{seed}", accept=accept)
    req.prompt.add().text = "a boat"
    neg = req.prompt.add()
    neg.text = "blurry"
    neg.parameters.weight = -1.0
    img = req.image
    img.height, img.width, img.steps, img.samples = 64, 64, 2, samples
    img.seed.append(seed)
    img.transform.diffusion = pb.SAMPLER_K_DPMPP_2M
    img.parameters.add().sampler.cfg_scale = 7.5
    return req


def _structure(answers):
    out = []
    for ans in answers:
        for a in ans.artifacts:
            meta = sorted(timages.png_metadata(a.binary)) \
                if a.mime == "image/png" else None
            out.append((ans.answer_id, ans.request_id, a.id, a.type, a.mime,
                        a.index, a.seed, a.finish_reason, a.size ==
                        len(a.binary), a.binary[:4], meta))
    return out


@pytest.mark.parametrize("samples,accept", [
    (1, ""), (3, "image/webp, image/png"),
    (1, "image/png;q=0.5, image/webp;q=0.9")])
def test_generate_matches_jax_in_structure(port, ref, samples, accept):
    t = list(port.Generate(_request(tpb, 11, samples, accept), TContext()))
    j = list(ref.Generate(_request(jpb, 11, samples, accept), JContext()))
    assert _structure(t) == _structure(j)
    assert len(t) == samples
    for ans in t:
        img = timages.decode_png(ans.artifacts[0].binary) \
            if ans.artifacts[0].mime == "image/png" else None
        assert img is None or img.shape == (1, 64, 64, 3)


def _poll(servicer, handle, ctx_cls):
    answers, deadline = [], time.monotonic() + 120
    while time.monotonic() < deadline:
        res = servicer.AsyncResult(handle, ctx_cls())
        answers.extend(res.answer)
        if res.complete:
            return answers, res.status.message
    raise AssertionError("AsyncResult never completed")


def test_async_returns_the_sync_bytes(port, ref):
    handle = port.AsyncGenerate(_request(tpb, 21), TContext())
    answers, status = _poll(port, handle, TContext)
    sync = list(port.Generate(_request(tpb, 21), TContext()))
    assert [a.artifacts[0].binary for a in answers] == \
        [a.artifacts[0].binary for a in sync]
    assert status == "1 artifact(s) ready"
    assert handle.async_handle not in port._async     # popped when read
    jhandle = ref.AsyncGenerate(_request(jpb, 21), JContext())
    janswers, jstatus = _poll(ref, jhandle, JContext)
    assert _structure(answers) == _structure(janswers)
    assert status == jstatus


@pytest.mark.parametrize("which", ["port", "jax"])
def test_async_cancel_unknown_handle_and_gc(port, ref, which):
    servicer, pb, ctx, abort, mod = (
        (port, tpb, TContext, TAbortError, tgen) if which == "port" else
        (ref, jpb, JContext, JAbortError, jgen))
    handle = servicer.AsyncGenerate(_request(pb, 31), ctx())
    servicer.AsyncCancel(pb.AsyncHandle(async_handle=handle.async_handle),
                         ctx())
    assert handle.async_handle not in servicer._async
    context = ctx()
    with pytest.raises(abort):
        servicer.AsyncResult(handle, context)
    assert context.code == grpc.StatusCode.NOT_FOUND
    # a finished request past its deadline is dropped, the rest stay
    old, running = mod.AsyncContext(), mod.AsyncContext()
    old.finish()
    old.deadline = time.monotonic() - 1.0
    with servicer._async_lock:
        servicer._async.update({"old": old, "running": running})
        servicer._gc_async()
        kept = set(servicer._async) & {"old", "running"}
        servicer._async.pop("running")
    assert kept == {"running"}


def _chain(pb, pass_to=None):
    chain = pb.ChainRequest(request_id="chain")
    for i, seed in enumerate((41, 42)):
        stage = chain.stage.add(id=f"s{i}")
        stage.request.CopyFrom(_request(pb, seed))
        on = stage.on_status.add()
        if pass_to and i == 0:
            on.action.append(pb.STAGE_ACTION_PASS)
            on.target = pass_to
        else:
            on.action.append(pb.STAGE_ACTION_RETURN)
    return chain


def test_chain_return_matches_jax(port, ref):
    t = list(port.ChainGenerate(_chain(tpb), TContext()))
    j = list(ref.ChainGenerate(_chain(jpb), JContext()))
    assert _structure(t) == _structure(j)
    assert [a.answer_id for a in t] == ["chain-s0", "chain-s1"]
    assert [a.artifacts[0].seed for a in t] == [41, 42]


def test_chain_pass_routes_images_as_init_matches_jax(port, ref):
    """PASS: stage 0's image becomes stage 1's init image (img2img), and
    only stage 1 answers, as in the JAX servicer."""
    t = list(port.ChainGenerate(_chain(tpb, pass_to="s1"), TContext()))
    j = list(ref.ChainGenerate(_chain(jpb, pass_to="s1"), JContext()))
    assert _structure(t) == _structure(j)
    assert [a.answer_id for a in t] == ["chain-s1"]
    assert timages.decode_png(t[0].artifacts[0].binary).shape == \
        (1, 64, 64, 3)


def _png(h=64, w=64, c=3, seed=0, alpha=None):
    img = np.random.default_rng(seed).integers(0, 256, (h, w, c), np.uint8)
    if alpha is not None:
        img[..., 3] = alpha
    return timages.encode_png(img)


def _artifact(req, kind, binary=None, init=False, echo=False, **fields):
    prompt = req.prompt.add()
    prompt.artifact.type = kind
    if binary is not None:
        prompt.artifact.binary = binary
    for k, v in fields.items():
        setattr(prompt.artifact, k, v)
    if init:
        prompt.parameters.init = True
    prompt.echo_back = echo
    return prompt


def _mode_request(pb, case):
    """A request exercising one of the mode fields of extract_params."""
    req = _request(pb)
    img = req.image
    if case == "init_alpha":
        alpha = np.full((64, 64), 255, np.uint8)
        alpha[8:40, 8:40] = 0
        _artifact(req, pb.ARTIFACT_IMAGE, _png(c=4, alpha=alpha), init=True,
                  echo=True)
    elif case == "init_opaque_and_mask":
        _artifact(req, pb.ARTIFACT_IMAGE, _png(c=4, alpha=255), init=True)
        _artifact(req, pb.ARTIFACT_MASK, _png(c=1, seed=1))
    elif case == "depth":
        _artifact(req, pb.ARTIFACT_IMAGE, _png())
        _artifact(req, pb.ARTIFACT_DEPTH, _png(seed=2))
    elif case in ("ref_uuid", "ref_id"):
        _artifact(req, pb.ARTIFACT_IMAGE, _png(seed=3), init=True,
                  uuid="u-1", id=5)
        mask = _artifact(req, pb.ARTIFACT_MASK)
        if case == "ref_uuid":
            mask.artifact.ref.uuid = "u-1"
        else:
            mask.artifact.ref.id = 5
    elif case == "schedule":
        img.parameters.add().schedule.start = 0.35
    elif case.startswith("masked_area_"):
        img.masked_area_init = getattr(pb, "MASKED_AREA_INIT_" +
                                       case[len("masked_area_"):].upper())
    elif case == "hires":
        img.hires.enable = True
        img.hires.oos_fraction = 0.4
    elif case == "hires_off":
        img.hires.enable = False
    elif case in ("tiling", "tiling_x", "tiling_y", "tiling_xy"):
        if case == "tiling":
            img.tiling = True
        img.tiling_x = case in ("tiling_x", "tiling_xy")
        img.tiling_y = case in ("tiling_y", "tiling_xy")
    return req


MODE_CASES = ["init_alpha", "init_opaque_and_mask", "depth", "ref_uuid",
              "ref_id", "schedule", "masked_area_zero", "masked_area_random",
              "masked_area_original", "hires", "hires_off", "tiling",
              "tiling_x", "tiling_y", "tiling_xy"]
MODE_FIELDS = ("strength", "masked_area_init", "hires_fix",
               "hires_oos_fraction", "tiling")


@pytest.mark.parametrize("case", MODE_CASES)
def test_mode_fields_extract_as_jax(case):
    t = tgen.extract_params(_mode_request(tpb, case))
    j = jgen.extract_params(_mode_request(jpb, case))
    assert [getattr(t, f) for f in MODE_FIELDS] == \
        [getattr(j, f) for f in MODE_FIELDS]
    for f in ("init_image", "mask_image", "depth_map"):
        a, b = getattr(t, f), getattr(j, f)
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a, b)
    assert [a.SerializeToString() for a in t.echo_artifacts] == \
        [a.SerializeToString() for a in j.echo_artifacts]


def test_generate_with_init_image_matches_jax_in_structure(port, ref):
    """img2img over Generate, its init image echoed back after the image,
    as the JAX servicer answers."""
    t = list(port.Generate(_mode_request(tpb, "init_alpha"), TContext()))
    j = list(ref.Generate(_mode_request(jpb, "init_alpha"), JContext()))
    assert _structure(t) == _structure(j)
    assert [a.artifacts[0].type for a in t] == [tpb.ARTIFACT_IMAGE] * 2
    assert t[1].artifacts[0].binary == _mode_request(
        tpb, "init_alpha").prompt[2].artifact.binary


def test_mode_fields_reach_the_pipeline(port, monkeypatch):
    """Init image, mask and depth map broadcast to the dispatcher's rows,
    and the strength, masked-area init, tiling and hires fields (the
    engine's `hires_fix:` option when the request sets none)."""
    seen = []

    def submit(pipe, kwargs, stop_event=None, solo=False):
        seen.append(kwargs)
        done = Future()
        done.set_result(np.zeros((len(kwargs["seeds"]), 64, 64, 3),
                                 np.uint8))
        return done

    monkeypatch.setattr(port.manager.dispatcher, "submit", submit)
    monkeypatch.setattr(port.manager.spec("tiny"), "options",
                        {"hires_fix": True})
    req = _mode_request(tpb, "init_opaque_and_mask")
    _artifact(req, tpb.ARTIFACT_DEPTH, _png(seed=4))
    req.image.samples = 3
    req.image.parameters.add().schedule.start = 0.5
    req.image.masked_area_init = tpb.MASKED_AREA_INIT_ZERO
    req.image.tiling_y = True
    assert len(list(port.Generate(req, TContext()))) == 3
    req.image.hires.enable = False
    list(port.Generate(req, TContext()))
    first = seen[0]
    assert [len(k["seeds"]) for k in seen] == [2, 1, 2, 1]   # batch_max 2
    for name, c in (("init_image", 3), ("mask_image", 1), ("depth_map", 1)):
        assert first[name].shape == (2, 64, 64, c)
    assert (first["strength"], first["masked_area_init"], first["tiling"],
            first["hires_fix"]) == (0.5, "zero", "y", True)
    assert seen[2]["hires_fix"] is False


@pytest.mark.parametrize("kind,item", [
    ("ARTIFACT_TOKEN_EMBEDDING", "C3"), ("adjusted", "D1"),
    ("ARTIFACT_LORA", "C3"), ("ARTIFACT_HINT_IMAGE", "C4")])
def test_artifact_prompts_name_their_item(kind, item):
    """The artifact prompts of the items ported since (LoRA and embedding
    artifacts, C3; hint images, C4; adjustment chains, D1) are extracted
    as the JAX servicer extracts them: an adjusted init image through each
    package's adjustments."""
    reqs = []
    for pb in (tpb, jpb):
        req = _request(pb)
        if kind == "adjusted":
            prompt = _artifact(req, pb.ARTIFACT_IMAGE, _png(), init=True)
            prompt.artifact.adjustments.add().invert.SetInParent()
        else:
            prompt = _artifact(req, getattr(pb, kind), _png())
            prompt.parameters.weight = 0.5
        reqs.append(req)
    if item == "D1":
        from gyre_tpu.services import adjustments as jadj
        from gyre_tpu_torch.services import adjustments as tadj

        got = tgen.extract_params(reqs[0], adjuster=lambda img, chain: (
            tadj.apply_image_adjustment(torch.from_numpy(img), chain)))
        want = jgen.extract_params(reqs[1], adjuster=lambda img, chain: (
            jadj.apply_image_adjustment(img, chain)))
        plain = tgen.extract_params(reqs[0])
        np.testing.assert_allclose(got.init_image, want.init_image,
                                   atol=1e-6)
        np.testing.assert_allclose(got.init_image, 1.0 - plain.init_image,
                                   atol=1e-6)
        return
    got, want = tgen.extract_params(reqs[0]), jgen.extract_params(reqs[1])
    for name in ("lora_artifacts", "ti_artifacts", "hint_images"):
        assert len(getattr(got, name)) == len(getattr(want, name))
    if item == "C4":
        (t, img, w, prio), = got.hint_images
        (jt, jimg, jw, jprio), = want.hint_images
        assert (t, w, prio) == (jt, jw, jprio)
        np.testing.assert_array_equal(img, jimg)


def test_webp_without_pillow_is_unimplemented(port, monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)
    context = TContext()
    with pytest.raises(TAbortError):
        list(port.Generate(_request(tpb, accept="image/webp"), context))
    assert context.code == grpc.StatusCode.UNIMPLEMENTED
    assert "Pillow" in context.details
    png = list(port.Generate(_request(tpb), TContext()))
    assert png[0].artifacts[0].binary.startswith(b"\x89PNG")


def test_debug_recorder_matches_jax(port, ref, tmp_path):
    stored = []
    for name, servicer, pb, ctx in (("port", port, tpb, TContext),
                                    ("jax", ref, jpb, JContext)):
        path = str(tmp_path / name)
        servicer.debug_recorder = DebugRecorder(path)
        try:
            list(servicer.Generate(_request(pb, 51), ctx()))
        finally:
            servicer.debug_recorder = None
        (f,) = os.listdir(path)
        with gzip.open(os.path.join(path, f), "rt") as fh:
            record = json.load(fh)
        record.pop("time")
        stored.append(record)
    assert stored[0] == stored[1] == {
        "label": "generate", "engine": "tiny", "request_id": "r51",
        "prompts": ["a boat", "blurry"]}


# ------------------------------------------------------- sampler knobs


def _knob_request(pb, churn=None, tmin=None, tmax=None, eta=None):
    req = _request(pb)
    req.image.transform.diffusion = pb.SAMPLER_K_HEUN
    s = req.image.parameters[0].sampler
    if churn is not None:
        s.churn.churn = churn
        if tmin is not None:
            s.churn.churn_tmin = tmin
        if tmax is not None:
            s.churn.churn_tmax = tmax
    if eta is not None:
        s.eta = eta
    return req


@pytest.mark.parametrize("knobs", [
    {}, {"churn": 0.5}, {"churn": 0.5, "tmin": 0.25, "tmax": 8.0},
    {"eta": 0.75}])
def test_sampler_knobs_extract_as_jax(knobs):
    t = tgen.extract_params(_knob_request(tpb, **knobs))
    j = jgen.extract_params(_knob_request(jpb, **knobs))
    fields = ("sampler", "eta", "churn", "churn_tmin", "churn_tmax")
    assert [getattr(t, f) for f in fields] == [getattr(j, f) for f in fields]
    assert t.sampler == "k_heun"
    assert t.churn == knobs.get("churn", 0.0)


def test_sampler_knobs_reach_the_pipeline(port, monkeypatch):
    """The request's eta and churn, or else the engine's `churn:` option,
    are what the dispatcher hands the pipeline; eta stays None when the
    request sets none, so the pipeline's default rule applies."""
    seen = []

    def submit(pipe, kwargs, stop_event=None, solo=False):
        seen.append(kwargs)
        done = Future()
        done.set_result(np.zeros((len(kwargs["seeds"]), 64, 64, 3),
                                 np.uint8))
        return done

    monkeypatch.setattr(port.manager.dispatcher, "submit", submit)
    monkeypatch.setattr(port.manager.spec("tiny"), "options",
                        {"churn": 0.3})
    for req in (_knob_request(tpb),
                _knob_request(tpb, churn=0.5, tmin=0.25, tmax=8.0,
                              eta=0.75)):
        assert len(list(port.Generate(req, TContext()))) == 1
    knobs = [(k["sampler"], k["eta"], k["churn"], k["churn_tmin"],
              k["churn_tmax"], k["noise_type"]) for k in seen]
    assert knobs == [("k_heun", None, 0.3, 0.0, 0.0, "normal"),
                     ("k_heun", 0.75, 0.5, 0.25, 8.0, "normal")]


def test_list_engines_matches_jax(port, ref):
    """ListEngines reports the same samplers with the same capabilities
    as the JAX servicer for the same engine: all 19 proto enums."""
    from gyre_tpu.generated import engines_pb2 as jepb
    from gyre_tpu.services.engines import EnginesServiceServicer as JEngines
    from gyre_tpu_torch.generated import engines_pb2 as tepb
    from gyre_tpu_torch.services.engines import \
        EnginesServiceServicer as TEngines

    (t,) = TEngines(port.manager).ListEngines(
        tepb.ListEnginesRequest(), TContext()).engine
    (j,) = JEngines(ref.manager).ListEngines(
        jepb.ListEnginesRequest(), JContext()).engine
    assert [s.SerializeToString() for s in t.supported_samplers] == \
        [s.SerializeToString() for s in j.supported_samplers]
    assert len(t.supported_samplers) == 19
