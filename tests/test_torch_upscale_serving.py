"""The upscaler and background-removal engines through the port's
generate servicer on the CPU, in f32, against the JAX package's servicer
on the same checkpoints: client.py's ``-e <upscaler> -i <png>`` request to
an ESRGAN, a SwinIR and a HAT engine (the PNGs within one level: no noise
enters an upscale), a request to the background-removal engine (its RGBA
PNG within one level) and client.py's ``--hint_from_image nobg:depth:``
chain (background removal, the depth hint, the mask reapplied as alpha;
2e-3); a request with the Upscaler transform to an ESRGAN and to a
generate engine, answered as the JAX servicer answers it; ListEngines of
the upscale group (``client.py --list-upscalers``),
the sd-x4 diffusion upscaler among them, ready and answering;
then the SDXL base -> refiner -> ESRGAN ChainGenerate of
tests/test_sdxl_chain.py through the port alone (the JAX package's noise
differs by design), its one answer 4x the refined image and equal to the
port's ESRGAN pipeline applied to the refiner stage's output."""

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
from gyre_tpu_torch.generated import engines_pb2 as epb
from gyre_tpu_torch.generated import generation_pb2 as tpb
from gyre_tpu_torch.http.router import FakeGrpcContext as TContext
from gyre_tpu_torch.manager.manager import EngineManager as TManager
from gyre_tpu_torch.models import esrgan as te
from gyre_tpu_torch.models import hat as th
from gyre_tpu_torch.models import inspyrenet as ti
from gyre_tpu_torch.models import modelset as tms
from gyre_tpu_torch.models import swinir as ts
from gyre_tpu_torch.ops import images as timages
from gyre_tpu_torch.services import generate as tgen
from gyre_tpu_torch.services.engines import EnginesServiceServicer
from test_torch_adjustments import _client_request, _png
from test_torch_modes import one_torch_thread  # noqa: F401

LEVEL = 1.0 / 255 + 1e-6
IMG = np.random.default_rng(7).random((32, 24, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def servicers(tmp_path_factory):
    """Both packages' servicers over config/engines/utility.yaml's
    upscaler and background-removal engines, each on a checkpoint of the
    port's random model at a small width, written to disk."""
    root = tmp_path_factory.mktemp("up")
    states = {
        "esrgan-x4": te.state_dict_esrgan(te.random_esrgan(
            2, 1, device="cpu", nf=16, gc=8)),
        "swinir-x4": ts.state_dict_swinir(ts.random_swinir(
            ts.SwinIRConfig(embed_dim=16, depths=(2, 2), heads=(2, 2),
                            window=4, num_feat=8, upsampler="pixelshuffle"),
            2, device="cpu")),
        "hat-x4": th.state_dict_hat(th.random_hat(th.HAT_TEST, 3,
                                                  device="cpu")),
        "background-removal": ti.state_dict_inspyrenet(ti.random_inspyrenet(
            ti.SWIN_TEST, 8, 4, device="cpu"))}
    paths = {}
    for eid, state in states.items():
        paths[eid] = str(root / f"{eid}.safetensors")
        save_file({k: np.asarray(v) for k, v in state.items()}, paths[eid])
    engines = [
        {"id": "tiny", "default": True, "model": "preset/test"},
        {"id": "esrgan-x4", "task": "upscaler", "tile": 32,
         "model": paths["esrgan-x4"]},
        {"id": "swinir-x4", "task": "upscaler", "kind": "swinir",
         "tile": 16, "model": paths["swinir-x4"]},
        {"id": "hat-x4", "task": "upscaler", "kind": "hat", "tile": 16,
         "model": paths["hat-x4"]},
        {"id": "background-removal", "task": "background_removal",
         "model": paths["background-removal"]}]
    tm = TManager(engines + [{"id": "upscaler-x4", "task": "upscaler",
                              "kind": "sd-x4",
                              "model": "preset/upscaler-x4-test",
                              "steps": 2}],
                  device="cpu", compute_dtype=torch.float32)
    jm = JManager(engines, compute_dtype=jnp.float32)
    tm.load_engines()
    jm.load_engines()
    yield tgen.GenerationServiceServicer(tm), \
        jgen.GenerationServiceServicer(jm), tm, jm
    tm.dispatcher.stop()
    jm.dispatcher.stop()


def _image(answers):
    (answer,) = answers
    return timages.decode_png(answer.artifacts[0].binary)


@pytest.mark.parametrize("engine", ["esrgan-x4", "swinir-x4", "hat-x4"])
def test_upscale_route_matches_jax(servicers, engine, tmp_path,
                                   monkeypatch):
    """client.py's ``-e <engine> -i <png>``: one 4x PNG, the JAX
    servicer's within one level."""
    port, ref, _, _ = servicers
    jreq = _client_request(["-e", engine, "-i", _png(tmp_path / "i.png",
                                                     IMG)], monkeypatch)
    treq = tpb.Request.FromString(jreq.SerializeToString())
    got = _image(port.Generate(treq, TContext()))
    want = _image(ref.Generate(jreq, JContext()))
    assert got.shape == want.shape == (1, 128, 96, 3)
    assert np.abs(got - want).max() <= LEVEL
    assert got.std() > 1e-3


@pytest.mark.parametrize("engine", ["esrgan-x4", "tiny"])
def test_upscaler_transform_is_served_as_by_jax(servicers, engine):
    """A request that sets ``image.transform.upscaler`` (the protocol's
    other TransformType): the JAX servicer reads only the diffusion
    transform, so an ESRGAN engine is routed by its task (the 4x PNG) and a
    generate engine keeps its default sampler (the image, on the JAX
    engine's weights bridged into the port's, with the same seed); the
    port answers both as the JAX servicer does, not UNIMPLEMENTED."""
    import jax

    port, ref, tm, jm = servicers
    if engine == "tiny":
        jms_ = jm.modelset("tiny")
        tm._modelsets["tiny"] = tms.from_jax_params(
            jax.tree.map(np.asarray, jms_.unet_params),
            jax.tree.map(np.asarray, jms_.vae_params),
            [jax.tree.map(np.asarray, t) for t in jms_.text_params],
            jms_.config, device="cpu")
        tm._pipelines.pop("tiny", None)
        tm._views.pop("tiny", None)

    def request(pb):
        req = pb.Request(engine_id=engine, request_id="up")
        req.image.transform.upscaler = pb.UPSCALER_ESRGAN
        if engine == "tiny":
            req.prompt.add().text = "a boat"
            req.image.height = req.image.width = 64
            req.image.steps = 2
            req.image.seed.append(3)
        else:
            p = req.prompt.add()
            p.artifact.type = pb.ARTIFACT_IMAGE
            p.artifact.binary = timages.encode_png(IMG)
            p.parameters.init = True
        return req

    treq, jreq = request(tpb), request(jpb)
    assert tgen.extract_params(treq).sampler == \
        jgen.extract_params(jreq).sampler
    got = _image(port.Generate(treq, TContext()))
    want = _image(ref.Generate(jreq, JContext()))
    shape = (1, 64, 64, 3) if engine == "tiny" else (1, 128, 96, 3)
    assert got.shape == want.shape == shape
    assert np.abs(got - want).max() <= LEVEL
    assert got.std() > 1e-3


def test_background_removal_request_matches_jax(servicers):
    port, ref, _, _ = servicers

    def request(pb):
        req = pb.Request(engine_id="background-removal", request_id="bg")
        req.prompt.add().text = ""
        p = req.prompt.add()
        p.artifact.type = pb.ARTIFACT_IMAGE
        p.artifact.binary = timages.encode_png(IMG)
        p.parameters.init = True
        return req

    got = _image(port.Generate(request(tpb), TContext()))
    want = _image(ref.Generate(request(jpb), JContext()))
    assert got.shape == want.shape == (1, 32, 24, 4)
    assert np.abs(got - want).max() <= LEVEL
    assert got[..., 3].std() > 1e-3


def test_nobg_hint_matches_jax(servicers, tmp_path, monkeypatch):
    """``--hint_from_image nobg:depth:<png>``: the subject cut out (SOLID),
    its depth (no depth engine here: both packages' luminance proxy), the
    memorised mask reapplied as the hint's alpha."""
    port, _, _, jm = servicers
    jreq = _client_request(["--hint_from_image",
                            f"nobg:depth:{_png(tmp_path / 'h.png', IMG)}"],
                           monkeypatch)
    treq = tpb.Request.FromString(jreq.SerializeToString())
    chain = [a.WhichOneof("adjustment") for p in jreq.prompt
             if p.WhichOneof("prompt") == "artifact"
             for a in p.artifact.adjustments]
    assert chain == ["background_removal", "depth", "background_removal"]
    got = tgen.extract_params(treq, adjuster=port._adjuster(0))
    want = jgen.extract_params(jreq, adjuster=lambda img, c: (
        jadj.apply_image_adjustment(img, c, jm, None)))
    (t, img, _, _), = got.hint_images
    (jt, jimg, _, _), = want.hint_images
    assert t == jt == "depth"
    assert np.shape(img) == np.shape(jimg) == (1, 32, 24, 4)
    assert np.abs(np.asarray(img) - np.asarray(jimg)).max() <= 2e-3


def test_list_upscalers(servicers):
    """ListEngines of the UPSCALE group (``client.py --list-upscalers``):
    the image-space upscalers and the sd-x4 diffusion upscaler (ROADMAP
    D4b, not ready before it was ported) ready; the x4 engine answers
    client.py's ``-e upscaler-x4 -i`` with a PNG 4x the image."""
    port, _, tm, _ = servicers
    engines = EnginesServiceServicer(tm).ListEngines(
        epb.ListEnginesRequest(task_group=epb.UPSCALE), TContext()).engine
    assert {e.id: e.ready for e in engines} == {
        "esrgan-x4": True, "swinir-x4": True, "hat-x4": True,
        "upscaler-x4": True}
    req = tpb.Request(engine_id="upscaler-x4", request_id="x4")
    p = req.prompt.add()
    p.artifact.type = tpb.ARTIFACT_IMAGE
    p.artifact.binary = timages.encode_png(IMG)
    p.parameters.init = True
    img = _image(port.Generate(req, TContext()))
    assert img.shape == (1, 128, 96, 3) and img.std() > 1e-3


def _chain(stages, seed=11):
    chain = tpb.ChainRequest(request_id=f"xlchain-{seed}")
    for sid, engine, steps, start, target in stages:
        s = chain.stage.add()
        s.id = sid
        req = tpb.Request(engine_id=engine)
        req.prompt.add().text = "a castle"
        img = req.image
        img.height = img.width = 64
        img.steps, img.samples = steps, 1
        img.seed.append(seed)
        img.transform.diffusion = tpb.SAMPLER_K_EULER
        sp = img.parameters.add()
        sp.sampler.cfg_scale = 7.5
        if start is not None:
            sp.schedule.start = start
        s.request.CopyFrom(req)
        on = s.on_status.add()
        if target:
            on.action.append(tpb.STAGE_ACTION_PASS)
            on.target = target
        else:
            on.action.append(tpb.STAGE_ACTION_RETURN)
    return chain


def test_sdxl_base_refiner_upscale_chain():
    """tests/test_sdxl_chain.py's chain on the port: base -> refiner (the
    denoise tail from 0.34) -> ESRGAN; one 256x256 answer, equal (within
    one level) to the port's ESRGAN pipeline applied to what the refiner
    stage answers alone."""
    m = TManager([{"id": "xl-base", "model": "preset/test-xl",
                   "default": True},
                  {"id": "xl-refiner", "model": "preset/test-xl-refiner"},
                  {"id": "esrgan-up", "task": "upscaler", "blocks": 2,
                   "tile": 32}],
                 device="cpu", compute_dtype=torch.float32, batch_max=2)
    try:
        m.load_engines()
        gen = tgen.GenerationServiceServicer(m, batch_max=2)
        base = ("base", "xl-base", 3, None, "refine")
        answers = list(gen.ChainGenerate(_chain([
            base, ("refine", "xl-refiner", 3, 0.34, "upscale"),
            ("upscale", "esrgan-up", 2, None, None)]), TContext()))
        assert len(answers) == 1 and answers[0].answer_id.endswith("upscale")
        up = timages.decode_png(answers[0].artifacts[0].binary)
        refined = _image(gen.ChainGenerate(_chain([
            base, ("refine", "xl-refiner", 3, 0.34, None)]), TContext()))
        assert refined.shape == (1, 64, 64, 3)
        assert up.shape == (1, 256, 256, 3)
        want = m.task_pipeline("upscaler", "esrgan-up")(refined)
        want = timages.decode_png(timages.encode_png(want[0].numpy()))
        assert np.abs(up - want).max() <= LEVEL
        assert up.std() > 1e-3
    finally:
        m.dispatcher.stop()
