"""SD2, SDXL and the SDXL refiner through the port's serving path on the
CPU, at the test presets: the shipped engine templates
(config/templates/stable-diffusion.yaml) build engines that are ready,
from a preset and from a diffusers directory; a request without a size
takes the engine's natural one; and ChainGenerate runs base -> refiner
(PASS routing, the refiner an img2img stage at schedule.start 0.34) ->
RETURN, as tests/test_sdxl_chain.py does for the JAX package without its
ESRGAN stage (ROADMAP D4).
"""

import os
import threading

import numpy as np
import pytest
import torch

from gyre_tpu_torch.generated import generation_pb2 as pb
from gyre_tpu_torch.http.router import FakeGrpcContext
from gyre_tpu_torch.manager import engines_yaml
from gyre_tpu_torch.manager.manager import EngineManager
from gyre_tpu_torch.manager.weights import WeightResolver
from gyre_tpu_torch.models import configs
from gyre_tpu_torch.models import load as tload
from gyre_tpu_torch.models import modelset as tms
from gyre_tpu_torch.ops import images as I
from gyre_tpu_torch.services.generate import GenerationServiceServicer
from test_torch_manager import _ready_by_rpc_and_status
from test_torch_modes import one_torch_thread  # noqa: F401
from test_torch_sd2 import sd2_test

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def manager(tmp_path_factory):
    """Engines on the shipped templates: sd21-template over an SD2-topology
    checkpoint on disk, sdxl-template over the test-xl preset (the
    default), and a preset/test-xl-refiner engine."""
    root = tmp_path_factory.mktemp("weights")
    tload.save_modelset(tms.random_modelset(
        sd2_test(configs), seed=1, dtype=torch.float32, device="cpu"),
        str(root / "org--tiny-sd2"))
    cfg = root / "engines.yaml"
    tmpl = os.path.join(REPO, "config", "templates", "stable-diffusion.yaml")
    cfg.write_text(
        f"- !include {tmpl}\n"
        "- {id: sd2, template: sd21-template, params: {model: org/tiny-sd2}}\n"
        "- {id: xl, template: sdxl-template, default: true,\n"
        "   params: {model: preset/test-xl}}\n"
        "- {id: xl-refiner, model: preset/test-xl-refiner}\n")
    m = EngineManager(engines_yaml.load(str(cfg), {}), device="cpu",
                      compute_dtype=torch.float32, batch_max=2,
                      gather_ms=0.0,
                      weight_resolver=WeightResolver(local_dirs=[str(root)]))
    m.load_engines()
    yield m
    m.dispatcher.stop()


@pytest.fixture(scope="module")
def generation(manager):
    return GenerationServiceServicer(manager, batch_max=2)


def test_templates_build_ready_engines(manager):
    listed, status = _ready_by_rpc_and_status(manager)
    assert listed == status == {"sd2": True, "xl": True, "xl-refiner": True}
    assert {s["id"]: s["weights"] for s in manager.status()} == {
        "sd2": "real", "xl": "random", "xl-refiner": "random"}
    sd2 = manager.modelset("sd2")
    assert sd2.config.unet.linear_projection
    assert sd2.schedule.prediction_type == "v_prediction"
    assert len(manager.modelset("xl").config.text_encoders) == 2
    assert manager.modelset("xl-refiner").config.unet.addition_time_ids == 5
    assert manager.spec("xl").options == {"sampler": "k_euler"}
    assert manager.natural_size("xl") == 64       # test-xl: 8 latents


def _request(engine, seed=11, steps=2, start=None, size=64):
    req = pb.Request(engine_id=engine, request_id=f"r{seed}")
    req.prompt.add().text = "a castle"
    img = req.image
    if size:
        img.height = img.width = size
    img.steps, img.samples = steps, 1
    img.seed.append(seed)
    img.transform.diffusion = pb.SAMPLER_K_EULER
    sp = img.parameters.add()
    sp.sampler.cfg_scale = 7.5
    if start is not None:
        sp.schedule.start = start
    return req


def _images(answers):
    return [I.decode_png(a.binary) for ans in answers for a in ans.artifacts
            if a.type == pb.ARTIFACT_IMAGE]


@pytest.mark.parametrize("engine", ["sd2", "xl", "xl-refiner"])
def test_generate_at_the_natural_size(generation, engine):
    """A request without a size answers at the engine's natural size."""
    (img,) = _images(generation.Generate(_request(engine, size=0),
                                         FakeGrpcContext()))
    assert img.shape == (1, 64, 64, 3) and np.isfinite(img).all()
    assert img.std() > 0


def _chain(seed=11):
    chain = pb.ChainRequest(request_id=f"xlchain-{seed}")
    for sid, engine, start, target in (("base", "xl", None, "refine"),
                                       ("refine", "xl-refiner", 0.34, None)):
        stage = chain.stage.add()
        stage.id = sid
        stage.request.CopyFrom(_request(engine, seed, 3, start))
        on = stage.on_status.add()
        if target:
            on.action.append(pb.STAGE_ACTION_PASS)
            on.target = target
        else:
            on.action.append(pb.STAGE_ACTION_RETURN)
    return chain


def test_base_refiner_chain(generation, manager):
    """The base's image reaches the refiner as its init image: the chain's
    answer differs from the refiner's txt2img of the same seed."""
    answers = list(generation.ChainGenerate(_chain(), FakeGrpcContext()))
    assert len(answers) == 1 and answers[0].answer_id.endswith("refine")
    (img,) = _images(answers)
    assert img.shape == (1, 64, 64, 3) and np.isfinite(img).all()
    (alone,) = _images(generation.Generate(_request("xl-refiner", 11, 3),
                                           FakeGrpcContext()))
    assert np.abs(img - alone).max() > 1e-2


def test_refiner_uses_aesthetic_time_ids(manager):
    """The refiner's 5 ids take the aesthetic scores (6.0 guided, 2.5
    unguided), and its denoise differs from the base's."""
    pipe = manager.pipeline("xl-refiner")
    added_u, added_g = pipe._added_cond("a castle", "", 1, True, 64, 64)
    assert added_g["time_ids"].tolist() == [[64, 64, 0, 0, 6.0]]
    assert added_u["time_ids"].tolist() == [[64, 64, 0, 0, 2.5]]
    kw = dict(prompt="a castle", height=64, width=64, steps=2,
              sampler="k_euler", seeds=[3], guidance_scale=7.5)
    out = pipe(**kw)
    assert bool(out.isfinite().all())
    assert float((out - manager.pipeline("xl")(**kw)).abs().max()) > 1e-3


def test_chain_concurrent_clients(generation):
    """Two chains in flight at once both complete with their own images."""
    results = {}

    def run(seed):
        answers = list(generation.ChainGenerate(_chain(seed),
                                                FakeGrpcContext()))
        results[seed] = _images(answers)[0]

    threads = [threading.Thread(target=run, args=(s,)) for s in (21, 22)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert set(results) == {21, 22}
    assert all(img.shape == (1, 64, 64, 3) for img in results.values())
    assert np.abs(results[21] - results[22]).max() > 1e-4


def test_size_ids_reach_the_unet(manager):
    """The same request with only its size time ids replaced gives
    another image."""
    pipe = manager.pipeline("xl")
    kw = dict(prompt="a castle", height=64, width=64, steps=2,
              sampler="k_euler", seeds=[3], guidance_scale=7.5)
    a = pipe(**kw)
    orig = pipe._added_cond

    def other_size(*args):
        return orig(*args[:4], 128, 96)

    pipe._added_cond = other_size
    try:
        b = pipe(**kw)
    finally:
        del pipe._added_cond
    assert float((a - b).abs().max()) > 1e-4
