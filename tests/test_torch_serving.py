"""The port's serving path on the CPU at the SD_TEST preset: EngineManager
with the shared coalescing dispatcher (gyre_tpu.manager.scheduler), and the
gRPC server answering Generate and ListEngines over a raw channel, as
client.py builds its requests.
"""

import threading

import grpc
import numpy as np
import pytest
import torch

from gyre_tpu.generated import engines_pb2 as epb
from gyre_tpu.generated import generation_pb2 as pb
from gyre_tpu_torch.manager.manager import EngineManager
from gyre_tpu_torch.server import build_server
from test_torch_modes import one_torch_thread  # noqa: F401

ENGINES = [{"id": "tiny", "default": True, "model": {"preset": "test"}}]
KW = dict(prompt="a boat", negative_prompt="", height=64, width=64, steps=4,
          sampler="k_dpmpp_2m", guidance_scale=7.5, output_dtype="uint8",
          chunk_steps=2)


@pytest.fixture(scope="module")
def manager():
    m = EngineManager(ENGINES, device="cpu", compute_dtype=torch.float32,
                      batch_max=4, gather_ms=300.0)
    m.load_engines()
    yield m
    m.dispatcher.stop()


@pytest.fixture(scope="module")
def channel(manager):
    server, port = build_server(manager, 0, host="localhost")
    ch = grpc.insecure_channel(f"localhost:{port}")
    yield ch
    ch.close()
    server.stop(0).wait()


def test_dispatcher_coalesces_concurrent_requests(manager):
    view = manager.dispatch_view("tiny")
    n = 3
    results = [None] * n

    def client(i):
        ev = threading.Event()
        results[i] = manager.dispatcher.submit(
            view, dict(KW, seeds=[10 + i], stop_event=ev), ev).result(120)

    threads = [threading.Thread(target=client, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(180)
    assert not any(t.is_alive() for t in threads)
    assert all(np.asarray(r).shape == (1, 64, 64, 3) and
               np.asarray(r).dtype == np.uint8 for r in results)
    assert (n, n) in manager.dispatcher.dispatched
    # each row is its own seed's image: the solo run of seed 11 agrees
    solo = np.asarray(view(**dict(KW, seeds=[11])))
    assert np.abs(solo.astype(int) - np.asarray(results[1]).astype(int)
                  ).max() <= 1


def _request(seed=7, sampler=pb.SAMPLER_K_DPMPP_2M):
    req = pb.Request(engine_id="tiny", request_id=f"r{seed}")
    req.prompt.add().text = "a boat"
    neg = req.prompt.add()
    neg.text = "blurry"
    neg.parameters.weight = -1.0
    img = req.image
    img.height, img.width, img.steps, img.samples = 64, 64, 4, 2
    img.seed.append(seed)
    img.transform.diffusion = sampler
    img.parameters.add().sampler.cfg_scale = 7.5
    return req


def _generate(channel):
    return channel.unary_stream(
        "/gooseai.GenerationService/Generate",
        request_serializer=pb.Request.SerializeToString,
        response_deserializer=pb.Answer.FromString)


def test_grpc_generate_returns_pngs(channel):
    answers = list(_generate(channel)(_request(), timeout=120))
    arts = [a for ans in answers for a in ans.artifacts]
    assert [a.seed for a in arts] == [7, 8]
    for a in arts:
        assert a.type == pb.ARTIFACT_IMAGE and a.mime == "image/png"
        assert a.binary.startswith(b"\x89PNG\r\n\x1a\n")


@pytest.mark.parametrize("sampler", sorted(pb.DiffusionSampler.values()))
def test_grpc_generate_every_sampler(channel, sampler):
    """Each proto sampler enum answers its PNG through the server and the
    dispatcher."""
    req = _request(seed=40 + sampler % 100, sampler=sampler)
    req.image.samples = 1
    arts = [a for ans in _generate(channel)(req, timeout=120)
            for a in ans.artifacts]
    assert len(arts) == 1 and arts[0].mime == "image/png"
    assert arts[0].binary.startswith(b"\x89PNG\r\n\x1a\n")


@pytest.mark.parametrize("mutate,item", [
    ("lora", "C3"), ("hint_image", "C4"), ("clip_guidance", "C6")])
def test_grpc_unported_features_are_unimplemented(channel, mutate, item):
    """A feature not ported yet answers UNIMPLEMENTED naming its ROADMAP
    item. LoRA artifacts (C3) and hint images (C4) are served since: a
    LoRA whose bytes are no safetensors file is skipped, as in the JAX
    servicer, and a hint image of a type no hintset names is skipped with
    a warning; each request answers its PNG."""
    req = _request()
    if mutate in ("lora", "hint_image"):
        art = req.prompt.add()
        art.artifact.type = pb.ARTIFACT_LORA if mutate == "lora" \
            else pb.ARTIFACT_HINT_IMAGE
        art.artifact.binary = b"\x89PNG"
        if mutate == "hint_image":
            from gyre_tpu_torch.ops.images import encode_png

            art.artifact.hint_image_type = "canny"
            art.artifact.binary = encode_png(np.zeros((64, 64, 3),
                                                      np.uint8))
        arts = [a for ans in _generate(channel)(req, timeout=120)
                for a in ans.artifacts]
        assert len(arts) == 2 and arts[0].mime == "image/png"
        return
    req.image.parameters.add().guidance.guidance_preset = \
        pb.GUIDANCE_PRESET_SIMPLE
    with pytest.raises(grpc.RpcError) as err:
        list(_generate(channel)(req, timeout=60))
    assert err.value.code() == grpc.StatusCode.UNIMPLEMENTED
    assert f"ROADMAP {item}" in err.value.details()


def test_grpc_list_engines(channel):
    call = channel.unary_unary(
        "/gooseai.EnginesService/ListEngines",
        request_serializer=epb.ListEnginesRequest.SerializeToString,
        response_deserializer=epb.Engines.FromString)
    engines = call(epb.ListEnginesRequest(), timeout=30).engine
    assert [e.id for e in engines] == ["tiny"]
    assert engines[0].ready
    listed = [s.sampler for s in engines[0].supported_samplers]
    assert listed == list(pb.DiffusionSampler.values())     # all 19
    assert len(listed) == 19
