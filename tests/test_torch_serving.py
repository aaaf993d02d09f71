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


@pytest.mark.parametrize("mutate", ["sampler", "init_image", "tiling"])
def test_grpc_unported_features_are_unimplemented(channel, mutate):
    req = _request(sampler=pb.SAMPLER_K_EULER if mutate == "sampler"
                   else pb.SAMPLER_K_DPMPP_2M)
    if mutate == "init_image":
        art = req.prompt.add()
        art.artifact.type = pb.ARTIFACT_IMAGE
        art.artifact.binary = b"\x89PNG"
    elif mutate == "tiling":
        req.image.tiling = True
    with pytest.raises(grpc.RpcError) as err:
        list(_generate(channel)(req, timeout=60))
    assert err.value.code() == grpc.StatusCode.UNIMPLEMENTED


def test_grpc_list_engines(channel):
    call = channel.unary_unary(
        "/gooseai.EnginesService/ListEngines",
        request_serializer=epb.ListEnginesRequest.SerializeToString,
        response_deserializer=epb.Engines.FromString)
    engines = call(epb.ListEnginesRequest(), timeout=30).engine
    assert [e.id for e in engines] == ["tiny"]
    assert engines[0].ready
    assert pb.SAMPLER_K_DPMPP_2M in [s.sampler
                                     for s in engines[0].supported_samplers]
