"""The system under test, as the benchmark builds and drives it: the
port's ModelSet loaded through its own key maps from the benchmark's
weights, one EngineManager with the cell's engine, the gRPC server in front
of it, and the pipeline's chunks recorded at the dispatcher's boundary.

This module and each family's ``serve`` (``families/<family>.py``, which
builds the served model set) are the benchmark's only imports of
``gyre_tpu_torch``.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import torch

from . import family


class Chunk(NamedTuple):
    """One chunk the dispatcher ran: "steps" (UNet calls ``first`` to
    ``end``; a batch's first, from step 0, also encodes its prompts) or
    "decode", at the rows and image size of its batch as run."""

    kind: str
    rows: int
    pad: int
    first: int
    end: int
    height: int
    width: int
    t0: float
    t1: float
    traced: bool


class ChunkLog:
    """What the dispatcher ran of the engine's pipeline, chunk by chunk
    (``Chunk``). Appended on the dispatcher's thread only."""

    def __init__(self):
        self.entries: list[Chunk] = []
        self.tracing = False


class RecordingView:
    """The engine's DispatchView with each chunk of its generator logged
    (``ChunkLog``); the dispatcher coalesces by this one object."""

    def __init__(self, view, dispatcher, log: ChunkLog):
        self.view, self.dispatcher, self.log = view, dispatcher, log
        self._padded = dispatcher.padded_rows

    def begin(self, **kwargs):
        # the dispatcher pads a merged batch just before begin()
        pad = self.dispatcher.padded_rows - self._padded
        self._padded = self.dispatcher.padded_rows
        rows = len(kwargs.get("seeds") or [1])
        size = (kwargs["height"], kwargs["width"])
        gen = self.view.begin(**kwargs)
        done = 0
        while True:
            t0 = time.perf_counter()
            try:
                step = next(gen)
            except StopIteration as stop:
                self.log.entries.append(Chunk(
                    "decode", rows, pad, done, done, *size, t0,
                    time.perf_counter(), self.log.tracing))
                return stop.value
            self.log.entries.append(Chunk(
                "steps", rows, pad, done, step[0], *size, t0,
                time.perf_counter(), self.log.tracing))
            done = step[0]
            yield step

    def __call__(self, **kwargs):
        return self.view(**kwargs)


class System:
    """One engine behind the gRPC server, ready for traffic."""

    def __init__(self, config: dict, workload: dict, state: dict, device,
                 engine_id: str):
        from gyre_tpu_torch.manager.manager import EngineManager

        srv = workload["server"]
        dtype = getattr(torch, config["serving"]["dtype"])
        self.engine_id = engine_id
        self.manager = EngineManager(
            [{"id": engine_id, "default": True,
              "model": {"preset": config["preset"]}}],
            device=device, compute_dtype=dtype,
            batch_max=int(srv["batch_max"]),
            interleave=int(srv.get("interleave", 2)),
            gather_ms=float(srv.get("gather_ms", 10.0)))
        # the manager has no public seam for a ready ModelSet: it is placed
        # where modelset() caches what it builds
        self.manager._modelsets[engine_id] = family.code(config).serve(
            config, state, device, dtype, engine_id)
        self.dispatcher = self.manager.dispatcher
        self.log = ChunkLog()
        view = self.manager.dispatch_view(engine_id)
        self.manager._views[engine_id] = RecordingView(
            view, self.dispatcher, self.log)
        self.server = None

    def prewarm(self, height: int, width: int, steps: int):
        """The server's own warm-up at the cell's size and steps: one
        request of 1 row, then the dispatcher's max batch."""
        self.manager.prewarm(self.engine_id, height=height, width=width,
                             steps=steps, buckets=True)

    def start(self, workers: int) -> int:
        from gyre_tpu_torch.server import build_server

        self.server, port = build_server(
            self.manager, 0, batch_max=int(self.dispatcher.max_batch),
            host="localhost", workers=workers)
        return port

    def on_dispatcher(self, fn):
        """Run ``fn`` on the dispatcher's thread between two chunks (a
        solo job), and wait for it."""
        self.dispatcher.submit(fn, {}, solo=True).result()

    def stats(self) -> dict:
        from gyre_tpu_torch.utils.timing import STATS

        return STATS.summary()

    def launches(self) -> dict:
        from gyre_tpu_torch import _build

        return dict(_build.launches)

    def close(self):
        if self.server is not None:
            self.server.stop(0).wait()
            self.server = None
        self.dispatcher.stop()
        self.dispatcher._thread.join(timeout=60)
        self.manager = None


def client_stub(port: int):
    """(channel, Generate callable, ListEngines callable) of a new gRPC
    channel to the server."""
    import grpc

    from gyre_tpu_torch.generated import engines_pb2 as epb
    from gyre_tpu_torch.generated import generation_pb2 as pb

    channel = grpc.insecure_channel(
        f"localhost:{port}",
        options=[("grpc.max_receive_message_length", 256 * 1024 * 1024)])
    generate = channel.unary_stream(
        "/gooseai.GenerationService/Generate",
        request_serializer=pb.Request.SerializeToString,
        response_deserializer=pb.Answer.FromString)
    engines = channel.unary_unary(
        "/gooseai.EnginesService/ListEngines",
        request_serializer=epb.ListEnginesRequest.SerializeToString,
        response_deserializer=epb.Engines.FromString)
    return channel, generate, lambda: engines(epb.ListEnginesRequest(),
                                              timeout=60)


def request_proto(req: dict, engine_id: str, request_id: str):
    """A gooseai Request for one txt2img request of the traffic mix."""
    from gyre_tpu_torch.generated import generation_pb2 as pb
    from gyre_tpu_torch.pipeline.samplers import PROTO_SAMPLERS

    r = pb.Request(engine_id=engine_id, request_id=request_id,
                   accept="image/png")
    r.prompt.add().text = req["prompt"]
    if req["negative_prompt"]:
        neg = r.prompt.add()
        neg.text = req["negative_prompt"]
        neg.parameters.weight = -1.0
    img = r.image
    img.height, img.width = req["height"], req["width"]
    img.steps, img.samples = req["steps"], 1
    img.seed.append(req["seed"])
    img.transform.diffusion = next(k for k, v in PROTO_SAMPLERS.items()
                                   if v == req["sampler"])
    img.parameters.add().sampler.cfg_scale = req["cfg_scale"]
    return r


def image_bytes(answers) -> list[bytes]:
    from gyre_tpu_torch.generated import generation_pb2 as pb

    return [a.binary for ans in answers for a in ans.artifacts
            if a.type == pb.ARTIFACT_IMAGE]

