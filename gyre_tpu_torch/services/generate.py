"""GenerationService: the gRPC Generate surface, txt2img slice.

Counterpart of gyre_tpu/services/generate.py. A Request carrying text
prompts (negative prompts as negative weights), size, steps, samples,
seeds, a sampler, cfg_scale, eta, sigma limits / karras rho and clip_layer
runs through the shared dispatcher and streams one Answer with a PNG
artifact per image. Every other request feature (image, mask, LoRA,
embedding and hint artifacts, churn, schedule strength, CLIP guidance,
masked-area init, hires fix, tiling) and the ChainGenerate / Async methods
answer UNIMPLEMENTED; none is ignored silently. The safety checker is not
ported (the JAX package flags nothing without trained checker weights).
"""

from __future__ import annotations

import logging
import threading
import time
import uuid as uuidlib
from concurrent.futures import CancelledError
from dataclasses import dataclass, field

import numpy as np

from gyre_tpu.generated import generation_pb2 as pb
from gyre_tpu.services.exception_to_grpc import exception_to_grpc
from gyre_tpu.utils.timing import STATS

from ..ops import images as I
from ..pipeline.samplers import PROTO_SAMPLERS

logger = logging.getLogger(__name__)

MAX_SEED = 2 ** 32 - 1
# engine `options:` the port applies as request defaults
_ENGINE_OPTIONS = ("sampler", "karras_rho", "warmup_lms", "ddim_cutoff")


@dataclass
class ExtractedParams:
    engine_id: str = ""
    request_id: str = ""
    prompt: str = ""
    negative_prompt: str = ""
    height: int = 512
    width: int = 512
    steps: int = 50
    samples: int = 1
    seeds: list = field(default_factory=list)
    sampler: str = "k_dpmpp_2m"
    sampler_set: bool = False
    guidance_scale: float = 7.5
    eta: float | None = None
    sigma_min: float | None = None
    sigma_max: float | None = None
    karras_rho: float | None = None
    noise_type: str = "normal"
    clip_layer: int = 0


def _unported(feature: str):
    raise NotImplementedError(
        f"{feature} is not ported to gyre_tpu_torch yet (txt2img only)")


def extract_params(request: pb.Request) -> ExtractedParams:
    p = ExtractedParams(engine_id=request.engine_id,
                        request_id=request.request_id)
    pos, neg = [], []
    for prompt in request.prompt:
        which = prompt.WhichOneof("prompt")
        if which != "text":
            _unported(f"prompt {which or 'without content'}")
        weight = 1.0
        if prompt.HasField("parameters"):
            if prompt.parameters.HasField("weight"):
                weight = prompt.parameters.weight
            if prompt.parameters.HasField("clip_layer"):
                p.clip_layer = -int(prompt.parameters.clip_layer)
        if weight < 0:
            neg.append((prompt.text, -weight))
        else:
            pos.append((prompt.text, weight))

    def join(frags):
        return " ".join(t if w == 1.0 else f"({t}:{w:g})" for t, w in frags)

    p.prompt, p.negative_prompt = join(pos), join(neg)

    img = request.image
    if img.height:
        p.height = img.height
    if img.width:
        p.width = img.width
    if img.steps:
        p.steps = img.steps
    if img.samples:
        p.samples = img.samples
    p.seeds = list(img.seed)
    if img.HasField("transform"):
        if img.transform.WhichOneof("type") != "diffusion":
            _unported(f"transform {img.transform.WhichOneof('type')}")
        p.sampler = PROTO_SAMPLERS[img.transform.diffusion]
        p.sampler_set = True
    for sp in img.parameters:
        if sp.HasField("schedule"):
            _unported("schedule (img2img strength)")
        if sp.HasField("guidance"):
            _unported("CLIP guidance")
        if not sp.HasField("sampler"):
            continue
        s = sp.sampler
        if s.HasField("cfg_scale"):
            p.guidance_scale = s.cfg_scale
        if s.HasField("eta"):
            p.eta = s.eta
        if s.HasField("churn"):
            _unported("churn")
        if s.HasField("sigma"):
            if s.sigma.HasField("sigma_min"):
                p.sigma_min = s.sigma.sigma_min
            if s.sigma.HasField("sigma_max"):
                p.sigma_max = s.sigma.sigma_max
            if s.sigma.HasField("karras_rho"):
                p.karras_rho = s.sigma.karras_rho
        if s.HasField("noise_type"):
            p.noise_type = ("brownian" if s.noise_type ==
                            pb.SAMPLER_NOISE_BROWNIAN else "normal")
    if img.HasField("masked_area_init"):
        _unported("masked_area_init")
    if img.HasField("hires") and img.hires.enable:
        _unported("hires fix")
    if img.tiling or img.tiling_x or img.tiling_y:
        _unported("tiling")
    return p


def fill_seeds(p: ExtractedParams) -> list[int]:
    """Extend the given seeds to `samples` (consecutive seeds)."""
    seeds = [s & MAX_SEED for s in p.seeds if s]
    if not seeds:
        seeds = [int(np.random.randint(0, MAX_SEED))]
    while len(seeds) < p.samples:
        seeds.append((seeds[-1] + 1) & MAX_SEED)
    return seeds[:p.samples]


def image_to_artifact(img: np.ndarray, *, index: int, seed: int,
                      metadata: dict | None = None) -> pb.Artifact:
    data = I.encode_png(img, metadata)
    return pb.Artifact(
        id=index, type=pb.ARTIFACT_IMAGE, mime="image/png", index=index,
        seed=seed, uuid=str(uuidlib.uuid4()), binary=data, size=len(data),
        finish_reason=pb.NULL)


class GenerationServiceServicer:
    def __init__(self, manager, batch_max: int = 4):
        self.manager = manager
        self.batch_max = batch_max

    def _run_request(self, request: pb.Request, stop_event=None):
        """Yield (image uint8 [H,W,3], seed, index, metadata)."""
        p = extract_params(request)
        if request.accept and "image/png" not in request.accept and \
                "*" not in request.accept:
            _unported(f"answer type {request.accept!r} (PNG only)")
        engine_id = p.engine_id or self.manager.default_engine_id()
        opts = self.manager.spec(engine_id).options or {}
        unknown = sorted(set(opts) - set(_ENGINE_OPTIONS))
        if unknown:
            _unported(f"engine options {unknown}")
        if not p.sampler_set:
            p.sampler = opts.get("sampler", p.sampler)
        if p.karras_rho is None and "karras_rho" in opts:
            p.karras_rho = float(opts["karras_rho"])
        seeds = fill_seeds(p)
        meta = {"prompt": p.prompt, "negative_prompt": p.negative_prompt,
                "engine": engine_id, "sampler": p.sampler, "steps": p.steps,
                "cfg_scale": p.guidance_scale, "height": p.height,
                "width": p.width}
        with self.manager.with_engine(engine_id) as pipe:
            index = 0
            for i in range(0, len(seeds), self.batch_max):
                if stop_event is not None and stop_event.is_set():
                    return
                batch = seeds[i:i + self.batch_max]
                kwargs = dict(
                    prompt=p.prompt, negative_prompt=p.negative_prompt,
                    height=p.height, width=p.width, steps=p.steps,
                    sampler=p.sampler, seeds=batch,
                    guidance_scale=p.guidance_scale, eta=p.eta,
                    karras_rho=p.karras_rho, sigma_min=p.sigma_min,
                    sigma_max=p.sigma_max, clip_layer=p.clip_layer,
                    noise_type=p.noise_type,
                    warmup_lms=bool(opts.get("warmup_lms", False)),
                    ddim_cutoff=float(opts.get("ddim_cutoff", 0.0)),
                    output_dtype="uint8", stop_event=stop_event,
                    chunk_steps=10 if stop_event is not None else 0)
                try:
                    t0 = time.perf_counter()
                    imgs = self.manager.dispatcher.submit(
                        pipe, kwargs, stop_event).result()
                    STATS.record("generate", time.perf_counter() - t0)
                except CancelledError:
                    return
                if imgs is None:   # cancelled mid-request
                    return
                imgs = np.asarray(imgs)
                for j, seed in enumerate(batch):
                    md = {k: str(v) for k, v in
                          dict(meta, seed=seed, index=index).items()}
                    yield imgs[j], seed, index, md
                    index += 1

    @exception_to_grpc()
    def Generate(self, request: pb.Request, context):
        stop_event = threading.Event()
        if context is not None and hasattr(context, "add_callback"):
            context.add_callback(stop_event.set)
        recv = int(time.time())
        for img, seed, index, md in self._run_request(request, stop_event):
            with STATS.timer("encode"):
                artifact = image_to_artifact(img, index=index, seed=seed,
                                             metadata=md)
            yield pb.Answer(
                answer_id=f"{request.request_id}-{index}",
                request_id=request.request_id,
                received=recv, created=int(time.time()),
                artifacts=[artifact])

    @exception_to_grpc()
    def ChainGenerate(self, request, context):
        _unported("ChainGenerate")

    @exception_to_grpc()
    def AsyncGenerate(self, request, context):
        _unported("AsyncGenerate")

    @exception_to_grpc()
    def AsyncResult(self, request, context):
        _unported("AsyncResult")

    @exception_to_grpc()
    def AsyncCancel(self, request, context):
        _unported("AsyncCancel")
