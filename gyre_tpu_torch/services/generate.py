"""GenerationService: the gRPC Generate surface.

Counterpart of gyre_tpu/services/generate.py. A Request carrying text
prompts (negative prompts as negative weights), image, mask and depth
artifacts (an init image's alpha as its mask; ``ref`` artifacts resolved
by uuid or id within the request), size, steps, samples, seeds, a sampler,
cfg_scale, eta, churn, sigma limits / karras rho, clip_layer, the
schedule's start (img2img strength), the masked-area init, the hires fix
and tiling runs through the shared dispatcher and streams one Answer per
image, as PNG or WebP by the request's accept list (``negotiate_mime``),
then the artifacts it asked to have echoed back. ChainGenerate runs its
stages with RETURN and PASS routing (a stage's images become the next
stage's init images), and the Async trio runs a request in the background,
as the JAX servicer does. Every other request feature (LoRA and embedding
artifacts, hint images, artifact adjustments, CLIP guidance) answers
UNIMPLEMENTED, naming its ROADMAP item; none is ignored silently. The
safety checker is not ported (ROADMAP C6): as the JAX package without
trained checker weights, nothing is flagged.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
import uuid as uuidlib
from concurrent.futures import CancelledError
from dataclasses import dataclass, field

import numpy as np

from ..generated import generation_pb2 as pb
from ..ops import images as I
from ..pipeline.samplers import PROTO_SAMPLERS
from ..utils.timing import STATS
from .exception_to_grpc import exception_to_grpc

logger = logging.getLogger(__name__)

MAX_SEED = 2 ** 32 - 1
# engine `options:` the port applies as request defaults, the sizes the
# manager's prewarm runs, and the engine the manager grafts on top
_ENGINE_OPTIONS = ("sampler", "karras_rho", "churn", "warmup_lms",
                   "ddim_cutoff", "hires_fix", "prewarm_sizes", "graft")


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
    churn: float = 0.0
    churn_tmin: float = 0.0
    churn_tmax: float = 0.0
    sigma_min: float | None = None
    sigma_max: float | None = None
    karras_rho: float | None = None
    noise_type: str = "normal"
    clip_layer: int = 0
    strength: float = 1.0
    init_image: np.ndarray | None = None
    mask_image: np.ndarray | None = None
    depth_map: np.ndarray | None = None
    masked_area_init: str = "shaped"
    hires_fix: bool | None = None
    hires_oos_fraction: float = 0.25
    tiling: bool | str = False
    echo_artifacts: list = field(default_factory=list)


# the ROADMAP item that ports each kind of artifact prompt not served yet
_ARTIFACT_ITEMS = {pb.ARTIFACT_LORA: "C3", pb.ARTIFACT_TOKEN_EMBEDDING: "C3",
                   pb.ARTIFACT_HINT_IMAGE: "C4"}


def _unported(feature: str, item: str | None = None):
    where = f" (ROADMAP {item})" if item else ""
    raise NotImplementedError(
        f"{feature} is not ported to gyre_tpu_torch yet{where}")


def extract_params(request: pb.Request) -> ExtractedParams:
    p = ExtractedParams(engine_id=request.engine_id,
                        request_id=request.request_id)

    def artifact_image(art, stage=pb.ARTIFACT_AFTER_ADJUSTMENTS, depth=0):
        """An artifact's image [1,H,W,C] in [0,1], following ``ref``
        artifacts (by uuid or id) within the request."""
        if depth > 8:
            raise ValueError("artifact reference chain too deep (cycle?)")
        # the stages that apply the artifact's own adjustment chains
        if (stage != pb.ARTIFACT_BEFORE_ADJUSTMENTS and
                len(art.adjustments)) or (
                stage == pb.ARTIFACT_AFTER_POSTADJUSTMENTS and
                len(art.postAdjustments)):
            _unported("artifact adjustments", "D1")
        if art.WhichOneof("data") != "ref":
            return I.decode_png(art.binary)
        want = art.ref.WhichOneof("reference")
        for other in request.prompt:
            if other.WhichOneof("prompt") != "artifact":
                continue
            o = other.artifact
            if (want == "uuid" and o.uuid == art.ref.uuid) or \
                    (want == "id" and o.id == art.ref.id):
                return artifact_image(o, art.ref.stage, depth + 1)
        raise ValueError(f"artifact reference {art.ref.uuid or art.ref.id!r}"
                         " matches no artifact in this request")

    pos, neg = [], []
    for prompt in request.prompt:
        which = prompt.WhichOneof("prompt")
        if which == "artifact":
            art = prompt.artifact
            if art.type == pb.ARTIFACT_IMAGE:
                img = artifact_image(art)
                p.init_image = img[..., :3]
                init = prompt.HasField("parameters") and \
                    prompt.parameters.init
                # an init image's alpha, where not opaque, is its mask
                if init and img.shape[-1] == 4 and \
                        (img[..., 3:] < 0.999).any():
                    p.mask_image = 1.0 - img[..., 3:]
                if prompt.echo_back:
                    p.echo_artifacts.append(art)
            elif art.type == pb.ARTIFACT_MASK:
                p.mask_image = artifact_image(
                    art, pb.ARTIFACT_AFTER_POSTADJUSTMENTS)[..., :1]
            elif art.type == pb.ARTIFACT_DEPTH:
                p.depth_map = artifact_image(art)[..., :1]
            else:
                _unported(f"{pb.ArtifactType.Name(art.type)} prompts",
                          _ARTIFACT_ITEMS.get(art.type))
            continue
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
        if sp.HasField("schedule") and sp.schedule.HasField("start"):
            p.strength = sp.schedule.start
        if sp.HasField("guidance"):
            _unported("CLIP guidance", "C6")
        if not sp.HasField("sampler"):
            continue
        s = sp.sampler
        if s.HasField("cfg_scale"):
            p.guidance_scale = s.cfg_scale
        if s.HasField("eta"):
            p.eta = s.eta
        if s.HasField("churn"):
            p.churn = s.churn.churn
            if s.churn.HasField("churn_tmin"):
                p.churn_tmin = s.churn.churn_tmin
            if s.churn.HasField("churn_tmax"):
                p.churn_tmax = s.churn.churn_tmax
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
        p.masked_area_init = {
            pb.MASKED_AREA_INIT_ZERO: "zero",
            pb.MASKED_AREA_INIT_RANDOM: "random",
            pb.MASKED_AREA_INIT_ORIGINAL: "original",
        }.get(img.masked_area_init, "shaped")
    if img.HasField("hires"):
        p.hires_fix = img.hires.enable
        if img.hires.HasField("oos_fraction"):
            p.hires_oos_fraction = img.hires.oos_fraction
    if img.tiling:
        p.tiling = True
    elif img.tiling_x or img.tiling_y:
        p.tiling = ("x" if img.tiling_x else "") + \
            ("y" if img.tiling_y else "")
    return p


def _rows(image, n: int):
    """A request's [1,H,W,C] image broadcast to n rows (a dispatcher
    batch of the request's seeds), or None."""
    if image is None:
        return None
    return np.broadcast_to(image, (n,) + image.shape[1:])


def fill_seeds(p: ExtractedParams) -> list[int]:
    """Extend the given seeds to `samples` (consecutive seeds)."""
    seeds = [s & MAX_SEED for s in p.seeds if s]
    if not seeds:
        seeds = [int(np.random.randint(0, MAX_SEED))]
    while len(seeds) < p.samples:
        seeds.append((seeds[-1] + 1) & MAX_SEED)
    return seeds[:p.samples]


def negotiate_mime(accept: str) -> str:
    """Request.accept (HTTP-style media-range list with optional q
    values) -> the answer mime type, image/png or image/webp; PNG when
    nothing matches."""
    if not accept:
        return "image/png"
    best, best_q = "image/png", 0.0
    for part in accept.split(","):
        fields = part.strip().split(";")
        media = fields[0].strip().lower()
        q = 1.0
        for f in fields[1:]:
            k, _, v = f.partition("=")
            if k.strip() == "q":
                try:
                    q = float(v)
                except ValueError:
                    q = 0.0
        for cand in ("image/png", "image/webp"):
            if media in (cand, "image/*", "*/*") and q > best_q:
                best, best_q = cand, q
    return best


def image_to_artifact(img: np.ndarray, *, index: int, seed: int,
                      metadata: dict | None = None,
                      mime: str = "image/png",
                      finish_reason=pb.NULL) -> pb.Artifact:
    data = I.encode_png(img, metadata) if mime == "image/png" else \
        I.encode_webp(img)
    return pb.Artifact(
        id=index, type=pb.ARTIFACT_IMAGE, mime=mime, index=index,
        seed=seed, uuid=str(uuidlib.uuid4()), binary=data, size=len(data),
        finish_reason=finish_reason)


class AsyncContext:
    """Bookkeeping of one AsyncGenerate request."""

    DEADLINE = 600.0

    def __init__(self):
        self.queue: queue.Queue = queue.Queue()
        self.stop_event = threading.Event()
        self.done = False
        self.deadline = None
        self.progress = ""  # human-readable status (AsyncStatus.message)

    def finish(self):
        self.done = True
        self.deadline = time.monotonic() + self.DEADLINE


class GenerationServiceServicer:
    def __init__(self, manager, batch_max: int = 4, debug_recorder=None):
        self.manager = manager
        self.batch_max = batch_max
        self.debug_recorder = debug_recorder
        self._async: dict[str, AsyncContext] = {}
        self._async_lock = threading.Lock()

    def _run_request(self, request: pb.Request, stop_event=None):
        """Yield (image uint8 [H,W,3], seed, index, metadata) for each
        image, then (artifact, None, index, None) for each artifact the
        request asked to have echoed back."""
        p = extract_params(request)
        engine_id = p.engine_id or self.manager.default_engine_id()
        opts = self.manager.spec(engine_id).options or {}
        unknown = sorted(set(opts) - set(_ENGINE_OPTIONS))
        if unknown:
            _unported(f"engine options {unknown}")
        if not p.sampler_set:
            p.sampler = opts.get("sampler", p.sampler)
        if p.karras_rho is None and "karras_rho" in opts:
            p.karras_rho = float(opts["karras_rho"])
        if not p.churn and "churn" in opts:
            p.churn = float(opts["churn"])
        if p.hires_fix is None and "hires_fix" in opts:
            p.hires_fix = bool(opts["hires_fix"])
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
                    churn=p.churn, churn_tmin=p.churn_tmin,
                    churn_tmax=p.churn_tmax,
                    karras_rho=p.karras_rho, sigma_min=p.sigma_min,
                    sigma_max=p.sigma_max, clip_layer=p.clip_layer,
                    noise_type=p.noise_type,
                    warmup_lms=bool(opts.get("warmup_lms", False)),
                    ddim_cutoff=float(opts.get("ddim_cutoff", 0.0)),
                    init_image=_rows(p.init_image, len(batch)),
                    mask_image=_rows(p.mask_image, len(batch)),
                    depth_map=_rows(p.depth_map, len(batch)),
                    strength=p.strength,
                    masked_area_init=p.masked_area_init, tiling=p.tiling,
                    hires_fix=p.hires_fix,
                    hires_oos_fraction=p.hires_oos_fraction,
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
            for art in p.echo_artifacts:
                yield art, None, index, None
                index += 1

    def _answers(self, request: pb.Request, stop_event):
        """The Answers of one request, one image each."""
        mime = negotiate_mime(request.accept)
        if mime == "image/webp":
            I.pil_image()          # before the card runs, not after
        if self.debug_recorder is not None:
            with self.debug_recorder.record("generate") as store:
                store.store("engine", request.engine_id)
                store.store("request_id", request.request_id)
                store.store("prompts", [p.text for p in request.prompt
                                        if p.WhichOneof("prompt") == "text"])
        recv = int(time.time())
        for item, seed, index, md in self._run_request(request, stop_event):
            if isinstance(item, pb.Artifact):        # echoed back
                artifact = item
            else:
                with STATS.timer("encode"):
                    artifact = image_to_artifact(item, index=index,
                                                 seed=seed, metadata=md,
                                                 mime=mime)
            yield pb.Answer(
                answer_id=f"{request.request_id}-{index}",
                request_id=request.request_id,
                received=recv, created=int(time.time()),
                artifacts=[artifact])

    @exception_to_grpc()
    def Generate(self, request: pb.Request, context):
        stop_event = threading.Event()
        if context is not None and hasattr(context, "add_callback"):
            context.add_callback(stop_event.set)
        yield from self._answers(request, stop_event)

    @exception_to_grpc()
    def ChainGenerate(self, request: pb.ChainRequest, context):
        """Staged generation with RETURN and PASS routing: a stage's
        artifacts are returned, or passed to its ``on_status`` targets as
        their init images."""
        stop_event = threading.Event()
        if context is not None and hasattr(context, "add_callback"):
            context.add_callback(stop_event.set)
        results: dict[str, list[pb.Artifact]] = {}
        for stage in request.stage:
            req = pb.Request()
            req.CopyFrom(stage.request)
            req.request_id = req.request_id or request.request_id
            for art in results.pop(stage.id, []):
                prompt = req.prompt.add()
                prompt.artifact.CopyFrom(art)
                prompt.parameters.init = True
            produced = []
            for answer in self._answers(req, stop_event):
                produced.extend(answer.artifacts)
            returned = []
            routed = False
            for on_status in stage.on_status:
                if pb.STAGE_ACTION_RETURN in on_status.action:
                    returned = produced
                if on_status.HasField("target"):
                    results.setdefault(on_status.target, []).extend(produced)
                    routed = True
            if not stage.on_status and not routed:
                returned = produced
            if returned:
                yield pb.Answer(request_id=request.request_id,
                                answer_id=f"{request.request_id}-{stage.id}",
                                artifacts=returned)

    @exception_to_grpc()
    def AsyncGenerate(self, request: pb.Request, context):
        """Start ``request`` in the background and return its handle. As in
        the JAX servicer, AsyncCancel stops the queueing of its answers;
        the request itself runs to its end."""
        ctx = AsyncContext()
        handle = str(uuidlib.uuid4())
        with self._async_lock:
            self._gc_async()
            self._async[handle] = ctx

        def run():
            try:
                n = 0
                for answer in self._answers(request, None):
                    if ctx.stop_event.is_set():
                        break
                    ctx.queue.put(answer)
                    n += 1
                    ctx.progress = f"{n} artifact(s) ready"
            except Exception as e:  # noqa: BLE001 - reported in the status
                logger.exception("async generate failed")
                ctx.progress = f"error: {e}"
            finally:
                ctx.finish()

        threading.Thread(target=run, daemon=True, name="async-generate"
                         ).start()
        return pb.AsyncHandle(request_id=request.request_id,
                              async_handle=handle)

    @exception_to_grpc()
    def AsyncResult(self, handle: pb.AsyncHandle, context):
        ctx = self._async.get(handle.async_handle)
        if ctx is None:
            raise KeyError(f"unknown async handle {handle.async_handle}")
        answers = []
        try:
            answers.append(ctx.queue.get(timeout=0.5))
            while True:
                answers.append(ctx.queue.get_nowait())
        except queue.Empty:
            pass
        complete = ctx.done and ctx.queue.empty()
        if complete:
            with self._async_lock:
                self._async.pop(handle.async_handle, None)
        out = pb.AsyncAnswer(answer=answers, complete=complete)
        if ctx.progress:
            out.status.message = ctx.progress
        return out

    @exception_to_grpc()
    def AsyncCancel(self, handle: pb.AsyncHandle, context):
        with self._async_lock:
            ctx = self._async.pop(handle.async_handle, None)
        if ctx is not None:
            ctx.stop_event.set()
        return pb.AsyncCancelAnswer()

    def _gc_async(self):
        """Drop finished requests past their deadline (under the lock)."""
        now = time.monotonic()
        for k in list(self._async):
            ctx = self._async[k]
            if ctx.done and ctx.deadline and now > ctx.deadline:
                del self._async[k]
