"""GenerationService: the gRPC Generate surface.

Counterpart of gyre_tpu/services/generate.py. A Request carrying text
prompts (negative prompts as negative weights), image, mask and depth
artifacts (an init image's alpha as its mask; ``ref`` artifacts resolved
by uuid or id within the request), size, steps, samples, seeds, a sampler,
cfg_scale, eta, churn, sigma limits / karras rho, clip_layer (the
prompt's ``clip_layer`` n as layer -n; unset, the engine's own), the
schedule's start (img2img strength), the masked-area init, the hires fix
and tiling runs through the shared dispatcher (at the engine's natural
size where the request sets none) and streams one Answer per
image, as PNG or WebP by the request's accept list (``negotiate_mime``),
then the artifacts it asked to have echoed back. LoRA and token-embedding
artifacts (weights, ``named_weights``, ``token_overrides``) fold into an
adapted view of the engine; their weights come as safetensors (raw bytes,
or the Safetensors, LoRA and TokenEmbedding messages), from the artifact
cache (``cache_control`` stores an upload under its ``cache_id``, a
``cache_id`` artifact fetches it, a miss is FAILED_PRECONDITION) or by
``url`` through the server's ResourceProvider. Hint images, rescaled to
the request's size, condition it through the engine's hintset
(``hint_priority``). ChainGenerate runs its stages with RETURN and PASS
routing (a stage's images become the next stage's init images), and the
Async trio runs a request in the background, as the JAX servicer does.
Every other request feature (artifact adjustments, CLIP guidance) answers
UNIMPLEMENTED, naming its ROADMAP item; none is ignored silently. The
safety checker is not ported (ROADMAP C6): as the JAX package without
trained checker weights, nothing is flagged.
"""

from __future__ import annotations

import hashlib
import logging
import queue
import threading
import time
import uuid as uuidlib
from concurrent.futures import CancelledError
from dataclasses import dataclass, field

import numpy as np
import torch

from ..generated import generation_pb2 as pb
from ..generated import tensors_pb2 as tpb
from ..ops import images as I
from ..pipeline.samplers import PROTO_SAMPLERS
from ..utils.timing import STATS
from .exception_to_grpc import CacheKeyError, exception_to_grpc

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
    height: int | None = None           # None: the engine's natural size
    width: int | None = None
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
    lora_artifacts: list = field(default_factory=list)
    ti_artifacts: list = field(default_factory=list)
    hint_images: list = field(default_factory=list)


_HINT_PRIORITIES = {pb.HINT_BALANCED: "balanced",
                    pb.HINT_PRIORITISE_HINT: "hint",
                    pb.HINT_PRIORITISE_PROMPT: "prompt"}


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
        params = prompt.parameters if prompt.HasField("parameters") else None
        weight = 1.0
        if params is not None and params.HasField("weight"):
            weight = params.weight
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
            elif art.type == pb.ARTIFACT_LORA:
                # per-model weights: '*' from the weight field, overridden
                # by named_weights entries
                weights = {}
                if params is not None:
                    if params.HasField("weight"):
                        weights["*"] = params.weight
                    for nw in params.named_weights:
                        weights[nw.name] = nw.weight
                p.lora_artifacts.append((art, weights or weight))
            elif art.type == pb.ARTIFACT_TOKEN_EMBEDDING:
                # token_overrides rename the embedding's tokens: named ones
                # match original_token, free ones take tokens in order
                overrides = tuple(
                    (ov.original_token if ov.HasField("original_token")
                     else None, ov.token)
                    for ov in (params.token_overrides if params else ()))
                p.ti_artifacts.append((art, overrides))
            elif art.type == pb.ARTIFACT_HINT_IMAGE:
                priority = "balanced"
                if params is not None and params.HasField("hint_priority"):
                    priority = _HINT_PRIORITIES[params.hint_priority]
                p.hint_images.append((art.hint_image_type,
                                      artifact_image(art), weight, priority))
            else:
                _unported(f"{pb.ArtifactType.Name(art.type)} prompts")
            continue
        if which != "text":
            _unported(f"prompt {which or 'without content'}")
        if params is not None and params.HasField("clip_layer"):
            p.clip_layer = -int(params.clip_layer)
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


def _proto_tensor(t) -> np.ndarray:
    """A tensors.Tensor message as a numpy array (bf16 widened to f32)."""
    dtypes = {tpb.DT_FLOAT32: np.float32, tpb.DT_FLOAT16: np.float16,
              tpb.DT_FLOAT64: np.float64, tpb.DT_INT32: np.int32,
              tpb.DT_INT64: np.int64, tpb.DT_UINT8: np.uint8}
    if t.dtype == tpb.DT_BFLOAT16:
        raw = np.frombuffer(t.data, dtype=np.uint16).astype(np.uint32) << 16
        arr = raw.view(np.float32)
    else:
        arr = np.frombuffer(t.data, dtype=dtypes.get(t.dtype, np.float32))
    return arr.reshape(list(t.shape))


def _proto_safetensors(st) -> dict:
    return {e.key: _proto_tensor(e.tensor) for e in st.tensors}


def _safetensors_from_bytes(data: bytes) -> dict:
    """A safetensors file's bytes -> {name: CPU tensor}."""
    from safetensors.torch import load

    return load(bytes(data))


def _artifact_safetensors(art) -> dict | None:
    """A weight artifact's state dict: raw safetensors bytes in
    ``binary``, or the Safetensors, LoRA and TokenEmbedding messages;
    None (logged) where ``binary`` does not parse."""
    which = art.WhichOneof("data")
    if which == "safetensors":
        return _proto_safetensors(art.safetensors)
    if which == "lora":
        return _proto_safetensors(art.lora.lora)
    if which == "token_embedding":
        return {art.token_embedding.text:
                _proto_tensor(art.token_embedding.tensor)}
    if which == "binary" and art.binary:
        try:
            return _safetensors_from_bytes(art.binary)
        except Exception:  # noqa: BLE001 - logged, the artifact is skipped
            logger.warning("could not parse weight artifact")
    return None


def state_digest(state: dict) -> str:
    """A digest of a state dict's names, dtypes, shapes and bytes: the
    cache key of the adapter it holds, one for a content whether its
    values are numpy arrays or tensors (the transports give either)."""
    h = hashlib.blake2b(digest_size=16)
    for key in sorted(state):
        v = state[key]
        if hasattr(v, "detach"):
            v = v.detach().cpu().contiguous()
            dtype = str(v.dtype).removeprefix("torch.")
            data = v.view(-1).view(torch.uint8).numpy().tobytes()
        else:
            v = np.asarray(v)
            dtype, data = str(v.dtype), v.tobytes()     # C order
        h.update(f"{key}|{dtype}|{tuple(v.shape)}|".encode())
        h.update(data)
    return h.hexdigest()


def rename_embeddings(state: dict, overrides) -> dict:
    """A TI state's embeddings under the tokens of ``overrides``
    ((original token or None, token) pairs): a named override renames its
    original token, free ones rename the remaining tokens in order."""
    from ..pipeline.lora import extract_ti_embeddings

    named = {orig: tok for orig, tok in overrides if orig is not None}
    free = [tok for orig, tok in overrides if orig is None]
    renamed = {}
    for key, tensor in extract_ti_embeddings(state).items():
        if key in named:
            renamed[named[key]] = tensor
        elif free:
            renamed[free.pop(0)] = tensor
        else:
            renamed[key] = tensor
    return renamed


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
    def __init__(self, manager, batch_max: int = 4, debug_recorder=None,
                 resource_cache=None):
        self.manager = manager
        self.batch_max = batch_max
        self.debug_recorder = debug_recorder
        self.resource_cache = resource_cache
        self._async: dict[str, AsyncContext] = {}
        self._async_lock = threading.Lock()

    def _artifact_state(self, art) -> dict | None:
        """A weight artifact's state dict, through the artifact cache: an
        upload with ``cache_control.cache_id`` is stored under it for
        ``max_age`` seconds (1 h when unset), and an artifact whose data
        is a ``cache_id`` fetches it (a miss raises CacheKeyError:
        FAILED_PRECONDITION, re-upload). A ``url`` artifact is fetched
        through the manager's ResourceProvider."""
        which = art.WhichOneof("data")
        if which == "cache_id":
            state = None if self.resource_cache is None else \
                self.resource_cache.get("generation:" + art.cache_id)
            if state is None:
                raise CacheKeyError(art.cache_id)
            return state
        if which == "url":
            provider = getattr(self.manager, "resources", None)
            if provider is None:
                raise ValueError(
                    "url artifacts need a resource provider (server "
                    "--local_resource / --allow_network_resources)")
            rtype = "lora" if art.type == pb.ARTIFACT_LORA else "embedding"
            state = _safetensors_from_bytes(
                provider.fetch(art.url, rtype=rtype, fmt="safetensors"))
        else:
            state = _artifact_safetensors(art)
        if (state and self.resource_cache is not None and
                art.HasField("cache_control") and
                art.cache_control.cache_id):
            self.resource_cache.set(
                "generation:" + art.cache_control.cache_id, state,
                ttl=float(art.cache_control.max_age or 3600))
        return state

    def _adapters(self, p: ExtractedParams):
        """(loras, tis) of a request for EngineManager.adapted_pipeline,
        each keyed by a digest of its content."""
        loras = []
        for art, weight in p.lora_artifacts:
            state = self._artifact_state(art)
            if state:
                loras.append((state, weight, state_digest(state)))
        tis = []
        for art, overrides in p.ti_artifacts:
            state = self._artifact_state(art)
            if state:
                if overrides:
                    state = rename_embeddings(state, overrides)
                tis.append((state, state_digest(state)))
        return loras, tis

    def _hints(self, p: ExtractedParams, engine_id: str) -> list:
        """The request's hints for UnifiedPipeline: each hint image
        rescaled to the request's size (lanczos3, cover) and conditioned
        through the engine's hint model for its type (a type no hintset
        names is skipped)."""
        hints = []
        for hint_type, img, weight, priority in p.hint_images:
            model = self.manager.hint_model(hint_type, engine_id)
            if model is None:
                continue
            if img.shape[1:3] != (p.height, p.width):
                img = I.rescale(torch.from_numpy(np.ascontiguousarray(img)),
                                p.height, p.width).numpy()
            hints.append({"params": model["params"], "kind": model["kind"],
                          "image": img[..., :3], "scale": weight,
                          "soft_injection": priority != "balanced",
                          "cfg_only": priority == "hint"})
        return hints

    def _run_request(self, request: pb.Request, stop_event=None):
        """Yield (image uint8 [H,W,3], seed, index, metadata) for each
        image, then (artifact, None, index, None) for each artifact the
        request asked to have echoed back."""
        p = extract_params(request)
        engine_id = p.engine_id or self.manager.default_engine_id()
        # an unset size is the engine's natural one (SD1.5 512, SD2 768,
        # SDXL 1024)
        natural = self.manager.natural_size(engine_id)
        p.height, p.width = p.height or natural, p.width or natural
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
        loras, tis = self._adapters(p)
        hints = self._hints(p, engine_id)
        with self.manager.with_engine(engine_id, loras=loras,
                                      tis=tis) as pipe:
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
                    hints=hints or None,
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
