"""EngineManager: engine registry, model-set construction, dispatcher.

Counterpart of gyre_tpu/manager/manager.py, the generate-engine part.
Engines come from the engines.yaml DSL (engines_yaml.py, read by
``manager_from_yaml`` or the server's ``build_manager``) as a list of
entries. A generate engine's ``model:`` is

  * a preset (``preset/sd15``, ``{preset: sd15, seed: 0}``): random
    weights of a models.configs preset, made on the manager's device;
  * a weight reference (a bare string or ``{path: ...}``, with optional
    ``subfolder``/``allow_patterns``): resolved to a local checkpoint
    directory by the WeightResolver (weights.py) and loaded from disk
    (models/load.py);
  * a mix (``{mix: [...], algorithm: ...}``) of other engines (mixing.py);

and ``vae/unet/text_encoder/tokenizer: "@engine"`` share that part of
another engine (the same tensors, no copy). ``model_id`` entries are the
registry ``@ref`` chains resolve through (load_model_entry). A failed build
falls back to the engine named by ``fallback:``.

All device work of the serving path flows through ONE shared
CoalescingDispatcher (manager/scheduler.py, the port's copy of the JAX
package's): its single thread owns the card and merges compatible
concurrent requests into one batch.

With a device mesh (``mesh``, parallel/mesh.py; the server's ``--tp`` and
several GPUs) each generate engine's ModelSet is sharded into one replica a
dp group (``replicas``), and its pipeline is a PooledPipeline
(parallel/pool.py) that splits every merged batch's samples over the
groups below the dispatcher, as the JAX package's mesh sits below its
dispatcher. What a group's rows touch sits on its devices: its replica,
the graft engine's replica, the request's hint models and the engine's
CLIP model (placed at first use), adapters folded into every replica.
Task engines and the safety checker stay on the first device.

LoRA/TI adapters fold into a view of an engine (``adapted_pipeline``,
bounded cache), with a DispatchView of its own so that the dispatcher never
merges adapted and plain requests. ``hintset_id`` entries name the hint
models (ControlNets, T2I adapters) an engine's ``hintset:`` offers
(hints.py, ``hint_model``). An engine's ``graft:`` names another engine
whose UNet its pipeline grafts on top of its own (the 9-channel inpainting
UNet under SD 1.5, say). Every generate family of models/configs.py is
served: SD1.x, SD2 (v-prediction at 768²), SDXL and its refiner (1024²),
each at its natural size (``natural_size``: the config's ``sample_size``
latents), which the servicer and the prewarm take where a request sets
none.

Task engines load at first use (``task_pipeline``): a ``depth`` engine of
kind ``depth``/``midas``/``dpt`` is a MiDaS DPT (models/dpt.py), of kind
``zoe``/``zoedepth`` ZoeDepth's head over a DPT trunk (models/zoedepth.py),
each in the manager's compute dtype (its head in f32), from the engine's
``model:`` checkpoint (``spec_state_dict``) or, with no resolvable
weights, random at ``DPT_TEST`` as in the JAX package; so are the
hinters (edges, line art, pose, segmentation, normals, lines), background
removal (InSPyReNet), the image-space upscalers (Real-ESRGAN, SwinIR,
HAT behind pipeline/upscaler.py's tiles) and face restoration
(CodeFormer, in f32). The diffusion upscalers (``kind: sd-x4`` and
``sd-x2``, pipeline/diffusion_upscaler.py) build a ModelSet of their own
as a generate engine would, from ``model:`` or their preset.

An engine's ``clip:`` (or ``clip_model:``) key names the CLIP model its
CLIP guidance and style hints use (``clip_model``: a transformers
CLIPModel, loaded at first use and shared by every engine naming it; its
activation and head counts from its config.json). The safety checker is a
``task: safety`` engine's model or an engine's ``safety_checker:`` key
(``safety_checker``); one that resolves and does not load raises when it
is first used, where the JAX manager logs a warning and serves without
it.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import threading
import time
import weakref
from contextlib import contextmanager
from dataclasses import dataclass, field

import numpy as np
import torch

from ..models import configs
from ..models.modelset import ModelSet, random_modelset
from ..pipeline.unified import UnifiedPipeline
from . import engines_yaml
from .hints import HintsetManager
from .scheduler import CoalescingDispatcher

logger = logging.getLogger(__name__)


@dataclass
class EngineSpec:
    id: str
    name: str = ""
    description: str = ""
    enabled: bool = True
    visible: bool = True
    default: bool = False
    task: str = "generate"
    model: str | dict | None = None     # preset name / weights path / dict
    options: dict = field(default_factory=dict)
    params: dict = field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: dict) -> "EngineSpec":
        return cls(
            id=d.get("id", ""),
            name=d.get("name", d.get("id", "")),
            description=d.get("description", ""),
            enabled=bool(d.get("enabled", True)),
            visible=bool(d.get("visible", True)),
            default=bool(d.get("default", False)),
            task=str(d.get("task", d.get("class", "generate"))).lower(),
            model=d.get("model"),
            options=d.get("options") or {},
            params={k: v for k, v in d.items()
                    if k not in ("id", "name", "description", "enabled",
                                 "visible", "default", "task", "model",
                                 "options")},
        )


class EngineNotFoundError(KeyError):
    pass


class DispatchView:
    """What the dispatcher runs for one pipeline: the pipeline's chunked
    generator, with the finished images copied to the host on the
    dispatcher's own thread (the dispatcher hands numpy arrays to request
    threads; device work and transfers stay on its thread)."""

    def __init__(self, pipe: UnifiedPipeline):
        self.pipe = pipe

    def begin(self, **kwargs):
        images = yield from self.pipe.begin(**kwargs)
        return None if images is None else images.cpu()

    def __call__(self, **kwargs):
        images = self.pipe(**kwargs)
        return None if images is None else images.cpu()


class EngineManager:
    """Loads engines, owns the dispatcher, hands out pipelines."""

    def __init__(self, engine_specs, device="cuda",
                 compute_dtype=torch.bfloat16, batch_max: int = 4,
                 weight_resolver=None, interleave: int = 2,
                 gather_ms: float = 10.0, watchdog_s: float = 900.0,
                 mesh=None):
        entries = [s for s in engine_specs if isinstance(s, dict)]
        hintset_entries = [e for e in entries if "hintset_id" in e]
        # model_id entries: the shared model registry "@ref"s resolve
        # through (reference @model_id memoization, gyre/manager.py:
        # 1602-1648 and config/models/*.yaml)
        self.model_entries: dict[str, dict] = {
            e["model_id"]: e for e in entries
            if isinstance(e.get("model_id"), str)}
        self.specs: list[EngineSpec] = [
            s if isinstance(s, EngineSpec) else EngineSpec.from_dict(s)
            for s in engine_specs
            if isinstance(s, EngineSpec) or (isinstance(s, dict) and
                                             s.get("id"))]
        # a mesh's first device holds the base ModelSets, the task engines
        # and the safety checker
        self.mesh = mesh
        self.device = mesh.homes[0] if mesh is not None else \
            torch.device(device)
        self.compute_dtype = compute_dtype
        self.batch_max = batch_max
        self._weight_resolver = weight_resolver
        # the loader through a weak reference: a bound method would make a
        # cycle that keeps a dropped manager's engines until the cycle
        # collector runs
        loader = weakref.WeakMethod(self.load_model_entry)
        self.hintsets = HintsetManager(
            hintset_entries, configs.SD15.unet, compute_dtype=compute_dtype,
            device=self.device, model_loader=lambda ref: loader()(ref))
        # url artifacts resolve through it (server.serve sets it)
        self.resources = None
        self._modelsets: dict[str, ModelSet] = {}
        self._replicas: dict[str, list] = {}
        self._pipelines: dict[str, UnifiedPipeline] = {}
        self._views: dict[str, DispatchView] = {}
        # adapted views (LoRA/TI folded in), oldest first
        self._adapted: dict[tuple, DispatchView] = {}
        # task pipelines by engine id, built at first use
        self._tasks: dict[str, object] = {}
        self._loaded = False
        self._probes: dict[tuple, float] = {}
        self._clip_models: dict[str, tuple] = {}
        self._safety = None           # (checker or None,) once looked up
        # per-engine weight provenance for status(): "real" (checkpoint
        # loaded), "random" (random weights: loud, so no engine silently
        # serves untrained weights), "pending" (not built yet)
        self._weights_kind: dict[str, str] = {}
        # guards lazy model/pipeline construction only; device work is
        # serialised (and batched) by the dispatcher's thread
        self._load_lock = threading.RLock()
        # max merged rows == batch_max: also the shape prewarm runs
        self.dispatcher = CoalescingDispatcher(max_batch=max(batch_max, 1),
                                               interleave=interleave,
                                               gather_ms=gather_ms,
                                               watchdog_s=watchdog_s)
        # off -> running -> done | failed
        self.prewarm_state: dict = {"state": "off"}

    # ------------------------------------------------------------ loading

    def load_engines(self):
        """Build every enabled generate engine's ModelSet."""
        for spec in self.specs:
            if not spec.enabled or spec.task != "generate":
                continue
            ms = self.modelset(spec.id)  # includes the fallback handling
            logger.info("engine %s loaded (%.1f MB params, %s weights)",
                        spec.id, ms.param_bytes() / 1e6,
                        self._weights_kind.get(spec.id, "pending"))
        self._loaded = True

    @property
    def weight_resolver(self):
        if self._weight_resolver is None:
            from .weights import WeightResolver

            self._weight_resolver = WeightResolver()
        return self._weight_resolver

    def _build_modelset(self, spec: EngineSpec) -> ModelSet:
        if spec.task != "generate":
            raise ValueError(f"engine {spec.id} is a {spec.task} engine: "
                             "it has no generate ModelSet")
        model = spec.model
        if isinstance(model, dict) and model.get("mix"):
            # model mixing: merge other engines' weights (reference
            # gyre/manager.py:1296-1443)
            from .mixing import mix_modelsets

            parts = []
            src_ids = []
            for entry in model["mix"]:
                if isinstance(entry, str):
                    entry = {"source": entry, "weight": 1.0}
                src_ids.append(str(entry["source"]).lstrip("@"))
                parts.append((self.modelset(src_ids[-1]),
                              float(entry.get("weight", 1.0))))
            self._weights_kind[spec.id] = "real" if all(
                self._weights_kind.get(i) == "real" for i in src_ids) \
                else "random"
            return mix_modelsets(parts,
                                 model.get("algorithm", "weighted_sum"),
                                 engine_id=spec.id)
        if isinstance(model, dict):
            path = model.get("path")
            preset = model.get("preset", "sd15")
            seed = int(model.get("seed", 0))
        elif isinstance(model, str) and model.startswith("preset/"):
            path, preset, seed = None, model.split("/", 1)[1], 0
        elif isinstance(model, str) and model:
            path, preset, seed = model, "sd15", 0
        else:
            path, preset, seed = None, "sd15", 0

        cfg = configs.PRESETS.get(preset)
        if cfg is None:
            raise ValueError(f"engine {spec.id}: unknown preset {preset!r}")

        if path:
            from ..models.load import load_modelset

            sub = pats = None
            if isinstance(model, dict):
                sub = model.get("subfolder")
                pats = model.get("allow_patterns")
            resolved = self.weight_resolver.resolve(
                path, subfolder=sub, allow_patterns=pats)
            ms = load_modelset(resolved, cfg, dtype=self.compute_dtype,
                               device=self.device, engine_id=spec.id)
            self._weights_kind[spec.id] = "real"
        else:
            ms = random_modelset(cfg, seed=seed, dtype=self.compute_dtype,
                                 device=self.device, engine_id=spec.id)
            self._weights_kind[spec.id] = "random"

        # '@engine-id' part references: share another engine's tensors
        # (reference @model_id references with memoization,
        # gyre/manager.py:1602-1648)
        if isinstance(model, dict):
            for part, attr in (("vae", "vae_params"), ("unet", "unet_params"),
                               ("text_encoder", "text_params"),
                               ("tokenizer", "tokenizer")):
                ref = model.get(part)
                if isinstance(ref, str) and ref.startswith("@"):
                    setattr(ms, attr, getattr(self.modelset(ref[1:]), attr))
        return ms

    # ------------------------------------------------------------- access

    @property
    def engine_ids(self) -> list[str]:
        return [s.id for s in self.specs if s.enabled]

    def spec(self, engine_id: str) -> EngineSpec:
        for s in self.specs:
            if s.id == engine_id:
                return s
        raise EngineNotFoundError(engine_id)

    def default_engine_id(self) -> str | None:
        for s in self.specs:
            if s.enabled and s.default:
                return s.id
        return self.engine_ids[0] if self.engine_ids else None

    def modelset(self, engine_id: str) -> ModelSet:
        if engine_id not in self._modelsets:
            with self._load_lock:
                if engine_id in self._modelsets:
                    return self._modelsets[engine_id]
                spec = self.spec(engine_id)
                if not spec.enabled:
                    raise EngineNotFoundError(engine_id)
                try:
                    self._modelsets[engine_id] = self._build_modelset(spec)
                except Exception as e:  # noqa: BLE001 - re-raised below
                    # engine `fallback:` spec (reference gyre/manager.py:
                    # 1662-1668): a failed load serves another engine
                    fb = spec.params.get("fallback")
                    if not fb:
                        raise
                    logger.warning("engine %s failed to load (%s); falling "
                                   "back to %s", engine_id, e, fb)
                    self._modelsets[engine_id] = self.modelset(fb)
                    self._weights_kind[engine_id] = \
                        self._weights_kind.get(fb, "pending")
        return self._modelsets[engine_id]

    def replicas(self, engine_id: str) -> list:
        """The engine's ModelSet on each dp group of the mesh
        (parallel/mesh.py's ``shard_modelset``): a group on the base's own
        device shares its replicated weights."""
        if engine_id not in self._replicas:
            with self._load_lock:
                if engine_id not in self._replicas:
                    from ..parallel import mesh as pmesh

                    self._replicas[engine_id] = pmesh.shard_modelset(
                        self.modelset(engine_id), self.mesh)
        return self._replicas[engine_id]

    def pipeline(self, engine_id: str):
        """The engine's UnifiedPipeline, or with a mesh its PooledPipeline
        over one UnifiedPipeline a dp group."""
        if engine_id not in self._pipelines:
            with self._load_lock:
                if engine_id in self._pipelines:
                    return self._pipelines[engine_id]
                spec = self.spec(engine_id)
                # `graft:` names the engine whose UNet is grafted on top
                graft_id = spec.params.get("graft") or \
                    (spec.options or {}).get("graft")
                # `clip:` -> the CLIP model of guidance and style hints,
                # loaded at the first such request (adapted views copy
                # the source)
                clip_ref = spec.params.get("clip") or \
                    spec.params.get("clip_model")
                if clip_ref is None and isinstance(spec.model, dict):
                    clip_ref = spec.model.get("clip")
                if self.mesh is None:
                    pipe = self._unified(self.modelset(engine_id),
                                         self.modelset(graft_id)
                                         if graft_id else None, clip_ref)
                else:
                    from ..parallel import mesh as pmesh
                    from ..parallel.pool import PooledPipeline

                    grafts = self.replicas(graft_id) if graft_id else \
                        [None] * len(self.mesh.grid)
                    pipe = PooledPipeline([
                        self._unified(ms, gms, clip_ref, lambda tree, d=(
                            ms.device): pmesh.place(tree, d))
                        for ms, gms in zip(self.replicas(engine_id),
                                           grafts)])
                self._pipelines[engine_id] = pipe
        return self._pipelines[engine_id]

    def _unified(self, ms, graft_ms, clip_ref, place=None):
        pipe = UnifiedPipeline(ms, compute_dtype=self.compute_dtype,
                               graft_ms=graft_ms)
        if clip_ref:
            if place is None:
                pipe.clip_source = lambda: self.clip_model(clip_ref)
            else:
                pipe.clip_source = lambda: place(self.clip_model(clip_ref))
        return pipe

    def dispatch_view(self, engine_id: str) -> DispatchView:
        """The engine's pipeline as the dispatcher runs it; one per engine,
        so that requests to the same engine share a coalescing key."""
        if engine_id not in self._views:
            with self._load_lock:
                if engine_id not in self._views:
                    self._views[engine_id] = DispatchView(
                        self.pipeline(engine_id))
        return self._views[engine_id]

    def adapted_pipeline(self, engine_id: str, loras=None, tis=None):
        """The engine's DispatchView, or with adapters a view over its
        weights with them folded in. loras: [(state_dict, scale,
        cache_key)], tis: [(state_dict, cache_key)]; a scale is a float or
        a per-model dict ('*' / 'unet' / 'text_encoder'), and scales that
        give each model the same weight share a view. Each adapted view has
        a DispatchView of its own (the dispatcher coalesces by it), kept in
        a cache of at most 8 beside the base."""
        from ..pipeline import lora as lora_mod

        if not loras and not tis:
            return self.dispatch_view(engine_id)

        def skey(s):
            return tuple(sorted((k, round(v, 4)) for k, v in
                                lora_mod.model_scales(s).items()))

        key = (engine_id, tuple((ck, skey(s)) for _, s, ck in loras or []),
               tuple(ck for _, ck in tis or []))
        cached = self._adapted.get(key)
        if cached is not None:
            return cached
        base = self.pipeline(engine_id)
        ms = base.ms
        # the host work (rebuilt, laid out and scaled deltas, TI rows) on
        # this request's thread, so that the dispatcher is held only for
        # the uploads and adds
        deltas = [lora_mod.lora_deltas(state, scale, config=ms.config)
                  for state, scale, _ in loras or []]
        embeddings = {}
        for state, _ in tis or []:
            embeddings.update(lora_mod.extract_ti_embeddings(state))
        # the fold is device work: on the dispatcher's thread, which owns
        # the card (not under _load_lock, which dispatcher jobs may take)
        return self.dispatcher.submit(
            lambda: self._adapted.get(key) or self._build_adapted(
                key, base, engine_id, deltas, embeddings), {},
            solo=True).result()

    def _build_adapted(self, key, base, engine_id, deltas, embeddings):
        if hasattr(base, "pipes"):       # a pool: fold into every replica
            view = DispatchView(base.derive([
                self._fold(p.ms, engine_id, deltas, embeddings)
                for p in base.pipes]))
        else:
            view = DispatchView(base.derive(
                self._fold(base.ms, engine_id, deltas, embeddings)))
        if len(self._adapted) >= 8:           # bounded: drop the oldest
            self._adapted.pop(next(iter(self._adapted)))
        self._adapted[key] = view
        return view

    @staticmethod
    def _fold(ms, engine_id, deltas, embeddings):
        """``ms`` with the adapters folded in (a new ModelSet)."""
        from ..pipeline import lora as lora_mod

        unet_p, text_p = ms.unet_params, list(ms.text_params)
        tokenizer = ms.tokenizer
        # no_grad, not inference_mode: a guided request saves these leaves
        # for its backward, which an inference tensor cannot be
        with torch.no_grad():
            for d in deltas:
                unet_p, text_p, n = lora_mod.fold_deltas(unet_p, text_p, d)
                logger.info("lora applied to %s on %s: %d modules",
                            engine_id, ms.device, n)
            if embeddings:
                text_p, tokenizer = lora_mod.apply_textual_inversions(
                    dataclasses.replace(ms, text_params=text_p), embeddings)
        return dataclasses.replace(
            ms, unet_params=unet_p, text_params=text_p, tokenizer=tokenizer,
            id=f"{ms.id}+adapters")

    @contextmanager
    def with_engine(self, engine_id: str | None = None, loras=None,
                    tis=None):
        """Borrow an engine for one request: yields its DispatchView, with
        the request's adapters folded in (adapted_pipeline). Not a device
        claim: device work is serialised (and batched) by the dispatcher
        thread."""
        yield self.adapted_pipeline(engine_id or self.default_engine_id(),
                                    loras, tis)

    def hint_model(self, hint_type: str, engine_id: str | None = None):
        """The conditioning model ({"params", "kind"}) for a hint type,
        built for the engine's UNet from the engine's ``hintset:`` (any
        hintset when that one has none for the type); None, with a warning,
        when no hintset names the type. (The JAX package gives such a type
        a random ControlNet, whose zero convs add exactly zero.)"""
        eid = engine_id or self.default_engine_id()
        model = self.hintsets.for_type(
            hint_type, self.modelset(eid).config.unet,
            hintset=self.spec(eid).params.get("hintset"))
        if model is None:
            logger.warning("no hintset provides hint type %r: hint skipped",
                           hint_type)
        return model

    # ------------------------------------------------------- task engines

    def task_pipeline(self, task: str, engine_id: str | None = None):
        """The pipeline of the first enabled engine of ``task`` (that
        engine's when ``engine_id`` is given), built at first use: a
        callable image [B,H,W,C] in [0,1] -> [B,H,W,3] on the manager's
        device; None when no such engine is configured. The task kinds the
        port has no model for yet raise NotImplementedError naming their
        ROADMAP item."""
        task = {"upscale": "upscaler"}.get(task, task)
        spec = next((s for s in self.specs
                     if s.enabled and s.task == task and
                     (engine_id is None or s.id == engine_id)), None)
        if spec is None:
            return None
        if spec.id not in self._tasks:
            with self._load_lock:
                if spec.id not in self._tasks:
                    self._tasks[spec.id] = self._build_task_pipeline(spec)
        return self._tasks[spec.id]

    def spec_state_dict(self, spec) -> dict | None:
        """The engine's ``model:`` (a "@model-id" registry reference, a
        repository or a local path) as a loaded state dict; None (weights
        "random") when it names none or it does not resolve, so the task
        model random-inits."""
        model = spec.model
        if not isinstance(model, str) or not model or \
                model.startswith("preset/"):
            self._weights_kind[spec.id] = "random"
            return None
        try:
            state = self.load_model_entry(model)[0]
        except Exception as e:  # noqa: BLE001 - logged, random weights
            logger.warning("engine %s: weights %s unavailable (%s); "
                           "random-init", spec.id, model, e)
            self._weights_kind[spec.id] = "random"
            return None
        self._weights_kind[spec.id] = "real"
        return state

    def _build_task_pipeline(self, spec: EngineSpec):
        if spec.task in ("depth", "hinter", "edge", "segmentation",
                         "background_removal", "pose", "normal"):
            return self._build_hinter(spec)
        if spec.task == "upscaler":
            return self._build_upscaler(spec)
        if spec.task in ("face_restore", "codeformer"):
            return self._build_face_restore(spec)
        return None

    # the upscaler kinds that are latent diffusion pipelines
    _DIFFUSION_UPSCALERS = ("sd-x2", "latent-x2", "x2", "sd-x4", "diffusion",
                            "latent")

    def _build_upscaler(self, spec: EngineSpec):
        """An image-space upscaler engine: a callable image [B,H,W,3|4] in
        [0,1] -> [B,4H,4W,3|4] f32 on the manager's device, the tiled
        pipeline (pipeline/upscaler.py) over HAT (``kind: hat``) or SwinIR
        (``kind: swinir``), each in f32 at ``tile`` (64) with an overlap
        of half its window, or else Real-ESRGAN in the manager's dtype at
        ``blocks`` (23) and ``tile`` (128). From the engine's checkpoint
        (its architecture derived from the shapes), else random at
        ``HAT_TEST`` / ``SWINIR_TEST`` / ``blocks`` as in the JAX package;
        a checkpoint that resolves and does not load raises. The diffusion
        upscalers: ``_build_diffusion_upscaler``."""
        from ..pipeline.upscaler import UpscalerPipeline, build_esrgan_pipeline

        kind = spec.params.get("kind")
        if kind in self._DIFFUSION_UPSCALERS:
            return self._build_diffusion_upscaler(spec, kind)
        state = self.spec_state_dict(spec)
        if kind in ("hat", "swinir"):
            from ..models import hat, swinir

            load, rand, test = {
                "hat": (hat.load_hat, hat.random_hat, hat.HAT_TEST),
                "swinir": (swinir.load_swinir, swinir.random_swinir,
                           swinir.SWINIR_TEST)}[kind]
            if state is not None:
                model, cfg = load(state, torch.float32, self.device)
            else:
                cfg = test
                model = rand(cfg, 0, torch.float32, self.device)
            return UpscalerPipeline(model, scale=cfg.scale,
                                    tile=int(spec.params.get("tile", 64)),
                                    overlap=cfg.window // 2)
        return build_esrgan_pipeline(
            state_dict=state, num_blocks=int(spec.params.get("blocks", 23)),
            tile=int(spec.params.get("tile", 128)), dtype=self.compute_dtype,
            device=self.device)

    def _build_diffusion_upscaler(self, spec: EngineSpec, kind: str):
        """A latent diffusion upscaler engine, in the manager's dtype: the
        sd-x2 latent upscaler (``sd-x2``/``latent-x2``/``x2``: ``steps``
        30 of k_euler, 2x) or the SD x4 upscaler (``sd-x4``/``diffusion``/
        ``latent``: ``steps`` 20 of DPM++ 2M at ``noise_level`` 20, 4x).
        Its ModelSet is built as a generate engine's from ``model:``,
        else the preset ``upscaler-x2`` / ``upscaler-x4``. A request runs
        the engine with no prompt and seed 0, as in the JAX package."""
        from ..pipeline import diffusion_upscaler as du

        x2 = kind in ("sd-x2", "latent-x2", "x2")
        cls = du.LatentUpscalerX2 if x2 else du.DiffusionUpscaler
        ms = self._build_modelset(EngineSpec(
            id=spec.id, model=spec.model or f"preset/{cls.PRESET}",
            task="generate"))
        up = cls(ms, compute_dtype=self.compute_dtype)
        steps = int(spec.params.get("steps", 30 if x2 else 20))
        if x2:
            run = lambda img: up(img, steps=steps)  # noqa: E731
        else:
            level = int(spec.params.get("noise_level", 20))
            run = lambda img: up(img, steps=steps,  # noqa: E731
                                 noise_level=level)
        run.upscaler = up
        return run

    def _build_face_restore(self, spec: EngineSpec):
        """A face-restore engine: CodeFormer in f32 from the engine's
        checkpoint (its architecture from the shapes), else random at
        ``CODEFORMER_TEST`` as in the JAX package, at ``fidelity`` (0.5);
        an image of another size than the model's is resized to it and
        back (bilinear, antialiased, as jax.image.resize), the result
        clamped to [0, 1] (the resize's f32 weights may overshoot by an
        ulp; the JAX engine does not clamp)."""
        from ..models import codeformer as cf
        from ..ops.resize import resize

        state = self.spec_state_dict(spec)
        model = cf.load_codeformer(state, self.device) if state is not None \
            else cf.random_codeformer(cf.CODEFORMER_TEST, 0, self.device)
        fidelity = float(spec.params.get("fidelity", 0.5))
        s = model.cfg.img_size

        @torch.inference_mode()
        def run(img):
            img = torch.as_tensor(img).to(self.device, torch.float32)
            h, w = img.shape[1:3]
            if (h, w) == (s, s):
                return model(img, fidelity)
            out = model(resize(img, (s, s), "bilinear"), fidelity)
            return resize(out, (h, w), "bilinear").clamp(0.0, 1.0)

        run.models = (model,)
        return run

    # the hinter kinds a task engine's ``kind:`` (else its task) names
    _BG_KINDS = ("background_removal", "bg", "inspyrenet")
    _DEPTH_KINDS = ("depth", "midas", "dpt", "zoe", "zoedepth")
    _HINTER_KINDS = _DEPTH_KINDS + (
        "segmentation", "seg", "uniformer", "normal", "bae", "baenormal",
        "pose", "openpose", "keypose", "mlsd", "lines", "dexined",
        "drawings", "informative_drawings", "lineart", "edge", "hinter",
        "hed", "soft_edge")

    def _build_hinter(self, spec: EngineSpec):
        """A hinter engine's pipeline: a callable image [B,H,W,C] in [0,1]
        -> [B,H,W,3] f32 on the manager's device (pose's also takes
        ``style=``). Depth (MiDaS DPT, ZoeDepth over a DPT trunk), HED
        edges, informative-drawings line art, DexiNed edges, OpenPose
        (the body CPM from a checkpoint, else the small PoseNet; top-down
        refinement unless ``refine: none``), UniFormer segmentation, BAE
        normals, M-LSD lines and background removal (InSPyReNet, RGBA
        out: ``_build_background_removal``); the models random-init at the
        JAX package's sizes without a checkpoint. A checkpoint that
        resolves and does not load raises (where the JAX package
        random-inits a DexiNed or a ZoeDepth trunk). An unknown kind has no
        pipeline (None)."""
        kind = spec.params.get("kind") or spec.task
        seed = int(spec.params.get("seed", 0))
        dtype, device = self.compute_dtype, self.device
        if kind in self._BG_KINDS:
            return self._build_background_removal(spec, seed)
        if kind not in self._HINTER_KINDS:
            return None
        state = self.spec_state_dict(spec)
        run = None
        size = None
        if kind in ("zoe", "zoedepth"):
            from ..models import dpt
            from ..models import zoedepth as zoe

            trunk_cfg = dpt.DPT_TEST
            trunk = head = None
            if state is not None:
                head, zcfg = zoe.load_zoe_head(state, device=device)
                core = {k.split("core.core.", 1)[1]: v
                        for k, v in state.items() if "core.core." in k}
                if core:
                    trunk, trunk_cfg = dpt.load_dpt(core, dtype=dtype,
                                                    device=device)
            if head is None:
                zcfg = dataclasses.replace(
                    zoe.ZOE_TEST, btlnck_features=trunk_cfg.fusion,
                    num_out_features=trunk_cfg.fusion)
                head = zoe.random_head(zcfg, seed, device=device)
            if trunk is None:
                # a head-only checkpoint: its trunk is random
                trunk = dpt.random_dpt(trunk_cfg, seed + 1, dtype=dtype,
                                       device=device)
                self._weights_kind[spec.id] = "random"
            size = int(spec.params.get("size",
                                       trunk_cfg.grid * trunk_cfg.patch))
            models = (trunk, head)

            def estimate(img):
                return zoe.estimate_depth_hint(trunk, head, img, size)
        elif kind in ("depth", "midas", "dpt"):
            from ..models import dpt

            if state is not None:
                model, cfg = dpt.load_dpt(state, dtype=dtype, device=device)
                size = int(spec.params.get("size", cfg.grid * cfg.patch))
            else:
                cfg = dpt.DPT_TEST
                model = dpt.random_dpt(cfg, seed, dtype=dtype, device=device)
                size = cfg.grid * cfg.patch
            models = (model,)

            def estimate(img):
                return dpt.estimate_depth(model, img, size)
        elif kind in ("segmentation", "seg", "uniformer"):
            from ..models import uniformer as uni

            model = uni.load_uniformer(state, dtype, device)[0] \
                if state is not None else uni.random_uniformer(
                    uni.UNIFORMER_TEST, seed, dtype, device)
            models, estimate = (model,), model
        elif kind in ("normal", "bae", "baenormal"):
            from ..models import baenormal as bae

            model = bae.load_baenormal(state, dtype, device)[0] \
                if state is not None else bae.random_baenormal(
                    bae.EFFNET_TEST, seed, dtype, device)
            models, estimate = (model,), model
        elif kind in ("pose", "openpose", "keypose"):
            from ..models import pose

            model = pose.load_body(state, dtype, device) \
                if state is not None else pose.random_posenet(seed, dtype,
                                                              device)
            models = (model,)
            if str(spec.params.get("refine", "topdown")) != "none":
                render = pose.make_topdown(model)
            else:
                def render(img, style="openpose"):
                    return pose.estimate_and_render(model, img, style=style)

            def run(img, style: str = "openpose"):
                img = torch.as_tensor(img).to(device, torch.float32)
                with torch.inference_mode():
                    return render(img, style=style)
        elif kind in ("mlsd", "lines"):
            from ..models import mlsd

            model = mlsd.load_mlsd(state, dtype, device) \
                if state is not None else mlsd.random_mlsd(seed, dtype,
                                                           device)
            models, estimate = (model,), model
        else:
            from ..models import hinters

            load, rand = {
                "dexined": (hinters.load_dexined, hinters.random_dexined),
                "drawings": (hinters.load_drawings, hinters.random_drawings),
                "informative_drawings": (hinters.load_drawings,
                                         hinters.random_drawings),
                "lineart": (hinters.load_drawings, hinters.random_drawings),
            }.get(kind, (hinters.load_hed, hinters.random_hed))
            model = load(state, dtype=dtype, device=device) \
                if state is not None else rand(seed, dtype=dtype,
                                               device=device)
            models, estimate = (model,), model

        if run is None:
            def run(img):
                img = torch.as_tensor(img).to(device, torch.float32)
                with torch.inference_mode():
                    out = estimate(img)
                return out if out.shape[-1] == 3 else out.repeat(1, 1, 1, 3)

        run.models, run.size = models, size     # what it runs, at what size
        return run

    def _build_background_removal(self, spec: EngineSpec, seed: int):
        """InSPyReNet in the manager's dtype, on the JAX manager's geometry
        (the reference's inspyrenet_pipeline): the image padded at the top
        and left to a square (reflected when both pads are shorter than
        the image, else edge-replicated) of a multiple of 32, or, past
        ``max_res`` (1280, rounded up to a multiple of 32), of its long
        side, resized to max_res for the model and its map resized back
        (bilinear as jax.image.resize, which antialiases the downscale);
        past twice max_res the map is refined by a guided filter of the
        image (radius 32, eps 1e-6; the larger of the two kept); then
        (map - 0.2) / 0.8 clipped as the alpha of the RGBA image out, f32.
        """
        from ..models import inspyrenet as isp
        from ..ops import images as I
        from ..ops.resize import resize

        dtype, device = self.compute_dtype, self.device
        state = self.spec_state_dict(spec)
        model = isp.load_inspyrenet(state, dtype, device)[0] \
            if state is not None else isp.random_inspyrenet(
                isp.SWIN_TEST, 64, seed, dtype, device)
        max_res = -(-int(spec.params.get("max_res", 1280)) // 32) * 32

        def run(img):
            rgb = torch.as_tensor(img).to(device, torch.float32)[..., :3]
            b, h, w, _ = rgb.shape
            scaled = max(h, w) > max_res
            maxdim = max(h, w) if scaled else \
                max(-(-h // 32) * 32, -(-w // 32) * 32)
            ph, pw = maxdim - h, maxdim - w
            sample = torch.nn.functional.pad(
                rgb.permute(0, 3, 1, 2), (pw, 0, ph, 0),
                mode="reflect" if ph < h and pw < w else "replicate"
            ).permute(0, 2, 3, 1)
            with torch.inference_mode():
                if scaled:
                    sample = resize(sample, (max_res, max_res), "bilinear")
                pred = model(sample)
                if scaled:
                    pred = resize(pred, (maxdim, maxdim), "bilinear")
                pred = pred[:, ph:, pw:]
                if scaled and max_res / maxdim < 0.5:
                    gp = I.guided_filter(rgb, pred, radius=32, eps=1e-6)
                    pred = torch.maximum(gp.clamp(0.0, 1.0), pred)
                pred = ((pred - 0.2) / 0.8).clamp(0.0, 1.0)
                return torch.cat([rgb, pred], dim=-1)

        run.models, run.size = (model,), max_res
        return run

    def load_model_entry(self, ref: str):
        """'@model-id' registry reference or direct path/repo -> (state
        dict, config entry, resolved path). The entry's model/subfolder/
        allow_patterns keys drive weight resolution (reference
        model-config loading, gyre/manager.py:1602-1698)."""
        from ..models.load import read_state_dict

        entry: dict = {}
        src = ref
        seen: set[str] = set()
        # follow '@a' -> '@b' alias chains (reference clip-common ->
        # @laion-clip-h, gyre/config/models/clip.yaml); later entries in
        # the chain keep the first entry's subfolder/patterns when unset
        while isinstance(src, str) and src.startswith("@"):
            mid = src[1:]
            if mid in seen:
                raise ValueError(f"model_id reference cycle at {mid!r}")
            seen.add(mid)
            if mid not in self.model_entries:
                raise KeyError(f"unknown model_id {mid!r}")
            nxt = self.model_entries[mid]
            entry = {**nxt, **{k: v for k, v in entry.items()
                               if k in ("subfolder", "allow_patterns")}}
            src = nxt.get("model") or nxt.get("source")
            if not isinstance(src, str):
                raise ValueError(f"model_id {mid!r} has no model reference")
        path = self.weight_resolver.resolve(
            src, subfolder=entry.get("subfolder"),
            allow_patterns=entry.get("allow_patterns"))
        return read_state_dict(path), entry, path

    def clip_model(self, ref: str):
        """A transformers CLIPModel (both towers with their joint-space
        projections) for guidance and style hints, memoised by ``ref``:
        (text_params, text_cfg, vision_params, vision_cfg). The activation
        and the head counts, which the weights do not carry, come from the
        registry entry's ``activation`` or the directory's config.json."""
        if ref in self._clip_models:
            return self._clip_models[ref]
        with self._load_lock:
            if ref in self._clip_models:
                return self._clip_models[ref]
            from ..models.load import load_clip_model_params

            state, entry, path = self.load_model_entry(ref)
            act = entry.get("activation")
            t_heads = v_heads = None
            cfg_file = os.path.join(path, "config.json")
            if os.path.isdir(path) and os.path.exists(cfg_file):
                with open(cfg_file) as fh:
                    cj = json.load(fh)
                tc = cj.get("text_config") or {}
                vc = cj.get("vision_config") or {}
                act = act or tc.get("hidden_act") or cj.get("hidden_act")
                t_heads = tc.get("num_attention_heads")
                v_heads = vc.get("num_attention_heads")
            loaded = load_clip_model_params(
                state, dtype=self.compute_dtype, device=self.device,
                activation=act, text_heads=t_heads, vision_heads=v_heads)
            self._clip_models[ref] = loaded
            logger.info("clip model %s loaded (text %dL/%dd, vision %dL/%dd"
                        " -> joint %dd)", ref, loaded[1].num_layers,
                        loaded[1].hidden_size, loaded[3].num_layers,
                        loaded[3].hidden_size, loaded[3].projection_dim)
            return loaded

    def safety_checker(self):
        """The trained safety checker engines.yaml configures, or None: the
        model of the first enabled ``task: safety`` engine, or the first
        enabled engine's ``safety_checker:`` key, resolved through the
        weight resolver (a directory's model.safetensors or
        safety_checker/model.safetensors). A reference that does not
        resolve is logged and gives None, as in the JAX manager; one that
        resolves and does not load raises."""
        if self._safety is None:
            with self._load_lock:
                if self._safety is None:
                    self._safety = (self._load_safety_checker(),)
        return self._safety[0]

    def _load_safety_checker(self):
        from ..pipeline.safety import SafetyChecker

        ref = None
        for s in self.specs:
            if s.task in ("safety", "safety_checker") and s.enabled:
                ref = s.model
                break
            if s.enabled and s.params.get("safety_checker"):
                ref = s.params["safety_checker"]
                break
        checker = None
        if isinstance(ref, str) and ref:
            try:
                path = self.weight_resolver.resolve(ref)
            except Exception as e:  # noqa: BLE001 - logged, no checker
                logger.warning("safety checker %s unavailable: %s", ref, e)
            else:
                for cand in ("model.safetensors",
                             os.path.join("safety_checker",
                                          "model.safetensors")):
                    if os.path.isdir(path) and \
                            os.path.exists(os.path.join(path, cand)):
                        path = os.path.join(path, cand)
                        break
                checker = SafetyChecker.load(path, self.compute_dtype,
                                             self.device)
                logger.info("safety checker loaded from %s", ref)
        return checker

    # ----------------------------------------------------- warm-up, sizing

    def natural_size(self, engine_id: str) -> int:
        """The engine's natural image size in pixels: its config's
        ``sample_size`` latents times 8 (SD1.5 512, SD2 768, SDXL 1024)."""
        return self.modelset(engine_id).config.sample_size * 8

    def prewarm(self, engine_id: str | None = None, *,
                height: int | None = None, width: int | None = None,
                steps: int = 50, buckets: bool = False):
        """Run the default engine's serving configuration once ahead of
        the first request, through the dispatcher (the card's one owner
        thread): one 1-sample request as the servicer sends it (chunked,
        with a stop event, uint8 out); with ``buckets`` also the
        dispatcher's max batch; then the engine's ``options:
        prewarm_sizes``. On the card this builds the kernels, loads the
        CUDA libraries and sizes the caching allocator's pools before
        traffic arrives. The size defaults to the engine's natural one.
        ``prewarm_state``: running -> done | failed."""
        eid = engine_id or self.default_engine_id()
        if eid is None:
            return
        height = height or self.natural_size(eid)
        width = width or self.natural_size(eid)
        t0 = time.time()
        self.prewarm_state = {"state": "running", "engine": eid}
        try:
            spec = self.spec(eid)
            sampler = (spec.options or {}).get("sampler", "k_dpmpp_2m")
            view = self.dispatch_view(eid)
            ev = threading.Event()
            kwargs = dict(prompt="prewarm", height=height, width=width,
                          steps=steps, sampler=sampler, seeds=[0],
                          guidance_scale=7.5, stop_event=ev, chunk_steps=10,
                          output_dtype="uint8")
            np.asarray(self.dispatcher.submit(view, kwargs, ev).result())
            sizes = [1]
            if buckets and self.dispatcher.max_batch > 1:
                bkw = dict(kwargs,
                           seeds=list(range(self.dispatcher.max_batch)))
                np.asarray(self.dispatcher.submit(view, bkw, ev).result())
                sizes.append(self.dispatcher.max_batch)
            # extra serving shapes the engine declares (engines.yaml
            # `options: {prewarm_sizes: [[768, 768], ...]}`)
            extra = (spec.options or {}).get("prewarm_sizes") or []
            for hw in extra:
                try:
                    h, w = int(hw[0]), int(hw[1])
                except (TypeError, ValueError, IndexError):
                    logger.warning("bad prewarm_sizes entry %r", hw)
                    continue
                if (h, w) == (height, width):
                    continue
                skw = dict(kwargs, height=h, width=w)
                np.asarray(self.dispatcher.submit(view, skw, ev).result())
        except Exception as e:
            self.prewarm_state = {"state": "failed", "engine": eid,
                                  "error": str(e)[:200]}
            raise
        self.prewarm_state = {"state": "done", "engine": eid,
                              "seconds": round(time.time() - t0, 1),
                              "sizes": sizes}
        logger.info("prewarm %s (%dx%d steps=%d %s batch=%s extra=%s) "
                    "in %.1fs", eid, width, height, steps, sampler, sizes,
                    extra, time.time() - t0)

    def suggest_max_batch(self, engine_id: str, height: int | None = None,
                          width: int | None = None) -> int:
        """Device-memory batch estimate (the reference's BatchMode
        autodetect, gyre/manager.py:202-282): the card's free memory over
        the measured bytes one image needs, at (height, width), by default
        the engine's natural size."""
        height = height or self.natural_size(engine_id)
        width = width or self.natural_size(engine_id)
        from ..utils.monitor import device_memory_stats

        stats = device_memory_stats()
        limit = max((s.get("bytes_limit") or 0) for s in stats) \
            if stats else 0
        limit = limit or 16 * 1024 ** 3
        used = max((s.get("bytes_in_use") or 0) for s in stats) \
            if stats else 0
        free = max(limit - used, 1 << 30)
        per_image = self._probe_bytes_per_image(engine_id, height, width)
        # a mesh's merged rows spread over its dp groups' cards
        groups = len(set(self.mesh.homes)) if self.mesh is not None else 1
        return max(1, min(int(free / per_image) * groups, 64))

    def _probe_bytes_per_image(self, engine_id: str, height: int,
                               width: int) -> float:
        """Bytes one image adds at (height, width). On the card: one CFG
        UNet call at 2 rows (one image) run on the dispatcher's thread,
        its peak allocation above what was allocated before it, with a
        25 % margin for the sampler's carry and the allocator (the CUDA
        counterpart of the JAX package's XLA memory analysis). On the CPU:
        the JAX package's config-scaled estimate. With a mesh, each dp
        group's replica is probed on its home device, each logged, and the
        largest kept. Cached per (engine, size)."""
        key = (engine_id, height, width)
        if key in self._probes:
            return self._probes[key]
        from ..models import unet as unet_mod

        pipe = self.pipeline(engine_id)
        mss = [p.ms for p in getattr(pipe, "pipes", [pipe])]
        ucfg = mss[0].config.unet
        cdt = self.compute_dtype
        if self.device.type == "cuda":
            def probe(ms):
                dev = ms.device
                x = torch.randn((2, height // 8, width // 8,
                                 ucfg.in_channels), device=dev, dtype=cdt)
                t = torch.full((2,), 500.0, device=dev)
                ctx = torch.randn((2, 77, ucfg.cross_attention_dim),
                                  device=dev, dtype=cdt)
                added = None
                if ucfg.addition_embed_dim:      # SDXL's text_time inputs
                    added = {"text_embeds": torch.randn(
                        (2, ucfg.addition_embed_dim), device=dev),
                        "time_ids": torch.full(
                            (2, ucfg.addition_time_ids), float(height),
                            device=dev)}
                torch.cuda.synchronize(dev)
                torch.cuda.reset_peak_memory_stats(dev)
                base = torch.cuda.memory_allocated(dev)
                with torch.inference_mode():
                    unet_mod.apply(ms.unet_params, ucfg, x, t, ctx,
                                   added_cond=added)
                torch.cuda.synchronize(dev)
                return torch.cuda.max_memory_allocated(dev) - base

            by_dev = {}
            for ms in mss:
                by_dev[str(ms.device)] = 1.25 * self.dispatcher.submit(
                    lambda ms=ms: probe(ms), {}, solo=True).result()
            logger.info("bytes an image of %s at %dx%d by device: %s",
                        engine_id, width, height, by_dev)
            per = max(by_dev.values())
        else:
            # ~12 live level-0-sized activation maps per CFG row
            c0 = ucfg.block_out_channels[0]
            bytes_el = 2 if cdt == torch.bfloat16 else 4
            per = 2 * 12 * (height // 8) * (width // 8) * c0 * bytes_el * 4
        self._probes[key] = per
        return per

    # ------------------------------------------------------------- status

    def engine_ready(self, spec) -> bool:
        """Ready when the port has a path for it: a generate engine of any
        family (SD1.x, SD2, SDXL and its refiner) once its weights are
        resident, its UNet taking 4 input channels (txt2img and every
        mode), 9 (inpainting) or 5 (depth2img); a hinter engine (depth,
        edge, line art, pose, segmentation, normals, lines, background
        removal), an upscaler (ESRGAN, SwinIR, HAT, the sd-x4 and sd-x2
        diffusion upscalers) or a face-restore engine, which loads at
        first use, once the engines have loaded, as in the JAX package."""
        if spec.task in ("depth", "edge", "hinter", "pose", "segmentation",
                         "normal", "background_removal"):
            return self._loaded and (spec.params.get("kind") or spec.task) \
                in self._HINTER_KINDS + self._BG_KINDS
        if spec.task in ("upscaler", "face_restore", "codeformer"):
            return self._loaded
        ms = self._modelsets.get(spec.id)
        if spec.task != "generate" or ms is None:
            return False
        return ms.config.unet.in_channels in (4, 5, 9)

    def engine_devices(self, spec) -> list[str]:
        """The devices an engine runs on: a generate engine's every mesh
        device once its replicas exist, else the first device."""
        if spec.id in self._replicas:
            return [str(d) for d in self.mesh.devices]
        return [str(self.device)]

    def status(self) -> list[dict]:
        return [
            {"id": s.id, "name": s.name, "task": s.task,
             "ready": self.engine_ready(s),
             "enabled": s.enabled, "default": s.default,
             "visible": s.visible,
             # "real" = checkpoint loaded, "random" = random weights
             # (loud), "pending" = not yet built
             "weights": self._weights_kind.get(s.id, "pending"),
             "devices": self.engine_devices(s)}
            for s in self.specs
        ]


def manager_from_yaml(path: str, flags: dict | None = None,
                      **kwargs) -> EngineManager:
    entries = engines_yaml.load(path, flags or {})
    return EngineManager(entries, **kwargs)
