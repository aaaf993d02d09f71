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
none. Not ported, and raising NotImplementedError with the ROADMAP item
when an engine or request needs them: the CLIP model for guidance (C6),
task engines (D), and the upscalers' class and scale-shift time
conditioning of a UNet (D4).
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
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


def _unported(what: str, item: str):
    raise NotImplementedError(
        f"{what} is not ported to gyre_tpu_torch yet (ROADMAP {item})")


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
                 gather_ms: float = 10.0, watchdog_s: float = 900.0):
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
        self.device = torch.device(device)
        self.compute_dtype = compute_dtype
        self.batch_max = batch_max
        self._weight_resolver = weight_resolver
        self.hintsets = HintsetManager(
            hintset_entries, configs.SD15.unet, compute_dtype=compute_dtype,
            device=self.device, model_loader=self.load_model_entry)
        # url artifacts resolve through it (server.serve sets it)
        self.resources = None
        self._modelsets: dict[str, ModelSet] = {}
        self._pipelines: dict[str, UnifiedPipeline] = {}
        self._views: dict[str, DispatchView] = {}
        # adapted views (LoRA/TI folded in), oldest first
        self._adapted: dict[tuple, DispatchView] = {}
        self._probes: dict[tuple, float] = {}
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

    @property
    def weight_resolver(self):
        if self._weight_resolver is None:
            from .weights import WeightResolver

            self._weight_resolver = WeightResolver()
        return self._weight_resolver

    def _build_modelset(self, spec: EngineSpec) -> ModelSet:
        if spec.task != "generate":
            _unported(f"engine {spec.id}: task {spec.task!r}", "D")
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

    def pipeline(self, engine_id: str) -> UnifiedPipeline:
        if engine_id not in self._pipelines:
            with self._load_lock:
                if engine_id in self._pipelines:
                    return self._pipelines[engine_id]
                spec = self.spec(engine_id)
                # `graft:` names the engine whose UNet is grafted on top
                graft_id = spec.params.get("graft") or \
                    (spec.options or {}).get("graft")
                self._pipelines[engine_id] = UnifiedPipeline(
                    self.modelset(engine_id),
                    compute_dtype=self.compute_dtype,
                    graft_ms=self.modelset(graft_id) if graft_id else None)
        return self._pipelines[engine_id]

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
        from ..pipeline import lora as lora_mod

        ms = base.ms
        unet_p, text_p = ms.unet_params, list(ms.text_params)
        tokenizer = ms.tokenizer
        with torch.inference_mode():
            for d in deltas:
                unet_p, text_p, n = lora_mod.fold_deltas(unet_p, text_p, d)
                logger.info("lora applied to %s: %d modules", engine_id, n)
            if embeddings:
                text_p, tokenizer = lora_mod.apply_textual_inversions(
                    dataclasses.replace(ms, text_params=text_p), embeddings)
        new_ms = dataclasses.replace(
            ms, unet_params=unet_p, text_params=text_p, tokenizer=tokenizer,
            id=f"{ms.id}+adapters")
        view = DispatchView(base.derive(new_ms))
        if len(self._adapted) >= 8:           # bounded: drop the oldest
            self._adapted.pop(next(iter(self._adapted)))
        self._adapted[key] = view
        return view

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
        return max(1, min(int(free / per_image), 64))

    def _probe_bytes_per_image(self, engine_id: str, height: int,
                               width: int) -> float:
        """Bytes one image adds at (height, width). On the card: one CFG
        UNet call at 2 rows (one image) run on the dispatcher's thread,
        its peak allocation above what was allocated before it, with a
        25 % margin for the sampler's carry and the allocator (the CUDA
        counterpart of the JAX package's XLA memory analysis). On the CPU:
        the JAX package's config-scaled estimate. Cached per (engine,
        size)."""
        key = (engine_id, height, width)
        if key in self._probes:
            return self._probes[key]
        from ..models import unet as unet_mod

        ms = self.pipeline(engine_id).ms
        ucfg = ms.config.unet
        cdt = self.compute_dtype
        if self.device.type == "cuda":
            def probe():
                dev = self.device
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

            per = 1.25 * self.dispatcher.submit(probe, {},
                                                solo=True).result()
        else:
            # ~12 live level-0-sized activation maps per CFG row
            c0 = ucfg.block_out_channels[0]
            bytes_el = 2 if cdt == torch.bfloat16 else 4
            per = 2 * 12 * (height // 8) * (width // 8) * c0 * bytes_el * 4
        self._probes[key] = per
        return per

    # ------------------------------------------------------------- status

    def engine_ready(self, spec) -> bool:
        """Ready when its weights are resident and the port has a path for
        it: a generate engine of any family (SD1.x, SD2, SDXL and its
        refiner: a UNet with class or scale-shift conditioning does not
        build), its UNet taking 4 input channels (txt2img and every mode),
        9 (inpainting) or 5 (depth2img). A task engine
        needs its pipeline (ROADMAP D) and is not ready, since each of its
        requests would answer UNIMPLEMENTED."""
        ms = self._modelsets.get(spec.id)
        if spec.task != "generate" or ms is None:
            return False
        return ms.config.unet.in_channels in (4, 5, 9)

    def status(self) -> list[dict]:
        return [
            {"id": s.id, "name": s.name, "task": s.task,
             "ready": self.engine_ready(s),
             "enabled": s.enabled, "default": s.default,
             "visible": s.visible,
             # "real" = checkpoint loaded, "random" = random weights
             # (loud), "pending" = not yet built
             "weights": self._weights_kind.get(s.id, "pending")}
            for s in self.specs
        ]


def manager_from_yaml(path: str, flags: dict | None = None,
                      **kwargs) -> EngineManager:
    entries = engines_yaml.load(path, flags or {})
    return EngineManager(entries, **kwargs)
