"""EngineManager: engine registry, model-set construction, dispatcher.

Counterpart of gyre_tpu/manager/manager.py, txt2img subset. Engines are
given as a list of dicts (the engines.yaml entry format; ``load_yaml``
reads such a file). A ``model: {preset: <name>, seed: N}`` engine builds a
random-weight ModelSet of a gyre_tpu.models.configs preset on the
manager's device. Weight files, model mixes, ``@engine`` part references,
LoRA/textual inversion and task engines are not ported yet and raise.

All device work of the serving path flows through ONE shared
CoalescingDispatcher (gyre_tpu.manager.scheduler, imported, not copied):
its single thread owns the card and merges compatible concurrent requests
into one batch.
"""

from __future__ import annotations

import logging
import threading
from contextlib import contextmanager
from dataclasses import dataclass, field

import torch

from gyre_tpu.manager.scheduler import CoalescingDispatcher

from ..models.modelset import ModelSet, random_preset
from ..pipeline.unified import UnifiedPipeline

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
    model: str | dict | None = None     # preset name or {preset:, seed:}
    options: dict = field(default_factory=dict)

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

    def __init__(self, engine_specs, device, compute_dtype=torch.bfloat16,
                 batch_max: int = 4, gather_ms: float = 10.0):
        self.specs: list[EngineSpec] = [
            s if isinstance(s, EngineSpec) else EngineSpec.from_dict(s)
            for s in engine_specs
            if isinstance(s, EngineSpec) or (isinstance(s, dict) and
                                             s.get("id"))]
        self.device = torch.device(device)
        self.compute_dtype = compute_dtype
        self.batch_max = batch_max
        self._modelsets: dict[str, ModelSet] = {}
        self._pipelines: dict[str, UnifiedPipeline] = {}
        self._views: dict[str, DispatchView] = {}
        self._load_lock = threading.RLock()
        self._loaded = False
        self.dispatcher = CoalescingDispatcher(max_batch=max(batch_max, 1),
                                               gather_ms=gather_ms)

    # ------------------------------------------------------------ loading

    def load_engines(self):
        for spec in self.specs:
            if spec.enabled and spec.task == "generate":
                ms = self.modelset(spec.id)
                logger.info("engine %s loaded (%.1f MB params)", spec.id,
                            ms.param_bytes() / 1e6)
        self._loaded = True

    def _build_modelset(self, spec: EngineSpec) -> ModelSet:
        if spec.task != "generate":
            raise NotImplementedError(
                f"engine {spec.id}: task {spec.task!r} is not ported to "
                "gyre_tpu_torch yet")
        model = spec.model
        if isinstance(model, dict):
            unported = sorted(set(model) - {"preset", "seed"})
            if unported:
                raise NotImplementedError(
                    f"engine {spec.id}: model keys {unported} are not "
                    "ported to gyre_tpu_torch yet (random-weight presets "
                    "only)")
            preset, seed = model.get("preset", "sd15"), int(
                model.get("seed", 0))
        elif isinstance(model, str) and model.startswith("preset/"):
            preset, seed = model.split("/", 1)[1], 0
        elif model is None:
            preset, seed = "sd15", 0
        else:
            raise NotImplementedError(
                f"engine {spec.id}: loading weights ({model!r}) is not "
                "ported to gyre_tpu_torch yet (random-weight presets only)")
        return random_preset(preset, seed=seed, dtype=self.compute_dtype,
                             device=self.device, engine_id=spec.id)

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
                if engine_id not in self._modelsets:
                    spec = self.spec(engine_id)
                    if not spec.enabled:
                        raise EngineNotFoundError(engine_id)
                    self._modelsets[engine_id] = self._build_modelset(spec)
        return self._modelsets[engine_id]

    def pipeline(self, engine_id: str) -> UnifiedPipeline:
        if engine_id not in self._pipelines:
            with self._load_lock:
                if engine_id not in self._pipelines:
                    self._pipelines[engine_id] = UnifiedPipeline(
                        self.modelset(engine_id),
                        compute_dtype=self.compute_dtype)
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

    @contextmanager
    def with_engine(self, engine_id: str | None = None):
        """Borrow an engine for one request: yields its DispatchView.
        Not a device claim: device work is serialised (and batched) by the
        dispatcher thread. LoRA/TI adapters are not ported yet."""
        yield self.dispatch_view(engine_id or self.default_engine_id())

    def engine_ready(self, spec) -> bool:
        return spec.id in self._modelsets

    def status(self) -> list[dict]:
        return [{"id": s.id, "name": s.name, "task": s.task,
                 "ready": self.engine_ready(s), "enabled": s.enabled,
                 "default": s.default, "visible": s.visible,
                 "weights": "random" if s.id in self._modelsets
                 else "pending"}
                for s in self.specs]


def load_yaml(path: str) -> list[dict]:
    """Engine entries from a YAML file holding a list of engine dicts."""
    import yaml

    with open(path) as fh:
        entries = yaml.safe_load(fh) or []
    if not isinstance(entries, list):
        raise ValueError(f"{path}: expected a list of engine entries")
    return entries
